"""Distribution rules: per-leaf sharding specs + gradient compression."""
from .compression import BLOCK, ef_compress
from .sharding import cache_specs, param_specs
from .spec import P, PartitionSpec

__all__ = ["BLOCK", "P", "PartitionSpec", "cache_specs", "ef_compress",
           "param_specs"]
