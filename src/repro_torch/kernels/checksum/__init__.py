from .ops import block_checksums

__all__ = ["block_checksums"]
