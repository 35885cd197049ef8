"""Deterministic synthetic data: the port of ``repro.data``."""
from .pipeline import SyntheticPipeline, batch_shapes

__all__ = ["SyntheticPipeline", "batch_shapes"]
