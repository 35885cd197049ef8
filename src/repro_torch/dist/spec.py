"""The port's PartitionSpec: how a leaf's dims map onto mesh axes.

A tuple with one entry per leading dim: an axis name, a tuple of names
(the dim is split over their product, row-major), or ``None``
(replicated).  Dims past its length are replicated.  Indexing and
equality are a tuple's, and a one-name tuple is stored as the bare name,
as the reference's ``jax.sharding.PartitionSpec`` stores it.
"""
from __future__ import annotations


class PartitionSpec(tuple):
    """``PartitionSpec(("pod", "data"), None)``: dim 0 over pod x data."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

