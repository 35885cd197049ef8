"""Shared helpers: tree flattening, device resolution, the CPU's vector math.

No counterpart of the reference's ``common/compat.py``: it is a
``shard_map`` keyword shim for JAX version drift, and the port has no
``shard_map``.
"""
from .device import resolve_device
from .flatten import flatten_dict, replace_leaves, tree_map, unflatten_dict

__all__ = ["flatten_dict", "replace_leaves", "resolve_device", "tree_map",
           "unflatten_dict"]
