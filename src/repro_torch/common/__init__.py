from .device import resolve_device
from .flatten import flatten_dict, replace_leaves, tree_map, unflatten_dict

__all__ = ["flatten_dict", "replace_leaves", "resolve_device", "tree_map",
           "unflatten_dict"]
