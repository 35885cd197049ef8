from .device import resolve_device
from .flatten import flatten_dict, unflatten_dict

__all__ = ["flatten_dict", "resolve_device", "unflatten_dict"]
