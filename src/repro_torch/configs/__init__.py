from .registry import get_arch, get_smoke, list_archs

__all__ = ["get_arch", "get_smoke", "list_archs"]
