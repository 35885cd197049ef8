from .ops import fused_update

__all__ = ["fused_update"]
