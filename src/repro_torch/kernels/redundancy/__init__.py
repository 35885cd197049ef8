from .ops import fused_update, fused_update_many

__all__ = ["fused_update", "fused_update_many"]
