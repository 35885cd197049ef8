from .ops import stripe_parity

__all__ = ["stripe_parity"]
