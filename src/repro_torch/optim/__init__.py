"""AdamW and the learning-rate schedule: the port of ``repro.optim``."""
from .adamw import AdamW
from .schedule import warmup_cosine

__all__ = ["AdamW", "warmup_cosine"]
