"""internvl2-1b [vlm] — InternViT frontend (stub) + Qwen2-0.5B-family LM.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821; hf].
The frontend is a stub: the batch carries precomputed patch embeddings
``frontend`` (B, 256, d), which the model puts in front of the prompt.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    norm="rmsnorm",
    activation="swiglu",
    frontend="vision",
    frontend_len=256,
)

SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-smoke", n_layers=3, d_model=56, n_heads=14,
    n_kv_heads=2, d_ff=96, vocab_size=512, frontend_len=16,
)
