"""glm4-9b [dense] — RoPE, GQA kv=2.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 [hf:THUDM/glm-4-9b; hf].
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    norm="rmsnorm",
    activation="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="glm4-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512,
)
