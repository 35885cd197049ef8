"""llama3.2-3b [dense] — small llama3; tied embeddings, RoPE theta 5e5.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B family; unverified].
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama3.2-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512,
)
