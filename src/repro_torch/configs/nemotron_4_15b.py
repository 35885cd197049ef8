"""nemotron-4-15b [dense] — GQA + squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000
[arXiv:2402.16819; unverified].
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    norm="layernorm",
    activation="squared_relu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="nemotron-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512,
)
