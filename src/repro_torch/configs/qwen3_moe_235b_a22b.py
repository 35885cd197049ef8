"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (expert width) vocab=151936
[hf:Qwen/Qwen3-30B-A3B scaled family; hf].
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    norm="rmsnorm",
    activation="swiglu",
    moment_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-moe-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, moe_d_ff=96, vocab_size=512, n_experts=8, top_k=2,
    moment_dtype="float32",
)
