"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave + MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]. MoE on every 2nd layer (as in Jamba), which lands
the analytic parameter count at ~398B.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    ssm_kind="mamba",
    d_state=16,
    d_conv=4,
    norm="rmsnorm",
    activation="swiglu",
    moment_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, name="jamba-smoke", n_layers=16, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, n_experts=4, top_k=2,
    moment_dtype="float32",
)
