"""arctic-480b [moe] — 128 experts top-2 + dense residual path.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000
[hf:Snowflake/snowflake-arctic-base; hf].
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    norm="rmsnorm",
    activation="swiglu",
    moment_dtype="bfloat16",   # 480B: the reference's memory budget
)

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, moe_d_ff=96, vocab_size=512, n_experts=8, top_k=2,
    moment_dtype="float32",
)
