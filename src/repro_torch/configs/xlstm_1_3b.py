"""xlstm-1.3b [ssm] — mLSTM + sLSTM blocks at 7:1, no FFN (d_ff=0).

48L d_model=2048 4H vocab=50304 [arXiv:2405.04517; unverified]. O(1)
recurrent state per layer.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_kind="xlstm",
    slstm_every=8,
    norm="layernorm",
    activation="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=512,
)
