"""seamless-m4t-medium [audio] — encoder-decoder, multimodal frontend stub.

12L (encoder) + 12L (decoder) d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206 [arXiv:2308.11596; hf]. The speech frontend is a stub: the
batch carries precomputed frame embeddings ``enc_input`` (B, enc_len, d).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    activation="gelu",
    enc_dec=True,
    frontend="audio",
)

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512,
)
