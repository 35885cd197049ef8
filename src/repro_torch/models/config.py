"""Model configuration: the port's own copy of ``repro.models.config``.

The fields that fix a model's shapes and arithmetic are kept with the
reference's names and defaults, so a config and its weights carry across;
the MoE fields among them (expert count, top-k, expert width, the dense
residual, the capacity factor), the recurrent mixers' (Mamba's state
width, convolution width and expansion; xLSTM's sLSTM period) and the
encoder-decoder stack's and front ends' (``enc_dec``, ``frontend``,
``frontend_len``).
The training numerics are here with the reference's names and defaults:
``moment_dtype``, ``remat`` (per-slot activation checkpointing),
``norm_vjp`` (the custom-VJP norms), ``bf16_grad_boundaries`` and
``attn_tile`` (the training attention's tile).  The reference's mesh and
XLA-only knobs have no counterpart:

- ``seq_parallel``: shards activations over a tensor-parallel mesh axis,
  and the port runs on one device;
- ``attn_kv_gather_first``: orders a sequence-parallel all-gather, and
  there is no collective on one device;
- ``opt_grad_barrier``: stops XLA hoisting converts past a gradient
  all-reduce, and eager PyTorch neither hoists nor all-reduces;
- ``unroll_layers``: unrolls ``lax.scan`` for XLA's cost analysis, and the
  port's stack is a Python loop already;
- ``use_flash_kernel``: the caller picks the attention path (the flash
  kernel for the prefill, the tiled differentiable path for training).
"""
from __future__ import annotations

import dataclasses
import math

VOCAB_PAD_MULTIPLE = 2048  # the reference pads the vocab so 16-way TP divides it


def pad_vocab(v: int, mult: int = VOCAB_PAD_MULTIPLE) -> int:
    return -(-v // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # expert hidden width (0: d_ff)
    moe_every: int = 1          # MoE FFN every k-th layer
    dense_residual: bool = False  # arctic: a dense FFN beside the MoE
    capacity_factor: float = 1.25

    # --- hybrid: one attention layer per `attn_every` layers ---
    attn_every: int = 0

    # --- SSM ---
    ssm_kind: str = ""          # mamba | xlstm
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2             # mamba d_inner = expand * d_model
    slstm_every: int = 0        # xlstm: one sLSTM per k layers (7:1 -> 8)

    # --- norm / activation / positions ---
    norm: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    activation: str = "swiglu"  # swiglu | squared_relu | gelu
    rope_theta: float = 10000.0

    # --- structure ---
    enc_dec: bool = False       # n_layers encoder layers + n_layers decoder layers
    frontend: str = ""          # "" | vision | audio (precomputed embeddings)
    frontend_len: int = 256     # vision: patches put in front of the prompt
    tie_embeddings: bool = False
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- numerics ---
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"   # Adam moments (bf16 for the 400B+ archs)
    remat: str = "full"             # none | full: checkpoint every slot
    attn_tile: int = 0              # training attention tile; 0 = pick_tile
    norm_vjp: str = "autodiff"      # "custom" = hand-written bf16-cotangent VJP
    bf16_grad_boundaries: bool = False  # cast q/k/v cotangents to their dtype

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:   # mamba inner width
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_kind(self, i: int) -> str:
        """Mixer kind of layer i: attn | mamba | mlstm | slstm."""
        if self.ssm_kind == "xlstm":
            last = self.slstm_every and i % self.slstm_every == self.slstm_every - 1
            return "slstm" if last else "mlstm"
        if self.attn_every:
            return "attn" if i % self.attn_every == self.attn_every // 2 else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """FFN kind of layer i: dense | moe | none (xlstm has no FFN)."""
        if self.ssm_kind == "xlstm":
            return "none"
        if self.n_experts and i % self.moe_every == self.moe_every - 1:
            return "moe"
        return "dense"

    @property
    def group_size(self) -> int:
        """Layers per group (the pattern period)."""
        if self.ssm_kind == "xlstm":
            return self.slstm_every or 1
        p = self.attn_every or 1
        if self.n_experts and self.moe_every > 1:
            p = p * self.moe_every // math.gcd(p, self.moe_every)
        return p

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.group_size:
            raise ValueError(f"{self.name}: {self.n_layers} layers are not a "
                             f"whole number of groups of {self.group_size}")
        return self.n_layers // self.group_size

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM/hybrid)."""
        return self.ssm_kind != "" or self.attn_every > 0

    def param_count(self) -> int:
        """Analytic parameter count (the 6ND roofline's N), the
        reference's formula."""
        d, hd = self.d_model, self.hd
        n_mats = 3 if self.activation == "swiglu" else 2
        emb = self.vocab_size * d
        total = emb if self.tie_embeddings else 2 * emb
        for i in range(self.n_layers):
            k = self.layer_kind(i)
            if k == "attn":
                total += d * self.n_heads * hd * 2          # q, o
                total += d * self.n_kv_heads * hd * 2       # k, v
            elif k == "mamba":
                di, ds, dtr = self.d_inner, self.d_state, self.dt_rank
                total += d * 2 * di + di * self.d_conv + di
                total += di * (dtr + 2 * ds) + dtr * di + di
                total += di * ds + di + di * d
            elif k in ("mlstm", "slstm"):
                total += 4 * d * d + 2 * d * self.n_heads + 2 * d
            f = self.ffn_kind(i)
            if f == "dense":
                total += n_mats * d * self.d_ff
            elif f == "moe":
                total += self.n_experts * n_mats * d * self.expert_d_ff
                total += d * self.n_experts                 # router
                if self.dense_residual:
                    total += n_mats * d * self.d_ff
            total += 2 * d if self.norm != "nonparam_ln" else 0
        if self.enc_dec:  # the encoder stack, and each decoder layer's cross attention
            for _ in range(self.n_layers):
                total += d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
                total += n_mats * d * self.d_ff
                total += d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        return total

    def active_param_count(self) -> int:
        """Parameters a token reads (MoE: top-k experts, not all)."""
        if not self.n_experts:
            return self.param_count()
        n_mats = 3 if self.activation == "swiglu" else 2
        per_expert = n_mats * self.d_model * self.expert_d_ff
        n_moe = sum(1 for i in range(self.n_layers) if self.ffn_kind(i) == "moe")
        return (self.param_count() - n_moe * self.n_experts * per_expert
                + n_moe * self.top_k * per_expert)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
