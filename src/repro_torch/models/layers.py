"""Shared layer primitives: norms, RoPE, dense FFNs, initialisers.

The port of ``repro.models.layers``.  Reductions run in fp32; the
(B, S, d)-sized products stay in the input dtype, as in the reference.
The custom-VJP norms (``rmsnorm_cv``, ``layernorm_cv``) are
``torch.autograd.Function``s whose backward keeps the (B, S, d) tensors in
the input dtype as well.  Initialisers draw from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(gen: Optional[torch.Generator], shape, in_axis: int = -2,
               scale: float = 1.0, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """Fan-in truncated normal (cut at +-2 sd), drawn in fp32, cast to ``dtype``."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale / math.sqrt(fan_in)).to(dtype)


def check_chunks(S: int, chunk: int) -> None:
    """The recurrent mixers' prefill walks whole chunks: a sequence longer
    than a chunk must be a multiple of it (the reference asserts so)."""
    if S % chunk:
        raise ValueError(f"a sequence of {S} tokens is not a whole number of "
                         f"chunks of {chunk}")


def chunk_checkpoint(fn: Callable, cfg, x: torch.Tensor,
                     params: Dict[str, torch.Tensor]) -> Callable:
    """``fn``, one chunk of a recurrent mixer's prefill, as training runs
    it: under a non-reentrant ``torch.utils.checkpoint`` (the reference's
    per-chunk ``jax.checkpoint``) where autograd records (grad mode on, and
    ``x`` or a parameter requires grad) unless ``cfg.remat == "none"``;
    else ``fn`` itself.  A chunk draws no random numbers, so no RNG state
    is saved for its recompute."""
    if (cfg.remat == "none" or not torch.is_grad_enabled()
            or not (x.requires_grad or any(p.requires_grad for p in params.values()))):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)


def embed_init(gen: Optional[torch.Generator], shape,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, 0.02, generator=gen).to(dtype)


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` in the ``(1 + scale)`` form.

    The sum of squares is fp32 (bf16 products are exact in fp32); ``inv``
    is cast to x's dtype before the product, as the reference does.
    """
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = x * inv
    if scale is not None:
        y = y * (1.0 + scale).to(x.dtype)
    return y


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    if scale is not None:
        y = y * scale.to(x.dtype) + bias.to(x.dtype)
    return y


# Custom-VJP norms: autodiff of the fp32 variance promotes the whole
# residual-stream cotangent to fp32; the hand-written backward keeps every
# (B, S, d) tensor in the input dtype and only the (B, S) reductions in
# fp32.  Selected by ``ModelConfig.norm_vjp == "custom"``.
def _f32_dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 sum over the last axis of ``a * b`` (bf16 products are exact in
    fp32; the fp32 copies are transient, inside the reduction)."""
    return (a.float() * b.float()).sum(dim=-1)


class _RMSNormCV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        var = (_f32_dot_last(x, x) / x.shape[-1])[..., None]
        inv = torch.rsqrt(var + eps)                        # fp32 (B, S, 1)
        y = x * inv.to(x.dtype)
        if scale is not None:
            y = y * (1.0 + scale).to(x.dtype)
        ctx.save_for_backward(x, scale, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        d = x.shape[-1]
        gs = g * (1.0 + scale).to(g.dtype) if scale is not None else g
        t = (_f32_dot_last(gs, x) / d)[..., None]           # fp32 (B, S, 1)
        dx = gs * inv.to(g.dtype) - x * (t * inv ** 3).to(g.dtype)
        dscale = None
        if scale is not None:
            xhat = x * inv.to(x.dtype)
            dscale = (g * xhat).float().sum(dim=tuple(range(g.dim() - 1))).to(scale.dtype)
        return dx, dscale, None


class _LayerNormCV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        d = x.shape[-1]
        mean = (x.float().sum(dim=-1) / d)[..., None]
        var = (_f32_dot_last(x, x) / d)[..., None] - mean * mean
        inv = torch.rsqrt(var.clamp_min(0.0) + eps)         # fp32 (B, S, 1)
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        y = xhat
        if scale is not None:
            y = y * scale.to(x.dtype) + bias.to(x.dtype)
        ctx.save_for_backward(xhat, scale, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        xhat, scale, inv = ctx.saved_tensors
        d = xhat.shape[-1]
        gs = g * scale.to(g.dtype) if scale is not None else g
        m1 = (gs.float().sum(dim=-1) / d)[..., None]
        m2 = (_f32_dot_last(gs, xhat) / d)[..., None]
        dx = inv.to(g.dtype) * (gs - m1.to(g.dtype) - xhat * m2.to(g.dtype))
        dscale = dbias = None
        if scale is not None:
            dims = tuple(range(g.dim() - 1))
            dscale = (g * xhat).float().sum(dim=dims).to(scale.dtype)
            dbias = g.float().sum(dim=dims).to(scale.dtype)
        return dx, dscale, dbias, None


def rmsnorm_cv(x: torch.Tensor, scale: Optional[torch.Tensor],
               eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` with the hand-written backward."""
    return _RMSNormCV.apply(x, scale, eps)


def layernorm_cv(x: torch.Tensor, scale: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the hand-written backward (``scale=bias=None``: OLMo's
    non-parametric form)."""
    return _LayerNormCV.apply(x, scale, bias, eps)


def nonparam_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    return layernorm(x, None, None, eps)


def make_norm(cfg) -> Tuple[Callable, Callable]:
    """``(init(d, device, lead), apply(params, x))`` for ``cfg.norm``.  Norm
    parameters are fp32 whatever the param dtype, as in the reference;
    ``lead`` prefixes their shapes (the stack's group axis).  With
    ``cfg.norm_vjp == "custom"`` ``apply`` takes the custom-VJP norms."""
    kind = cfg.norm
    custom = cfg.norm_vjp == "custom"

    def init(d: int, device=None, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
        shape = lead + (d,)
        if kind == "nonparam_ln":
            return {}
        if kind == "layernorm":
            return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
                    "bias": torch.zeros(shape, dtype=torch.float32, device=device)}
        return {"scale": torch.zeros(shape, dtype=torch.float32, device=device)}

    def apply(params, x):
        if kind == "nonparam_ln":
            return layernorm_cv(x, None, None) if custom else nonparam_ln(x)
        if kind == "layernorm":
            if custom:
                return layernorm_cv(x, params["scale"], params["bias"])
            return layernorm(x, params["scale"], params["bias"])
        if custom:
            return rmsnorm_cv(x, params["scale"])
        return rmsnorm(x, params["scale"])

    return init, apply


# ----------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """fp32 ``1 / theta ** (2i / hd)``.  ``theta`` stays a Python scalar: a
    tensor made from it on the card would be a blocking host-to-device copy
    on every call."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) with ``positions`` broadcastable to (..., S).

    Angles, cos and sin are fp32; the rotation runs in x's dtype.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ----------------------------------------------------------------- FFN
def ffn_init(gen: Optional[torch.Generator], cfg, d_ff: Optional[int] = None,
             dtype: torch.dtype = torch.float32, device=None,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``lead`` prefixes every shape (the stack's group axis)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, lead + (d, ff), dtype=dtype, device=device)}
    if cfg.activation == "swiglu":
        p["wg"] = dense_init(gen, lead + (d, ff), dtype=dtype, device=device)
    p["wo"] = dense_init(gen, lead + (ff, d), dtype=dtype, device=device)
    return p


def ffn_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif cfg.activation == "squared_relu":   # nemotron-4
        h = torch.square(F.relu(x @ params["wi"]))
    else:                                     # gelu (jax.nn.gelu's tanh form)
        h = F.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"]
