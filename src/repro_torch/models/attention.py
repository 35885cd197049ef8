"""GQA attention: causal and full (encoder, cross) attention for the
prefill and for training, and decode.

The port of ``repro.models.attention``.  The caller picks the path: the
prefill takes ``kernels.flash_attn.flash_attention``, the hand-written
CUDA kernel on the card (its plain version on the CPU), which is
forward-only and refuses a gradient; training takes the reference's
differentiable paths (causal: a static lower-triangle schedule of (q, kv)
tiles, merged flash-style; full: one unmasked tile over every key), whose
backward is autograd's.  Cross attention reads keys of the encoder's
length, which the kernel takes beside the decoder's queries.  The kernel maps
query head ``h`` to KV head ``h // (H // KV)``, the head order of
``expand_kv``, so on the prefill k and v are never expanded.

KV caches are sequence-major ``(S_max, B, KV, hd)``, as in the reference:
a decode write is one leading-axis row, and Vilamb's page-level dirty
tracking maps pages to leading-axis rows.  The port writes that row in
place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attn import ops as flash_ops
from .layers import apply_rope, dense_init

NEG_INF = -1e30


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is cast back to the primal dtype (the
    reference's ``bf16_grad_boundaries`` knob: attention's fp32 scores must
    not make dq, dk and dv fp32)."""
    return _GradCast.apply(x)


def attn_init(gen: Optional[torch.Generator], cfg, dtype: torch.dtype = torch.float32,
              device=None, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """wq (d, H, hd), wk and wv (d, KV, hd), wo (H, hd, d), each prefixed by
    ``lead`` (the stack's group axis); fan-in over the first unprefixed axis."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    a = len(lead)
    return {
        "wq": dense_init(gen, lead + (d, H, hd), in_axis=a, dtype=dtype, device=device),
        "wk": dense_init(gen, lead + (d, KV, hd), in_axis=a, dtype=dtype, device=device),
        "wv": dense_init(gen, lead + (d, KV, hd), in_axis=a, dtype=dtype, device=device),
        "wo": dense_init(gen, lead + (H, hd, d), in_axis=a, dtype=dtype, device=device),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.reshape(h * k, d)


def _qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor, rope: bool = True):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast the KV heads of (B, S, KV, hd) up to ``n_heads``: KV head
    ``j`` serves query heads ``j * G .. j * G + G - 1``."""
    B, S, KV, hd = k.shape
    G = n_heads // KV
    return k[:, :, :, None, :].expand(B, S, KV, G, hd).reshape(B, S, n_heads, hd)


def _tile_attn(q, k, v, scale: float, mask=None):
    """One (q-tile, kv-tile) partial: ``(acc, m, l)``, fp32.

    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd) (KV already expanded to H).
    The scores are rounded to q's dtype before the fp32 scale, and p to
    v's dtype before the second product, as in the reference.
    """
    s = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                        # (B, H, Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqs,bshd->bhqd", p.to(v.dtype), v).float()
    return acc, m, l


def _merge(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


def pick_tile(B: int, H: int, S: int, shards: int = 1,
              budget_bytes: int = 256 * 2**20) -> int:
    """Largest q/kv tile whose fp32 score block fits the budget."""
    for t in (4096, 2048, 1024, 512):
        if S % t == 0 and B * H * t * t * 4 // max(shards, 1) <= budget_bytes:
            return t
    return 512 if S % 512 == 0 else S


def _causal_mask(n: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)
    return (i[:, None] >= i[None, :])[None, None]


def _tiled_causal(q, ke, ve, tile: int) -> torch.Tensor:
    """The training attention: (B, H, S, hd) fp32 over the lower triangle
    of (q, kv) tiles only; the diagonal tiles carry the causal mask."""
    S = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if S <= tile:
        acc, m, l = _tile_attn(q, ke, ve, scale, _causal_mask(S, q.device))
        return acc / l[..., None].clamp_min(1e-30)
    if S % tile:
        raise ValueError(f"attention tile {tile} does not divide S={S}")
    diag = _causal_mask(tile, q.device)
    outs = []
    for i in range(S // tile):                 # static schedule
        qi = q[:, i * tile:(i + 1) * tile]
        acc = m = l = None
        for j in range(i + 1):                 # lower triangle only
            part = _tile_attn(qi, ke[:, j * tile:(j + 1) * tile],
                              ve[:, j * tile:(j + 1) * tile], scale,
                              diag if j == i else None)
            acc, m, l = part if acc is None else _merge(acc, m, l, *part)
        outs.append(acc / l[..., None].clamp_min(1e-30))
    return torch.cat(outs, dim=2)


def causal_attention(params, x: torch.Tensor, cfg,
                     positions: Optional[torch.Tensor] = None, rope: bool = True,
                     *, train: bool = False
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal GQA over (B, S, d).  Returns ``(out, (k, v))``, k and v
    (B, S, KV, hd) after RoPE, for the cache.

    ``train=False`` (the prefill) runs the flash kernel, which raises if
    asked for a gradient; ``train=True`` runs the differentiable tiled path
    with ``cfg.attn_tile`` (0: :func:`pick_tile`'s 256 MiB budget).
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions, rope)
    if not train:
        out = flash_ops.flash_attention(q, k, v, causal=True)     # (B, S, H, hd)
        return _out_proj(out.to(x.dtype), params["wo"]), (k, v)
    if cfg.bf16_grad_boundaries:
        q, k, v = grad_cast(q), grad_cast(k), grad_cast(v)
    H = cfg.n_heads
    out = _tiled_causal(q, expand_kv(k, H), expand_kv(v, H),
                        cfg.attn_tile or pick_tile(B, H, S))
    out = out.transpose(1, 2).to(x.dtype)                    # (B, S, H, hd)
    return _out_proj(out, params["wo"]), (k, v)


def full_attention(params, x: torch.Tensor, cfg, kv_x: Optional[torch.Tensor] = None,
                   rope: bool = False, *, train: bool = False
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Non-causal GQA (the encoder's self attention, the decoder's cross
    attention) of x (B, Sq, d) over ``kv_x`` (B, Sk, d), x by default.
    Returns ``(out, (k, v))``, k and v (B, Sk, KV, hd) (after RoPE where
    ``rope``, at positions ``0 .. Sk - 1``; queries at ``0 .. Sq - 1``).

    ``train=False`` (the prefill) runs the flash kernel with ``causal=False``
    at Sk keys; ``train=True`` the differentiable path, the reference's one
    unmasked tile over all Sk keys.
    """
    src = x if kv_x is None else kv_x
    q = _proj(x, params["wq"])
    k = _proj(src, params["wk"])
    v = _proj(src, params["wv"])
    if rope:
        q = apply_rope(q, torch.arange(x.shape[1], device=x.device)[None, :],
                       cfg.rope_theta)
        k = apply_rope(k, torch.arange(src.shape[1], device=x.device)[None, :],
                       cfg.rope_theta)
    if not train:
        out = flash_ops.flash_attention(q, k, v, causal=False)    # (B, Sq, H, hd)
        return _out_proj(out.to(x.dtype), params["wo"]), (k, v)
    H = cfg.n_heads
    acc, _, l = _tile_attn(q, expand_kv(k, H), expand_kv(v, H), 1.0 / math.sqrt(cfg.hd))
    out = (acc / l[..., None].clamp_min(1e-30)).transpose(1, 2).to(x.dtype)
    return _out_proj(out, params["wo"]), (k, v)


def decode_attention(params, x: torch.Tensor, cfg, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, rope: bool = True,
                     cross: bool = False) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); caches (S_max, B, KV, hd).

    Writes this token's k and v at row ``pos`` of the caches, in place, and
    attends over rows ``<= pos`` by a mask over all S_max rows, with an fp32
    softmax, as the reference does.  With ``cross`` the caches are the
    encoder memory: nothing is written and every row is attended to.
    Returns the (B, 1, d) output (the reference also returns the new
    caches; here they are the inputs, written in place).
    """
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S_max = k_cache.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q = _proj(x, params["wq"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    if not cross:
        k_new = _proj(x, params["wk"])
        v_new = _proj(x, params["wv"])
        if rope:
            k_new = apply_rope(k_new, positions, cfg.rope_theta)
        k_cache[pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[pos] = v_new[:, 0].to(v_cache.dtype)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,sbkd->bkgs", qg, k_cache).float() / math.sqrt(hd)
    if not cross:
        valid = torch.arange(S_max, device=x.device) <= pos
        s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,sbkd->bkgd", p.to(v_cache.dtype), v_cache)
    return _out_proj(out.reshape(B, 1, H, hd).to(x.dtype), params["wo"])
