"""GQA attention: the causal prefill on the flash kernel, and decode.

The port of ``repro.models.attention``.  The prefill has one causal path:
``kernels.flash_attn.flash_attention``, the hand-written CUDA kernel on the
card (its plain version on the CPU).  The kernel maps query head ``h`` to
KV head ``h // (H // KV)``, the head order of the reference's
``expand_kv``, so k and v are never expanded.

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


def causal_attention(params, x: torch.Tensor, cfg,
                     positions: Optional[torch.Tensor] = None, rope: bool = True
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal GQA over (B, S, d).  Returns ``(out, (k, v))``, k and v
    (B, S, KV, hd) after RoPE, for the cache."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions, rope)
    out = flash_ops.flash_attention(q, k, v, causal=True)     # (B, S, H, hd)
    return _out_proj(out.to(x.dtype), params["wo"]), (k, v)


def decode_attention(params, x: torch.Tensor, cfg, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, rope: bool = True
                     ) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); caches (S_max, B, KV, hd).

    Writes this token's k and v at row ``pos`` of the caches, in place, and
    attends over rows ``<= pos`` by a mask over all S_max rows, with an fp32
    softmax, as the reference does.  Returns the (B, 1, d) output (the
    reference also returns the new caches; here they are the inputs,
    written in place).
    """
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S_max = k_cache.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q = _proj(x, params["wq"])
    k_new = _proj(x, params["wk"])
    v_new = _proj(x, params["wv"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    k_cache[pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[pos] = v_new[:, 0].to(v_cache.dtype)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,sbkd->bkgs", qg, k_cache).float() / math.sqrt(hd)
    valid = torch.arange(S_max, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,sbkd->bkgd", p.to(v_cache.dtype), v_cache)
    return _out_proj(out.reshape(B, 1, H, hd).to(x.dtype), params["wo"])
