"""Mamba (selective SSM) mixer of the jamba hybrid.

The port of ``repro.models.mamba``.  The prefill walks the sequence in
chunks of 128 carrying the ``(B, d_inner, d_state)`` fp32 state, with an
associative scan inside each chunk: :func:`associative_scan` combines in
``jax.lax.associative_scan``'s tree order (adjacent pairs reduced, the
recursion on the reduced half, the even elements fixed up), so the fp32
products of up to 128 ``exp(dt * A)`` factors round as the reference's do.
The ``(B, chunk, d_inner, d_state)`` tensors exist one chunk at a time.
Decode is the O(1) recurrent step over the carried ``(h, conv)``, written
into the caches in place.  In training each chunk runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint(step)``
does: the carried ``(h, conv)`` go in and come out, so the gradient
crosses chunk boundaries, and a backward holds one chunk's scan at a time.
No Pallas kernel stands behind it: the reference is plain ``jnp``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .layers import check_chunks, chunk_checkpoint, dense_init


def mamba_init(gen: Optional[torch.Generator], cfg, dtype: torch.dtype = torch.float32,
               device=None, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """The reference's parameters, each shape prefixed by ``lead`` (the
    stack's group axis); ``dt_bias``, ``A_log`` and ``D`` are fp32 and
    deterministic."""
    d, di, ds, dtr, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    f32 = dict(dtype=torch.float32, device=device)
    A = torch.arange(1, ds + 1, **f32).expand(lead + (di, ds))
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di), dtype=dtype, device=device),
        "conv_w": dense_init(gen, lead + (dc, di), dtype=dtype, device=device),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, lead + (di, dtr + 2 * ds), dtype=dtype, device=device),
        "dt_proj": dense_init(gen, lead + (dtr, di), dtype=dtype, device=device),
        "dt_bias": torch.full(lead + (di,), math.log(math.expm1(0.01)), **f32),
        "A_log": torch.log(A),
        "D": torch.ones(lead + (di,), **f32),
        "out_proj": dense_init(gen, lead + (di, d), dtype=dtype, device=device),
    }


def _along(dim: int, s: slice) -> tuple:
    return (slice(None),) * dim + (s,)


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int
                     ) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of ``fn`` along ``dim`` in ``jax.lax.associative_scan``'s
    order: ``fn(a, b)`` combines tuples of tensors, ``a`` the earlier."""
    n = elems[0].shape[dim]
    if n < 2:
        return tuple(elems)
    reduced = fn(tuple(e[_along(dim, slice(0, n - 1, 2))] for e in elems),
                 tuple(e[_along(dim, slice(1, None, 2))] for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        m = odd[0].shape[dim]
        even = fn(tuple(e[_along(dim, slice(0, m - 1))] for e in odd),
                  tuple(e[_along(dim, slice(2, None, 2))] for e in elems))
    else:
        even = fn(odd, tuple(e[_along(dim, slice(2, None, 2))] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[_along(dim, slice(0, 1))] = e[_along(dim, slice(0, 1))]
        r[_along(dim, slice(2, None, 2))] = ev
        r[_along(dim, slice(1, None, 2))] = od
        out.append(r)
    return tuple(out)


def _combine(a, b):
    a_a, b_a = a
    a_b, b_b = b
    return a_a * a_b, b_a * a_b + b_b


def _causal_conv_chunk(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over a chunk.  x: (B, C, di); conv_state:
    (B, dc - 1, di).  Returns the output and the new state."""
    dc, C = w.shape[0], x.shape[1]
    full = torch.cat([conv_state, x], dim=1)                   # (B, C + dc - 1, di)
    out = full[:, 0:C] * w[0]
    for j in range(1, dc):
        out = out + full[:, j:j + C] * w[j]
    new_state = full[:, -(dc - 1):] if dc > 1 else conv_state
    return out + b, new_state


def _ssm_chunk(xc, dt, Bc, Cc, A, D, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan within one chunk.  xc, dt: (B, C, di); Bc, Cc:
    (B, C, ds); A: (di, ds); h0: (B, di, ds), all fp32.  Returns ``(y,
    h_last)``."""
    Ab = torch.exp(dt[..., None] * A)                          # (B, C, di, ds)
    Bx = (dt * xc)[..., None] * Bc[:, :, None, :]              # (B, C, di, ds)
    cumA, h_local = associative_scan(_combine, (Ab, Bx), dim=1)
    del Ab, Bx
    h = h_local + cumA * h0[:, None]
    del cumA, h_local
    y = torch.einsum("bcds,bcs->bcd", h, Cc) + D * xc
    return y, h[:, -1]


def _chunk_step(params, cfg, A: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
                h: torch.Tensor, conv: torch.Tensor):
    """One chunk of the prefill: the conv over the carried ``conv``, SiLU,
    ``x_proj``, ``dt``, the scan from ``h`` and the gate.  Returns ``(y,
    h, conv)``."""
    ds, dtr = cfg.d_state, cfg.dt_rank
    xc, conv = _causal_conv_chunk(xs, conv, params["conv_w"], params["conv_b"])
    xc = F.silu(xc)
    dt_r, Bc, Cc = (xc @ params["x_proj"]).split([dtr, ds, ds], dim=-1)
    dt = F.softplus((dt_r @ params["dt_proj"]).float() + params["dt_bias"])
    y, h = _ssm_chunk(xc.float(), dt, Bc.float(), Cc.float(), A, params["D"], h)
    return y.to(xs.dtype) * F.silu(z), h, conv


def mamba_apply(params, x: torch.Tensor, cfg, chunk: int = 128
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence mixer.  x: (B, S, d) -> ``((B, S, d), {"h", "conv"})``,
    the final state for the cache.  Where autograd records, each chunk is
    checkpointed unless ``cfg.remat == "none"``."""
    B, S, _ = x.shape
    di, ds = cfg.d_inner, cfg.d_state
    xs, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    chunk = min(chunk, S)
    check_chunks(S, chunk)
    A = -torch.exp(params["A_log"])
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    conv = torch.zeros((B, cfg.d_conv - 1, di), dtype=x.dtype, device=x.device)
    run = chunk_checkpoint(_chunk_step, cfg, x, params)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        y, h, conv = run(params, cfg, A, xs[:, sl], z[:, sl], h, conv)
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y @ params["out_proj"], {"h": h, "conv": conv}


def mamba_decode_step(params, x: torch.Tensor, cfg, cache: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
    """One-token recurrent step.  x: (B, 1, d) -> (B, 1, d); ``cache["h"]``
    and ``cache["conv"]`` are written in place."""
    ds, dtr = cfg.d_state, cfg.dt_rank
    dt_ = x.dtype
    xs, z = (x[:, 0] @ params["in_proj"]).chunk(2, dim=-1)    # (B, di) each
    full = torch.cat([cache["conv"], xs[:, None]], dim=1)      # (B, dc, di)
    xc = F.silu((full * params["conv_w"]).sum(dim=1) + params["conv_b"])
    cache["conv"].copy_(full[:, 1:])
    dt_r, Bc, Cc = (xc @ params["x_proj"]).split([dtr, ds, ds], dim=-1)
    dt = F.softplus((dt_r @ params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xf = xc.float()
    h = cache["h"].mul_(torch.exp(dt[..., None] * A)).add_(
        (dt * xf)[..., None] * Bc.float()[:, None, :])
    y = torch.einsum("bds,bs->bd", h, Cc.float()) + params["D"] * xf
    y = y.to(dt_) * F.silu(z)
    return (y @ params["out_proj"])[:, None]
