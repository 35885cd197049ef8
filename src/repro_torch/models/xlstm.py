"""xLSTM mixers: mLSTM (matrix memory, chunkwise-parallel) and sLSTM.

The port of ``repro.models.xlstm``, with the reference's numerics: input
gates are sigmoids, so every decay and gate term lies in (0, 1) and the
chunkwise form needs no running-max stabiliser.  The mLSTM prefill walks
chunks of 256 (an intra-chunk masked quadratic term plus the carried
``(C, n)`` state); the sLSTM prefill is the strictly sequential cell, one
position at a time.  Decode is the O(1) recurrent step, written into the
caches in place.  In training each chunk runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of its
scan step does, carrying the state in and out.  The normaliser is
``torch.maximum(|n|, 1)``, whose gradient splits at a tie as
``jnp.maximum``'s does.  One difference from the reference, in the
gradient only: the mLSTM's relative decay ``b_q - b_k`` is zeroed on the
masked half (keys after the query) before ``exp``.  The reference
exponentiates it there too and masks after, so where it overflows (small
forget gates across a chunk, which full-size training reaches within a
few steps) its gradient is ``0 * inf``, NaN.  The forward, and every
gradient the reference computes finitely, are the same bits either way
(``ROADMAP.md`` Queue 3).  No Pallas kernel stands behind these mixers:
the reference is plain ``jnp`` with ``lax.scan``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .layers import check_chunks, chunk_checkpoint, dense_init


def mlstm_init(gen: Optional[torch.Generator], cfg, dtype: torch.dtype = torch.float32,
               device=None, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """The reference's parameters, each shape prefixed by ``lead``; the gate
    projections ``wi``, ``wf`` and ``f_bias`` are fp32."""
    d, H = cfg.d_model, cfg.n_heads

    def w(shape, dt=dtype):
        return dense_init(gen, lead + shape, dtype=dt, device=device)

    return {
        "wq": w((d, d)), "wk": w((d, d)), "wv": w((d, d)),
        "wi": w((d, H), torch.float32), "wf": w((d, H), torch.float32),
        "f_bias": torch.full(lead + (H,), 3.0, dtype=torch.float32, device=device),
        "wo": w((d, d)), "wout": w((d, d)),
    }


slstm_init = mlstm_init  # the same parameter family (the scalar-memory variant)


def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as ``jnp.float32(v).astype(dtype)`` is."""
    return torch.tensor(v, dtype=torch.float32).to(dtype).item()


def _gates(params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 input, forget and output gates of ``x`` (..., d)."""
    dt_ = x.dtype
    i = torch.sigmoid((x @ params["wi"].to(dt_)).float())
    f = torch.sigmoid((x @ params["wf"].to(dt_)).float() + params["f_bias"])
    o = torch.sigmoid((x @ params["wo"]).float())
    return i, f, o


def _normaliser(nq: torch.Tensor) -> torch.Tensor:
    """``max(nq, 1)``; at a tie the gradient splits in halves, as the
    reference's ``jnp.maximum``'s does (``clamp_min`` would pass it whole)."""
    return torch.maximum(nq, nq.new_ones(()))


def _mlstm_chunk(causal: torch.Tensor, q, k, v, ic, fc, oc, C, n):
    """One chunk: q, k, v (B, T, H, hd) in the model's dtype, the fp32
    gates ic, fc (B, T, H) and oc (B, T, d), from the carried fp32 ``(C,
    n)``.  Returns ``(h (B, T, d) in q's dtype, C, n)``."""
    B, T, H, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    b = torch.cumsum(torch.log(fc + 1e-12), dim=1)            # (B, T, H) log decay
    # inter-chunk: the decayed carried state, read by the queries
    qd = qf * torch.exp(b)[..., None]
    h_inter = torch.einsum("bchd,bhde->bche", qd, C)
    n_inter = torch.einsum("bchd,bhd->bch", qd, n)
    # intra-chunk: masked quadratic with relative decay; the masked half's
    # exponent is zeroed before exp (see the module docstring)
    rel = torch.where(causal, b[:, :, None] - b[:, None, :], 0.0)
    gate = torch.where(causal, torch.exp(rel) * ic[:, None], 0.0)
    scores = torch.einsum("bchd,bkhd->bckh", qf, kf) * gate
    h_intra = torch.einsum("bckh,bkhd->bchd", scores, vf)
    n_intra = scores.sum(dim=2)
    # normaliser max(|n q|, 1)
    h = h_inter + h_intra
    h = h / _normaliser(torch.abs(n_inter + n_intra))[..., None]
    h = (h.reshape(B, T, H * hd) * oc).to(q.dtype)
    # state: C1 = exp(b_T) C0 + sum_s exp(b_T - b_s) i_s k_s v_s^T
    kw = kf * (torch.exp(b[:, -1:] - b) * ic)[..., None]
    last = torch.exp(b[:, -1])
    C = last[..., None, None] * C + torch.einsum("bchd,bche->bhde", kw, vf)
    n = last[..., None] * n + kw.sum(dim=1)
    return h, C, n


def mlstm_apply(params, x: torch.Tensor, cfg, chunk: int = 256
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunkwise-parallel mLSTM.  x: (B, S, d) -> ``((B, S, d), {"C", "n"})``.
    Where autograd records, each chunk is checkpointed unless
    ``cfg.remat == "none"``."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    q = (x @ params["wq"]).view(B, S, H, hd)
    k = (x @ params["wk"]).view(B, S, H, hd) / _rounded(math.sqrt(hd), x.dtype)
    v = (x @ params["wv"]).view(B, S, H, hd)
    i, f, o = _gates(params, x)
    chunk = min(chunk, S)
    check_chunks(S, chunk)
    ar = torch.arange(chunk, device=x.device)
    causal = (ar[:, None] >= ar[None, :])[None, :, :, None]
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    run = chunk_checkpoint(_mlstm_chunk, cfg, x, params)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, C, n = run(causal, q[:, sl], k[:, sl], v[:, sl], i[:, sl], f[:, sl], o[:, sl],
                      C, n)
        hs.append(h)
    h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    return h @ params["wout"], {"C": C, "n": n}


def mlstm_decode_step(params, x: torch.Tensor, cfg, cache: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
    """O(1) recurrent step.  x: (B, 1, d) -> (B, 1, d); ``cache["C"]`` and
    ``cache["n"]`` are written in place."""
    B, _, d = x.shape
    H = cfg.n_heads
    hd = d // H
    xt = x[:, 0]
    q = (xt @ params["wq"]).view(B, H, hd).float()
    k = (xt @ params["wk"]).view(B, H, hd).float() / _rounded(math.sqrt(hd), torch.float32)
    v = (xt @ params["wv"]).view(B, H, hd).float()
    i, f, o = _gates(params, xt)
    C = cache["C"].mul_(f[..., None, None]).add_(
        i[..., None, None] * k[..., :, None] * v[..., None, :])
    n = cache["n"].mul_(f[..., None]).add_(i[..., None] * k)
    h = torch.einsum("bhd,bhde->bhe", q, C)
    nq = torch.abs(torch.einsum("bhd,bhd->bh", q, n))
    h = (h / torch.clamp_min(nq, 1.0)[..., None]).reshape(B, d) * o
    return (h.to(x.dtype) @ params["wout"])[:, None]


# --------------------------------------------------------------------- sLSTM
def _slstm_inputs(params, x: torch.Tensor, H: int):
    """The cell input ``z`` (..., H, hd) and the fp32 gates of ``x``."""
    z = torch.tanh((x @ params["wq"]).float())
    z = z.view(*z.shape[:-1], H, z.shape[-1] // H)
    return (z, *_gates(params, x))


class _SlstmScan(torch.autograd.Function):
    """The sequential cell over one chunk, ``c_t = f_t c_{t-1} + i_t z_t``:
    ``z`` (B, T, H, hd + 1), the cell input with a last column of ones, so
    that the last column of ``c`` is the normaliser ``n = f n + i`` (``i *
    1`` is ``i``); ``i`` and ``f`` (B, T, H, 1) fp32; ``c0`` (B, H, hd + 1).
    Returns every ``c_t`` (B, T, H, hd + 1).

    The forward forms the products ``i z`` in one pass, then two kernels a
    position (``f c``, then ``+ i z``): each product and the sum round on
    their own, as ``f c + i z`` does op by op.  The backward is
    written out: the cotangent's reverse recurrence ``g_t = G_t + f_{t+1}
    g_{t+1}`` is one kernel a position, and the gradients of ``z``, ``i``,
    ``f`` and ``c0`` are whole-chunk products from it, so a position costs
    no autograd node."""

    @staticmethod
    def forward(ctx, z, i, f, c0):
        iz = i * z
        cs = torch.empty_like(iz)
        c = c0
        for ft, izt, ct in zip(f.unbind(1), iz.unbind(1), cs.unbind(1)):
            c = torch.mul(ft, c, out=ct).add_(izt)
        ctx.save_for_backward(z, i, f, c0, cs)
        return cs

    @staticmethod
    def backward(ctx, G):
        z, i, f, c0, cs = ctx.saved_tensors
        g = torch.empty_like(G)
        gs, Gs, fs = g.unbind(1), G.unbind(1), f.unbind(1)
        gs[-1].copy_(Gs[-1])
        for t in range(len(gs) - 2, -1, -1):
            torch.addcmul(Gs[t], fs[t + 1], gs[t + 1], out=gs[t])
        prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
        return (g * i, (g * z).sum(-1, keepdim=True), (g * prev).sum(-1, keepdim=True),
                f[:, 0] * g[:, 0])


def slstm_apply(params, x: torch.Tensor, cfg, chunk: int = 256
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar-memory sLSTM: the strictly sequential cell, chunk by chunk.
    x: (B, S, d) -> ``((B, S, d), {"c", "n"})``.  Where autograd records,
    each chunk is checkpointed unless ``cfg.remat == "none"``."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    z, i, f, o = _slstm_inputs(params, x, H)
    chunk = min(chunk, S)
    check_chunks(S, chunk)
    z = torch.cat([z, z.new_ones(z.shape[:-1] + (1,))], dim=-1)   # (B, S, H, hd + 1)
    i, f = i[..., None], f[..., None]
    c = torch.cat([torch.zeros((B, H, hd), dtype=torch.float32, device=x.device),
                   torch.full((B, H, 1), 1e-6, dtype=torch.float32, device=x.device)], dim=-1)
    run = chunk_checkpoint(_SlstmScan.apply, cfg, x, params)
    cs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        cs.append(run(z[:, sl], i[:, sl], f[:, sl], c))
        c = cs[-1][:, -1]
    cs = torch.cat(cs, dim=1) if len(cs) > 1 else cs[0]       # (B, S, H, hd + 1)
    h = cs[..., :hd] / _normaliser(torch.abs(cs[..., hd]))[..., None]
    h = h.reshape(B, S, d) * o
    return h.to(x.dtype) @ params["wout"], {"c": c[..., :hd], "n": c[..., hd]}


def slstm_decode_step(params, x: torch.Tensor, cfg, cache: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
    """One-token step.  x: (B, 1, d) -> (B, 1, d); ``cache["c"]`` and
    ``cache["n"]`` are written in place."""
    B, _, d = x.shape
    z, i, f, o = _slstm_inputs(params, x[:, 0], cfg.n_heads)
    c = cache["c"].mul_(f[..., None]).add_(i[..., None] * z)
    n = cache["n"].mul_(f).add_(i)
    h = c / torch.clamp_min(torch.abs(n), 1.0)[..., None]
    h = (h.reshape(B, d) * o).to(x.dtype)
    return (h @ params["wout"])[:, None]
