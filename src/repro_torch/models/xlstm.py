"""xLSTM mixers: mLSTM (matrix memory, chunkwise-parallel) and sLSTM.

The port of ``repro.models.xlstm``, with the reference's numerics: input
gates are sigmoids, so every decay and gate term lies in (0, 1) and the
chunkwise form needs no running-max stabiliser.  The mLSTM prefill walks
chunks of 256 (an intra-chunk masked quadratic term plus the carried
``(C, n)`` state); the sLSTM prefill is the strictly sequential cell, one
position at a time.  Decode is the O(1) recurrent step, written into the
caches in place.  The reference's per-chunk ``jax.checkpoint`` belongs
with training through these mixers, which the port does not run yet
(``models/transformer.py``).  No Pallas kernel stands behind them: the
reference is plain ``jnp`` with ``lax.scan``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .layers import check_chunks, dense_init


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


def mlstm_apply(params, x: torch.Tensor, cfg, chunk: int = 256
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunkwise-parallel mLSTM.  x: (B, S, d) -> ``((B, S, d), {"C", "n"})``."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    dt_ = x.dtype
    q = (x @ params["wq"]).view(B, S, H, hd)
    k = (x @ params["wk"]).view(B, S, H, hd) / _rounded(math.sqrt(hd), dt_)
    v = (x @ params["wv"]).view(B, S, H, hd)
    i, f, o = _gates(params, x)
    chunk = min(chunk, S)
    check_chunks(S, chunk)
    ar = torch.arange(chunk, device=x.device)
    causal = (ar[:, None] >= ar[None, :])[None, :, :, None]
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ic, fc = i[:, sl], f[:, sl]
        b = torch.cumsum(torch.log(fc + 1e-12), dim=1)        # (B, C, H) log decay
        # inter-chunk: the decayed carried state, read by the queries
        qd = qf * torch.exp(b)[..., None]
        h_inter = torch.einsum("bchd,bhde->bche", qd, C)
        n_inter = torch.einsum("bchd,bhd->bch", qd, n)
        # intra-chunk: masked quadratic with relative decay
        gate = torch.exp(b[:, :, None] - b[:, None, :]) * ic[:, None]
        gate = torch.where(causal, gate, 0.0)
        scores = torch.einsum("bchd,bkhd->bckh", qf, kf) * gate
        h_intra = torch.einsum("bckh,bkhd->bchd", scores, vf)
        n_intra = scores.sum(dim=2)
        # normaliser max(|n q|, 1)
        h = h_inter + h_intra
        nq = torch.abs(n_inter + n_intra)
        h = h / torch.clamp_min(nq, 1.0)[..., None]
        hs.append((h.reshape(B, chunk, d) * o[:, sl]).to(dt_))
        # state: C1 = exp(b_T) C0 + sum_s exp(b_T - b_s) i_s k_s v_s^T
        kw = kf * (torch.exp(b[:, -1:] - b) * ic)[..., None]
        last = torch.exp(b[:, -1])
        C = last[..., None, None] * C + torch.einsum("bchd,bche->bhde", kw, vf)
        n = last[..., None] * n + kw.sum(dim=1)
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


def slstm_apply(params, x: torch.Tensor, cfg, chunk: int = 256
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar-memory sLSTM: the strictly sequential cell, chunk by chunk.
    x: (B, S, d) -> ``((B, S, d), {"c", "n"})``."""
    B, S, d = x.shape
    H = cfg.n_heads
    z, i, f, o = _slstm_inputs(params, x, H)
    chunk = min(chunk, S)
    check_chunks(S, chunk)
    c = torch.zeros((B, H, d // H), dtype=torch.float32, device=x.device)
    n = torch.full((B, H), 1e-6, dtype=torch.float32, device=x.device)
    cs, ns = [], []
    for c0 in range(0, S, chunk):
        for t in range(c0, c0 + chunk):
            ft, it = f[:, t], i[:, t]
            c = ft[..., None] * c + it[..., None] * z[:, t]
            n = ft * n + it
            cs.append(c)
            ns.append(n)
    cs, ns = torch.stack(cs, dim=1), torch.stack(ns, dim=1)   # (B, S, H, hd), (B, S, H)
    h = cs / torch.clamp_min(torch.abs(ns), 1.0)[..., None]
    h = h.reshape(B, S, d) * o
    return h.to(x.dtype) @ params["wout"], {"c": c, "n": n}


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
