"""Mixture-of-Experts FFN: the port of ``repro.models.moe``, local path.

Routing is the reference's (``moe.py:61-76``): the router's logits as a
product in x's dtype, cast to fp32; an fp32 softmax; the top k with the
lower expert index first among equal probabilities (``lax.top_k``'s order,
taken here from a stable descending sort: ``torch.topk`` promises no order
for ties, and bf16 logits tie often); the gates renormalised.  Dispatch is
the reference's sorted fixed-capacity one: the T·K choices sorted stably
by expert, and each expert's window of ``cap`` sorted entries from the
start of its segment, that start clamped to ``[0, T·K - cap]`` as
``dynamic_slice_in_dim`` clamps it, with other experts' entries and those
past capacity masked.  ``counts`` counts all T·K choices, dropped ones
included.

Where the reference loops over experts, the port runs every window at
once: x's rows are gathered for a chunk of experts at a time (at most
:data:`CHUNK_ELEMS` elements of x a chunk) and each chunk's products are
batched matrix products.  The combine adds each token's K contributions in
fp32, one at a time, in ascending expert order, which is the order in
which the reference's per-expert ``.at[tok].add`` reaches them.  Every
gather is ``F.embedding`` or an integer index, whose backward is
deterministic, and nothing is added with atomics, so a training step is
bit for bit repeatable on the card.  The reference's ``shard_map`` expert
parallelism (``moe.py:128-164``) is ROADMAP.md, Queue 1 item 11 (expert
parallelism).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init

# Elements of one chunk: of x's gathered rows in ``moe_apply``, of an fp32
# draw in ``moe_init`` (1 GiB of fp32).
CHUNK_ELEMS = 1 << 28


def _slabs_init(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
                device) -> torch.Tensor:
    """``dense_init`` (fan-in ``shape[-2]``) of a stack of expert slabs,
    drawn a few slabs at a time: no fp32 copy of the whole stack exists
    (a 12-layer qwen3-moe ``wi`` is 9.7 G elements).  On the ``meta``
    device nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    slabs = out.view(-1, shape[-2], shape[-1])
    step = max(1, CHUNK_ELEMS // (shape[-2] * shape[-1]))
    for i in range(0, slabs.shape[0], step):
        part = slabs[i:i + step]
        part.copy_(dense_init(gen, tuple(part.shape), device=device))
    return out


def moe_init(gen: Optional[torch.Generator], cfg, dtype: torch.dtype, device=None,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """The router fp32 ``(d, E)``; ``wi`` (and ``wg`` for swiglu) ``(E, d,
    ff)`` and ``wo`` ``(E, ff, d)`` in ``dtype``; ``lead`` prefixes every
    shape (the stack's group axis)."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    p = {"router": dense_init(gen, lead + (d, E), device=device),
         "wi": _slabs_init(gen, lead + (E, d, ff), dtype, device)}
    if cfg.activation == "swiglu":
        p["wg"] = _slabs_init(gen, lead + (E, d, ff), dtype, device)
    p["wo"] = _slabs_init(gen, lead + (E, ff, d), dtype, device)
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Entries each expert keeps: ``ceil(T·K / E · capacity_factor)``, at
    least 1 and at most T·K (``moe.py:61``)."""
    tk = n_tokens * cfg.top_k
    return max(1, min(tk, int(math.ceil(tk / cfg.n_experts * cfg.capacity_factor))))


def _pick(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``vals[t, ids[t, k]]`` as a masked sum over ``vals``' columns: one
    nonzero term, so exact, and a backward with no scatter."""
    cols = torch.arange(vals.shape[-1], device=vals.device)
    return (vals[:, None, :] * (ids[..., None] == cols)).sum(-1)


def route(params, x2d: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(probs (T, E) fp32, gates (T, K) fp32, ids (T, K) int64)``, the
    reference's routing (``moe.py:63-66``)."""
    logits = (x2d @ params["router"].to(x2d.dtype)).float()
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = u / u.sum(dim=-1, keepdim=True)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
    top = _pick(probs, ids)
    return probs, top / top.sum(dim=-1, keepdim=True), ids


def _expert_ffn(x: torch.Tensor, wi, wg, wo, activation: str) -> torch.Tensor:
    """Batched over a chunk of experts: x (c, cap, d), weights (c, d, ff)
    and (c, ff, d)."""
    if activation == "swiglu":
        h = F.silu(x @ wg) * (x @ wi)
    elif activation == "squared_relu":
        h = torch.square(F.relu(x @ wi))
    else:                                     # gelu (jax.nn.gelu's tanh form)
        h = F.gelu(x @ wi, approximate="tanh")
    return h @ wo


def moe_apply(params, x2d: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoE FFN over flat tokens (T, d): ``(out (T, d) in x's dtype, counts
    (E,) int32, aux_loss fp32)``."""
    T, d = x2d.shape
    E, K = cfg.n_experts, cfg.top_k
    n, cap = T * K, capacity(T, cfg)
    dev, dt = x2d.device, x2d.dtype
    probs, gates, ids = route(params, x2d, cfg)

    # The sorted dispatch: entry j of the sorted list is choice order[j] of
    # token order[j] // K, at position pos[j] of its expert's segment.
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(E, device=dev)
    starts = torch.searchsorted(se, experts)
    counts = (torch.searchsorted(se, experts, right=True) - starts).to(torch.int32)
    pos = torch.arange(n, device=dev) - torch.searchsorted(se, se)
    win = starts.clamp(max=n - cap)                       # (E,)
    idx = win[:, None] + torch.arange(cap, device=dev)    # (E, cap) sorted entries
    keep = (se[idx] == experts[:, None]) & (pos[idx] < cap)
    tok = order[idx] // K

    # Every expert's window, a chunk of experts at a time.
    w = {k: params[k].to(dt) for k in ("wi", "wg", "wo") if k in params}
    step = max(1, CHUNK_ELEMS // (cap * d))
    ys = []
    for e0 in range(0, E, step):
        sl = slice(e0, min(E, e0 + step))
        xe = F.embedding(tok[sl], x2d) * keep[sl, :, None].to(dt)
        ys.append(_expert_ffn(xe, w["wi"][sl], w["wg"][sl] if "wg" in w else None,
                              w["wo"][sl], cfg.activation))
    ye = (ys[0] if len(ys) == 1 else torch.cat(ys)).reshape(E * cap, d)

    # The combine: token t's choices in ascending expert order, each its
    # window row's output times its gate, added in fp32.  A dropped choice
    # adds an exact 0, as the reference's zeroed window row does, whatever
    # the row it gathers holds (inf or NaN included).
    asc, perm = ids.sort(dim=-1)                          # distinct ids: no ties
    j = torch.argsort(order)[torch.arange(T, device=dev)[:, None] * K + perm]
    kept = pos[j] < cap
    rows = torch.where(kept, asc * cap + j - win[asc], 0)
    g_asc = _pick(gates, perm)
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for k in range(K):
        y = F.embedding(rows[:, k], ye).float() * g_asc[:, k, None]
        out = out + y.masked_fill_(~kept[:, k, None], 0.0)

    aux_loss = E * torch.sum(probs.mean(dim=0) * (counts.float() / max(n, 1)))
    return out.to(dt), counts, aux_loss
