"""Per-leaf PartitionSpec rules for params and decode caches.

The port of ``repro.dist.sharding``: the same rules, the same
divisibility guard and the same log lines.  The model stack is
scan-stacked (leading dim = layers-per-slot), so specs never shard dim 0.
Rules are basename-driven and divisibility-guarded: an axis is only
assigned where it divides the dim, otherwise it is dropped and the
fallback is logged.

Conventions:
  * TP (``model`` axis): attention heads, FFN hidden, MoE experts,
    mamba d_inner, vocab (embed table rows).
  * FSDP (``data`` or ``("pod","data")``): the remaining large matrix dim.
  * Batch (``pod``+``data``): the batch dim of KV/recurrent caches.

On one card the specs decide how a store shards a leaf's redundancy
(``ProtectedStore.attach(tree, specs=)``); every shard lives on that card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..models.parallel import ParallelCtx
from .spec import PartitionSpec as P


def _size(ctx: ParallelCtx, axis) -> int:
    return ctx.axis_size(axis)


def _fits(ctx: ParallelCtx, dim: int, axis) -> bool:
    return axis is not None and dim % max(_size(ctx, axis), 1) == 0


def _guard(ctx: ParallelCtx, name: str, shape, spec: List, log: List[str]):
    """Drop any axis that does not divide its dim; log the fallback."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or _fits(ctx, shape[i], ax):
            out.append(ax)
        else:
            log.append(f"replicated dim {i} of {name} {tuple(shape)}: "
                       f"{ax} does not divide {shape[i]}")
            out.append(None)
    return P(*out)


def param_specs(flat: Dict, ctx: ParallelCtx) -> Tuple[Dict[str, P], List[str]]:
    """PartitionSpecs for a flat (path -> anything with ``.shape``) param dict."""
    log: List[str] = []
    if ctx.mesh is None:
        return {k: P() for k in flat}, log
    tp, fs = ctx.tp_axis, ctx.fsdp_axis
    specs: Dict[str, P] = {}
    for name, v in flat.items():
        base = name.rsplit("/", 1)[-1]
        parent = name.rsplit("/", 2)[-2] if name.count("/") else ""
        nd = len(v.shape)
        spec: List = [None] * nd
        if base == "embed":
            spec = [tp, fs]                            # vocab over TP
        elif base == "head":
            spec = [fs, tp]
        elif parent == "moe":
            if base != "router":                       # router: replicated
                spec = [None, tp, fs, None][:nd]       # (L, E, D|F, F|D)
        elif parent == "attn":
            if base == "wo":                           # (L, H, hd, D)
                spec = [None, tp, None, fs][:nd]
            else:                                      # wq/wk/wv (L, D, H, hd)
                spec = [None, fs, tp, None][:nd]
        elif parent == "ffn":
            if base == "wo":                           # (L, F, D)
                spec = [None, tp, fs][:nd]
            else:                                      # wi/wg (L, D, F)
                spec = [None, fs, tp][:nd]
        elif parent == "mamba":
            if base == "in_proj":                      # (L, D, 2*di)
                spec = [None, fs, tp][:nd]
            elif base in ("out_proj", "x_proj"):       # (L, di, ...)
                spec = [None, tp, None][:nd]
            elif base == "A_log":                      # (L, di, d_state)
                spec = [None, tp, None][:nd]
            elif nd == 2:                              # D/conv_b/dt_bias (L, di)
                spec = [None, tp]
            elif nd == 3:                              # conv_w/dt_proj (L, k, di)
                spec = [None, None, tp]
        elif base == "scale" or nd <= 1:
            pass                                       # norms/bias: replicate
        elif nd >= 2:
            # Unknown matrix: FSDP its largest non-leading dim if it fits.
            big = max(range(1, nd), key=lambda i: v.shape[i])
            spec[big] = fs
        specs[name] = _guard(ctx, name, v.shape, spec, log)
    return specs, log


def cache_specs(cfg, flat: Dict, ctx: ParallelCtx,
                batch: int) -> Tuple[Dict[str, P], List[str]]:
    """PartitionSpecs for flat decode caches (KV pages, recurrent state).

    KV: (L, S, B, H, hd): batch over the data axes, heads over TP.
    Mamba: conv (L, B, k, di), h (L, B, di, d_state): batch + d_inner.
    Anything unrecognized shards its batch-sized dim only.
    """
    log: List[str] = []
    if ctx.mesh is None:
        return {k: P() for k in flat}, log
    tp = ctx.tp_axis
    dp: Optional[Tuple[str, ...]] = ctx.dp_axes or None
    specs: Dict[str, P] = {}
    for name, v in flat.items():
        base = name.rsplit("/", 1)[-1]
        nd = len(v.shape)
        spec: List = [None] * nd
        if base in ("k", "v") and nd == 5:             # (L, S, B, H, hd)
            spec = [None, None, dp, tp, None]
        elif base == "conv" and nd == 4:               # (L, B, k, di)
            spec = [None, dp, None, tp]
        elif base == "h" and nd == 4:                  # (L, B, di, d_state)
            spec = [None, dp, tp, None]
        else:
            for i, d in enumerate(v.shape):
                if d == batch:
                    spec[i] = dp
                    break
        specs[name] = _guard(ctx, name, v.shape, spec, log)
    return specs, log
