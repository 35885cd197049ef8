"""AdamW with global-norm clipping and row-sparse (lazy) updates, in place.

The port of ``repro.optim.adamw``, with its fields, defaults and
arithmetic.  Leaves named in ``row_masks`` (the embedding table, MoE
expert slabs) update only the rows or slabs the step touched: untouched
ones keep params, ``m`` and ``v`` bit-identical, so their blocks stay clean
for Vilamb (paper §3.2).  Moments are kept in ``moment_dtype``.

Unlike the reference's functional update, :meth:`AdamW.update` writes
params and moments in place, leaf by leaf, under ``torch.no_grad()``: a
second copy of a 3B model's params and fp32 moments (32 GB) does not fit
beside the first on an 80 GB card, and in place the protected leaves stay
the same tensors from step to step.  Each leaf is walked in slices along
as many leading axes as it takes for no fp32 temporary to exceed
:data:`SLICE_ELEMS` (one group of a full-width qwen3-moe expert leaf is
805 M elements), and a lazy mask of any leading rank is cut with the same
slices.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..common import flatten_dict, tree_map

# fp32 elements of one slice of a leaf's update temporaries (1 GiB).
SLICE_ELEMS = 1 << 28


def _slices(leaf: torch.Tensor):
    """Indices of slices of ``leaf`` of at most SLICE_ELEMS elements (or one
    innermost row, if that is larger): tuples of a slice per leading axis,
    the last of several indices and the ones before it of one, in
    ``leaf``'s order.  ``...``, the whole leaf, for a 0-d or small one."""
    if leaf.dim() == 0 or leaf.numel() <= SLICE_ELEMS:
        return [...]
    inner, axis = leaf.numel(), 0
    while True:
        inner //= leaf.shape[axis]
        if inner <= SLICE_ELEMS or axis == leaf.dim() - 1:
            break
        axis += 1
    step = max(1, SLICE_ELEMS // inner)
    out = []
    for outer in itertools.product(*(range(n) for n in leaf.shape[:axis])):
        head = tuple(slice(i, i + 1) for i in outer)
        out += [head + (slice(i, i + step),) for i in range(0, leaf.shape[axis], step)]
    return out


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params) -> Dict[str, Any]:
        """Zero moments of every leaf's shape, on its device, in
        ``moment_dtype``; ``count`` 0.  Empty subtrees are kept."""
        dtype = getattr(torch, self.moment_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "count": 0}

    def update(self, grads, opt_state: Dict[str, Any], params,
               row_masks: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """One step, in place on ``params`` and ``opt_state`` (``count``
        included); returns the global grad norm (a 0-d fp32 tensor on the
        params' device).  ``row_masks`` maps flat param paths to bool masks
        over a leaf's leading axis.  Never waits for the device: the
        learning rate and the bias corrections are host float32 values."""
        row_masks = dict(row_masks or {})
        count = opt_state["count"] + 1
        lr = self.lr(count)
        # float32 ``1 - b ** count``, the power rounded once from float64.
        f32 = np.float32
        bc1 = float(f32(1) - f32(float(f32(self.b1)) ** count))
        bc2 = float(f32(1) - f32(float(f32(self.b2)) ** count))
        flat_g = flatten_dict(grads)
        flat_p = flatten_dict(params)
        flat_m = flatten_dict(opt_state["m"])
        flat_v = flatten_dict(opt_state["v"])
        mdtype = getattr(torch, self.moment_dtype)
        with torch.no_grad():
            sq = sum(torch.square(g[sl].float()).sum()
                     for g in flat_g.values() for sl in _slices(g))
            gnorm = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
            clip = torch.full_like(gnorm, self.clip_norm)    # a fill, no host copy
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            for name, p in flat_p.items():
                decay = self.weight_decay if p.dim() >= 2 else 0.0
                mask = row_masks.get(name)
                for sl in _slices(p):
                    g = flat_g[name][sl].float() * scale
                    m0 = flat_m[name][sl].float()
                    v0 = flat_v[name][sl].float()
                    m1 = self.b1 * m0 + (1 - self.b1) * g
                    v1 = self.b2 * v0 + (1 - self.b2) * torch.square(g)
                    step = (m1 / bc1) / (torch.sqrt(v1 / bc2) + self.eps)
                    p0 = p[sl].float()
                    p1 = p0 - lr * (step + decay * p0)
                    if mask is not None:
                        ms = mask[sl if sl is ... else sl[:mask.dim()]]
                        mb = ms.reshape(ms.shape + (1,) * (p.dim() - mask.dim()))
                        p1 = torch.where(mb, p1, p0)
                        m1 = torch.where(mb, m1, m0)
                        v1 = torch.where(mb, v1, v0)
                    p[sl] = p1.to(p.dtype)
                    flat_m[name][sl] = m1.to(mdtype)
                    flat_v[name][sl] = v1.to(mdtype)
        opt_state["count"] = count
        return gnorm
