"""Carry state across from numpy (and so from the JAX package), both ways.

Redundancy state travels as ``{name: {field: np.uint32 array}}``; the port
holds the same bits as int32 tensors.  Leaves travel as numpy arrays of
their own dtype (bfloat16 through ``ml_dtypes``, which numpy needs for it).
Nested dicts of leaves are converted leaf by leaf.  Tensors land on the
GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..common.device import DeviceLike, resolve_device
from .state import FIELDS, LeafRedundancy, RedundancyState


def _field(r: Any, f: str):
    return r[f] if isinstance(r, Mapping) else getattr(r, f)


def red_from_numpy(red: Mapping[str, Any],
                   device: DeviceLike = None) -> RedundancyState:
    """``{name: {field: uint32 array}}`` (or objects with those attributes)
    -> port ``LeafRedundancy`` per leaf, int32 tensors on ``device``."""
    device = resolve_device(device, "red_from_numpy")
    out: RedundancyState = {}
    for name, r in red.items():
        out[name] = LeafRedundancy(**{
            f: torch.from_numpy(np.array(_field(r, f), dtype=np.uint32)
                                .view(np.int32)).to(device)
            for f in FIELDS})
    return out


def red_to_numpy(red: RedundancyState, store=None) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`red_from_numpy`: uint32 numpy arrays per field.

    Pass the ``store`` that owns ``red`` when an update may be in flight (on
    the card, right after a due tick): its checksums and parity are being
    refreshed in place on the store's side stream, and the copy is then
    ordered after that update (``store.await_inflight()``).  Without it
    the copy may mix old and new entries."""
    if store is not None:
        store.await_inflight()
    return {name: {f: getattr(r, f).detach().cpu().numpy().view(np.uint32)
                   for f in FIELDS}
            for name, r in red.items()}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")          # a copy; keeps 0-d shapes
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def leaves_from_numpy(tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """numpy leaves (nested dicts allowed) -> tensors on ``device``."""
    device = resolve_device(device, "leaves_from_numpy")
    return {k: leaves_from_numpy(v, device) if isinstance(v, Mapping)
            else _leaf_from_numpy(v, device) for k, v in tree.items()}


def leaves_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Tensors (nested dicts allowed) -> numpy arrays of the same dtype."""
    return {k: leaves_to_numpy(v) if isinstance(v, Mapping)
            else _leaf_to_numpy(v) for k, v in tree.items()}
