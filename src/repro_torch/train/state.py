"""Training state and the protected-leaf view the redundancy store covers."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..common import flatten_dict, replace_leaves
from ..core.blocks import ShapeDtype


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any          # {"m": tree, "v": tree, "count": int}
    red: Any          # RedundancyState (flat path -> LeafRedundancy), may be {}
    step: int = 0

    @staticmethod
    def create(params, opt_state, red=None) -> "TrainState":
        return TrainState(params=params, opt=opt_state, red=red or {}, step=0)


def protected_leaves(params, opt_state) -> Dict[str, torch.Tensor]:
    """The long-lived device state Vilamb covers: params and both Adam
    moments, as ``params/...``, ``m/...`` and ``v/...`` paths (the step and
    ``count`` are checkpoint metadata)."""
    out = {}
    for prefix, tree in (("params", params), ("m", opt_state["m"]),
                         ("v", opt_state["v"])):
        for k, v in flatten_dict(tree).items():
            out[f"{prefix}/{k}"] = v
    return out


def protected_structs(params, opt_state) -> Dict[str, ShapeDtype]:
    """Shape and dtype of every protected leaf: enough for
    ``ProtectedStore.attach``.  Build ``params`` and ``opt_state`` on the
    ``meta`` device (``Model.init`` and ``AdamW.init`` there draw nothing),
    where the reference uses ``jax.eval_shape``."""
    return {k: ShapeDtype(tuple(v.shape), v.dtype)
            for k, v in protected_leaves(params, opt_state).items()}


def replace_protected(state: TrainState, leaves: Dict[str, Any]) -> TrainState:
    """Inverse of :func:`protected_leaves`: fold repaired or restored flat
    leaves back into a TrainState (``count`` untouched, empty subtrees
    kept)."""
    def sub(prefix):
        return {k[len(prefix) + 1:]: v for k, v in leaves.items()
                if k.startswith(prefix + "/")}
    opt = dict(state.opt, m=replace_leaves(state.opt["m"], sub("m")),
               v=replace_leaves(state.opt["v"], sub("v")))
    return dataclasses.replace(
        state, params=replace_leaves(state.params, sub("params")), opt=opt)
