"""Carry a model's parameters and optimizer state across from numpy (and so
from the JAX package).

``params_from_numpy`` turns the reference's parameter tree, as numpy arrays
(bf16 through ``ml_dtypes``), into the port's tensors, bit for bit, and
checks every name, shape and dtype against the port's own ``Model.init``.
``opt_from_numpy`` does the same for AdamW's state (``m`` and ``v`` in the
config's ``moment_dtype``, and ``count``).  ``params_to_numpy`` is the
inverse of the first.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..common import flatten_dict
from ..common.device import DeviceLike, resolve_device
from ..core.convert import leaves_from_numpy, leaves_to_numpy
from .config import ModelConfig
from .model import Model


def _check_fits(tree: Mapping[str, Any], cfg: ModelConfig, dtype, what: str) -> None:
    """Raise ``ValueError`` naming every leaf of ``tree`` that is missing,
    extra, or of another shape or dtype than ``Model(cfg).init`` makes
    (every leaf in ``dtype`` when given)."""
    want = {n: (tuple(t.shape), dtype or t.dtype) for n, t in
            flatten_dict(Model(cfg, torch.device("meta")).init()).items()}
    got = {n: (tuple(np.shape(a)), np.asarray(a).dtype.name)
           for n, a in flatten_dict(dict(tree)).items()}
    errors = [f"missing {n}" for n in sorted(set(want) - set(got))]
    errors += [f"unexpected {n}" for n in sorted(set(got) - set(want))]
    for n in sorted(set(want) & set(got)):
        shape, dt = want[n]
        name = str(dt).removeprefix("torch.")
        if got[n] != (shape, name):
            errors.append(f"{n}: {got[n][1]} {got[n][0]}, want {name} {shape}")
    if errors:
        raise ValueError(f"{what} do not fit {cfg.name}: " + "; ".join(errors))


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """numpy parameter tree -> tensors on ``device`` (the card by default).

    Raises ``ValueError`` naming every leaf that is missing, extra, or of
    another shape or dtype than ``Model(cfg).init`` makes.
    """
    device = resolve_device(device, "params_from_numpy")
    _check_fits(tree, cfg, None, "parameters")
    return leaves_from_numpy(tree, device)


def opt_from_numpy(opt_state: Mapping[str, Any], cfg: ModelConfig,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's AdamW state ``{"m", "v", "count"}`` as numpy ->
    the port's, moments on ``device`` (the card by default) and ``count``
    a Python int.  ``m`` and ``v`` must have the params' names and shapes
    in ``cfg.moment_dtype``."""
    device = resolve_device(device, "opt_from_numpy")
    mdtype = getattr(torch, cfg.moment_dtype)
    for k in ("m", "v"):
        _check_fits(opt_state[k], cfg, mdtype, f"Adam moments {k!r}")
    return {"m": leaves_from_numpy(opt_state["m"], device),
            "v": leaves_from_numpy(opt_state["v"], device),
            "count": int(np.asarray(opt_state["count"]))}


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Tensors -> numpy arrays of the same dtype (bf16 through ``ml_dtypes``)."""
    return leaves_to_numpy(params)
