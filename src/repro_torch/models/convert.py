"""Carry a model's parameters across from numpy (and so from the JAX package).

``params_from_numpy`` turns the reference's parameter tree, as numpy arrays
(bf16 through ``ml_dtypes``), into the port's tensors, bit for bit, and
checks every name, shape and dtype against the port's own ``Model.init``.
``params_to_numpy`` is the inverse.
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


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """numpy parameter tree -> tensors on ``device`` (the card by default).

    Raises ``ValueError`` naming every leaf that is missing, extra, or of
    another shape or dtype than ``Model(cfg).init`` makes.
    """
    device = resolve_device(device, "params_from_numpy")
    want = {n: (tuple(t.shape), t.dtype) for n, t in
            flatten_dict(Model(cfg, torch.device("meta")).init()).items()}
    got = {n: (tuple(np.shape(a)), np.asarray(a).dtype.name)
           for n, a in flatten_dict(dict(tree)).items()}
    errors = [f"missing {n}" for n in sorted(set(want) - set(got))]
    errors += [f"unexpected {n}" for n in sorted(set(got) - set(want))]
    for n in sorted(set(want) & set(got)):
        shape, dtype = want[n]
        if got[n] != (shape, str(dtype).removeprefix("torch.")):
            errors.append(f"{n}: {got[n][1]} {got[n][0]}, want "
                          f"{str(dtype).removeprefix('torch.')} {shape}")
    if errors:
        raise ValueError(f"parameters do not fit {cfg.name}: " + "; ".join(errors))
    return leaves_from_numpy(tree, device)


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Tensors -> numpy arrays of the same dtype (bf16 through ``ml_dtypes``)."""
    return leaves_to_numpy(params)
