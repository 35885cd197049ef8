"""Meshes on one card.

The port of ``repro.launch.mesh``.  A :class:`Mesh` names the axes a
store shards its leaves over and their sizes; every shard lives on the
mesh's one device, and the kernels process every shard of a leaf in one
launch.  ``torch.distributed.DeviceMesh`` is not used: it needs a process
group per device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..common.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes over one device."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_mesh(shape, axes, device: DeviceLike = None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on one device (the card unless
    ``device="cpu"``)."""
    return Mesh(tuple(str(a) for a in axes), tuple(int(s) for s in shape),
                resolve_device(device, "make_mesh"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
