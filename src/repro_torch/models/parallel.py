"""Parallelism context threaded through model code.

The port of ``repro.models.parallel``: the same axis resolution, so that
the sharding rules (:mod:`repro_torch.dist.sharding`) give the
reference's specs.  On one card there is no layout to pin, so
:meth:`ParallelCtx.constrain` returns its input.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Any] = None
    tp_axis: Optional[str] = "model"
    # str, or tuple for cross-pod FSDP (ZeRO over DCN: ("pod", "data")).
    fsdp_axis = "data"
    pod_axis: Optional[str] = "pod"

    def __init__(self, mesh=None, tp_axis="model", fsdp_axis="data", pod_axis="pod"):
        object.__setattr__(self, "mesh", mesh)
        if mesh is not None:
            names = mesh.axis_names
            tp_axis = tp_axis if tp_axis in names else None
            pod_axis = pod_axis if pod_axis in names else None
            if isinstance(fsdp_axis, tuple):
                fs = tuple(a for a in fsdp_axis if a in names)
                fsdp_axis = fs if len(fs) > 1 else (fs[0] if fs else None)
            else:
                fsdp_axis = fsdp_axis if fsdp_axis in names else None
        object.__setattr__(self, "tp_axis", tp_axis)
        object.__setattr__(self, "fsdp_axis", fsdp_axis)
        object.__setattr__(self, "pod_axis", pod_axis)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes the batch is sharded over."""
        axes = []
        if self.pod_axis:
            axes.append(self.pod_axis)
        fs = self.fsdp_axis if isinstance(self.fsdp_axis, tuple) else (
            (self.fsdp_axis,) if self.fsdp_axis else ())
        for a in fs:
            if a not in axes:
                axes.append(a)
        return tuple(axes)

    @property
    def batch_spec(self):
        return tuple(self.dp_axes) or None

    def axis_size(self, name) -> int:
        if self.mesh is None or name is None:
            return 1
        if isinstance(name, tuple):
            out = 1
            for a in name:
                out *= self.mesh.shape[a]
            return out
        return self.mesh.shape[name]

    def constrain(self, x, *spec):
        """The reference's sharding hint; one card has no layout to pin."""
        return x

    def divides(self, dim: int, axis) -> bool:
        return axis is not None and dim % self.axis_size(axis) == 0

    def seq_spec(self, seq_len: int) -> Optional[str]:
        """Sequence-parallel axis for activations between layers (the TP
        axis wherever it divides the sequence)."""
        if (self.tp_axis is not None and seq_len % self.axis_size(self.tp_axis) == 0
                and seq_len > 1):
            return self.tp_axis
        return None


NO_PARALLEL = ParallelCtx(mesh=None, tp_axis=None, fsdp_axis=None, pod_axis=None)
