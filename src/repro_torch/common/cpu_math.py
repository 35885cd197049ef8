"""Bind the CPU's vector math before any parallel call reaches it.

On the CPU, ``torch.exp``, ``log``, ``sqrt``, ``tanh`` and the other
``at::vml`` functions run MKL's vector math, which binds its code to the
processor on the process's first call into it.  When that first call is a
parallel one (a tensor above the op's grain, split over the OpenMP
threads), the threads race the binding, and a thread can compute its
chunk with other code: results off by up to 1.5e-4 relative, right the
second time (``scripts/torch_vml_race.py``: 2 of 240 fresh processes on a
loaded 8-core host).  The port's cross entropy is then off in the rows of
that chunk.  One call on a one-element tensor (below every grain, so on
the calling thread alone) binds it for the process: after a single
``exp``, a single ``log`` or this package's import, 0 of 720.
:func:`bind_vector_math` runs when ``repro_torch`` is imported.
"""
from __future__ import annotations

import torch


def bind_vector_math() -> None:
    """One serial call into the CPU's vector math (cheap, idempotent)."""
    torch.exp(torch.zeros(1))
