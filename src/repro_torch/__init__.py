"""Vilamb on PyTorch and CUDA: the port of the ``repro`` package.

``repro_torch.core`` holds the store lifecycle; ``repro_torch.kernels``
the hand-written CUDA kernels (sources in ``repro_torch/csrc``), each
beside its plain PyTorch version.  The package imports no JAX.  Importing
it makes one serial call into the CPU's vector math
(``common/cpu_math.py``), so that no parallel call races its binding.
"""
from .common.cpu_math import bind_vector_math

bind_vector_math()
