"""Vilamb on PyTorch and CUDA: the port of the ``repro`` package.

``repro_torch.core`` holds the store lifecycle; ``repro_torch.kernels``
the hand-written CUDA kernels (sources in ``repro_torch/csrc``), each
beside its plain PyTorch version.  The package imports no JAX.
"""
