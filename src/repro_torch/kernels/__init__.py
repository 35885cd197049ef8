"""Hand-written CUDA kernels of the port, each beside its plain version.

``checksum`` (K1), ``parity`` (K2) and ``redundancy`` (K3) wrap the
sources in ``repro_torch/csrc``; ``_build`` compiles and loads them at
first use.
"""
