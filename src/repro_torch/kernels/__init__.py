"""Hand-written CUDA kernels of the port, each beside its plain version.

``checksum`` (K1), ``parity`` (K2), ``redundancy`` (K3) and ``flash_attn``
(the prefill's attention) wrap the sources in ``repro_torch/csrc``;
``_build`` compiles and loads them at first use.
"""
