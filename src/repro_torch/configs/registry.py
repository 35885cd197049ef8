"""Architecture registry: ``--arch <id>`` resolves here.

Every arch of the reference: the attention-only ones, dense and MoE, the
recurrent ones (jamba's Mamba, xLSTM's mLSTM and sLSTM), the
encoder-decoder seamless-m4t-medium and the vision-front-end internvl2-1b.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

_ARCH_MODULES = {
    "olmo-1b": "olmo_1b",
    "nemotron-4-15b": "nemotron_4_15b",
    "glm4-9b": "glm4_9b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "arctic-480b": "arctic_480b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "xlstm-1.3b": "xlstm_1_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-1b": "internvl2_1b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {list_archs()}")
    return importlib.import_module(f"{__package__}.{_ARCH_MODULES[name]}")


def get_arch(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE
