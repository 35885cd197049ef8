"""Architecture registry: ``--arch <id>`` resolves here.

The port serves and trains the attention-only archs, dense and MoE, and
serves the recurrent ones (jamba's Mamba, xLSTM's mLSTM and sLSTM).  The
reference's other archs need a stack or front end the port does not have
yet; asking for one raises ``NotImplementedError`` naming its
``ROADMAP.md`` item.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from ..models.config import ModelConfig
from ..models.transformer import not_ported

_ARCH_MODULES = {
    "olmo-1b": "olmo_1b",
    "nemotron-4-15b": "nemotron_4_15b",
    "glm4-9b": "glm4_9b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "arctic-480b": "arctic_480b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "xlstm-1.3b": "xlstm_1_3b",
}

# The reference's other archs, by the kinds they need that the port does
# not have yet (``models.transformer.NOT_PORTED`` names their items).
NEEDS: Dict[str, Tuple[str, ...]] = {
    "seamless-m4t-medium": ("enc_dec",),
    "internvl2-1b": ("frontend",),
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(name: str):
    if name in NEEDS:
        raise not_ported(f"arch {name!r}", NEEDS[name])
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {list_archs()}")
    return importlib.import_module(f"{__package__}.{_ARCH_MODULES[name]}")


def get_arch(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE
