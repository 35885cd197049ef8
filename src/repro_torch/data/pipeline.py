"""Deterministic synthetic data pipeline (restart-reproducible).

The port of ``repro.data.pipeline``.  Batches are pure functions of
``(seed, step)``, drawn from the same numpy ``default_rng((seed, step))``
as the reference, so the port's batches equal the reference's bit for
bit.  Token streams are zipf-skewed, so embedding-row dirty tracking sees
a hot/cold key distribution (the paper's YCSB analogue).  ``get`` puts
the batch on the pipeline's device, the card unless ``device="cpu"``.
The reference's ``mesh`` argument and ``batch_spec`` (sharded batches)
are ROADMAP.md, Queue 1 item 11; the vision and encoder inputs wait for
their models (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..common.device import DeviceLike, resolve_device
from ..core.blocks import ShapeDtype
from ..models.config import ModelConfig, ShapeConfig
from ..models.transformer import not_ported


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int, a: float = 1.3):
    """Zipf-skewed token ids in [0, vocab)."""
    z = rng.zipf(a, size=shape).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def _text_only(cfg: ModelConfig) -> None:
    kinds = [k for k in ("enc_dec", "frontend") if getattr(cfg, k)]
    if kinds:
        raise not_ported(f"{cfg.name}'s batches", kinds)


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ShapeDtype]:
    """Shapes and dtypes of one training batch (the reference's
    ``batch_structs``)."""
    _text_only(cfg)
    spec = ShapeDtype((shape.global_batch, shape.seq_len), torch.int32)
    return {"tokens": spec, "labels": spec}


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    zipf_a: float = 1.3
    device: DeviceLike = None

    def __post_init__(self):
        _text_only(self.cfg)
        self.device = resolve_device(self.device, "SyntheticPipeline")

    def _numpy_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.shape.global_batch, self.shape.seq_len
        stream = _zipf_tokens(rng, (B, S + 1), self.cfg.vocab_size, self.zipf_a)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:].copy()}

    def get(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step``: ``{"tokens", "labels"}`` (B, S) int32."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self._numpy_batch(step).items()}
