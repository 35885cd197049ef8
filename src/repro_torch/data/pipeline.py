"""Deterministic synthetic data pipeline (restart-reproducible).

The port of ``repro.data.pipeline``.  Batches are pure functions of
``(seed, step)``, drawn from the same numpy ``default_rng((seed, step))``
as the reference, so the port's batches equal the reference's bit for
bit.  Token streams are zipf-skewed, so embedding-row dirty tracking sees
a hot/cold key distribution (the paper's YCSB analogue).  A vision front
end's batch carries ``frontend`` patches (B, frontend_len, d) and its text
is that much shorter; an encoder-decoder's carries ``enc_input`` frames
(B, S - S // 2, d) and S // 2 tokens: both fp32 standard normals drawn
before the token stream, in the reference's order.  ``get`` puts the
batch on the pipeline's device, the card unless ``device="cpu"``.  The
reference's ``mesh`` argument is taken (``make_mesh``; the pipeline then
runs on the mesh's device) and so is ``batch_spec``: every shard of a
batch lives on that one device, so the batch is the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..common.device import DeviceLike, resolve_device
from ..core.blocks import ShapeDtype
from ..models.config import ModelConfig, ShapeConfig


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int, a: float = 1.3):
    """Zipf-skewed token ids in [0, vocab)."""
    z = rng.zipf(a, size=shape).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def _text_len(cfg: ModelConfig, S: int) -> int:
    """The tokens of a batch of sequence length ``S``: the vision patches
    and an encoder's frames take their share of it."""
    if cfg.enc_dec:
        return S // 2
    return S - cfg.frontend_len if cfg.frontend == "vision" else S


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ShapeDtype]:
    """Shapes and dtypes of one training batch (the reference's
    ``batch_structs``, whose front-end and encoder inputs are fp32 here, as
    both pipelines yield them)."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, ShapeDtype] = {}
    if cfg.frontend == "vision":
        out["frontend"] = ShapeDtype((B, cfg.frontend_len, cfg.d_model), torch.float32)
    if cfg.enc_dec:
        out["enc_input"] = ShapeDtype((B, S - S // 2, cfg.d_model), torch.float32)
    spec = ShapeDtype((B, _text_len(cfg, S)), torch.int32)
    return dict(out, tokens=spec, labels=spec)


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    zipf_a: float = 1.3
    device: DeviceLike = None
    mesh: Any = None

    def __post_init__(self):
        if self.device is None and self.mesh is not None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device, "SyntheticPipeline")

    def batch_spec(self) -> Dict[str, Any]:
        """The reference's batch specs: the batch dim over the mesh's
        ``pod`` and ``data`` axes (replicated without a mesh)."""
        from ..dist.spec import PartitionSpec
        dp = tuple(a for a in ("pod", "data")
                   if self.mesh is not None and a in self.mesh.axis_names)
        spec = PartitionSpec(dp or None)
        return {k: spec for k in batch_shapes(self.cfg, self.shape)}

    def _numpy_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S, cfg = self.shape.global_batch, self.shape.seq_len, self.cfg
        out: Dict[str, np.ndarray] = {}
        if cfg.frontend == "vision":
            out["frontend"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        if cfg.enc_dec:
            out["enc_input"] = rng.standard_normal(
                (B, S - S // 2, cfg.d_model)).astype(np.float32)
        stream = _zipf_tokens(rng, (B, _text_len(cfg, S) + 1), cfg.vocab_size, self.zipf_a)
        return dict(out, tokens=stream[:, :-1], labels=stream[:, 1:].copy())

    def get(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step``: ``{"tokens", "labels"}`` int32 of the
        text's length, and ``"frontend"`` or ``"enc_input"`` fp32 where the
        model takes them (see :func:`batch_shapes`)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self._numpy_batch(step).items()}
