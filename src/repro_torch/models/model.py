"""Top-level Model: init, prefill and decode, plus Vilamb dirty events.

The port of ``repro.models.model`` for serving dense decoder-only models.
``build_model(cfg)`` returns a :class:`Model` on the card unless the caller
passes ``device="cpu"``.  The model reports which KV-cache pages a decode
step wrote (``dirty_events_decode``), feeding the store's bitvectors (the
paper's dirty bits, generated at the writer).  The training half (loss,
cross entropy, ``dirty_events_train``) waits for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..common.device import DeviceLike, resolve_device
from ..core.blocks import ShapeDtype
from . import transformer as tfm
from .config import ModelConfig
from .layers import embed_init, make_norm


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.param_dtype)

    # ------------------------------------------------------------------ init
    def init(self, gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Random parameters: the reference's tree of names, shapes and
        dtypes, drawn from ``gen`` (a generator on the model's device).  On
        the ``meta`` device nothing is drawn (shapes only)."""
        cfg, dev = self.cfg, self.device
        norm_init, _ = make_norm(cfg)
        params: Dict[str, Any] = {
            "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), self.dtype, dev),
            "final_norm": norm_init(cfg.d_model, dev),
            "stack": tfm.stack_init(gen, cfg, cfg.n_groups, self.dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                        self.dtype, dev)
        return params

    # ---------------------------------------------------------------- embed
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        rows = params["embed"].index_select(0, tokens.reshape(-1))
        return rows.view(*tokens.shape, self.cfg.d_model).to(self.dtype)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["head"]

    # ---------------------------------------------------------------- caches
    def cache_shapes(self, batch: int, max_len: int) -> Dict[str, Dict[str, ShapeDtype]]:
        """Shape and dtype of every KV cache: sequence-major ``(G, max_len,
        B, KV, hd)`` per attention slot.  Enough for ``ProtectedStore.attach``
        (the reference uses ``jax.eval_shape(init_caches)``)."""
        cfg = self.cfg
        spec = ShapeDtype((cfg.n_groups, max_len, batch, cfg.n_kv_heads, cfg.hd),
                          self.dtype)
        return {f"slot_{s}": {"k": spec, "v": spec}
                for s, (mixer, _) in enumerate(tfm.slot_kinds(cfg)) if mixer == "attn"}

    def init_caches(self, batch: int, max_len: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Zeroed KV caches of :meth:`cache_shapes` on the model's device."""
        return {slot: {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                       for k, s in c.items()}
                for slot, c in self.cache_shapes(batch, max_len).items()}

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]], int]:
        """Full forward filling the caches; returns ``(last_logits, caches,
        pos)``, the logits (B, padded_vocab) of the last prompt position."""
        _, norm = make_norm(self.cfg)
        x = self._embed(params, batch["tokens"])
        B, S, _ = x.shape
        caches = self.init_caches(B, max_len)
        x = tfm.stack_apply_full(params["stack"], x, self.cfg, caches)
        x = norm(params["final_norm"], x[:, -1:])
        return self._logits(params, x)[:, 0], caches, S

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, caches, token: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]], torch.Tensor]:
        """One token for the whole batch.  token: (B,) int.  The caches are
        written in place at ``pos``.  Returns ``(logits, caches, next)``,
        ``next`` the greedy int32 tokens."""
        _, norm = make_norm(self.cfg)
        x = self._embed(params, token[:, None])
        x = tfm.stack_apply_decode(params["stack"], x, self.cfg, caches, pos)
        logits = self._logits(params, norm(params["final_norm"], x))[:, 0]
        return logits, caches, torch.argmax(logits, dim=-1).to(torch.int32)

    # ----------------------------------------------------- dirty events (§3.2)
    def dirty_events_decode(self, caches, pos: int) -> Dict[str, torch.Tensor]:
        """KV-cache page dirty events for a decode step at ``pos``.

        Masks are (n_groups, S_max) bool over the sequence-major caches'
        leading dims: only the written position's row goes dirty.
        """
        events: Dict[str, torch.Tensor] = {}
        for slot, c in caches.items():
            G, S_max = c["k"].shape[:2]
            ev = torch.zeros((G, S_max), dtype=torch.bool, device=c["k"].device)
            ev[:, pos] = True
            events[f"{slot}/k"] = ev
            events[f"{slot}/v"] = ev
        return events


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """A :class:`Model` on ``device`` (the card unless told otherwise)."""
    tfm.check_supported(cfg)
    return Model(cfg=cfg, device=resolve_device(device, "build_model"))
