"""Top-level Model: init, loss, prefill and decode, plus Vilamb dirty events.

The port of ``repro.models.model``: decoder-only models (dense, MoE, and
the recurrent mixers: jamba's Mamba, xLSTM's mLSTM and sLSTM), the
encoder-decoder stack (seamless-m4t-medium: the encoder runs
once over the batch's ``enc_input`` frames, and every decoder slot's
cross attention reads its memory) and the vision front end (internvl2-1b:
the batch's ``frontend`` patches go in front of the prompt).
``build_model(cfg)`` returns a :class:`Model` on the card unless the
caller passes ``device="cpu"``.  The model reports which embedding rows a
train step touched, and which expert slabs its tokens were routed to
(``dirty_events_train``), and which KV-cache pages a decode step wrote,
every recurrent state being rewritten whole and the cross-attention
caches never (``dirty_events_decode``), feeding the store's bitvectors
(the paper's dirty bits, generated at the writer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..common.device import DeviceLike, resolve_device
from ..core.blocks import ShapeDtype
from ..core.engine import ALL
from . import transformer as tfm
from .config import ModelConfig
from .layers import embed_init, make_norm


# fp32 elements of one row slice of the cross entropy's temporaries (1 GiB):
# no (B, S, V) fp32 buffer of the whole batch lives at once.
CE_SLICE_ELEMS = 1 << 28


def _row_slices(n_rows: int, row_elems: int):
    step = max(1, CE_SLICE_ELEMS // max(row_elems, 1))
    return [slice(i, min(n_rows, i + step)) for i in range(0, n_rows, step)]


def _masked_f32(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """fp32 logits with the padded vocabulary tail at -1e30."""
    lf = logits.float()
    if lf.shape[-1] > vocab_size:
        lf = lf.clone() if lf is logits else lf
        lf[:, vocab_size:].fill_(-1e30)
    return lf


class _CrossEntropy(torch.autograd.Function):
    """The reference's custom-VJP masked cross entropy.

    Residuals are the logits and the lse (the backward recomputes the
    softmax from them); ``dlogits`` comes back in the logits' dtype.  Both
    directions walk row slices of :data:`CE_SLICE_ELEMS` elements, with the
    same arithmetic for every element as the reference's whole-batch form.
    The label's score is gathered, which equals the reference's one-hot
    product exactly (one nonzero term).
    """

    @staticmethod
    def forward(ctx, logits, labels, vocab_size):
        V = logits.shape[-1]
        flat, lab = logits.reshape(-1, V), labels.reshape(-1)
        nll, lse = [], []
        for sl in _row_slices(flat.shape[0], V):
            lf = _masked_f32(flat[sl], vocab_size)
            shifted = lf - lf.amax(dim=-1, keepdim=True)
            lse_s = torch.log(torch.exp(shifted).sum(dim=-1))
            ll = shifted.gather(-1, lab[sl].clamp_min(0).long()[:, None])[:, 0]
            nll.append(lse_s - ll)
            lse.append(lse_s)
        mask = (lab >= 0).float()
        denom = mask.sum().clamp_min(1.0)
        ctx.save_for_backward(logits, labels, torch.cat(lse), mask, denom)
        ctx.vocab_size = vocab_size
        return (torch.cat(nll) * mask).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, mask, denom = ctx.saved_tensors
        V = logits.shape[-1]
        flat, lab = logits.reshape(-1, V), labels.reshape(-1)
        dlogits = torch.empty_like(flat)
        scale = g * mask / denom
        iota = torch.arange(V, device=flat.device)
        for sl in _row_slices(flat.shape[0], V):
            lf = _masked_f32(flat[sl], ctx.vocab_size)
            p = torch.exp(lf - lf.amax(dim=-1, keepdim=True)) / torch.exp(lse[sl])[:, None]
            onehot = (iota[None, :] == lab[sl].clamp_min(0)[:, None]).float()
            dlogits[sl] = ((p - onehot) * scale[sl, None]).to(logits.dtype)
        return dlogits.view(logits.shape), None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Masked mean cross entropy over (B, S, V_pad) logits of any float
    dtype: the padded vocabulary tail is masked, labels below 0 ignored."""
    return _CrossEntropy.apply(logits, labels, vocab_size)


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
            "stack": tfm.stack_init(gen, cfg, cfg.n_groups, self.dtype, dev,
                                    cross=cfg.enc_dec),
        }
        if not cfg.tie_embeddings:
            params["head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                        self.dtype, dev)
        if cfg.enc_dec:
            enc = self._enc_cfg
            params["enc_stack"] = tfm.stack_init(gen, enc, enc.n_layers, self.dtype, dev)
            params["enc_final_norm"] = norm_init(cfg.d_model, dev)
        return params

    @property
    def _enc_cfg(self) -> ModelConfig:
        """The encoder's config: attention and dense FFNs only, one layer a
        group."""
        return dataclasses.replace(self.cfg, attn_every=0, ssm_kind="", n_experts=0,
                                   slstm_every=0)

    # ---------------------------------------------------------------- embed
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """The table's rows: ``F.embedding``, whose backward (sort-based)
        is deterministic, where ``index_select``'s adds with atomics."""
        return F.embedding(tokens.long(), params["embed"]).to(self.dtype)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["head"]

    def _encode(self, params, enc_input: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The encoder over ``enc_input`` (B, S_enc, d): its stack with full
        attention (the flash kernel on the prefill), then its final norm."""
        enc = self._enc_cfg
        _, norm = make_norm(enc)
        x, _ = tfm.stack_apply_full(params["enc_stack"], enc_input.to(self.dtype), enc,
                                    train=train, causal=False)
        return norm(params["enc_final_norm"], x)

    def _inputs(self, params, batch: Dict[str, torch.Tensor], train: bool):
        """The decoder's input (the vision patches in front of the prompt's
        embeddings) and the encoder's memory (None without an encoder)."""
        memory = self._encode(params, batch["enc_input"], train) if self.cfg.enc_dec else None
        x = self._embed(params, batch["tokens"])
        if self.cfg.frontend == "vision":
            x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
        return x, memory

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss of a batch ``{"tokens", "labels"}`` (B, S) int,
        with ``"frontend"`` (B, frontend_len, d) patches for a vision front
        end and ``"enc_input"`` (B, S_enc, d) frames for an encoder; the
        loss covers the text positions only.

        Returns ``(loss, aux)``: the loss is ``ce + 0.01 * aux_loss``, aux
        ``{"ce", "aux_loss", "expert_counts", "logits_mean"}`` with
        ``expert_counts`` ``(G, group_size, max(E, 1))`` int32, each slot's
        tokens per expert; a dense model has no router, so its ``aux_loss``
        is 0 and its counts zeros.
        """
        cfg = self.cfg
        _, norm = make_norm(cfg)
        x, memory = self._inputs(params, batch, train=True)
        x, (counts, aux_loss) = tfm.stack_apply_full(params["stack"], x, cfg, train=True,
                                                     memory=memory)
        if cfg.frontend == "vision":
            x = x[:, batch["frontend"].shape[1]:]
        logits = self._logits(params, norm(params["final_norm"], x))
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        with torch.no_grad():
            logits_mean = logits.abs().mean(dtype=torch.float32)
        return ce + 0.01 * aux_loss, {
            "ce": ce, "aux_loss": aux_loss, "logits_mean": logits_mean,
            "expert_counts": counts}

    # ---------------------------------------------------------------- caches
    def cache_shapes(self, batch: int, max_len: int, enc_len: int = 0
                     ) -> Dict[str, Dict[str, ShapeDtype]]:
        """Shape and dtype of every cache, per slot by its mixer: attention's
        sequence-major ``k`` and ``v`` ``(G, max_len, B, KV, hd)``; Mamba's
        fp32 ``h`` ``(G, B, d_inner, d_state)`` and ``conv`` ``(G, B,
        d_conv - 1, d_inner)``; mLSTM's fp32 ``C`` ``(G, B, H, hd, hd)`` and
        ``n`` ``(G, B, H, hd)``; sLSTM's fp32 ``c`` ``(G, B, H, hd)`` and
        ``n`` ``(G, B, H)``; an encoder-decoder's cross-attention ``ck``
        and ``cv`` ``(G, enc_len, B, KV, hd)`` in every slot.  Enough for
        ``ProtectedStore.attach`` (the reference uses
        ``jax.eval_shape(init_caches)``)."""
        cfg, G, B = self.cfg, self.cfg.n_groups, batch
        f32 = torch.float32
        hd = cfg.d_model // cfg.n_heads          # the recurrent mixers' head width
        out: Dict[str, Dict[str, ShapeDtype]] = {}
        for s, (mixer, _) in enumerate(tfm.slot_kinds(cfg)):
            if mixer == "attn":
                kv = ShapeDtype((G, max_len, B, cfg.n_kv_heads, cfg.hd), self.dtype)
                c = {"k": kv, "v": kv}
            elif mixer == "mamba":
                c = {"h": ShapeDtype((G, B, cfg.d_inner, cfg.d_state), f32),
                     "conv": ShapeDtype((G, B, cfg.d_conv - 1, cfg.d_inner), self.dtype)}
            elif mixer == "mlstm":
                c = {"C": ShapeDtype((G, B, cfg.n_heads, hd, hd), f32),
                     "n": ShapeDtype((G, B, cfg.n_heads, hd), f32)}
            else:
                c = {"c": ShapeDtype((G, B, cfg.n_heads, hd), f32),
                     "n": ShapeDtype((G, B, cfg.n_heads), f32)}
            if cfg.enc_dec:
                mem = ShapeDtype((G, enc_len, B, cfg.n_kv_heads, cfg.hd), self.dtype)
                c = dict(c, ck=mem, cv=mem)
            out[f"slot_{s}"] = c
        return out

    def init_caches(self, batch: int, max_len: int, enc_len: int = 0
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The caches of :meth:`cache_shapes` on the model's device: zeros,
        but for sLSTM's normaliser ``n``, which starts at 1e-6 as in the
        reference."""
        shapes = self.cache_shapes(batch, max_len, enc_len)
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for s, (mixer, _) in enumerate(tfm.slot_kinds(self.cfg)):
            out[f"slot_{s}"] = {
                k: torch.full(sd.shape, 1e-6 if (mixer, k) == ("slstm", "n") else 0.0,
                              dtype=sd.dtype, device=self.device)
                for k, sd in shapes[f"slot_{s}"].items()}
        return out

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]], int]:
        """Full forward filling the caches; returns ``(last_logits, caches,
        pos)``, the logits (B, padded_vocab) of the last prompt position and
        ``pos`` the decoder's length (the vision patches and the prompt).
        An encoder runs once here; its memory fills ``ck`` and ``cv`` and is
        never recomputed in decode."""
        _, norm = make_norm(self.cfg)
        x, memory = self._inputs(params, batch, train=False)
        B, S, _ = x.shape
        caches = self.init_caches(B, max_len, memory.shape[1] if memory is not None else 0)
        x, _ = tfm.stack_apply_full(params["stack"], x, self.cfg, caches, memory=memory)
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
    def dirty_events_train(self, batch: Dict[str, torch.Tensor],
                           aux: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Dirty events of the sparse leaves after a train step: a presence
        row mask over ``padded_vocab`` for ``embed``, and for each MoE slot
        ``s`` a ``(G, E)`` mask of the expert slabs that received tokens
        (``aux["expert_counts"][:, s] > 0``) for its ``moe/wi``, ``wg`` and
        ``wo``.  Lazy AdamW leaves untouched rows and slabs bit-identical.
        The train loop expands the events to the params and both moments
        and marks every other leaf ALL-dirty: every Mamba, mLSTM and sLSTM
        leaf among them, as in the reference."""
        cfg = self.cfg
        tokens = batch["tokens"]
        presence = torch.zeros((cfg.padded_vocab,), dtype=torch.bool,
                               device=tokens.device)
        presence.index_fill_(0, tokens.reshape(-1).long(), True)
        events = {"embed": presence}
        for s, (_, ffn) in enumerate(tfm.slot_kinds(cfg)):
            if ffn == "moe":
                ev = aux["expert_counts"][:, s, :] > 0
                for w in ("wi", "wg", "wo"):
                    events[f"stack/slot_{s}/moe/{w}"] = ev
        return events

    def dirty_events_decode(self, caches, pos: int) -> Dict[str, Any]:
        """Cache dirty events for a decode step at ``pos``.

        A KV cache's mask is (n_groups, S_max) bool over its sequence-major
        leading dims: only the written position's row goes dirty.  A
        recurrent state (``h``, ``conv``, ``C``, ``n``, ``c``) is rewritten
        whole every step: ``ALL``.  The cross-attention caches ``ck`` and
        ``cv`` are the encoder memory, written once by the prefill: no
        event.
        """
        events: Dict[str, Any] = {}
        for s, (mixer, _) in enumerate(tfm.slot_kinds(self.cfg)):
            c = caches[f"slot_{s}"]
            if mixer == "attn":
                G, S_max = c["k"].shape[:2]
                ev = torch.zeros((G, S_max), dtype=torch.bool, device=c["k"].device)
                ev[:, pos].fill_(True)
                events[f"slot_{s}/k"] = ev
                events[f"slot_{s}/v"] = ev
            else:
                for key in c:
                    if key not in ("ck", "cv"):
                        events[f"slot_{s}/{key}"] = ALL
        return events


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """A :class:`Model` on ``device`` (the card unless told otherwise)."""
    return Model(cfg=cfg, device=resolve_device(device, "build_model"))
