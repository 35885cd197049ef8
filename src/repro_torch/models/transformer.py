"""Layer stacks of decoder-only and encoder-decoder LMs: attention, Mamba,
mLSTM and sLSTM mixers with dense, MoE or no FFNs, and cross attention.

The port of ``repro.models.transformer``.  Parameters stay stacked by
group on a leading axis, with the reference's names and shapes
(``slot_0/attn/wq`` is ``(n_groups, d, H, hd)``), so weights carry across.
A Python loop over groups takes the place of ``lax.scan``; each stacked
leaf is split into its groups once per call (``unbind``), so the backward
stacks each leaf's gradient once instead of adding a full-size zero tensor
per group.  Training checkpoints each slot (``cfg.remat``), as the
reference's per-slot ``jax.checkpoint`` does.  A slot's FFN is dense or
MoE (``models/moe.py``; arctic's dense residual beside it); the full
forward returns every slot's expert counts and the summed aux loss, as
the reference's scan does.  The recurrent mixers (``models/mamba.py``,
``models/xlstm.py``) serve and train: the prefill writes each one's final
state into its cache, and decode rewrites that state in place; in
training a recurrent slot runs under the per-slot checkpoint with each
chunk of its scan checkpointed inside it, as in the reference.  An
encoder-decoder's decoder slots carry a cross attention (``cross_norm``,
``cross``) over the encoder's memory; the encoder is a stack of its own,
run with ``causal=False``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import xlstm as xlstm_mod
from .config import ModelConfig
from .layers import ffn_apply, ffn_init, make_norm

# Each mixer's (init, full-sequence apply, one-token decode step) beside
# attention's: init(gen, cfg, dtype, device, lead); apply(p, x, cfg) ->
# (y, final state); decode(p, x, cfg, cache) -> y, the state in place.
RECURRENT = {
    "mamba": (mamba_mod.mamba_init, mamba_mod.mamba_apply, mamba_mod.mamba_decode_step),
    "mlstm": (xlstm_mod.mlstm_init, xlstm_mod.mlstm_apply, xlstm_mod.mlstm_decode_step),
    "slstm": (xlstm_mod.slstm_init, xlstm_mod.slstm_apply, xlstm_mod.slstm_decode_step),
}


def slot_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) kind per slot within one group."""
    return [(cfg.layer_kind(s), cfg.ffn_kind(s)) for s in range(cfg.group_size)]


def _unbind(tree: Dict[str, Any], n_groups: int) -> List[Dict[str, Any]]:
    """A stacked tree split into its ``n_groups`` groups (views, no copies),
    each leaf split once by ``unbind(0)``."""
    out: List[Dict[str, Any]] = [{} for _ in range(n_groups)]
    for k, v in tree.items():
        parts = _unbind(v, n_groups) if isinstance(v, dict) else v.unbind(0)
        for g in range(n_groups):
            out[g][k] = parts[g]
    return out


# --------------------------------------------------------------------- init
def _slot_init(gen, cfg: ModelConfig, mixer: str, ffn: str, dtype: torch.dtype,
               device, n_groups: int, cross: bool) -> Dict[str, Any]:
    norm_init, _ = make_norm(cfg)
    lead = (n_groups,)
    mixer_init = attn_mod.attn_init if mixer == "attn" else RECURRENT[mixer][0]
    p: Dict[str, Any] = {"mixer_norm": norm_init(cfg.d_model, device, lead),
                         mixer: mixer_init(gen, cfg, dtype, device, lead)}
    if cross:
        p["cross_norm"] = norm_init(cfg.d_model, device, lead)
        p["cross"] = attn_mod.attn_init(gen, cfg, dtype, device, lead)
    if ffn != "none":
        p["ffn_norm"] = norm_init(cfg.d_model, device, lead)
        if ffn == "moe":
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, lead)
            if cfg.dense_residual:
                p["dense_res"] = ffn_init(gen, cfg, cfg.d_ff, dtype, device, lead)
        else:
            p["ffn"] = ffn_init(gen, cfg, cfg.d_ff, dtype, device, lead)
    return p


def stack_init(gen, cfg: ModelConfig, n_groups: int, dtype: torch.dtype,
               device=None, cross: bool = False) -> Dict[str, Any]:
    """Every slot's parameters stacked over ``n_groups``; ``cross`` adds
    each slot's cross attention (an encoder-decoder's decoder)."""
    return {f"slot_{s}": _slot_init(gen, cfg, mixer, ffn, dtype, device, n_groups, cross)
            for s, (mixer, ffn) in enumerate(slot_kinds(cfg))}


# -------------------------------------------------------------------- apply
def _ffn(p, h: torch.Tensor, cfg: ModelConfig, ffn: str):
    """The slot's FFN on ``h`` (B, S, d): ``(y, counts (E,) int32, aux)``
    for MoE (its dense residual added), ``(y, None, None)`` for a dense
    FFN, which has no router."""
    if ffn == "moe":
        B, S, d = h.shape
        y, counts, aux = moe_mod.moe_apply(p["moe"], h.reshape(B * S, d), cfg)
        y = y.reshape(B, S, d)
        if cfg.dense_residual:
            y = y + ffn_apply(p["dense_res"], h, cfg)
        return y, counts, aux
    return ffn_apply(p["ffn"], h, cfg), None, None


def _slot_apply_full(p, x: torch.Tensor, cfg: ModelConfig, mixer: str, ffn: str,
                     train: bool, memory: Optional[torch.Tensor] = None,
                     causal: bool = True):
    """Full-sequence slot (prefill or training).  Returns ``(x, state,
    counts, aux)``: the state for the cache (attention's k and v (B, S, KV,
    hd), a recurrent mixer's final state; with ``memory``, the cross
    attention's ``ck`` and ``cv`` (B, S_enc, KV, hd) too), counts and aux
    None without a router.  ``causal=False`` is the encoder's attention
    (full, RoPE)."""
    _, norm = make_norm(cfg)
    h = norm(p["mixer_norm"], x)
    if mixer == "attn" and causal:
        y, (k, v) = attn_mod.causal_attention(p["attn"], h, cfg, train=train)
        state = {"k": k, "v": v}
    elif mixer == "attn":                  # the encoder's: full, with RoPE
        y, (k, v) = attn_mod.full_attention(p["attn"], h, cfg, rope=True, train=train)
        state = {"k": k, "v": v}
    else:
        y, state = RECURRENT[mixer][1](p[mixer], h, cfg)
    x = x + y
    if memory is not None:                 # the decoder's cross attention
        y, (ck, cv) = attn_mod.full_attention(p["cross"], norm(p["cross_norm"], x), cfg,
                                              kv_x=memory, rope=False, train=train)
        state = dict(state, ck=ck, cv=cv)
        x = x + y
    counts = aux = None
    if ffn != "none":
        y, counts, aux = _ffn(p, norm(p["ffn_norm"], x), cfg, ffn)
        x = x + y
    return x, state, counts, aux


def _slot_train(p, x: torch.Tensor, memory: Optional[torch.Tensor], cfg: ModelConfig,
                mixer: str, ffn: str, causal: bool):
    x, _, counts, aux = _slot_apply_full(p, x, cfg, mixer, ffn, train=True,
                                         memory=memory, causal=causal)
    return x, counts, aux


def _slot_apply_decode(p, x: torch.Tensor, cfg: ModelConfig, mixer: str, ffn: str,
                       cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
    """One-token slot.  x: (B, 1, d).  Writes attention's cache row ``pos``,
    or a recurrent mixer's whole state, in place; a cross attention reads
    the encoder memory ``ck``/``cv`` and writes nothing."""
    _, norm = make_norm(cfg)
    h = norm(p["mixer_norm"], x)
    if mixer == "attn":
        y = attn_mod.decode_attention(p["attn"], h, cfg, cache["k"], cache["v"], pos)
    else:
        y = RECURRENT[mixer][2](p[mixer], h, cfg, cache)
    x = x + y
    if "ck" in cache:
        x = x + attn_mod.decode_attention(p["cross"], norm(p["cross_norm"], x), cfg,
                                          cache["ck"], cache["cv"], pos, rope=False,
                                          cross=True)
    if ffn != "none":
        x = x + _ffn(p, norm(p["ffn_norm"], x), cfg, ffn)[0]
    return x


def stack_apply_full(stack, x: torch.Tensor, cfg: ModelConfig,
                     caches: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                     *, train: bool = False, memory: Optional[torch.Tensor] = None,
                     causal: bool = True
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the stack over the sequence, group by group.  Returns ``(x,
    (counts, aux_loss))``: counts ``(G, group_size, max(E, 1))`` int32, every
    slot's tokens per expert, and the fp32 aux loss summed over slots and
    groups, as the reference's scan returns them.

    Prefill (``train=False``): the flash kernel's attention, and each
    layer's k and v go straight into rows ``:S`` of its group of ``caches``
    (``init_caches``' sequence-major ``(G, S_max, B, KV, hd)`` tensors), so
    the stacked ``(G, B, S, KV, hd)`` copies the reference builds never
    exist; a recurrent layer's final state goes into its group of its
    caches the same way, and with ``memory`` (the encoder's output, (B,
    S_enc, d)) the cross attention's k and v go whole into ``ck`` and
    ``cv``.  Training (``train=True``, no caches): the differentiable
    attention, each slot under ``torch.utils.checkpoint`` unless
    ``cfg.remat == "none"``, with ``memory`` an explicit input so that its
    gradient reaches the encoder, so a slot's backward recomputes its
    forward from its inputs and holds only that slot's activations; a
    recurrent slot's recompute runs its mixer's per-chunk checkpoints in
    turn (``layers.chunk_checkpoint``).  ``causal=False`` runs the encoder: full attention with RoPE, and no
    caches in either mode.
    """
    if (train or not causal) != (caches is None):
        raise ValueError("stack_apply_full fills caches on the decoder's prefill "
                         "and none in training or in the encoder")
    kinds = slot_kinds(cfg)
    groups = {s: _unbind(stack[f"slot_{s}"], cfg.n_groups) for s in range(len(kinds))}
    counts, aux = [], []
    for g in range(cfg.n_groups):
        group_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s, (mixer, ffn) in enumerate(kinds):
            p = groups[s][g]
            if train and cfg.remat != "none":
                x, c, a = checkpoint(_slot_train, p, x, memory, cfg, mixer, ffn, causal,
                                     use_reentrant=False)
            elif train:
                x, c, a = _slot_train(p, x, memory, cfg, mixer, ffn, causal)
            else:
                x, state, c, a = _slot_apply_full(p, x, cfg, mixer, ffn, train=False,
                                                  memory=memory, causal=causal)
                for key, t in (state.items() if caches is not None else ()):
                    dst = caches[f"slot_{s}"][key]
                    if key in ("k", "v", "ck", "cv"):  # rows :S, sequence-major
                        dst[g, :t.shape[1]] = t.transpose(0, 1)
                    else:
                        dst[g] = t
            if c is None:                  # no router: zeros, as the reference's
                c = torch.zeros((max(cfg.n_experts, 1),), dtype=torch.int32,
                                device=x.device)
            else:
                group_aux = group_aux + a
            counts.append(c)
        aux.append(group_aux)
    counts = torch.stack(counts).view(cfg.n_groups, len(kinds), -1)
    return x, (counts, torch.stack(aux).sum())


def stack_apply_decode(stack, x: torch.Tensor, cfg: ModelConfig, caches,
                       pos: int) -> torch.Tensor:
    """One token through the stack; every cache is written in place (a KV
    cache at row ``pos``, a recurrent state whole)."""
    kinds = slot_kinds(cfg)
    params = [_unbind(stack[f"slot_{s}"], cfg.n_groups) for s in range(len(kinds))]
    cache = [_unbind(caches[f"slot_{s}"], cfg.n_groups) for s in range(len(kinds))]
    for g in range(cfg.n_groups):
        for s, (mixer, ffn) in enumerate(kinds):
            x = _slot_apply_decode(params[s][g], x, cfg, mixer, ffn, cache[s][g], pos)
    return x
