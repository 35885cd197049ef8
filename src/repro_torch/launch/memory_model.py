"""Analytic per-chip HBM model for the dry run's "fits" verdict.

The port of ``repro.launch.memory_model``, with the same itemised terms:
exact state bytes from the real per-leaf PartitionSpecs (replication
fallbacks and redundancy arrays included), and a first-principles
activation and working-set estimate.  A trace on the meta device
allocates nothing, so this model is the dry run's only memory figure.

The budget is one NVIDIA H100 80GB HBM3's ``total_memory`` as
``torch.cuda.get_device_properties(0)`` gives it (``chip_smoke.py`` phase
26 checks the constant against the card).  The verdict is
``fits_hbm_analytic``; the reference's is ``fits_16g_analytic``, against
a TPU v5e's 16 GiB: the same test, ``total <= HBM_BUDGET * HEADROOM``.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..common import flatten_dict
from ..core.blocks import ShapeDtype
from ..core.engine import local_shape
from ..dist.sharding import cache_specs, param_specs
from ..models.attention import pick_tile

HBM_BUDGET = 85_017_493_504      # NVIDIA H100 80GB HBM3: total_memory (79.18 GiB)
HEADROOM = 0.9                   # fragmentation / runtime reserves


def _local_bytes(struct, spec, mesh) -> int:
    shape = local_shape(tuple(struct.shape), spec, mesh)
    return math.prod(shape) * struct.dtype.itemsize


def state_bytes_per_chip(flat_structs: Dict, flat_specs: Dict, mesh) -> int:
    return sum(_local_bytes(v, flat_specs.get(k), mesh) for k, v in flat_structs.items())


def red_bytes_per_chip(store) -> int:
    """Redundancy-array bytes per chip (a ProtectedStore or an engine)."""
    total = 0
    metas = getattr(store, "protected_metas", None) or store.metas
    for meta in metas.values():  # metas are shard-local geometry
        total += meta.n_blocks * 4                           # checksums
        total += meta.n_stripes * meta.lanes_per_block * 4   # parity
        total += 2 * meta.n_dirty_words * 4                  # dirty + shadow
    return total


def activation_model(cfg, shape, mesh, accum: int) -> Dict[str, int]:
    """Coarse working-set terms for one train step (per chip; one card
    without a mesh)."""
    axes = mesh.shape if mesh is not None else {}
    dp = int(np.prod([axes.get(a, 1) for a in ("pod", "data")]))
    tp = axes.get("model", 1)
    S, B = shape.seq_len, shape.global_batch
    tokens_ds = S * max(B // dp, 1) // accum          # per data-shard tokens
    sp = tp if S % tp == 0 else 1
    d = cfg.d_model
    out = {}
    # residual stream saved at every layer boundary (remat inputs), SP-sharded
    out["acts_saved"] = cfg.n_layers * tokens_ds * d * 2 // sp
    # LM head working set: f32 softmax + bf16 onehot + bf16 dlogits
    v_loc = cfg.padded_vocab // tp if cfg.padded_vocab % tp == 0 else cfg.padded_vocab
    out["logits_peak"] = tokens_ds * v_loc * (4 + 2 + 2)
    # per-slot backward working sets (max over layer kinds)
    ffn = 3 * tokens_ds * max(cfg.d_ff, 1) * 2 // sp
    h_loc = cfg.n_heads // tp if cfg.n_heads % tp == 0 else cfg.n_heads
    tile = pick_tile(B, cfg.n_heads, S, dp * (tp if cfg.n_heads % tp == 0 else 1))
    attn = 2 * max(B // dp, 1) // accum * h_loc * tile * tile * 4 \
        + 4 * tokens_ds * cfg.n_heads * cfg.hd * 2 // (tp if cfg.n_heads % tp == 0 else 1)
    slot = max(ffn, attn)
    if cfg.ssm_kind == "mamba" or cfg.attn_every:
        di = cfg.d_inner // tp if cfg.d_inner % tp == 0 else cfg.d_inner
        chunk = 128
        mamba = (4 * tokens_ds * di * 2             # xz, ys, dt-ish streams
                 + 3 * max(B // dp, 1) // accum * chunk * di * cfg.d_state * 4)
        slot = max(slot, mamba)
    if cfg.n_experts:
        cap = int(np.ceil(tokens_ds * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
        e_loc = max(cfg.n_experts // tp, 1)
        moe = e_loc * cap * (cfg.d_model + 3 * cfg.expert_d_ff) * 2
        # the FSDP-gathered expert slab of one layer
        moe += 3 * e_loc * cfg.d_model * cfg.expert_d_ff * 2
        slot = max(slot, moe)
    out["slot_peak"] = int(slot)
    return out


def analytic_hbm(cfg, shape, mesh, setup, mode: str, accum: int) -> Dict:
    """Itemised per-chip HBM estimate for a dry-run cell (``setup`` from
    ``launch.specs``: its meta model, parallel context and store)."""
    rec: Dict = {}
    flat_p = flatten_dict(setup.model.init())
    p_specs, _ = param_specs(flat_p, setup.ctx)
    if shape.kind == "train":
        rec["params"] = state_bytes_per_chip(flat_p, p_specs, mesh)
        mbytes = sum(_local_bytes(ShapeDtype(tuple(v.shape), getattr(torch, cfg.moment_dtype)),
                                  p_specs.get(k), mesh) for k, v in flat_p.items())
        rec["moments"] = 2 * mbytes
        rec["grads"] = mbytes * (2 if accum > 1 else 1)  # fp32 accum vs transient
        rec["redundancy"] = red_bytes_per_chip(setup.store) if setup.store else 0
        rec.update(activation_model(cfg, shape, mesh, accum))
    else:
        rec["params"] = state_bytes_per_chip(flat_p, p_specs, mesh)
        if shape.kind == "decode":
            flat_c = flatten_dict(setup.args_struct[1])
            c_specs, _ = cache_specs(cfg, flat_c, setup.ctx, shape.global_batch)
            rec["caches"] = state_bytes_per_chip(flat_c, c_specs, mesh)
            rec["redundancy"] = (red_bytes_per_chip(setup.store)
                                 if getattr(setup, "store", None) else 0)
        else:  # prefill: the transient attention and caches' working set
            axes = mesh.shape if mesh is not None else {}
            dp = int(np.prod([axes.get(a, 1) for a in ("pod", "data")]))
            tp = axes.get("model", 1)
            kv = 2 * cfg.n_layers * (shape.global_batch // max(dp, 1)) * shape.seq_len \
                * cfg.n_kv_heads * cfg.hd * 2
            rec["caches"] = kv // (tp if shape.seq_len % tp == 0 else 1)
            rec.update(activation_model(cfg, shape, mesh, 1))
            rec.pop("acts_saved", None)  # no backward in prefill
    total = int(sum(rec.values()))
    rec["total"] = total
    rec["fits_hbm_analytic"] = bool(total <= HBM_BUDGET * HEADROOM)
    return rec
