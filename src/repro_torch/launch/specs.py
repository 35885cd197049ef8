"""Dry-run setups: every cell's inputs as ``meta`` tensors, with their specs.

The port of ``repro.launch.specs``.  The reference builds
``jax.ShapeDtypeStruct`` stand-ins and ``NamedSharding`` trees and lowers
a jitted step over them; here every stand-in is a tensor on PyTorch's
``meta`` device (``Model(cfg, meta).init()``, AdamW's moments on meta,
the caches and the batch on meta), which holds shapes and dtypes and no
memory, and every leaf carries the PartitionSpec the port's
``dist.sharding`` rules give it (``param_specs``, ``cache_specs``).  A
setup's step function runs on those tensors as it runs on the card (the
dry run traces it: ``launch.dryrun``).  The store is attached to the
structs with ``precompile=False``, as the reference's dry run attaches
it.  Training cells trace ``make_train_step`` (and the
redundancy step), decode cells ``make_decode_step`` (one token against a
``seq_len`` cache), prefill cells the prefill.  The mesh is the port's
simulated one (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..common import flatten_dict
from ..core.store import ProtectedStore, RedundancyPolicy
from ..core.state import FIELDS, LeafRedundancy
from ..data.pipeline import batch_shapes
from ..dist.sharding import cache_specs, param_specs
from ..dist.spec import P
from ..models.config import ModelConfig, ShapeConfig
from ..models.model import Model
from ..models.parallel import ParallelCtx
from ..optim import AdamW, warmup_cosine
from ..serve.serve_loop import make_decode_step, make_prefill
from ..train.state import TrainState, protected_structs
from ..train.train_loop import make_redundancy_step, make_train_step
from .mesh import Mesh

META = torch.device("meta")
ENC_MEMORY_LEN = 1024  # precomputed encoder memory length for decode cells

POD_FSDP_THRESHOLD = 8 * 2**30  # in-pod state bytes/chip above which ZeRO spans pods


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def make_ctx(cfg: ModelConfig, mesh: Optional[Mesh]) -> ParallelCtx:
    """Parallelism context; 400B-class state enables cross-pod FSDP (ZeRO
    over DCN) when a pod axis exists.

    The trigger uses the *within-pod* state bytes (params + 2 moments over
    data x model only): without pod-FSDP the pod axis replicates state, so
    extra pods don't relieve per-chip HBM.
    """
    if mesh is None:
        return ParallelCtx(mesh=None)
    axes = mesh.shape
    chips_in_pod = 1
    for k, v in axes.items():
        if k != "pod":
            chips_in_pod *= v
    state = (cfg.param_count() * (_itemsize(cfg.param_dtype) + 2 * _itemsize(cfg.moment_dtype))
             / chips_in_pod)
    if "pod" in axes and state > POD_FSDP_THRESHOLD:
        return ParallelCtx(mesh=mesh, fsdp_axis=("pod", "data"))
    return ParallelCtx(mesh=mesh)


def default_accum(cfg: ModelConfig, shape: ShapeConfig, mesh: Optional[Mesh]) -> int:
    """Microbatching heuristic: keep ~<=16k tokens per data-shard when the
    fp32 grad accumulator is affordable (small/mid models); big-param archs
    (accumulator >= ~4 GB/chip) run accum=1 -- their activations are small
    relative to state anyway."""
    if mesh is None or shape.kind != "train":
        return 1
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    tokens_per_ds = shape.seq_len * shape.global_batch // max(dp, 1)
    accum = max(1, tokens_per_ds // 16384)
    grad_acc_bytes = cfg.param_count() * 4 / mesh.size
    if grad_acc_bytes > 4 * 2**30:
        return 1
    while accum > 1 and (shape.global_batch // dp) % accum:
        accum -= 1
    return min(accum, 8)


def _batch_spec(mesh: Optional[Mesh], batch: int) -> Optional[P]:
    """The batch dim over the mesh's pod and data axes where they divide it
    (replicated otherwise, as in the reference); None without a mesh."""
    if mesh is None:
        return None
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    k = 1
    for a in dp:
        k *= mesh.shape[a]
    return P(dp) if batch % k == 0 else P(None)


def _meta_batch(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in batch_shapes(cfg, shape).items()}


def _meta_red(store: Optional[ProtectedStore]) -> Dict[str, LeafRedundancy]:
    """The store's redundancy arrays (global shapes) on meta."""
    if store is None:
        return {}
    return meta_red(store.red_structs())


def meta_red(structs: Dict[str, LeafRedundancy]) -> Dict[str, LeafRedundancy]:
    """Redundancy arrays on meta of the shapes of ``structs``
    (``ShapeDtype`` fields)."""
    return {n: LeafRedundancy(**{f: torch.empty(getattr(r, f).shape,
                                                dtype=getattr(r, f).dtype, device=META)
                                 for f in FIELDS})
            for n, r in structs.items()}


def _store(mode: str, mesh: Optional[Mesh], structs, specs, **policy) -> Optional[ProtectedStore]:
    """A store of ``mode`` attached to the structs on the meta device, with
    no warm-up (``precompile=False``, as in the reference's dry run)."""
    if mode == "none":
        return None
    pol = RedundancyPolicy.single(mode, precompile=False, **policy)
    meta_mesh = dataclasses.replace(mesh, device=META) if mesh is not None else None
    return ProtectedStore(pol, device=META, mesh=meta_mesh).attach(
        structs, specs=specs if mesh is not None else None)


@dataclasses.dataclass
class TrainSetup:
    model: Model
    ctx: ParallelCtx
    step_fn: Callable
    state_struct: TrainState          # meta tensors; ``red`` from the store's structs
    state_specs: Optional[TrainState]  # PartitionSpecs (None without a mesh)
    batch_struct: Dict[str, torch.Tensor]
    batch_specs: Optional[Dict[str, P]]
    store: Optional[ProtectedStore]
    fallback_log: List[str]
    redundancy_fn: Optional[Callable] = None
    accum_steps: int = 1


def build_train_setup(cfg: ModelConfig, shape: ShapeConfig, mesh: Optional[Mesh],
                      mode: str = "vilamb", period_steps: int = 8,
                      accum_steps: Optional[int] = None) -> TrainSetup:
    ctx = make_ctx(cfg, mesh)
    model = Model(cfg, META)
    params = model.init()
    opt = AdamW(lr=warmup_cosine(3e-4, 100, 10000), moment_dtype=cfg.moment_dtype)
    opt_state = opt.init(params)
    p_specs, log = param_specs(flatten_dict(params), ctx)
    prot = protected_structs(params, opt_state)
    prot_specs = {k: p_specs[k.partition("/")[2]] for k in prot}
    store = _store(mode, mesh, prot, prot_specs, period_steps=period_steps)
    state = TrainState(params=params, opt=opt_state, red=_meta_red(store), step=0)
    state_specs = None
    if mesh is not None:
        p_tree = _fill(params, p_specs)
        state_specs = TrainState(params=p_tree, opt={"m": p_tree, "v": p_tree, "count": P()},
                                 red=store.red_specs() if store is not None else {},
                                 step=P())
    batch = _meta_batch(cfg, shape)
    bspec = _batch_spec(mesh, shape.global_batch)
    if accum_steps is None:
        accum_steps = default_accum(cfg, shape, mesh)
    if accum_steps > 1:
        log.append(f"grad accumulation: {accum_steps} microbatches")
    step_fn = make_train_step(model, opt, store, accum_steps=accum_steps)
    red_fn = make_redundancy_step(store) if store is not None else None
    return TrainSetup(model, ctx, step_fn, state, state_specs, batch,
                      None if bspec is None else {k: bspec for k in batch},
                      store, log, red_fn, accum_steps)


def _fill(tree, flat_specs: Dict[str, P], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by its flat path's spec
    (empty subtrees kept)."""
    if isinstance(tree, dict):
        return {k: _fill(v, flat_specs, f"{prefix}{k}/") for k, v in tree.items()}
    return flat_specs[prefix[:-1]]


@dataclasses.dataclass
class DecodeSetup:
    model: Model
    ctx: ParallelCtx
    step_fn: Callable
    args_struct: tuple        # (params, caches, red, token, pos) on meta
    args_specs: Optional[tuple]
    store: Optional[ProtectedStore]
    fallback_log: List[str]
    cache_specs: Dict[str, P] = dataclasses.field(default_factory=dict)


def build_decode_setup(cfg: ModelConfig, shape: ShapeConfig, mesh: Optional[Mesh],
                       mode: str = "vilamb", pos: Optional[int] = None) -> DecodeSetup:
    """One token for the whole batch against a ``seq_len`` cache, written at
    ``pos`` (the cache's last position unless given)."""
    ctx = make_ctx(cfg, mesh)
    model = Model(cfg, META)
    B, S = shape.global_batch, shape.seq_len
    enc_len = ENC_MEMORY_LEN if cfg.enc_dec else 0
    params = model.init()
    p_specs, log = param_specs(flatten_dict(params), ctx)
    caches = model.init_caches(B, S, enc_len)
    flat_c = flatten_dict(caches)
    c_specs, clog = cache_specs(cfg, flat_c, ctx, B)
    log = log + clog
    store = _store(mode, mesh, model.cache_shapes(B, S, enc_len), c_specs)
    token = torch.empty((B,), dtype=torch.int32, device=META)
    args = (params, caches, _meta_red(store), token, S - 1 if pos is None else pos)
    args_specs = None
    if mesh is not None:
        args_specs = (_fill(params, p_specs),
                      _fill(caches, c_specs),
                      store.red_specs() if store is not None else {},
                      _batch_spec(mesh, B), P())
    return DecodeSetup(model, ctx, make_decode_step(model, store), args, args_specs,
                       store, log, c_specs)


@dataclasses.dataclass
class PrefillSetup:
    model: Model
    ctx: ParallelCtx
    step_fn: Callable
    args_struct: tuple        # (params, batch) on meta
    args_specs: Optional[tuple]
    fallback_log: List[str]
    out_specs: Optional[Dict[str, Any]] = None   # the prefilled caches' specs


def build_prefill_setup(cfg: ModelConfig, shape: ShapeConfig, mesh: Optional[Mesh],
                        max_len: Optional[int] = None) -> PrefillSetup:
    """The prefill of a ``seq_len`` batch into caches of ``max_len``
    positions (``seq_len`` unless given, as in the reference)."""
    ctx = make_ctx(cfg, mesh)
    model = Model(cfg, META)
    B, S = shape.global_batch, shape.seq_len
    params = model.init()
    p_specs, log = param_specs(flatten_dict(params), ctx)
    batch = _meta_batch(cfg, shape)
    args_specs = out_specs = None
    if mesh is not None:
        bspec = _batch_spec(mesh, B)
        args_specs = (_fill(params, p_specs),
                      {k: bspec for k in batch})
        # The prefilled caches land in the decode cache's layout.
        enc_len = ENC_MEMORY_LEN if cfg.enc_dec else 0
        c_specs, clog = cache_specs(cfg, flatten_dict(model.cache_shapes(B, S, enc_len)),
                                    ctx, B)
        log.extend(clog)
        out_specs = c_specs
    return PrefillSetup(model, ctx, make_prefill(model, max_len or S), (params, batch),
                        args_specs, log, out_specs)
