"""Incremental re-striping of protected state onto a new mesh.

The port of ``repro.remesh.migrate``.  Real deployments resize: a pod
gains devices (grow) or loses a rack (shrink).  Re-attaching the store on
the new mesh would stop the world for a full-leaf redundancy recompute;
this module migrates **online** instead, with the bounded-window
discipline of the online shard rebuild (:mod:`repro_torch.scrub.rebuild`):

1. **Start** (one tick): the new geometry's engines, and zeroed
   redundancy in the new layout.  Zeros are safe capital: Algorithm 1
   recomputes the checksums of dirty blocks and the parity of dirty
   stripes from the data, so the windows fill the arrays in without ever
   reading the zeros as truth.  ``meta_ck`` starts as the
   checksum-of-checksums of the zero page, consistent by construction and
   kept so by every window's update.  Every shard of a leaf lives on the
   mesh's one device, and the port keeps each leaf as its global tensor
   (the shards are views or staged copies cut at each launch), so no data
   moves: the "moved" leaves are the caller's own tensors, surfaced on
   ``TickReport.repaired`` as the reference's moved arrays are.
2. **Migrate** (bounded ticks): a cursor walks each leaf's new *local*
   block space; each tick marks one window of ``remesh_bytes_per_tick``
   bytes dirty in the new bitvectors of every shard and runs the new
   engine's Algorithm 1 over it, on the current stream (after the
   foreground's writes).  On the card that is one launch of the fused
   kernel over the window's stripes of every shard of every leaf of the
   group; on the CPU the work queue where the window fits it and the full
   recompute otherwise (``RemeshStatus.overflowed``; the card has no
   queue, so there it stays 0).  Ticks: ``max over leaves of
   ceil(n_blocks / window)``.
3. **Adopt** (the tick the last window lands): the OLD redundancy, frozen
   during the migration except for ``on_write`` marks and so the truth a
   crash restores throughout, is read once, and every old ``dirty |
   shadow`` mark is translated into new-geometry dirty marks
   (:func:`translate_words`), so writes that raced the migration re-enter
   the normal pipeline.  Rows the old cross-shard parity could not vouch
   quiescent at the start (``xvalid`` False) are re-marked too
   (``RemeshStatus.xpar_seeded`` counts the rows it vouched for).  Then
   the store swaps wholesale: mesh, engines and groups (their freshness
   clocks carried), and a **fresh patroller** under a bumped
   ``geometry_version``: cross-shard parity folded across the old shard
   count means nothing on the new one, so old images are dropped.

A crash before adoption persists the leaves and the old redundancy, and a
restart recovers on the old mesh as if no remesh had been asked for.  The
``remesh_migrate`` crash phase fires after every window with that old view.

Marks translate through the one space both geometries share: each block's
true global position.  For shards that are row ranges of dim 0 filling
their blocks exactly, global block ``s * n_blocks + b`` covers the global
words ``[(s * n_blocks + b) * L, ... + L)``, the reference's formula; for
any other split (a KV cache under ``cache_specs`` is split over batch and
KV heads) the port maps each old block's elements to their global
positions and on to the new blocks that hold them, where the reference
applies the row-range formula and so re-marks the wrong new blocks (ROADMAP
Queue 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..common.device import to_device
from ..core import bits, blocks, checksum
from ..core.blocks import BlockMeta, ShapeDtype, make_meta
from ..core.engine import RedundancyEngine, local_shape
from ..core.state import LeafRedundancy


class RemeshError(RuntimeError):
    """Base class for elastic-remesh failures."""


class RemeshInProgressError(RemeshError):
    """A remesh is already queued or migrating."""


class RemeshGeometryError(RemeshError):
    """The requested mesh cannot host the attached leaves (uneven split,
    unknown axis, missing mesh, or an unsupported group mode)."""


@dataclasses.dataclass
class RemeshStatus:
    """Progress of one elastic remesh (surfaced on ``TickReport.remesh``).

    ``total_blocks`` and ``migrated`` count new-geometry *local* blocks
    (each window covers the same local range on every new shard);
    ``overflowed`` counts windows whose marks missed the CPU work queue (the
    full recompute ran; always 0 on the card, which has no queue);
    ``xpar_seeded`` counts the old cross-shard parity rows that vouched
    quiescence at the start."""
    from_shape: Tuple[int, ...]
    to_shape: Tuple[int, ...]
    total_blocks: int
    started_step: int
    migrated: int = 0
    xpar_seeded: int = 0
    ticks: int = 0
    overflowed: int = 0
    done: bool = False


def validate_remesh(store, new_mesh, specs: Mapping[str, Any]) -> None:
    """Check before queueing: every attached leaf must split evenly onto
    ``new_mesh`` under its spec, the mesh must lie on the store's device,
    and every protected group must be a mode the migration supports
    (``vilamb`` or ``none``: ``sync`` keeps its redundancy inline with the
    writes and has no frozen old geometry to migrate from)."""
    if new_mesh is None or store.mesh is None:
        raise RemeshGeometryError(
            "elastic remesh needs a mesh on both sides (store.mesh and "
            "new_mesh); use attach() for machine-local stores")
    if torch.device(new_mesh.device) != store.device:
        raise RemeshGeometryError(
            f"the new mesh lies on {new_mesh.device}, the store on {store.device}")
    for g in store.groups.values():
        if g.policy.mode == "sync":
            raise RemeshGeometryError(
                f"group {g.label}: sync-mode leaves cannot remesh online "
                "(inline redundancy has no frozen-old-geometry window)")
    structs = store._structs
    if not structs:
        raise RemeshGeometryError("store has no attached leaves to remesh")
    for name, st in structs.items():
        spec = specs.get(name)
        try:
            local_shape(st.shape, spec, new_mesh)
        except (ValueError, KeyError, AssertionError) as e:
            raise RemeshGeometryError(
                f"{name}: shape {tuple(st.shape)} does not re-stripe onto "
                f"mesh {new_mesh.shape} under spec {spec} ({e})") from e


def translate_marks(old_mask: np.ndarray, old_lanes_per_block: int,
                    new_lanes_per_block: int, new_n_blocks: int,
                    new_k: int) -> np.ndarray:
    """Translate per-block marks between block geometries through global
    uint32 words of the flattened leaf, the reference's formula (exact for
    row-range shards of dim 0 that fill their blocks).

    ``old_mask`` is bool ``(k_old, nb_old)``; old shard ``s`` local block
    ``b`` covers global words ``[(s*nb_old + b) * L_old, ... + L_old)``.
    Returns bool ``(new_k, new_n_blocks)`` marking every new block whose
    word range meets a marked old block (a partial overlap marks the whole
    new block).  The reference loops over the marked blocks in Python;
    here one difference array covers them all, with the same output.
    The adoption does not call it (:func:`translate_words` computes the
    same marks on the device); it is kept as the reference's host
    function."""
    old_mask = np.asarray(old_mask, bool)
    size = new_k * new_n_blocks
    gb = np.flatnonzero(old_mask.reshape(-1))
    if not gb.size:
        return np.zeros((new_k, new_n_blocks), bool)
    if int(old_lanes_per_block) == int(new_lanes_per_block):
        b0 = np.minimum(gb, size)             # block g covers new block g alone
        b1 = np.minimum(gb + 1, size)
    else:
        w0 = gb.astype(np.int64) * int(old_lanes_per_block)
        b0 = np.clip(w0 // int(new_lanes_per_block), 0, size)
        b1 = np.clip(-(-(w0 + int(old_lanes_per_block)) // int(new_lanes_per_block)), 0, size)
    diff = np.bincount(b0, minlength=size + 1) - np.bincount(b1, minlength=size + 1)
    return (np.cumsum(diff[:-1]) > 0).reshape(new_k, new_n_blocks)


def _fills_rows(meta: BlockMeta, splits) -> bool:
    """Are the shards row ranges of dim 0 that fill their blocks exactly
    (so global block ``s * n_blocks + b`` is global words ``[(s *
    n_blocks + b) * L, ...)``)?"""
    return (not blocks.is_strided(splits)
            and meta.n_elems == meta.padded_lanes * meta.elems_per_word)


def _unshard(parts: torch.Tensor, splits, shape) -> torch.Tensor:
    """Inverse of :func:`~repro_torch.core.blocks.shard_view`: the global
    tensor of ``shape`` from its ``(k, *local)`` shards."""
    nd = len(shape)
    splits = tuple(splits) + (1,) * (nd - len(splits))
    local = tuple(d // s for d, s in zip(shape, splits))
    x = parts.reshape(splits + local)
    order = [i for d in range(nd) for i in (d, nd + d)]
    return x.permute(order).reshape(shape)


def translate_marks_global(old_mask: torch.Tensor, shape, old_meta: BlockMeta,
                           old_splits, new_meta: BlockMeta,
                           new_splits) -> torch.Tensor:
    """Translate per-block marks through each block's true global position:
    bool ``(k_old, nb_old)`` -> bool ``(k_new, nb_new)`` marking every new
    block that holds an element of a marked old block (exact; a partial
    overlap marks the whole new block).  Valid for any split; one pass
    over a bool of the leaf's global shape, on ``old_mask``'s device."""
    per_old = old_meta.lanes_per_block * old_meta.elems_per_word
    el = old_mask.repeat_interleave(per_old, dim=1)[:, :old_meta.n_elems]
    glob = _unshard(el, old_splits, tuple(shape))
    k_new = math.prod(new_splits)
    per_new = new_meta.lanes_per_block * new_meta.elems_per_word
    parts = blocks.shard_view(glob, new_splits).reshape(k_new, -1)
    padded = torch.zeros((k_new, new_meta.n_blocks * per_new), dtype=torch.bool,
                         device=old_mask.device)
    padded[:, :new_meta.n_elems] = parts
    return padded.view(k_new, new_meta.n_blocks, per_new).any(dim=2)


def translate_words(words: torch.Tensor, shape, old_meta: BlockMeta, old_splits,
                    new_meta: BlockMeta, new_splits,
                    stale: Optional[np.ndarray] = None) -> torch.Tensor:
    """The new geometry's packed dirty words of one leaf from the old
    geometry's live words (``dirty | shadow``, every shard's, on the
    device), with ``stale`` (bool ``(nb_old,)``: local rows the old
    cross-shard parity did not vouch for) marked on every old shard.
    Nothing leaves the device.

    Where both geometries are row ranges of dim 0 filling their blocks
    with the same lanes a block, old global block ``g`` is new global
    block ``g`` (:func:`translate_marks` is the identity): the marks are
    unpacked, regrouped into the new shards and packed again.  Any other
    split goes through :func:`translate_marks_global`."""
    k_old, k_new = math.prod(old_splits), math.prod(new_splits)
    if stale is not None and stale.any():
        row = bits.pack_mask_np(stale, old_meta.n_dirty_words).view(np.int32)
        words = words.view(k_old, -1) | to_device(row, words.device)[None]
    live = bits.unpack_rows(words, k_old, old_meta.n_blocks)
    if (_fills_rows(old_meta, old_splits) and _fills_rows(new_meta, new_splits)
            and old_meta.lanes_per_block == new_meta.lanes_per_block):
        return bits.pack_rows(live.reshape(k_new, new_meta.n_blocks))
    return bits.pack_rows(translate_marks_global(live, shape, old_meta, old_splits,
                                                 new_meta, new_splits))


def _window_words(meta: BlockMeta, start: int, wb: int,
                  device: torch.device) -> torch.Tensor:
    """int32 ``(n_dirty_words,)``: blocks ``[start, start + wb)`` packed,
    built on ``device`` (no host copy)."""
    ids = torch.arange(meta.n_blocks, device=device)
    return bits.pack_rows(((ids >= start) & (ids < start + wb))[None])


class RemeshMigrator:
    """One mesh geometry change in progress, paced over ticks.

    Construction builds the new engines and the zeroed new-geometry
    redundancy, which the migrator alone holds (and, on the card, the
    fused kernel rewrites in place) until adoption.  Each
    :meth:`step_once` marks one bounded window dirty in the new bitvectors
    and runs the new engine's Algorithm 1; :meth:`adopt` hands over.
    """

    def __init__(self, store, new_mesh, new_specs: Mapping[str, Any],
                 leaves: Mapping[str, torch.Tensor], red, step: int):
        self.store = store
        self.new_mesh = new_mesh
        self.new_specs = dict(new_specs)
        pol = store.policy
        dev = store.device

        # New-geometry engines, one a protected group (the group's config;
        # only the mesh and the specs change).
        self.new_engines: Dict[str, RedundancyEngine] = {}
        for g in store._protected():
            self.new_engines[g.label] = RedundancyEngine(
                {n: store._structs[n] for n in g.names}, g.engine.config,
                device=dev, mesh=new_mesh,
                specs={n: self.new_specs[n] for n in g.names if n in self.new_specs})

        # The leaves, as they are: every shard lives on the one device.
        self.moved: Dict[str, torch.Tensor] = {
            name: leaves[name] for name in store._structs if name in leaves}

        # Zeroed new redundancy; meta_ck seeds as the checksum-of-checksums
        # of the zero page.
        self.new_red: Dict[str, LeafRedundancy] = {}
        budget = (int(pol.remesh_bytes_per_tick)
                  or 4 * int(pol.patrol_bytes_per_tick))
        self.wb: Dict[str, int] = {}
        self.cur: Dict[str, int] = {}
        self.done_mask: Dict[str, np.ndarray] = {}
        total = 0
        for eng in self.new_engines.values():
            for name, meta in eng.metas.items():
                kn = eng.shard_factor(name)
                nb = meta.n_blocks
                ck0 = checksum.meta_checksum(torch.zeros((nb,), dtype=torch.int32, device=dev))
                words = torch.zeros((meta.n_dirty_words * kn,), dtype=torch.int32, device=dev)
                self.new_red[name] = LeafRedundancy(
                    checksums=torch.zeros((nb * kn,), dtype=torch.int32, device=dev),
                    parity=torch.zeros((meta.n_stripes * kn, meta.lanes_per_block),
                                       dtype=torch.int32, device=dev),
                    dirty=words, shadow=torch.zeros_like(words),
                    meta_ck=ck0.reshape(1).repeat(kn))
                self.wb[name] = (max(1, min(nb, budget // max(1, meta.bytes_per_block)))
                                 if budget else nb)
                self.cur[name] = 0
                self.done_mask[name] = np.zeros((nb,), bool)
                total += nb

        # Freshness seed from the old cross-shard parity: rows it vouched
        # quiescent at the start need no conservative re-mark at adoption.
        self._stale0: Dict[str, np.ndarray] = {}
        seeded = 0
        pat = store.patroller
        if pat is not None:
            for name, xp in pat.xpar.items():
                if name in self.new_red and xp.xvalid is not None:
                    self._stale0[name] = ~np.asarray(xp.xvalid, bool)
                    seeded += int(np.asarray(xp.xvalid).sum())

        self.status = RemeshStatus(
            from_shape=tuple(store.mesh.sizes), to_shape=tuple(new_mesh.sizes),
            total_blocks=total, started_step=int(step), xpar_seeded=seeded)

    # ------------------------------------------------------------------ tick
    def step_once(self, leaves, out, report, step: Optional[int]) -> None:
        """Mark and update one bounded window a leaf still migrating; fires
        the ``remesh_migrate`` crash phase with the OLD live view, still
        the truth.  ``step`` is None from a stepless drain; the phase then
        omits it, so the crash machine's counter fills it in."""
        self.status.ticks += 1
        marks: Dict[str, Dict[str, Tuple[int, int]]] = {}
        for label, eng in self.new_engines.items():
            for name, meta in eng.metas.items():
                nb = meta.n_blocks
                if self.cur[name] >= nb:
                    continue
                wb = self.wb[name]
                start = min(self.cur[name], max(0, nb - wb))
                done = self.done_mask[name][start:start + wb]
                self.status.migrated += int((~done).sum())
                done[:] = True
                marks.setdefault(label, {})[name] = (start, wb)
                self.cur[name] = start + wb
        for label, wmap in marks.items():
            eng = self.new_engines[label]
            names = tuple(eng.metas)
            red_sub = {n: self.new_red[n] for n in names}
            for n, (start, wb) in wmap.items():
                # The same local window on every shard: a plain OR into
                # each shard's packed words.
                meta, r = eng.metas[n], red_sub[n]
                w = _window_words(meta, start, wb, r.dirty.device)
                red_sub[n] = dataclasses.replace(
                    r, dirty=(r.dirty.view(-1, meta.n_dirty_words) | w).reshape(-1))
            queued = eng.has_queue and eng.queue_fits(red_sub)
            if eng.has_queue and not queued:
                self.status.overflowed += 1
            update = eng.redundancy_step_queued if queued else eng.redundancy_step
            self.new_red.update(update({n: leaves[n] for n in names}, red_sub))
        if all(self.cur[n] >= eng.metas[n].n_blocks
               for eng in self.new_engines.values() for n in eng.metas):
            self.status.done = True
        report.remesh = self.status
        self.store._phase("remesh_migrate", red=dict(out),
                          **({} if step is None else {"step": int(step)}),
                          migrated=self.status.migrated, ticks=self.status.ticks)

    # ------------------------------------------------------------- adoption
    def adopt(self, out, report) -> None:
        """Wholesale handover: translate the old live marks into new dirty
        marks; swap the mesh, the specs, the engines and groups (freshness
        clocks carried); bump ``geometry_version``; build the patroller
        fresh; and replace ``out``'s entries with the new-geometry
        redundancy."""
        from ..core.store import _Group
        store = self.store
        for g in store._protected():
            old_eng = g.engine
            new_eng = self.new_engines[g.label]
            for name in g.names:
                r_old = out[name]
                words = translate_words(
                    r_old.dirty | r_old.shadow, store._structs[name].shape,
                    old_eng.metas[name], old_eng.splits(name), new_eng.metas[name],
                    new_eng.splits(name), self._stale0.get(name))
                self.new_red[name] = dataclasses.replace(self.new_red[name], dirty=words)
        store.mesh = self.new_mesh
        store._specs = dict(self.new_specs)
        groups = {}
        for label, g in store.groups.items():
            eng = self.new_engines.get(label) if g.engine is not None else None
            # The freshness clocks carry over: the deadline counts from the
            # oldest unprotected write, and the migration moved no
            # redundancy for the writes made since its start.
            groups[label] = _Group(label, g.policy, g.names, eng,
                                   last_update_step=g.last_update_step,
                                   last_update_time=g.last_update_time)
        store.groups = groups
        for n in list(store._none_metas):
            st = store._structs[n]
            store._none_metas[n] = make_meta(
                ShapeDtype(local_shape(st.shape, self.new_specs.get(n), self.new_mesh),
                           st.dtype),
                lanes_per_block=store.policy.lanes_per_block,
                stripe_data_blocks=store.policy.stripe_data_blocks)
        store.geometry_version += 1
        store.patroller = None
        if store.policy.patrol_bytes_per_tick > 0 and any(
                g.policy.mode == "vilamb" for g in store._protected()):
            from ..scrub import ScrubPatroller
            store.patroller = ScrubPatroller(store)
        out.update(self.new_red)
        report.remesh = self.status
