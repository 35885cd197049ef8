"""RedundancyEngine — the paper's contribution over torch tensors.

Modes (Table 1 of the paper):
  * ``none``   — No-Redundancy baseline.
  * ``sync``   — Pangolin-analogue: checksum+parity updated inside the step,
                 incrementally from the old/new value diff.
  * ``vilamb`` — the paper: dirty bits accumulate during steps; a periodic
                 ``redundancy_step`` (Algorithm 1) amortizes the update.

One engine owns the redundancy of a named set of leaves on one device,
the GPU unless the caller passes ``device="cpu"``; a leaf on another
device is refused.  On a CUDA device (and on the ``meta`` device, where
the dry run traces the card's path) the Algorithm-1 update of all the
engine's leaves is one launch of the fused kernel (``kernels/redundancy``),
which reads the packed dirty words itself, so there is no mask, no queue
and no host-side fit check; on the CPU the plain work queue or full
recompute of ``workqueue.py`` runs, leaf by leaf, exactly as in the
reference.  The results are bitwise identical either way.

Sharded (``mesh=`` and per-leaf ``specs=``): every redundancy array of a
leaf concatenates one array per shard, in global block space (shard
``s``'s local block ``b`` is global block ``s * n_blocks + b``, ``metas``
being the shard-local geometry), and ``meta_ck`` is one value per shard,
as the reference's ``shard_map`` programs lay them out.  Every shard lives
on the mesh's one device: the checksum, parity and fused kernels take
every shard of a leaf in one launch (a leading shard axis, or one
descriptor per shard), on the CPU their plain versions run shard by shard.
A mesh axis a leaf's spec does not use replicates its redundancy, which is
computed once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch

from ..common.device import DeviceLike, resolve_device
from ..kernels.common import xor_fold
from ..kernels.redundancy import ops as _fused
from . import bits, blocks, checksum, parity, workqueue
from .blocks import (BlockMeta, DEFAULT_LANES_PER_BLOCK, DEFAULT_STRIPE_DATA_BLOCKS,
                     ShapeDtype)
from .state import LeafRedundancy, RedundancyState

# Dirty-event sentinel: "every block of this leaf was (potentially) written".
ALL = "__all__"
DirtyEvent = Union[str, torch.Tensor]  # ALL or bool row-mask over leading axis


@dataclasses.dataclass(frozen=True)
class RedundancyConfig:
    mode: str = "vilamb"                 # none | sync | vilamb
    lanes_per_block: int = DEFAULT_LANES_PER_BLOCK
    stripe_data_blocks: int = DEFAULT_STRIPE_DATA_BLOCKS
    # CPU work-queue capacity as a fraction of each leaf's stripe count
    # (<= 0 disables; overflow falls back to the full masked recompute).
    work_queue_frac: float = workqueue.DEFAULT_QUEUE_FRAC

    def __post_init__(self):
        if self.mode not in ("none", "sync", "vilamb"):
            raise ValueError(f"unknown redundancy mode {self.mode!r}")


def _unravel(i: int, sizes) -> Tuple[int, ...]:
    """Row-major coordinates of flat index ``i`` over ``sizes``."""
    out = []
    for n in reversed(tuple(sizes)):
        i, c = divmod(i, n)
        out.append(c)
    return tuple(reversed(out))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """Per-shard local shape of a leaf under ``spec`` on ``mesh``; raises
    on a dim its axes do not divide and (KeyError) on an unknown axis."""
    if mesh is None or spec is None:
        return tuple(shape)
    out = []
    for i, dim in enumerate(shape):
        k = math.prod(mesh.shape[a] for a in _entry_axes(spec[i] if i < len(spec) else None))
        if dim % k:
            raise ValueError(f"dim {dim} not divisible by mesh axes "
                             f"{spec[i]} ({k})")
        out.append(dim // k)
    return tuple(out)


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    """``torch.cat``, with no copy of a lone part (a machine-local leaf)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _leaf_axes(spec) -> Tuple[str, ...]:
    """All mesh axes a leaf is sharded over (flattened, order of appearance)."""
    if spec is None:
        return ()
    return tuple(a for ax in spec for a in _entry_axes(ax))


def _dim_splits(shape, spec, mesh) -> Tuple[int, ...]:
    """Shards along each dim of a leaf (1 where the dim is whole)."""
    if mesh is None or spec is None:
        return (1,) * len(shape)
    return tuple(math.prod(mesh.shape[a] for a in _entry_axes(
        spec[i] if i < len(spec) else None)) for i in range(len(shape)))


class RedundancyEngine:
    """Redundancy operations for a named dict of leaves on one device."""

    def __init__(self, leaf_structs: Mapping[str, Any],
                 config: RedundancyConfig = RedundancyConfig(),
                 device: DeviceLike = None, mesh: Any = None,
                 specs: Optional[Mapping[str, Any]] = None):
        self.config = config
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device, "RedundancyEngine")
        if mesh is not None and torch.device(mesh.device) != self.device:
            raise ValueError(f"the mesh lies on {mesh.device}, the engine on "
                             f"{self.device}")
        # The meta device (the dry run) takes the card's path.
        self.use_kernels = self.device.type != "cpu"
        self.mesh = mesh
        self.specs = dict(specs or {})
        # Global leaf shapes (as handed in); the metas are shard-local.
        self.global_shapes = {name: tuple(leaf.shape)
                              for name, leaf in leaf_structs.items()}
        self._splits = {name: _dim_splits(leaf.shape, self.specs.get(name), mesh)
                        for name, leaf in leaf_structs.items()}
        self.metas: Dict[str, BlockMeta] = {
            name: blocks.make_meta(
                ShapeDtype(local_shape(leaf.shape, self.specs.get(name), mesh),
                           leaf.dtype),
                config.lanes_per_block, config.stripe_data_blocks)
            for name, leaf in leaf_structs.items()}
        # The shard of each leaf that each device (row-major over the mesh's
        # axes; one device machine-local) holds, and the first device
        # holding each shard, whose fit flag decides the shard's overflow
        # select (the reference reads a replicated shard from it).
        self._device_shard: Dict[str, List[int]] = {
            name: self._shards_by_device(name) for name in self.metas}
        self._first_device: Dict[str, List[int]] = {
            name: [shards.index(s) for s in range(self.shard_factor(name))]
            for name, shards in self._device_shard.items()}
        # Static per-leaf work-queue capacities (0 = full recompute).  The
        # fused kernel reads only dirty stripes, so it needs no queue.
        self._queue_caps = {
            name: 0 if self.use_kernels else workqueue.queue_capacity(
                meta.n_stripes, config.work_queue_frac)
            for name, meta in self.metas.items()}

    # ------------------------------------------------------------------ utils
    def shard_factor(self, name: str) -> int:
        """Number of shards a leaf's redundancy arrays concatenate (1 = local)."""
        return math.prod(self._splits[name])

    def splits(self, name: str) -> Tuple[int, ...]:
        """Shards along each dim of a leaf (1 where the dim is whole)."""
        return self._splits[name]

    def _shards_by_device(self, name: str) -> List[int]:
        """The shard of ``name`` each device holds: the row-major index of
        the device's coordinates over the leaf's axes (``[0]``
        machine-local)."""
        if self.mesh is None:
            return [0]
        axes = _leaf_axes(self.specs.get(name))
        shards = []
        for d in range(self.mesh.size):
            coords = dict(zip(self.mesh.axis_names, _unravel(d, self.mesh.sizes)))
            s = 0
            for a in axes:
                s = s * self.mesh.shape[a] + coords[a]
            shards.append(s)
        return shards

    def _mck_store(self, per_shard: torch.Tensor) -> torch.Tensor:
        """A leaf's int32[k] meta-checksums as stored: ``(k,)`` under a mesh
        (one checksum-of-checksums per shard, as the reference stores it),
        the scalar machine-local."""
        return per_shard if self.mesh is not None else per_shard.reshape(())

    def _mck_out(self, cks: torch.Tensor, name: str) -> torch.Tensor:
        """The stored meta-checksum of a leaf's checksums."""
        return self._mck_store(checksum.meta_checksum_rows(
            cks.reshape(self.shard_factor(name), self.metas[name].n_blocks)))

    def red_spec(self, name: str) -> LeafRedundancy:
        """PartitionSpecs of a leaf's redundancy arrays: dim 0 over the
        leaf's axes (``meta_ck`` too: one value per shard)."""
        from ..dist.spec import PartitionSpec
        axes = _leaf_axes(self.specs.get(name))
        s = PartitionSpec(axes if axes else None)
        return LeafRedundancy(checksums=s, parity=s, dirty=s, shadow=s, meta_ck=s)

    def red_structs(self, global_: bool = True) -> Dict[str, LeafRedundancy]:
        """Shapes of the redundancy state (``ShapeDtype`` per field): global
        (every shard's concatenated) or one shard's."""
        out = {}
        for name, meta in self.metas.items():
            k = self.shard_factor(name) if global_ else 1
            mck = (k,) if self.mesh is not None else ()

            def sd(*shape):
                return ShapeDtype(tuple(shape), torch.int32)
            out[name] = LeafRedundancy(
                checksums=sd(meta.n_blocks * k),
                parity=sd(meta.n_stripes * k, meta.lanes_per_block),
                dirty=sd(meta.n_dirty_words * k), shadow=sd(meta.n_dirty_words * k),
                meta_ck=sd(*mck))
        return out

    def _shard_red(self, name: str, r: LeafRedundancy, s: int) -> LeafRedundancy:
        """Shard ``s``'s fields of a leaf's global redundancy: views."""
        meta = self.metas[name]
        nb, ns, nw = meta.n_blocks, meta.n_stripes, meta.n_dirty_words
        return LeafRedundancy(
            checksums=r.checksums[s * nb:(s + 1) * nb],
            parity=r.parity[s * ns:(s + 1) * ns],
            dirty=r.dirty[s * nw:(s + 1) * nw], shadow=r.shadow[s * nw:(s + 1) * nw],
            meta_ck=r.meta_ck.reshape(-1)[s])

    # ------------------------------------------------------------- primitives
    def queue_capacity(self, name: str) -> int:
        """Static work-queue capacity (stripes) for a leaf; 0 = no queue."""
        return self._queue_caps[name]

    @property
    def has_queue(self) -> bool:
        return any(self._queue_caps.values())

    def _leaf(self, leaves: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
        """The leaf; raises if it lies off the engine's device (so a CUDA
        leaf never reaches the CPU work queue) or has another shape than
        the one declared."""
        leaf = leaves[name]
        if leaf.device != self.device:
            raise ValueError(f"leaf {name!r} lies on {leaf.device}, the engine "
                             f"on {self.device}")
        if self.mesh is not None and tuple(leaf.shape) != self.global_shapes[name]:
            raise ValueError(f"leaf {name!r} has shape {tuple(leaf.shape)}, "
                             f"declared {self.global_shapes[name]}")
        return leaf

    def lanes_by_shard(self, leaf: torch.Tensor, name: str) -> torch.Tensor:
        """int32 ``(k, n_blocks, L)``: every shard's lane view of a global
        leaf (see :func:`~repro_torch.core.blocks.shard_lanes`: a view of
        the leaf where it can be, a staged copy where the shards are
        strided); ``(1, n_blocks, L)`` machine-local."""
        return blocks.shard_lanes(leaf, self.metas[name], self._splits[name])

    def _lanes(self, leaves: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
        """What K1, K2 and K3 take: the leaf's ``(k, n_blocks, L)`` lanes,
        ``k = 1`` machine-local."""
        return self.lanes_by_shard(self._leaf(leaves, name), name)

    def _live_rows(self, name: str, r: LeafRedundancy) -> torch.Tensor:
        """bool[k, n_blocks]: ``dirty | shadow`` unpacked shard by shard."""
        return bits.unpack_rows(r.dirty | r.shadow, self.shard_factor(name),
                                self.metas[name].n_blocks)

    def queue_fits(self, red: RedundancyState) -> bool:
        """Host-side overflow check: do all live dirty stripes fit the
        queues?  Under a mesh each shard's count is held against the
        shard-local capacity (the queues are per shard)."""
        if not self.has_queue:
            return False
        for name, meta in self.metas.items():
            cap = self._queue_caps[name]
            if not cap:
                continue
            sd = blocks.stripe_dirty_rows(meta, self._live_rows(name, red[name]))
            if not bool((sd.sum(dim=1, dtype=torch.int32) <= cap).all()):
                return False
        return True

    def _update_leaf(self, name: str, meta: BlockMeta, lanes: torch.Tensor,
                     old: LeafRedundancy, bdirty: torch.Tensor,
                     sdirty: torch.Tensor, queued: bool):
        """Masked checksum+parity+meta refresh of one leaf on the CPU (Alg. 1
        lines 7-22): the work queue (caller guarantees the fit) or the full
        masked recompute.  The card updates a group's leaves together
        (:meth:`_alg1_card`)."""
        cap = self._queue_caps[name]
        if queued and cap:
            ids, _, _ = workqueue.compact_stripe_ids(sdirty, cap)
            return workqueue.queued_update(
                lanes, old.checksums, old.parity, old.meta_ck, bdirty, ids,
                meta.stripe_data_blocks)
        return workqueue.full_update(lanes, old.checksums, old.parity, bdirty,
                                     sdirty, meta.stripe_data_blocks)

    # -------------------------------------------------------------------- init
    def init(self, leaves: Mapping[str, torch.Tensor]) -> RedundancyState:
        """Full redundancy computation (file-creation time in the paper)."""
        out: RedundancyState = {}
        for name, meta in self.metas.items():
            lanes = self._lanes(leaves, name)
            cks = checksum.block_checksums(lanes)
            par = parity.stripe_parity(lanes, meta.stripe_data_blocks)
            words = torch.zeros((meta.n_dirty_words * self.shard_factor(name),),
                                dtype=torch.int32, device=lanes.device)
            out[name] = LeafRedundancy(
                checksums=cks, parity=par, dirty=words,
                shadow=torch.zeros_like(words), meta_ck=self._mck_out(cks, name))
        return out

    # ----------------------------------------------------------------- marking
    def mark_dirty(self, red: RedundancyState,
                   events: Mapping[str, DirtyEvent]) -> RedundancyState:
        """OR dirty events into the bitvectors.

        Events are domain-space: ``ALL`` for dense leaves, or a bool
        row-mask over the leaf's leading axes.  Under a mesh a row mask is
        sharded like the leaf's leading dims (a dim the spec leaves whole
        is replicated) and each shard marks its own local blocks from its
        part, as the reference's ``shard_map`` does.
        """
        out = dict(red)
        for name, ev in events.items():
            meta = self.metas[name]
            r = red[name]
            if isinstance(ev, str):
                if ev != ALL:
                    raise ValueError(f"{name}: unknown dirty event {ev!r}")
                mask = torch.ones((meta.n_blocks * self.shard_factor(name),),
                                  dtype=torch.bool, device=r.dirty.device)
                out[name] = dataclasses.replace(
                    r, dirty=r.dirty | bits.pack_rows(mask.view(-1, meta.n_blocks)))
            else:
                k = self.shard_factor(name)
                parts = blocks.shard_view(ev, self._splits[name][:ev.dim()])
                masks = torch.stack([self._event_mask(meta, e) for e in parts])
                if parts.shape[0] != k:
                    masks = masks.repeat_interleave(k // parts.shape[0], dim=0)
                out[name] = dataclasses.replace(r, dirty=r.dirty | bits.pack_rows(masks))
        return out

    @staticmethod
    def _event_mask(meta: BlockMeta, ev: torch.Tensor) -> torch.Tensor:
        """bool[n_blocks] of one shard's blocks a local row mask touches."""
        if (ev.dim() == 1 and len(meta.shape) >= 1 and ev.shape[0] == meta.shape[0]
                and meta.n_blocks == meta.shape[0]):
            # Fast path: rows map 1:1 to blocks (4 KiB-page heaps).
            return ev
        return blocks.row_mask_block_mask(meta, ev, row_dims=ev.dim())

    # ---------------------------------------------------- Algorithm 1 (vilamb)
    def _alg1_parts(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
                    queued: bool, want_fits: bool):
        """Shared Algorithm-1 body: per-leaf masked update.

        Lines 2-4: snapshot ``dirty | shadow`` (leftover shadow from a
        crash); lines 7-18 + 22: masked checksum + parity recompute and the
        meta-checksum.  Returns ``({name: (cks, par, meta_ck, snapshot)},
        fits)``.  On the CPU each shard of each leaf (the one shard of a
        machine-local leaf) runs the update over its local lanes and fields
        (its own queue, sized from the local stripes), and the results
        concatenate in global block space.  ``fits`` (do the live dirty
        stripes fit the work queues?) is the per-device flag vector
        (``(mesh.size,)``, row-major over the mesh's axes, ``(1,)``
        machine-local: a device's flag ANDs its shards of every queued
        leaf) when requested and some leaf has a queue, else the host value
        ``True``: the card has no queue, so it never fetches a fit signal
        from the device.
        """
        if self.use_kernels:
            return self._alg1_card(leaves, red), True
        parts: Dict[str, Tuple] = {}
        dev_fits: List[List[torch.Tensor]] = [
            [] for _ in range(self.mesh.size if self.mesh is not None else 1)]
        for name, meta in self.metas.items():
            r = red[name]
            snapshot = r.dirty | r.shadow
            lanes = self._lanes(leaves, name)
            cap = self._queue_caps[name]
            nw = meta.n_dirty_words
            out_c, out_p, out_m, shard_fits = [], [], [], []
            for s in range(self.shard_factor(name)):
                bdirty = bits.unpack(snapshot[s * nw:(s + 1) * nw], meta.n_blocks)
                sdirty = blocks.stripe_dirty_mask(meta, bdirty)
                if want_fits and cap:
                    shard_fits.append(workqueue.stripe_fits(sdirty, cap))
                c, p, m = self._update_leaf(name, meta, lanes[s], self._shard_red(name, r, s),
                                            bdirty, sdirty, queued)
                out_c.append(c)
                out_p.append(p)
                out_m.append(m.reshape(()))
            if shard_fits:
                for d, s in enumerate(self._device_shard[name]):
                    dev_fits[d].append(shard_fits[s])
            parts[name] = (_cat(out_c), _cat(out_p), self._mck_store(torch.stack(out_m)),
                           snapshot)
        if not dev_fits[0]:
            return parts, True
        return parts, torch.stack([torch.stack(f).all() for f in dev_fits])

    def _alg1_card(self, leaves: Mapping[str, torch.Tensor],
                   red: RedundancyState) -> Dict[str, Tuple]:
        """The card's Algorithm-1 body: every leaf's snapshot, then one
        fused launch over all the leaves (it reads the snapshots' packed
        words), in place on their checksums and parity, then each leaf's
        meta-checksum.  Each shard of each leaf (a machine-local leaf's one
        shard) is one job of that launch: its lanes and the views of its
        checksums, parity rows and dirty words at the shard's offsets.  A
        leaf whose shards are strided is staged into one ``(k, *local)``
        copy first, on the current stream (K3 only reads it).  Returns
        ``_alg1_parts``'s parts."""
        snaps = {name: red[name].dirty | red[name].shadow for name in self.metas}
        jobs = []
        for name, meta in self.metas.items():
            r = red[name]
            lanes = self._lanes(leaves, name)
            nw = meta.n_dirty_words
            for s in range(self.shard_factor(name)):
                rs = self._shard_red(name, r, s)
                jobs.append((lanes[s], rs.checksums, rs.parity,
                             snaps[name][s * nw:(s + 1) * nw]))
        _fused.fused_update_many(jobs, self.config.stripe_data_blocks)
        return {name: (red[name].checksums, red[name].parity,
                       self._mck_out(red[name].checksums, name), snaps[name])
                for name in self.metas}

    def _alg1(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
              queued: bool) -> RedundancyState:
        parts, _ = self._alg1_parts(leaves, red, queued, want_fits=False)
        # Lines 19-20: redundancy written, then shadow cleared.
        return {name: LeafRedundancy(
                    checksums=cks, parity=par, dirty=torch.zeros_like(snapshot),
                    shadow=torch.zeros_like(snapshot), meta_ck=meta_ck)
                for name, (cks, par, meta_ck, snapshot) in parts.items()}

    def redundancy_step(self, leaves: Mapping[str, torch.Tensor],
                        red: RedundancyState) -> RedundancyState:
        """One invocation of the paper's background update thread.

        Per leaf: snapshot dirty→shadow, clear dirty, recompute checksums of
        dirty blocks and parity of stripes containing a dirty block, clear
        shadow, refresh the meta-checksum.  On the card the checksum and
        parity tensors of ``red`` are updated in place: adopt the result
        and do not reuse ``red``.
        """
        return self._alg1(leaves, red, queued=False)

    def redundancy_step_queued(self, leaves: Mapping[str, torch.Tensor],
                               red: RedundancyState) -> RedundancyState:
        """Work-queue Algorithm 1 (CPU cost ∝ dirty stripes).  Bitwise equal
        to :meth:`redundancy_step` iff every leaf's dirty stripes fit its
        queue — check :meth:`queue_fits` first."""
        return self._alg1(leaves, red, queued=True)

    flush = redundancy_step

    def redundancy_step_async(self, leaves: Mapping[str, torch.Tensor],
                              red: RedundancyState, queued: bool = False
                              ) -> Tuple[RedundancyState, Union[bool, torch.Tensor]]:
        """Algorithm 1 for the overlapped tick: ``(red_out, fits)``.

        The same per-leaf work as :meth:`redundancy_step` /
        :meth:`redundancy_step_queued`, but valid unconditionally: ``fits``
        is the queue-fit predicate (the speculation signal for the next
        queued-vs-full choice, and the overflow flag of this one), and
        ``red_out.shadow`` is ``where(overflowed, snapshot, 0)``, so after
        a queued dispatch that overflowed every block the truncated queue
        may have missed stays marked until the full fallback runs.
        ``red_out.dirty`` is zero: the caller carries its own live epoch-B
        bitmap over.  On the card there is no queue, nothing overflows and
        ``fits`` is the host value ``True``; the checksums and parity of
        ``red`` are updated in place on the current stream.
        """
        parts, fits = self._alg1_parts(leaves, red, queued, want_fits=True)
        overflowed = ~fits if queued and isinstance(fits, torch.Tensor) else None
        out: RedundancyState = {}
        for name, (cks, par, meta_ck, snapshot) in parts.items():
            zeros = torch.zeros_like(snapshot)
            ovf = overflowed
            if ovf is not None:
                # Per shard: only shards whose device's queue overflowed
                # keep their snapshot marked.
                ovf = ovf[self._first_device[name]].repeat_interleave(
                    self.metas[name].n_dirty_words)
            out[name] = LeafRedundancy(
                checksums=cks, parity=par, dirty=torch.zeros_like(snapshot),
                shadow=zeros if ovf is None else torch.where(ovf, snapshot, zeros),
                meta_ck=meta_ck)
        return out, fits

    # ------------------------------------------------------- sync (Pangolin)
    def sync_update(self, old_leaves: Mapping[str, torch.Tensor],
                    new_leaves: Mapping[str, torch.Tensor],
                    red: RedundancyState) -> RedundancyState:
        """Pangolin-analogue inline update from the old/new diff (valid only
        when redundancy was current before the step)."""
        out: RedundancyState = {}
        for name, meta in self.metas.items():
            r = red[name]
            o = self._lanes(old_leaves, name)
            n = self._lanes(new_leaves, name)
            cks = r.checksums ^ checksum.checksum_diff(o, n)
            par = r.parity ^ parity.parity_diff(o, n, meta.stripe_data_blocks)
            out[name] = LeafRedundancy(
                checksums=cks, parity=par, dirty=r.dirty, shadow=r.shadow,
                meta_ck=self._mck_out(cks, name))
        return out

    def sync_update_rows(self, name: str, r: LeafRedundancy,
                         rows: torch.Tensor, old_rows: torch.Tensor,
                         new_rows: torch.Tensor) -> LeafRedundancy:
        """Sparse Pangolin update when rows map 1:1 to blocks.

        Cost is O(touched rows).  ``rows`` must be unique; rows sharing a
        stripe XOR-accumulate their parity deltas.  The checksum and parity
        tensors of ``r`` are updated in place.
        """
        meta = self.metas[name]
        if self.mesh is not None:
            raise ValueError(f"{name}: the row fast path is machine-local only")
        if not (len(meta.shape) >= 1 and meta.n_blocks == meta.shape[0]):
            raise ValueError(f"{name}: rows do not map 1:1 to blocks")
        S = meta.stripe_data_blocks
        old_lanes = old_rows.contiguous().view(torch.int32).reshape(old_rows.shape[0], -1)
        new_lanes = new_rows.contiguous().view(torch.int32).reshape(new_rows.shape[0], -1)
        rows = rows.to(torch.int64)
        lids = torch.arange(old_lanes.shape[1], dtype=torch.int32,
                            device=rows.device)[None, :]
        salt = checksum.lane_salt(rows[:, None], lids)
        h = checksum.fmix32_(old_lanes ^ salt)
        h ^= checksum.fmix32_(new_lanes ^ salt)
        old_cks = r.checksums[rows]
        new_cks = old_cks ^ xor_fold(h, 1)
        r.checksums[rows] = new_cks
        parity.scatter_xor_stripes(r.parity, rows // S, old_lanes ^ new_lanes)
        meta_ck = r.meta_ck ^ checksum.meta_checksum_delta(old_cks, new_cks, rows)
        return dataclasses.replace(r, meta_ck=meta_ck)

    # -------------------------------------------------------------- scrubbing
    def scrub(self, leaves: Mapping[str, torch.Tensor],
              red: RedundancyState) -> Dict[str, torch.Tensor]:
        """Per-leaf bool[n_blocks] masks of clean blocks whose fresh
        checksum differs from the stored one (paper §3.4); in global block
        space under a mesh (one checksum launch over every shard)."""
        out: Dict[str, torch.Tensor] = {}
        for name, meta in self.metas.items():
            r = red[name]
            clean = ~self._live_rows(name, r).reshape(-1)
            fresh = checksum.block_checksums(self._lanes(leaves, name))
            out[name] = clean & (fresh != r.checksums)
        return out

    def verify_window_fn(self, name: str, window: int,
                         want_slab: bool = False) -> Callable:
        """Bounded patrol probe over one leaf (the scrub patroller's core).

        Returns ``fn(leaf, r, start)``, which checksums the ``window``
        blocks at ``[start, start + window)`` of every shard and compares
        them against the stored per-block checksums, exactly like
        :meth:`scrub` but over a bounded slab: the per-tick byte budget is
        ``window * meta.bytes_per_block`` a shard.  Outputs (dim 0 the
        shard, ``k == 1`` machine-local):

        * ``mism``  bool ``(k, window)``: clean and mismatching (corrupt),
        * ``clean`` bool ``(k, window)``: outside the vulnerability window
          and inside the block range (the comparison is meaningful),
        * ``slab``  int32 ``(k, window, L)`` (only with ``want_slab``):
          the raw lanes the checksums read, for the caller to fold
          cross-shard parity from the same pass.

        Window positions past ``n_blocks`` are reported not clean (and
        their slab rows repeat the last block, as the reference clamps).
        On the card the window's fresh checksums are one launch of the
        checksum kernel over every shard with ``block_offset=start``; the
        lanes (:func:`~repro_torch.core.blocks.shard_window_lanes`) are the
        leaf's own memory for row-range shards (the kernel steps from one
        shard's window to the next), a copy of the window alone, ``k *
        window`` blocks, where the shards are strided or the window holds
        a partial last block.  The slab is those lanes: a view of a leaf
        the foreground rewrites in place, so a caller reads it on this
        stream, before the next write.  Nothing here waits for the device.
        """
        meta = self.metas[name]
        nb, L = meta.n_blocks, meta.lanes_per_block
        k = self.shard_factor(name)
        nw = meta.n_dirty_words

        def fn(leaf: torch.Tensor, r: LeafRedundancy, start: int):
            leaf = self._leaf({name: leaf}, name)
            start = int(start)
            n = max(0, min(window, nb - start))
            lanes = blocks.shard_window_lanes(leaf, meta, self._splits[name], start, n)
            fresh = checksum.block_checksums(lanes, block_offset=start).view(k, n)
            w0, w1 = start // bits.WORD_BITS, -(-(start + n) // bits.WORD_BITS)
            live_w = r.dirty.view(k, nw)[:, w0:w1] | r.shadow.view(k, nw)[:, w0:w1]
            off = start - w0 * bits.WORD_BITS
            live = bits.unpack_rows(live_w, k, (w1 - w0) * bits.WORD_BITS)
            clean = ~live[:, off:off + n]
            mism = clean & (fresh != r.checksums.view(k, nb)[:, start:start + n])
            if n < window:
                pad = torch.zeros((k, window - n), dtype=torch.bool, device=leaf.device)
                clean, mism = torch.cat([clean, pad], 1), torch.cat([mism, pad], 1)
            if not want_slab:
                return mism, clean
            if n < window:
                last = blocks.shard_window_lanes(leaf, meta, self._splits[name], nb - 1, 1)
                lanes = torch.cat([lanes, last.expand(k, window - n, L)], 1)
            return mism, clean, lanes

        return fn

    def live_words_fn(self, name: str) -> Callable:
        """``fn(r) -> dirty | shadow`` for one leaf: the patroller's
        per-tick write sample (every shard's packed words, shard after
        shard)."""
        def fn(r: LeafRedundancy) -> torch.Tensor:
            return r.dirty | r.shadow
        return fn

    def shard_lanes_fn(self, name: str) -> Callable:
        """``fn(leaf) -> int32 (k, n_blocks, L)``: every shard's lane view
        (:meth:`lanes_by_shard`, a view of the leaf for exact row-range
        shards), the cross-shard parity primitive: XOR-folding it over dim
        0 gives one parity row per local block covering the same-indexed
        block of every shard.  ``(1, n_blocks, L)`` machine-local."""
        def fn(leaf: torch.Tensor) -> torch.Tensor:
            return self.lanes_by_shard(self._leaf({name: leaf}, name), name)
        return fn

    def verify_meta(self, red: RedundancyState) -> Dict[str, torch.Tensor]:
        """Check the checksum-of-checksums (detects corrupted checksum
        pages).  Under a mesh each shard's checksums are held against its
        own ``meta_ck`` entry and the leaf's result is the AND over its
        shards."""
        return {name: (self._mck_out(r.checksums, name) == r.meta_ck).all()
                for name, r in red.items() if name in self.metas}

    # --------------------------------------------------------------- recovery
    def recover_block(self, leaf: torch.Tensor, r: LeafRedundancy, name: str,
                      block_id: int) -> Tuple[torch.Tensor, bool]:
        """Reconstruct one corrupted block from its stripe, **in place**.

        Returns ``(leaf, ok)``: the repaired block is written into
        ``leaf``'s own memory (the reference returns a new array; a copy of
        a multi-GiB leaf is what this avoids), and ``leaf`` itself is
        returned.  A machine-local leaf whose lane view is a padded copy is
        rebuilt into a new tensor instead.  ``ok`` is False — and nothing
        is written — when the stripe is vulnerable (any *other* member
        dirty or shadow-set), the paper's §3.3 recoverability rule.

        ``block_id`` is in global block space; under a mesh it addresses
        shard ``block_id // n_blocks``, whose rows are rebuilt in place
        (dim0 sharding only: :func:`~repro_torch.core.blocks.shard_slice`
        raises the reference's ``ValueError`` for other specs).
        """
        meta = self.metas[name]
        k = self.shard_factor(name)
        block_id = int(block_id)
        P = meta.stripe_data_blocks
        par_row = r.parity[blocks.global_stripe_id(meta, block_id)]
        shard, block_id = divmod(block_id, meta.n_blocks)
        if not 0 <= shard < k:
            raise ValueError(f"{name}: global block {shard * meta.n_blocks + block_id} "
                             f"addresses shard {shard} of {k}")
        sub, put = blocks.shard_slice(leaf, meta, k, shard)
        nw = meta.n_dirty_words
        live = bits.unpack((r.dirty | r.shadow)[shard * nw:(shard + 1) * nw],
                           meta.n_blocks)
        sid = block_id // P
        members = [b for b in range(sid * P, (sid + 1) * P)
                   if b < meta.n_blocks and b != block_id]
        others_clean = not bool(live[members].any()) if members else True
        if not others_clean:
            return leaf, False
        if sub.device != self.device:
            raise ValueError(f"leaf {name!r} lies on {sub.device}, the engine "
                             f"on {self.device}")
        lanes = blocks.to_lanes(sub, meta)
        lanes[block_id] = parity.reconstruct_block(lanes, par_row, P, block_id, sid)
        if lanes.data_ptr() != sub.data_ptr():
            sub = blocks.from_lanes(lanes, meta).clone()
        return put(sub), True

    # ------------------------------------------------------------- accounting
    def vulnerable_masks(self, red: RedundancyState) -> Dict[str, torch.Tensor]:
        """Per-leaf bool[n_blocks] of blocks inside the vulnerability window
        (``dirty | shadow`` unpacked; in global block space under a mesh)."""
        return {name: self._live_rows(name, red[name]).reshape(-1)
                for name in self.metas}

    def dirty_stats(self, red: RedundancyState) -> Dict[str, Dict[str, Any]]:
        """Dirty/vulnerable-stripe counts (feeds §4.7 battery + §4.8 MTTDL).
        Totals are global (local geometry x shard count)."""
        out = {}
        for name, meta in self.metas.items():
            k = self.shard_factor(name)
            bdirty = self._live_rows(name, red[name])
            out[name] = {
                "dirty_blocks": bdirty.sum(dtype=torch.int32),
                "vulnerable_stripes": blocks.stripe_dirty_rows(meta, bdirty).sum(
                    dtype=torch.int32),
                "total_blocks": meta.n_blocks * k,
                "total_stripes": meta.n_stripes * k,
            }
        return out
