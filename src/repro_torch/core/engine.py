"""RedundancyEngine — the paper's contribution over torch tensors.

Modes (Table 1 of the paper):
  * ``none``   — No-Redundancy baseline.
  * ``sync``   — Pangolin-analogue: checksum+parity updated inside the step,
                 incrementally from the old/new value diff.
  * ``vilamb`` — the paper: dirty bits accumulate during steps; a periodic
                 ``redundancy_step`` (Algorithm 1) amortizes the update.

Machine-local: one engine owns the redundancy of a named set of leaves on
one device, the GPU unless the caller passes ``device="cpu"``; a leaf on
another device is refused.  On a CUDA device the Algorithm-1 update of
all the engine's leaves is one launch of the fused kernel
(``kernels/redundancy``), which reads the packed dirty words itself, so
there is no mask, no queue and no host-side fit check; on the CPU the
plain work queue or full recompute of ``workqueue.py`` runs, leaf by leaf,
exactly as in the reference.  The results are bitwise identical either
way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple, Union

import torch

from ..common.device import DeviceLike, resolve_device
from ..kernels.common import xor_fold
from ..kernels.redundancy import ops as _fused
from . import bits, blocks, checksum, parity, workqueue
from .blocks import BlockMeta, DEFAULT_LANES_PER_BLOCK, DEFAULT_STRIPE_DATA_BLOCKS
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


class RedundancyEngine:
    """Redundancy operations for a named dict of leaves on one device."""

    def __init__(self, leaf_structs: Mapping[str, Any],
                 config: RedundancyConfig = RedundancyConfig(),
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device, "RedundancyEngine")
        self.use_kernels = self.device.type == "cuda"
        self.metas: Dict[str, BlockMeta] = {
            name: blocks.make_meta(leaf, config.lanes_per_block,
                                   config.stripe_data_blocks)
            for name, leaf in leaf_structs.items()}
        # Static per-leaf work-queue capacities (0 = full recompute).  The
        # fused kernel reads only dirty stripes, so it needs no queue.
        self._queue_caps = {
            name: 0 if self.use_kernels else workqueue.queue_capacity(
                meta.n_stripes, config.work_queue_frac)
            for name, meta in self.metas.items()}

    # ------------------------------------------------------------- primitives
    def queue_capacity(self, name: str) -> int:
        """Static work-queue capacity (stripes) for a leaf; 0 = no queue."""
        return self._queue_caps[name]

    @property
    def has_queue(self) -> bool:
        return any(self._queue_caps.values())

    def _lanes(self, leaves: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
        """The leaf's lane view.  Raises if the leaf lies off the engine's
        device, so a CUDA leaf never reaches the CPU work queue."""
        leaf = leaves[name]
        if leaf.device != self.device:
            raise ValueError(f"leaf {name!r} lies on {leaf.device}, the engine "
                             f"on {self.device}")
        return blocks.to_lanes(leaf, self.metas[name])

    def _stripe_dirty(self, meta: BlockMeta, bdirty: torch.Tensor) -> torch.Tensor:
        return blocks.stripe_dirty_mask(meta, bdirty)

    def queue_fits(self, red: RedundancyState) -> bool:
        """Host-side overflow check: do all live dirty stripes fit the queues?"""
        if not self.has_queue:
            return False
        for name, meta in self.metas.items():
            cap = self._queue_caps[name]
            if not cap:
                continue
            r = red[name]
            bd = bits.unpack(r.dirty | r.shadow, meta.n_blocks)
            if not bool(workqueue.stripe_fits(self._stripe_dirty(meta, bd), cap)):
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
            words = bits.zeros(meta.n_blocks, lanes.device)
            out[name] = LeafRedundancy(
                checksums=cks, parity=par, dirty=words,
                shadow=torch.zeros_like(words),
                meta_ck=checksum.meta_checksum(cks))
        return out

    # ----------------------------------------------------------------- marking
    def mark_dirty(self, red: RedundancyState,
                   events: Mapping[str, DirtyEvent]) -> RedundancyState:
        """OR dirty events into the bitvectors.

        Events are domain-space: ``ALL`` for dense leaves, or a bool
        row-mask over the leaf's leading axes.
        """
        out = dict(red)
        for name, ev in events.items():
            meta = self.metas[name]
            r = red[name]
            if isinstance(ev, str):
                if ev != ALL:
                    raise ValueError(f"{name}: unknown dirty event {ev!r}")
                mask = torch.ones((meta.n_blocks,), dtype=torch.bool,
                                  device=r.dirty.device)
            elif (ev.dim() == 1 and len(meta.shape) >= 1
                  and ev.shape[0] == meta.shape[0]
                  and meta.n_blocks == meta.shape[0]):
                # Fast path: rows map 1:1 to blocks (4 KiB-page heaps).
                mask = ev
            else:
                mask = blocks.row_mask_block_mask(meta, ev, row_dims=ev.dim())
            out[name] = dataclasses.replace(r, dirty=bits.mark(r.dirty, mask))
        return out

    # ---------------------------------------------------- Algorithm 1 (vilamb)
    def _alg1_parts(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
                    queued: bool, want_fits: bool):
        """Shared Algorithm-1 body: per-leaf masked update.

        Lines 2-4: snapshot ``dirty | shadow`` (leftover shadow from a
        crash); lines 7-18 + 22: masked checksum + parity recompute and the
        meta-checksum.  Returns ``({name: (cks, par, meta_ck, snapshot)},
        fits)``; ``fits`` (do all live dirty stripes fit the CPU work
        queues?) is a bool tensor when requested and some leaf has a queue,
        else the host value ``True``: the card has no queue, so it never
        fetches a fit signal from the device.
        """
        if self.use_kernels:
            return self._alg1_card(leaves, red), True
        parts: Dict[str, Tuple] = {}
        fits = []
        for name, meta in self.metas.items():
            r = red[name]
            snapshot = r.dirty | r.shadow
            bdirty = bits.unpack(snapshot, meta.n_blocks)
            sdirty = self._stripe_dirty(meta, bdirty)
            cap = self._queue_caps[name]
            if want_fits and cap:
                fits.append(workqueue.stripe_fits(sdirty, cap))
            lanes = self._lanes(leaves, name)
            cks, par, meta_ck = self._update_leaf(name, meta, lanes, r, bdirty,
                                                  sdirty, queued)
            parts[name] = (cks, par, meta_ck, snapshot)
        return parts, (torch.stack(fits).all() if fits else True)

    def _alg1_card(self, leaves: Mapping[str, torch.Tensor],
                   red: RedundancyState) -> Dict[str, Tuple]:
        """The card's Algorithm-1 body: every leaf's snapshot, then one
        fused launch over all the leaves (it reads the snapshots' packed
        words), in place on their checksums and parity, then each leaf's
        meta-checksum.  Returns ``_alg1_parts``'s parts."""
        snaps = {name: red[name].dirty | red[name].shadow for name in self.metas}
        _fused.fused_update_many(
            [(self._lanes(leaves, name), red[name].checksums, red[name].parity,
              snaps[name]) for name in self.metas],
            self.config.stripe_data_blocks)
        return {name: (red[name].checksums, red[name].parity,
                       checksum.meta_checksum(red[name].checksums), snaps[name])
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
            out[name] = LeafRedundancy(
                checksums=cks, parity=par, dirty=torch.zeros_like(snapshot),
                shadow=zeros if overflowed is None
                else torch.where(overflowed, snapshot, zeros),
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
                meta_ck=checksum.meta_checksum(cks))
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
        checksum differs from the stored one (paper §3.4)."""
        out: Dict[str, torch.Tensor] = {}
        for name, meta in self.metas.items():
            r = red[name]
            clean = ~bits.unpack(r.dirty | r.shadow, meta.n_blocks)
            fresh = checksum.block_checksums(self._lanes(leaves, name))
            out[name] = clean & (fresh != r.checksums)
        return out

    def verify_window_fn(self, name: str, window: int,
                         want_slab: bool = False) -> Callable:
        """Bounded patrol probe over one leaf (the scrub patroller's core).

        Returns ``fn(leaf, r, start)``, which checksums the ``window``
        blocks at ``[start, start + window)`` and compares them against the
        stored per-block checksums, exactly like :meth:`scrub` but over a
        bounded slab: the per-tick byte budget is ``window *
        meta.bytes_per_block``.  Outputs, machine-local (``k == 1``):

        * ``mism``  bool ``(1, window)``: clean and mismatching (corrupt),
        * ``clean`` bool ``(1, window)``: outside the vulnerability window
          and inside the block range (the comparison is meaningful).

        Window positions past ``n_blocks`` are reported not clean.  On the
        card the window's fresh checksums are one launch of the checksum
        kernel over the window's lanes with ``block_offset=start``; the
        lanes are a row slice of the leaf's own memory
        (:func:`~repro_torch.core.blocks.window_lanes`), padded only where
        the window holds a partial last block.  Nothing here waits for the
        device.  ``want_slab`` (the raw lanes, for cross-shard parity) is
        not ported.
        """
        if want_slab:
            raise NotImplementedError(
                "the probe's slab feeds cross-shard parity, which is not ported "
                "yet: ROADMAP.md, Queue 1 item 11.4 (xpar and shard rebuild)")
        meta = self.metas[name]
        nb = meta.n_blocks

        def fn(leaf: torch.Tensor, r: LeafRedundancy, start: int):
            if leaf.device != self.device:
                raise ValueError(f"leaf {name!r} lies on {leaf.device}, the "
                                 f"engine on {self.device}")
            start = int(start)
            n = max(0, min(window, nb - start))
            fresh = checksum.block_checksums(
                blocks.window_lanes(leaf, meta, start, n), block_offset=start)
            w0, w1 = start // bits.WORD_BITS, -(-(start + n) // bits.WORD_BITS)
            live = bits.unpack(r.dirty[w0:w1] | r.shadow[w0:w1],
                               (w1 - w0) * bits.WORD_BITS)
            off = start - w0 * bits.WORD_BITS
            clean = ~live[off:off + n]
            mism = clean & (fresh != r.checksums[start:start + n])
            if n < window:
                pad = torch.zeros((window - n,), dtype=torch.bool, device=leaf.device)
                clean, mism = torch.cat([clean, pad]), torch.cat([mism, pad])
            return mism.reshape(1, window), clean.reshape(1, window)

        return fn

    def verify_meta(self, red: RedundancyState) -> Dict[str, torch.Tensor]:
        """Check the checksum-of-checksums (detects corrupted checksum pages)."""
        return {name: checksum.meta_checksum(r.checksums) == r.meta_ck
                for name, r in red.items() if name in self.metas}

    # --------------------------------------------------------------- recovery
    def recover_block(self, leaf: torch.Tensor, r: LeafRedundancy, name: str,
                      block_id: int) -> Tuple[torch.Tensor, bool]:
        """Reconstruct one corrupted block from its stripe, **in place**.

        Returns ``(leaf, ok)``: the repaired block is written into
        ``leaf``'s own memory (the reference returns a new array; a copy of
        a multi-GiB leaf is what this avoids), and ``leaf`` itself is
        returned.  A leaf whose lane view is a padded copy is rebuilt into
        a new tensor instead.  ``ok`` is False — and nothing is written —
        when the stripe is vulnerable (any *other* member dirty or
        shadow-set), the paper's §3.3 recoverability rule.
        """
        meta = self.metas[name]
        block_id = int(block_id)
        P = meta.stripe_data_blocks
        sid = block_id // P
        live = bits.unpack(r.dirty | r.shadow, meta.n_blocks)
        members = [b for b in range(sid * P, (sid + 1) * P)
                   if b < meta.n_blocks and b != block_id]
        others_clean = not bool(live[members].any()) if members else True
        if not others_clean:
            return leaf, False
        lanes = self._lanes({name: leaf}, name)
        lanes[block_id] = parity.reconstruct_block(lanes, r.parity[sid], P,
                                                   block_id, sid)
        if lanes.data_ptr() != leaf.data_ptr():
            leaf = blocks.from_lanes(lanes, meta).clone()
        return leaf, True

    # ------------------------------------------------------------- accounting
    def vulnerable_masks(self, red: RedundancyState) -> Dict[str, torch.Tensor]:
        """Per-leaf bool[n_blocks] of blocks inside the vulnerability window
        (``dirty | shadow`` unpacked)."""
        return {name: bits.unpack(red[name].dirty | red[name].shadow, meta.n_blocks)
                for name, meta in self.metas.items()}

    def dirty_stats(self, red: RedundancyState) -> Dict[str, Dict[str, Any]]:
        """Dirty/vulnerable-stripe counts (feeds §4.7 battery + §4.8 MTTDL)."""
        out = {}
        for name, meta in self.metas.items():
            bdirty = bits.unpack(red[name].dirty | red[name].shadow, meta.n_blocks)
            out[name] = {
                "dirty_blocks": bdirty.sum(dtype=torch.int32),
                "vulnerable_stripes": self._stripe_dirty(meta, bdirty).sum(
                    dtype=torch.int32),
                "total_blocks": meta.n_blocks,
                "total_stripes": meta.n_stripes,
            }
        return out
