"""Online shard rebuild from cross-shard parity.

The port of ``repro.scrub.rebuild``.  Shard-local XOR stripes (the paper's
parity) correct a single block per stripe — useless when a whole shard's
data is lost or wholesale-corrupt (device dropout, firmware scribble over
one host's DAX range).  For that failure domain the patroller maintains a
second, orthogonal parity layer per eligible leaf: **cross-shard parity**
(``xpar``), one XOR row per *local* block folding the same-indexed block
of every shard.  Losing shard ``s`` then rebuilds block ``b`` as
``xpar[b] XOR (XOR of the surviving shards' block b)`` — provided no shard
wrote block ``b`` since its row was refreshed.

Freshness is tracked on the host (``xvalid``) by the patroller's per-tick
write sampling plus an exact ``dirty | shadow`` fetch at rebuild start and
at every rebuild tick (writes land before the tick, so the fetch at tick
``t`` sees every mark through step ``t`` — no rebuilt paste can clobber a
foreground write).  Marks already live on the lost shard *at loss
declaration* are a separate class: those writes were in flight when the
shard died, so their data died with it — the ``preloss`` snapshot
(captured by ``declare_shard_lost`` when the caller passes ``red``, else
conservatively at rebuild construction) keeps them out of ``written``
until the mark is observed to clear once; only a mark that *appears*
after the snapshot is a foreground rewrite.  Blocks classified per
window:

* **rebuilt** — ``xvalid`` row, pasted from the reconstruction and marked
  dirty so the normal Algorithm-1 pipeline regenerates their shard-local
  redundancy (no direct checksum/parity surgery racing in-flight updates);
* **fresh** — rewritten by the foreground since the rebuild started; the
  new data supersedes the loss and its redundancy flows through the normal
  dirty path;
* **unrecoverable** — stale ``xpar`` row and never rewritten (including
  blocks already dirty at loss time: their pre-loss writes died with the
  shard).  Reported structurally and *also* marked dirty, so redundancy
  re-converges over the garbage (accepted, named loss) instead of alarming
  forever.

The per-tick paste window is bounded by ``rebuild_bytes_per_tick``
(default 4x the patrol budget).  The one full-leaf read happens once, at
rebuild start, to freeze the surviving shards' XOR (so later survivor
writes cannot skew the reconstruction).

The port repairs in place: every shard of a leaf lives on the store's one
device, and the paste writes the lost shard's rows of the caller's own
leaf, so ``TickReport.repaired`` hands back the caller's tensor.  On the
card the paste is ordered (on the device) after any update still running
on the store's side stream, which reads the same rows.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core import blocks
from ..core.repairs import UnrecoverableBlock


@dataclasses.dataclass
class CrossShardParity:
    """Per-leaf cross-shard parity: ``xpar[b]`` = XOR over shards of local
    block ``b``'s lanes (int32 ``(n_blocks, lanes)`` on the store's
    device); ``xvalid[b]`` = no shard wrote block ``b`` since the row was
    refreshed (host-tracked, conservatively invalidated)."""
    name: str
    n_blocks: int
    xpar: Optional[torch.Tensor] = None
    xvalid: Optional[np.ndarray] = None
    # Mesh-geometry epoch this image was folded under; a remesh (ROADMAP.md,
    # Queue 1 item 11.5) would bump it and discard images of the old
    # geometry (a row folded across k shards is meaningless once k changes).
    version: int = 0

    def __post_init__(self):
        if self.xvalid is None:
            self.xvalid = np.zeros((self.n_blocks,), bool)


@dataclasses.dataclass
class RebuildStatus:
    """Progress of one online shard rebuild (surfaced on ``TickReport``)."""
    leaf: str
    shard: int
    total_blocks: int
    started_step: int
    rebuilt: int = 0
    fresh: int = 0
    lost: int = 0
    ticks: int = 0
    done: bool = False


def xor_fold(stack: torch.Tensor) -> torch.Tensor:
    """XOR-fold a ``(k, ...)`` stack over dim 0 into one new buffer the size
    of ``stack[0]``, in place: the first XOR writes the buffer, each later
    shard is XORed into it, so no intermediate buffer exists.  Plain torch,
    as the reference computes it outside any Pallas kernel."""
    if stack.shape[0] == 1:
        return stack[0].clone()
    out = torch.bitwise_xor(stack[0], stack[1])
    for i in range(2, stack.shape[0]):
        out ^= stack[i]
    return out


def pack_mask_np(mask: np.ndarray, n_words: int) -> np.ndarray:
    """Host-side pack of a bool block mask into uint32 words (bit ``i`` of
    word ``j`` = block ``j*32+i`` — the :mod:`repro_torch.core.bits`
    layout)."""
    padded = np.zeros((n_words * 32,), bool)
    padded[:mask.size] = mask
    return np.packbits(padded, bitorder="little").view("<u4").astype(np.uint32)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a host wait: on the card it
    goes through pinned memory with a non-blocking copy, ordered on the
    current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class ShardRebuilder:
    """One in-progress rebuild of a lost shard, paced over ticks.

    Construction blocks once: an exact freshness fetch, then the full
    reconstruction image ``recon = frozen_survivor_xor ^ xpar`` (on the
    device, one shard's size, queued on the current stream).  Each
    :meth:`step_once` pastes a bounded window of ``recon`` into the lost
    shard's rows and marks it dirty — everything else is the normal
    redundancy pipeline.
    """

    def __init__(self, patroller, name: str, shard: int, leaves, red, step: int,
                 preloss: Optional[np.ndarray] = None):
        self.pat = patroller
        self.name = name
        self.shard = int(shard)
        store = patroller.store
        eng = patroller.engine_of(name)
        self.eng = eng
        self.meta = meta = store.metas[name]
        self.k = eng.shard_factor(name)
        xp = patroller.xpar.get(name)
        if xp is None or xp.xpar is None:
            raise RuntimeError(
                f"{name}: shard rebuild needs cross-shard parity "
                "(leaf not dim0-sharded, or patroller not yet primed)")
        if xp.version != patroller.geometry_version:
            raise RuntimeError(
                f"{name}: cross-shard parity is from mesh geometry epoch "
                f"{xp.version}, patroller is at {patroller.geometry_version}"
                " — stale parity cannot seed a rebuild after a remesh")
        assert 0 <= self.shard < self.k, (name, shard, self.k)
        nb = meta.n_blocks
        budget = int(store.policy.rebuild_bytes_per_tick) or (
            4 * int(store.policy.patrol_bytes_per_tick))
        self.wb = max(1, min(nb, budget // max(1, meta.bytes_per_block)))
        self.rows_local = eng.global_shapes[name][0] // self.k

        # Exact freshness fetch (blocking, once): a row any shard wrote
        # since its refresh cannot be rebuilt from it.
        live = self.pat.fetch_live_rows(name, red[name])    # (k, nb) bool
        xp.xvalid &= ~live.any(axis=0)
        # Pre-loss in-flight writes: marks on the lost shard at loss
        # declaration (or, without a declaration-time snapshot, every mark
        # live now).  Their data died with the shard, so they must never
        # count as foreground rewrites — the per-tick refetch re-sees the
        # same marks, and without the snapshot those blocks would be
        # misclassified "fresh" while holding scribble.  Conservative: at
        # worst a block the foreground actually rewrote inside the
        # snapshot window is reported lost while holding correct data.
        self.preloss = (live[self.shard] if preloss is None
                        else np.asarray(preloss, bool)).copy()
        self.eligible = xp.xvalid & ~self.preloss
        self.written = live[self.shard] & ~self.preloss
        # A cleared mark resolves the ambiguity: the pre-loss write was
        # consumed, so any mark that appears later is a genuine rewrite.
        self.preloss &= live[self.shard]
        self.done_mask = np.zeros((nb,), bool)
        self.lost_blocks: List[int] = []                    # local ids
        self.cur = 0
        self.status = RebuildStatus(leaf=name, shard=self.shard,
                                    total_blocks=nb, started_step=int(step))

        # Freeze the surviving shards' XOR and finish the reconstruction
        # image: recon[b] = xpar[b] ^ (XOR of the survivors' block b) = the
        # lost shard's block b as of its row's refresh.  The reference's
        # fold of every shard XOR the lost one, in one buffer: xpar's copy
        # with each survivor XORed in.
        stack = eng.shard_lanes_fn(name)(leaves[name])     # (k, nb, L)
        recon = xp.xpar.clone()
        for s in range(self.k):
            if s != self.shard:
                recon ^= stack[s]
        self.recon = recon

    # ------------------------------------------------------------------ tick
    def step_once(self, leaves, out, report, step: Optional[int]) -> None:
        """Paste one bounded window; updates ``out`` (dirty marks) and
        ``report`` (repaired leaf + status) in place via the patroller.

        ``step`` is None when driven from a stepless drain (``settle()``
        without a step); the crash phase then omits the kwarg so the
        crash machine's own step counter fills it in."""
        meta, nb = self.meta, self.meta.n_blocks
        self.status.ticks += 1
        # Per-tick exact freshness fetch: marks through this step are
        # visible (writes precede the tick), so a block the foreground
        # rewrote is never pasted over.  Only marks that appeared after
        # the pre-loss snapshot count as rewrites (a carried-over mark is
        # an in-flight write whose data died with the shard).
        live = self.pat.fetch_live_rows(self.name, out[self.name])
        now = live[self.shard]
        self.written |= now & ~self.preloss
        self.preloss &= now

        start = min(self.cur, max(0, nb - self.wb))
        ids = np.arange(start, start + self.wb)
        fresh_ids = ids[~self.done_mask[ids] & self.written[ids]]
        ok = np.zeros((nb,), bool)
        lost_now = np.zeros((nb,), bool)
        sel = ids[~self.done_mask[ids] & ~self.written[ids]]
        ok[sel[self.eligible[sel]]] = True
        lost_now[sel[~self.eligible[sel]]] = True
        self.done_mask[ids] = True
        self.lost_blocks.extend(int(b) for b in np.flatnonzero(lost_now))
        self.status.rebuilt += int(ok.sum())
        self.status.fresh += int(fresh_ids.size)
        self.status.lost += int(lost_now.sum())

        leaf = leaves[self.name]
        self._paste(leaf, ok[ids], start)
        # Rebuilt *and* unrecoverable blocks go dirty: Algorithm 1 then
        # regenerates shard-local checksums/parity through the normal
        # pipeline (rebuilt = correct redundancy; lost = consistent
        # redundancy over the reported garbage, so scrub stops alarming).
        mark = ok | lost_now
        if mark.any():
            nw = meta.n_dirty_words
            r = out[self.name]
            dirty = r.dirty.clone()
            seg = dirty[self.shard * nw:(self.shard + 1) * nw]
            seg |= to_device(pack_mask_np(mark, nw).view(np.int32), dirty.device)
            out[self.name] = dataclasses.replace(r, dirty=dirty)
        self.pat.adopt_repair(self.name, leaf, leaves, report)

        self.cur = start + self.wb
        if self.cur >= nb:
            self.status.done = True
        report.rebuild = self.status
        self.pat.store._phase("rebuild_paste", red=dict(out),
                              **({} if step is None else {"step": int(step)}),
                              leaf=self.name, shard=self.shard,
                              window=(int(start), int(start + self.wb)))

    def unrecoverable(self) -> List[UnrecoverableBlock]:
        """Structured loss records (global ids), grouped by parity stripe."""
        meta, per = self.meta, {}
        for b in self.lost_blocks:
            gb = self.shard * meta.n_blocks + b
            per.setdefault(blocks.global_stripe_id(meta, gb), []).append(gb)
        return [UnrecoverableBlock(self.name, s, tuple(bs), "shard_loss")
                for s, bs in sorted(per.items())]

    # ------------------------------------------------------------- the paste
    def _paste(self, leaf: torch.Tensor, ok: np.ndarray, start: int) -> None:
        """Window paste into the lost shard's rows of ``leaf``, in place:
        block ``start + i`` takes ``recon``'s where ``ok[i]``.

        The reference pins its functional paste's output to the leaf's
        NamedSharding (``out_shardings``) and its repairs' (``_repin``),
        so its precompiled programs accept the live view; a torch leaf has
        one layout on the one device, and the paste writes the caller's
        own tensor, so neither has a counterpart here.  The rows belong to
        stripes an update on the store's side stream may still be reading,
        so on the card the current stream first waits for it (on the
        device, never on the host)."""
        self.pat.store.await_inflight()
        meta, wb = self.meta, self.wb
        lo = self.shard * self.rows_local
        sub = leaf[lo:lo + self.rows_local]                 # the shard's rows, a view
        new = self.recon[start:start + wb]
        if not ok.all():
            cur = blocks.shard_window_lanes(sub, meta, (1,), start, wb)[0]
            new = torch.where(to_device(ok, leaf.device)[:, None], new, cur)
        blocks.put_window(sub, meta, start, new)
