"""Seeded, deterministic corruption injector for ProtectedStore state.

The port of ``repro.faults.inject``.  Every fault the paper's §5 analysis
worries about is a :class:`FaultSpec` applied *functionally* to
``(leaves, red)``: the inputs are never written.  The injector never
changes dirty bitmaps as a side effect, so the vulnerability-window oracle
can classify each fault exactly.

Kinds
-----
``data_bitflip``       flip one bit of one uint32 lane of a data block.
``checksum_bitflip``   corrupt a stored per-block checksum (caught by the
                       meta-checksum, Alg. 1 line 22).
``parity_bitflip``     corrupt a stored parity lane (silent until a repair
                       needs that stripe).
``meta_bitflip``       corrupt the checksum-of-checksums scalar.
``torn_write``         a multi-block write that only partially landed and
                       whose dirty marks were lost: scrub must catch all of
                       it.
``stale_redundancy``   a lost dirty bit: the block changed but
                       ``dirty | shadow`` say it did not.
``shard_loss``         every lane of one shard XOR-scribbled.
``mesh_shrink``        a departing shard's data, checksums and meta
                       checksum XOR-scribbled.
``mesh_grow``          a joining shard with zeroed redundancy.

All randomness flows from one ``numpy`` generator seeded at construction,
drawn call for call as the reference draws it: the same seed over the
same geometry gives the same specs in both packages.

Sharded leaves (``factors``, ``store.shard_factor``) are addressed in
global block space: shard ``s``'s local block ``b`` is global block
``s * n_blocks + b``, and the surgery lands on that shard's rows (dim0
sharding only; other specs raise the reference's ``ValueError``);
``shard_loss``, ``mesh_shrink`` and ``mesh_grow`` take the shard index in
``block``.  uint32 payloads are carried as int32 bits
(``np.uint32(x).view(np.int32)``), as every field of the state is.  A
written leaf or field is cloned first: a lane view of a leaf that fills
its blocks exactly aliases the leaf (on an 8 GiB heap, one 8 GiB copy a
data fault).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import blocks as B
from ..core.bits import bits_to_mask
from ..core.state import LeafRedundancy
from ..kernels.common import i32

FAULT_KINDS = ("data_bitflip", "checksum_bitflip", "parity_bitflip",
               "meta_bitflip", "torn_write", "stale_redundancy",
               "shard_loss", "mesh_shrink", "mesh_grow")

# Adversarial uint32 payloads: float32 NaN/Inf bit patterns and sentinel-ish
# values, so detection never depends on "corrupt values look random".
SPECIAL_LANES = np.array([
    0x7FC00000,  # float32 quiet NaN
    0x7F800000,  # +Inf
    0xFF800000,  # -Inf
    0x7F800001,  # signalling NaN
    0x00000000,  # zeros (absorbing for XOR mistakes)
    0xFFFFFFFF,  # all ones
], dtype=np.uint32)

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One concrete, replayable fault.

    ``block``/``lane``/``bit`` address the corruption site in block-lane
    space (see :mod:`repro_torch.core.blocks`); ``blocks`` lists every
    block a ``torn_write``/``stale_redundancy`` fault touches.  ``payload``
    carries the uint32 value XORed at the site.
    """
    kind: str
    leaf: str
    block: int = -1
    lane: int = 0
    bit: int = 0
    blocks: Tuple[int, ...] = ()
    payload: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {FAULT_KINDS})")

    @property
    def touched_blocks(self) -> Tuple[int, ...]:
        """Every data block whose content vs redundancy this fault skews
        (for checksum, parity and meta faults: the block they weaken)."""
        if self.blocks:
            return self.blocks
        if self.block >= 0:
            return (self.block,)
        return ()


def apply_fault(metas, leaves: Mapping[str, torch.Tensor],
                red: Mapping[str, LeafRedundancy], spec: FaultSpec,
                factors: Optional[Mapping[str, int]] = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, LeafRedundancy]]:
    """Apply one fault functionally; returns new ``(leaves, red)``.

    ``metas`` maps leaf name -> :class:`~repro_torch.core.blocks.BlockMeta`
    (``store.metas``).  ``factors`` maps leaf name -> shard count for
    sharded leaves (``store.shard_factor``; absent/1 = machine-local):
    block ids are then global and the surgery lands on the owning shard's
    rows.  The written leaf or redundancy field is a clone; the inputs are
    never mutated.
    """
    leaves = dict(leaves)
    red = dict(red)
    meta = metas[spec.leaf]
    k = int((factors or {}).get(spec.leaf, 1))

    def owner(block):
        """(shard, local block) of a global id, checked against ``k``."""
        s, b = divmod(int(block), meta.n_blocks)
        if not 0 <= s < k:
            raise ValueError(
                f"{spec.leaf}: global block {block} addresses shard {s} but "
                f"the leaf has {k} shard(s) — pass factors= "
                "(store.shard_factor) when injecting into a sharded store")
        return s, b

    def shard(s):
        s = int(s)
        if not 0 <= s < k:
            raise ValueError(f"{spec.leaf}: {spec.kind} addresses shard {s} "
                             f"but the leaf has {k} shard(s)")
        return s

    def edit_lanes(edits):
        """``fn(lanes)`` on the lanes of shard ``s``, for each ``(s, fn)`` of
        ``edits``, all on one clone of the leaf."""
        leaf = leaves[spec.leaf].clone()
        by_shard: Dict[int, list] = {}
        for s, fn in edits:
            by_shard.setdefault(s, []).append(fn)
        for s, fns in by_shard.items():
            sub, put = B.shard_slice(leaf, meta, k, s)
            lanes = B.to_lanes(sub, meta)
            for fn in fns:
                fn(lanes)
            leaf = put(B.from_lanes(lanes, meta))
        leaves[spec.leaf] = leaf

    r = red.get(spec.leaf)
    if spec.kind == "data_bitflip":
        s, b = owner(spec.block)
        word = i32(spec.payload or (1 << spec.bit))
        edit_lanes([(s, lambda lanes: lanes[b, spec.lane].bitwise_xor_(word))])
    elif spec.kind == "checksum_bitflip":
        # Global checksums concatenate the shards', so the global id
        # indexes them directly (owner() validates it).
        owner(spec.block)
        cks = r.checksums.clone()
        cks[int(spec.block)] ^= i32(spec.payload or (1 << spec.bit))
        red[spec.leaf] = dataclasses.replace(r, checksums=cks)
    elif spec.kind == "parity_bitflip":
        owner(spec.block)
        sid = B.global_stripe_id(meta, spec.block)
        par = r.parity.clone()
        par[sid, spec.lane] ^= i32(spec.payload or (1 << spec.bit))
        red[spec.leaf] = dataclasses.replace(r, parity=par)
    elif spec.kind == "meta_bitflip":
        word = i32(spec.payload or (1 << spec.bit))
        mck = r.meta_ck.clone()
        if mck.dim():         # sharded: one meta checksum per shard
            mck[owner(spec.block)[0] if spec.block >= 0 else 0] ^= word
        else:
            mck ^= word
        red[spec.leaf] = dataclasses.replace(r, meta_ck=mck)
    elif spec.kind == "shard_loss":
        # Wholesale corruption of one shard's rows (``block`` = the shard),
        # redundancy untouched.
        s = shard(spec.block)
        word = i32(spec.payload or 0xA5A5A5A5)
        edit_lanes([(s, lambda lanes: lanes.bitwise_xor_(word))])
    elif spec.kind in ("mesh_shrink", "mesh_grow"):
        # mesh_shrink: the departing shard's data AND redundancy (its
        # checksums and meta checksum) scribbled; mesh_grow: data intact,
        # redundancy zeroed.
        s = shard(spec.block)
        lo, hi = s * meta.n_blocks, (s + 1) * meta.n_blocks
        word = i32(spec.payload or 0xA5A5A5A5)
        cks, mck = r.checksums.clone(), r.meta_ck.clone()
        if spec.kind == "mesh_shrink":
            edit_lanes([(s, lambda lanes: lanes.bitwise_xor_(word))])
            cks[lo:hi] ^= word
            mval = (mck[s] if mck.dim() else mck) ^ word
        else:
            cks[lo:hi] = 0
            mval = torch.zeros_like(mck[s] if mck.dim() else mck)
        if mck.dim():
            mck[s] = mval
        else:
            mck = mval
        red[spec.leaf] = dataclasses.replace(r, checksums=cks, meta_ck=mck)
    elif spec.kind in ("torn_write", "stale_redundancy"):
        # Data changes land, the dirty marks do not: red is left untouched.
        # Deterministic per-block garbage mixing special payloads; a torn
        # write is partial, so only a prefix of lanes flips.
        seed = np.uint32(spec.payload or 0xD15EA5E)
        n = max(1, meta.lanes_per_block // 4)

        def tear(b, flip):
            return lambda lanes: lanes[b, :n].bitwise_xor_(flip.to(lanes.device))

        edits = []
        for gb in spec.touched_blocks:
            s, b = owner(gb)
            rng = np.random.default_rng(int(seed) + int(gb))
            vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            kk = rng.integers(0, n + 1)
            vals[:kk] = SPECIAL_LANES[rng.integers(0, len(SPECIAL_LANES), size=kk)]
            edits.append((s, tear(b, torch.from_numpy(vals.view(np.int32)))))
        edit_lanes(edits)
    else:  # pragma: no cover — guarded by FaultSpec.__post_init__
        raise AssertionError(spec.kind)
    return leaves, red


class FaultInjector:
    """Plans and applies deterministic fault sequences over a store.

    One generator (``numpy`` PCG64, seeded once) drives every placement
    decision; :meth:`plan` with the same seed and geometry returns the same
    specs as the reference's.  Every applied fault is recorded in
    :attr:`log`.
    """

    def __init__(self, store, seed: int = 0):
        self.store = store
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.log: List[FaultSpec] = []

    # ------------------------------------------------------------- planning
    def _leaf_names(self) -> List[str]:
        return sorted(self.store.protected_metas)

    def _factor(self, name: str) -> int:
        fn = getattr(self.store, "shard_factor", None)
        return int(fn(name)) if fn is not None else 1

    def plan(self, n: int, kinds: Sequence[str] = ("data_bitflip",),
             leaf: Optional[str] = None) -> List[FaultSpec]:
        """Draw ``n`` fault specs over the protected geometry.

        Placement is uniform over blocks/lanes/bits of the chosen leaf (or
        all protected leaves); ``torn_write`` draws 2-4 consecutive blocks
        spanning at least one stripe boundary when the leaf allows it.
        Sharded leaves are addressed in global block space: placement is
        uniform over every shard's blocks, and a torn run never crosses a
        shard boundary.
        """
        metas = self.store.protected_metas
        names = [leaf] if leaf is not None else self._leaf_names()
        out: List[FaultSpec] = []
        for _ in range(n):
            kind = str(self.rng.choice(list(kinds)))
            name = str(names[self.rng.integers(0, len(names))])
            meta = metas[name]
            b = int(self.rng.integers(0, meta.n_blocks * self._factor(name)))
            lane = int(self.rng.integers(0, meta.lanes_per_block))
            bit = int(self.rng.integers(0, 32))
            payload = 0
            if self.rng.random() < 0.5:
                payload = int(SPECIAL_LANES[self.rng.integers(0, len(SPECIAL_LANES))])
            blocks: Tuple[int, ...] = ()
            if kind == "torn_write":
                width = int(self.rng.integers(2, 5))
                sw = meta.stripe_data_blocks
                base = (b // meta.n_blocks) * meta.n_blocks   # owning shard
                if meta.n_blocks > sw:
                    # Start 1..width-1 blocks before a random non-zero
                    # stripe start, so the run spans >= 2 stripes.
                    bnd = sw * int(self.rng.integers(
                        1, (meta.n_blocks - 1) // sw + 1))
                    start = max(0, bnd - int(self.rng.integers(1, width)))
                else:   # single-stripe leaf: boundary impossible
                    start = int(self.rng.integers(
                        0, max(1, meta.n_blocks - width + 1)))
                blocks = tuple(base + lb for lb in
                               range(start, min(start + width, meta.n_blocks)))
            elif kind == "stale_redundancy":
                blocks = (b,)
            out.append(FaultSpec(kind=kind, leaf=name, block=b, lane=lane,
                                 bit=bit, blocks=blocks, payload=payload))
        return out

    def plan_clean_blocks(self, red, n: int, kinds=("data_bitflip",),
                          ) -> List[FaultSpec]:
        """Like :meth:`plan` but place only on blocks *outside* the current
        vulnerability window (clean per ``dirty | shadow``), at most one
        fault per stripe.  Returns possibly fewer than ``n`` specs when not
        enough clean stripes exist.

        The candidates are the reference's list, every leaf's clean blocks
        in ``red``'s order, drawn through one permutation of it; the list
        is kept as per-leaf index arrays and read only where the
        permutation lands (2,097,152 Python tuples on an 8 GiB heap take
        seconds to build), which draws nothing differently.
        """
        metas = self.store.protected_metas
        out: List[FaultSpec] = []
        used_stripes = set()
        names, clean = [], []
        for name, r in red.items():
            if name in metas:
                live = (r.dirty | r.shadow).cpu().numpy().view(np.uint32)
                names.append(name)
                clean.append(np.flatnonzero(~bits_to_mask(
                    live, metas[name].n_blocks, shards=self._factor(name))))
        starts = np.cumsum([0] + [len(c) for c in clean])
        for i in self.rng.permutation(int(starts[-1])):
            if len(out) >= n:
                break
            k = int(np.searchsorted(starts, i, side="right")) - 1
            name, b = names[k], int(clean[k][i - starts[k]])
            meta = metas[name]
            sid = (name, B.global_stripe_id(meta, b))
            if sid in used_stripes:
                continue
            used_stripes.add(sid)
            kind = str(self.rng.choice(list(kinds)))
            out.append(FaultSpec(
                kind=kind, leaf=name, block=b,
                lane=int(self.rng.integers(0, meta.lanes_per_block)),
                bit=int(self.rng.integers(0, 32)),
                blocks=(b,) if kind == "stale_redundancy" else ()))
        return out

    # ------------------------------------------------------------ injection
    def inject(self, leaves, red, spec: FaultSpec):
        """Apply one spec through the store (records it in :attr:`log`)."""
        self.log.append(spec)
        return self.store.inject(leaves, red, spec)

    def inject_many(self, leaves, red, specs: Sequence[FaultSpec]):
        for spec in specs:
            leaves, red = self.inject(leaves, red, spec)
        return leaves, red
