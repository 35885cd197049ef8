"""Shared stripe-repair planning and execution.

The port of ``repro.core.repairs``.  Checkpoint verification
(``CheckpointManager.restore_verified``) and the live repair path
(``ProtectedStore.repair``) face the same question: given a set of
detected-corrupt blocks, which are parity-repairable and which stripes
must be declared lost?  The planning (group by parity stripe, refuse
multi-corrupt groups) and the execution (``recover_block`` per
single-corrupt stripe) live here, so the callers cannot drift on the
recoverability rule, and both report the same structured
:class:`UnrecoverableBlock` records instead of bare counts.

Block and stripe ids are in global block space: shard ``s``'s local
block ``b`` is global block ``s * n_blocks + b``, and parity groups never
span shards (``global_stripe_id``); on a machine-local leaf (one shard)
they are the leaf's own.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, List, Mapping, Tuple

import numpy as np
import torch

from .blocks import global_stripe_id

# Why a stripe (or block) was refused repair:
#   multi_corrupt      >= 2 detected-corrupt blocks share the parity group;
#                      XOR parity is single-failure-correcting, and
#                      "repairing" one member from such a stripe would
#                      fabricate plausible garbage while reporting success.
#   vulnerable_stripe  another member is dirty/shadow-set, so the stored
#                      parity is stale there (paper §3.3).
#   shard_loss         lost with its shard (the reference's sharded stores;
#                      kept so that records compare across packages).
#   read_timeout       a degraded read exhausted its retry budget (the
#                      reference's ``read_verified``; kept likewise).
UNRECOVERABLE_REASONS = ("multi_corrupt", "vulnerable_stripe", "shard_loss",
                         "read_timeout")


class UnrecoverableReadError(RuntimeError):
    """A degraded read could not produce verified data for one or more
    requested blocks.  Carries the structured :class:`UnrecoverableBlock`
    records."""

    def __init__(self, leaf: str, records):
        self.leaf = leaf
        self.records = tuple(records)
        blocks = sorted(b for r in self.records for b in r.blocks)
        super().__init__(
            f"{leaf}: degraded read failed for global blocks {blocks} "
            f"({', '.join(sorted({r.reason for r in self.records}))})")


@dataclasses.dataclass(frozen=True)
class UnrecoverableBlock:
    """Structured loss report: which blocks of which stripe, and why.

    ``stripe`` is the stripe id (``-1`` when the loss is not stripe-shaped);
    ``blocks`` lists every block id given up on.
    """
    leaf: str
    stripe: int
    blocks: Tuple[int, ...]
    reason: str

    def __post_init__(self):
        assert self.reason in UNRECOVERABLE_REASONS, self.reason


def _block_ids(mask) -> np.ndarray:
    """Block ids from a bool mask (a tensor on any device, or array-like)
    or from an iterable of ids."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    arr = np.asarray(mask)
    if arr.dtype == np.bool_:
        return np.flatnonzero(arr)
    return arr.astype(np.int64).ravel()


def plan_stripe_repairs(
    metas, mismatches: Mapping[str, object]
) -> Tuple[List[Tuple[str, int]], List[UnrecoverableBlock]]:
    """Group detected-corrupt blocks by parity stripe.

    ``mismatches`` maps leaf name -> bool mask over the leaf's blocks (as
    ``scrub`` returns it) or an iterable of block ids.  Returns
    ``(singles, unrecoverable)``: the repair candidates (at most one per
    stripe, as ``(leaf, block)`` pairs) and the stripes refused because
    XOR parity cannot correct them.
    """
    singles: List[Tuple[str, int]] = []
    unrec: List[UnrecoverableBlock] = []
    for name, mask in sorted(mismatches.items()):
        meta = metas[name]
        by_stripe = collections.defaultdict(list)
        for b in _block_ids(mask):
            by_stripe[global_stripe_id(meta, int(b))].append(int(b))
        for stripe, blks in sorted(by_stripe.items()):
            if len(blks) > 1:
                unrec.append(UnrecoverableBlock(
                    name, int(stripe), tuple(blks), "multi_corrupt"))
            else:
                singles.append((name, blks[0]))
    return singles, unrec


def repair_blocks(
    engine, leaves, red, singles: Iterable[Tuple[str, int]]
) -> Tuple[dict, List[Tuple[str, int]], List[Tuple[str, int]]]:
    """Parity-rebuild each planned single-corrupt block.

    ``engine`` is anything exposing ``recover_block`` and ``metas``: a
    RedundancyEngine or a ProtectedStore.  Returns ``(leaves, fixed,
    vulnerable)``: a new dict of the leaves with the repairs applied, the
    repaired ``(leaf, block)`` pairs, and the pairs refused because their
    stripe was vulnerable (stale parity) at repair time.

    Unlike the reference, whose inputs are never mutated, the port repairs
    **in place**: ``recover_block`` writes the rebuilt block into the
    leaf's own memory (a multi-GiB leaf is not copied), so the returned
    dict holds the same tensors as ``leaves`` (a leaf whose lane view is a
    padded copy comes back as a new tensor).
    """
    leaves = dict(leaves)
    fixed: List[Tuple[str, int]] = []
    vulnerable: List[Tuple[str, int]] = []
    for name, b in singles:
        repaired, ok = engine.recover_block(leaves[name], red[name], name, b)
        if bool(ok):
            leaves[name] = repaired
            fixed.append((name, int(b)))
        else:
            vulnerable.append((name, int(b)))
    return leaves, fixed, vulnerable


def vulnerable_unrecoverable(metas, pairs: Iterable[Tuple[str, int]]
                             ) -> List[UnrecoverableBlock]:
    """Wrap refused ``(leaf, block)`` pairs as structured loss records."""
    return [UnrecoverableBlock(n, global_stripe_id(metas[n], b), (int(b),),
                               "vulnerable_stripe")
            for n, b in pairs]
