"""Wrapper for the fused update kernel K3 (``csrc/redundancy.cu``).

``fused_update_many`` refreshes the checksums and parity of a group's
leaves in place, all of them in one launch (as few as the group's leaf
count allows: ``max_jobs`` leaves a launch).  Each job is ``(lanes,
checksums, parity, dirty_words)``, the words being the leaf's packed
``dirty | shadow`` snapshot, which the kernel reads itself: no mask is
unpacked and no queue is built, and nothing here waits for the card.  The
leaves' descriptors travel in the launch's parameters; the work items'
shape (whole stripes, or runs of their column tiles where the launch has
too few stripes) and the ticket's grab size follow from the shapes alone.
Each launch's ticket, and the counters and partials of stripes split into
runs, are stream-ordered tensors from the caching allocator, zeroed here
for each call, so launches in flight on two streams never share them.

A CPU tensor runs the plain version in ``ref.py`` and copies its result
into the same tensors; ``meta`` tensors run the card's checks, and nothing
is launched (the dry run: the results are the jobs' own tensors).
``LAUNCHES`` counts kernel launches.  On every device the call reports
the card's launches and their work to an active cost counter
(``launch.cost_analysis``): the counter reads no data, so the work is the
full pass's, every stripe of every job dirty.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import bits
from ...launch import cost_analysis
from .. import _build
from . import ref

LAUNCHES = 0
MAX_STRIPE = 16      # kMaxStripe in csrc/redundancy.cu
MAX_JOBS = 352       # kMaxJobs in csrc/redundancy.cu (CUDA >= 12.1): what the
                     # meta and CPU branches count a launch, as the card's
DESC_WORDS = 11      # kDescWords: int64 words of a leaf's descriptor
FILL = 4             # stripes a CTA of the persistent grid at least, else they split
GRABS = 64           # tickets a CTA's share of a launch, about


def tile_cols(stripe_width: int, l4: int) -> int:
    """16-byte columns of a tile (``K3_DISPATCH`` in the source): 512 for
    stripes of up to 4 members where some block holds more than 256
    columns (4 KiB), else 256."""
    return 512 if stripe_width <= 4 and l4 > 256 else 256


@functools.lru_cache(maxsize=None)
def max_jobs() -> int:
    """Leaves one launch takes (its descriptors fill the parameters)."""
    return int(_build.library().vilamb_fused_update_max_jobs())


@functools.lru_cache(maxsize=None)
def grid(device: int, stripe_width: int, cols: int) -> int:
    """CTAs of the kernel's persistent grid on ``device`` (its SM count
    times the instance's occupancy), asked once."""
    with torch.cuda.device(device):
        n = int(_build.library().vilamb_fused_update_grid(stripe_width, cols))
    _build.check(max(0, -n), "fused_update grid")
    return n


def fused_update_many(jobs, stripe_width: int = 4):
    """Masked checksum+parity refresh of every job, in place; returns the
    ``(checksums, parity)`` pair of each job.

    Bitwise equal to ``ref.fused_update_many``.  On the card every leaf
    must lie on the same device; the update runs on its current stream.
    A work item is a stripe, or a run of its column tiles where the
    launch's stripes are too few to give every CTA ``FILL`` items (their
    checksum partials then fold through the scratch tensors).
    """
    jobs = list(jobs)
    if not jobs:
        return []
    with cost_analysis.launch("fused_update", lambda: _work(jobs, stripe_width)):
        return _update_many(jobs, stripe_width)


def _work(jobs, stripe_width: int):
    n_bytes = ops = 0
    for lanes, _, _, words in jobs:
        nb, L = lanes.shape
        b, o = cost_analysis.fused_update_work(-(-nb // stripe_width), stripe_width, L,
                                               words.numel())
        n_bytes, ops = n_bytes + b, ops + o
    cap = max_jobs() if jobs[0][0].device.type == "cuda" else MAX_JOBS
    return -(-len(jobs) // cap), 0, n_bytes, ops


def _update_many(jobs, stripe_width: int):
    global LAUNCHES
    if all(lanes.device.type == "cpu" for lanes, *_ in jobs):
        for (_, cks, par, _), (c, p) in zip(jobs, ref.fused_update_many(jobs, stripe_width)):
            cks.copy_(c)
            par.copy_(p)
        return [(cks, par) for _, cks, par, _ in jobs]
    if not 1 <= stripe_width <= MAX_STRIPE:
        raise ValueError(f"fused_update: stripe_width must be in 1..{MAX_STRIPE}")
    dev = jobs[0][0].device
    geo = []
    for lanes, cks, par, words in jobs:
        _build.require_lanes(lanes, "fused_update")
        if lanes.device != dev:
            raise ValueError(f"fused_update: leaves on {dev} and {lanes.device}")
        nb, L = lanes.shape
        ns = -(-nb // stripe_width)
        _build.require(cks, lanes, torch.int32, (nb,), "fused_update checksums")
        _build.require(par, lanes, torch.int32, (ns, L), "fused_update parity")
        _build.require(words, lanes, torch.int32, (max(1, -(-nb // 32)),),
                       "fused_update dirty_words")
        if par.data_ptr() % 16:
            raise ValueError("fused_update: parity must be 16-byte aligned")
        if ns >= 1 << 31:
            raise ValueError(f"fused_update: {ns} stripes in one leaf (at most 2^31 - 1)")
        geo.append((nb, L // 4, ns))
    if dev.type == "meta":
        return [(cks, par) for _, cks, par, _ in jobs]
    cols = tile_cols(stripe_width, max(l4 for _, l4, _ in geo))
    # Split stripes into runs of tiles only where the launch has too few.
    ctas = grid(dev.index, stripe_width, cols)
    n_stripes = sum(ns for _, _, ns in geo)
    split = 1 if n_stripes >= FILL * ctas else -(-FILL * ctas // n_stripes)
    desc = np.empty((len(jobs), DESC_WORDS), dtype=np.int64)
    n_cnt = n_part = 0
    item_bytes = []
    for i, ((lanes, cks, par, words), (nb, l4, ns)) in enumerate(zip(jobs, geo)):
        tiles = -(-l4 // cols)
        cpt = -(-tiles // min(tiles, split))
        per = -(-tiles // cpt)                   # items a stripe
        desc[i] = (lanes.data_ptr(), cks.data_ptr(), par.data_ptr(), words.data_ptr(),
                   nb, l4, tiles, cpt, ns * per, -1, -1)
        item_bytes.append(stripe_width * min(l4, cpt * cols) * 16)
        if per > 1:
            desc[i, 9:] = n_cnt, n_part
            n_cnt += ns
            n_part += ns * per
    n_launch = -(-len(jobs) // max_jobs())
    scratch = torch.zeros((n_launch + n_cnt,), dtype=torch.int32, device=dev)
    partials = (torch.empty((n_part * stripe_width,), dtype=torch.int32, device=dev)
                if n_part else None)
    lib, stream, cap = _build.library(), _build.stream_handle(jobs[0][0]), max_jobs()
    for n, lo in enumerate(range(0, len(jobs), cap)):
        part = desc[lo:lo + cap]
        items = part[:, 8].copy()
        part[:, 8] = np.concatenate(([0], np.cumsum(items)[:-1]))   # first items
        # A ticket hands out about 1/GRABS of a CTA's share of the launch's
        # bytes (all of them dirty), and never less than one item.
        share = int((items * np.asarray(item_bytes[lo:lo + cap])).sum()) // (ctas * GRABS)
        grab = max(1, share // max(item_bytes[lo:lo + cap]))
        rc = lib.vilamb_fused_update_many(
            part.ctypes.data, len(part), int(items.sum()), grab, stripe_width, cols,
            scratch.data_ptr() + 4 * n,
            scratch.data_ptr() + 4 * n_launch if n_cnt else 0,
            0 if partials is None else partials.data_ptr(), stream)
        _build.check(rc, "fused_update")
        LAUNCHES += 1
    return [(cks, par) for _, cks, par, _ in jobs]


def fused_update(lanes: torch.Tensor, checksums: torch.Tensor,
                 parity: torch.Tensor, block_dirty: torch.Tensor,
                 stripe_dirty: torch.Tensor, stripe_width: int = 4):
    """One leaf's masked checksum+parity refresh, in place; returns
    (checksums, parity): a one-job :func:`fused_update_many` over
    ``block_dirty`` packed on its device.

    Bitwise equal to ``ref.fused_update`` when ``stripe_dirty`` is the
    stripe reduction of ``block_dirty`` (the kernel derives it from the
    packed words; ``stripe_dirty`` is checked for its shape only).
    """
    ns = -(-lanes.shape[0] // max(1, stripe_width))
    if tuple(stripe_dirty.shape) != (ns,) or stripe_dirty.dtype != torch.bool:
        raise ValueError(f"fused_update stripe_dirty: want bool ({ns},), got "
                         f"{stripe_dirty.dtype} {tuple(stripe_dirty.shape)}")
    if tuple(block_dirty.shape) != (lanes.shape[0],) or block_dirty.dtype != torch.bool:
        raise ValueError(f"fused_update block_dirty: want bool ({lanes.shape[0]},), got "
                         f"{block_dirty.dtype} {tuple(block_dirty.shape)}")
    return fused_update_many([(lanes, checksums, parity, bits.pack_mask(block_dirty))],
                             stripe_width)[0]
