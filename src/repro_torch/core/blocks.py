"""Block views over state leaves (paper's "pages", §3.1).

A leaf tensor of any shape/dtype is reinterpreted as a 2-D int32 lane view
``(n_blocks, lanes_per_block)`` — the unit over which checksums are
computed and parity stripes are formed.  When the leaf fills its blocks
exactly the view aliases the leaf's memory (no copy); a multi-GiB heap is
never duplicated.  Sub-word dtypes pack little-endian into each word.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from . import bits

DEFAULT_LANES_PER_BLOCK = 16384  # 64 KiB blocks
DEFAULT_STRIPE_DATA_BLOCKS = 4   # paper: 4 data pages + 1 parity page

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    if dtype not in _NAMES:
        raise ValueError(f"unsupported leaf dtype: {dtype}")
    return _NAMES[dtype]


def _elems_per_word(dtype: torch.dtype) -> int:
    isz = dtype.itemsize
    if isz > 4:
        raise ValueError(f"dtypes wider than 4 bytes unsupported: {dtype}")
    if 4 % isz:
        raise ValueError(f"itemsize must divide 4: {dtype}")
    return 4 // isz


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype without its data (the counterpart of
    ``jax.ShapeDtypeStruct``): enough to declare a leaf to a store."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """Static geometry of a leaf's block view."""
    shape: Tuple[int, ...]
    dtype: str
    lanes_per_block: int
    stripe_data_blocks: int

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def n_elems(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def elems_per_word(self) -> int:
        return _elems_per_word(self.torch_dtype)

    @property
    def n_lanes(self) -> int:
        """Total uint32 lanes (before block padding)."""
        return -(-self.n_elems // self.elems_per_word)

    @property
    def n_blocks(self) -> int:
        return max(1, -(-self.n_lanes // self.lanes_per_block))

    @property
    def n_stripes(self) -> int:
        return -(-self.n_blocks // self.stripe_data_blocks)

    @property
    def n_dirty_words(self) -> int:
        return bits.n_words(self.n_blocks)

    @property
    def padded_lanes(self) -> int:
        return self.n_blocks * self.lanes_per_block

    @property
    def padded_blocks(self) -> int:
        return self.n_stripes * self.stripe_data_blocks

    @property
    def bytes_per_block(self) -> int:
        return self.lanes_per_block * 4

    @property
    def data_bytes(self) -> int:
        return self.n_elems * self.torch_dtype.itemsize


def make_meta(
    leaf,
    lanes_per_block: int = DEFAULT_LANES_PER_BLOCK,
    stripe_data_blocks: int = DEFAULT_STRIPE_DATA_BLOCKS,
) -> BlockMeta:
    """Geometry of ``leaf`` (anything with ``.shape`` and a torch ``.dtype``)."""
    n_lanes = -(-(math.prod(leaf.shape) or 1) // _elems_per_word(leaf.dtype))
    # Small leaves get a single (possibly shorter) block, padded to a
    # multiple of 128 lanes like the reference geometry.
    lpb = min(lanes_per_block, max(128, -(-n_lanes // 128) * 128))
    return BlockMeta(
        shape=tuple(leaf.shape),
        dtype=dtype_name(leaf.dtype),
        lanes_per_block=lpb,
        stripe_data_blocks=stripe_data_blocks,
    )


def to_lanes(x: torch.Tensor, meta: BlockMeta) -> torch.Tensor:
    """int32 ``(n_blocks, lanes_per_block)`` view of a leaf.

    A view of the leaf's own memory when the leaf fills its blocks exactly
    (writes through it land in the leaf); a zero-padded copy otherwise.
    """
    flat = x.contiguous().reshape(-1)
    epw = meta.elems_per_word
    if meta.n_elems == meta.padded_lanes * epw:
        return flat.view(torch.int32).view(meta.n_blocks, meta.lanes_per_block)
    out = torch.zeros((meta.padded_lanes * epw,), dtype=x.dtype, device=x.device)
    out[: meta.n_elems] = flat
    return out.view(torch.int32).view(meta.n_blocks, meta.lanes_per_block)


def shard_window_lanes(x: torch.Tensor, meta: BlockMeta, splits, start: int,
                       n: int) -> torch.Tensor:
    """int32 ``(k, n, lanes_per_block)``: blocks ``[start, start + n)`` of
    every shard of a leaf (``meta`` the shard-local geometry, ``splits`` as
    in :func:`shard_view`; ``start + n <= n_blocks``), the patrol probe's
    window.

    A view of the leaf's own memory when each shard is a contiguous row
    range and the window lies wholly inside it: the shards then lie one
    shard apart (``stride(0)``), which the checksum kernel steps over in
    one launch.  Otherwise a copy of the window alone, ``k * n`` blocks,
    zero-padded past each shard's end as :func:`to_lanes` pads: where the
    window holds a shard's partial last block, or where the shards are
    strided (a KV cache under ``cache_specs``), whose window is gathered
    piece by piece (:func:`_range_pieces`) and never by staging the whole
    leaf as :func:`shard_lanes` does.
    """
    L, epw = meta.lanes_per_block, meta.elems_per_word
    lo, hi = start * L * epw, (start + n) * L * epw
    m = max(0, min(hi, meta.n_elems) - lo)      # the window's elements in a shard
    if n == 0:
        k = math.prod(splits)
        return torch.empty((k, 0, L), dtype=torch.int32, device=x.device)
    if not is_strided(splits):
        k = math.prod(splits)
        flat = x.contiguous().reshape(k, -1)
        # A view where the shards lie a whole number of 16-byte loads apart.
        if hi <= meta.n_elems and (k == 1 or meta.n_elems % (4 * epw) == 0):
            win = flat[0, lo:hi][None] if k == 1 else flat[:, lo:hi]
            return win.view(torch.int32).view(k, n, L)
        out = torch.empty((k, hi - lo), dtype=x.dtype, device=x.device)
        out[:, :m] = flat[:, lo:lo + m]
    else:
        splits, local, perm = _split_view(x, splits)
        k = math.prod(splits)
        out = torch.empty((k, hi - lo), dtype=x.dtype, device=x.device)
        pos = 0
        for prefix, a, b in _range_pieces(local, lo, lo + m):
            rest = local[len(prefix) + 1:]
            cnt = (b - a) * math.prod(rest)
            src = perm[(slice(None),) * len(splits) + prefix + (slice(a, b),)]
            out[:, pos:pos + cnt].view(splits + (b - a,) + rest).copy_(src)
            pos += cnt
    if m < hi - lo:
        out[:, m:].zero_()              # past a shard's end, as to_lanes pads
    return out.view(torch.int32).view(k, n, L)


def _range_pieces(shape, lo: int, hi: int):
    """Elements ``[lo, hi)`` of a row-major ``shape`` as rectangular pieces
    ``(prefix, a, b)``: the coordinates ``prefix`` on the leading dims,
    ``[a, b)`` on the next, every later dim whole (at most ``2 * ndim - 1``
    pieces), in order."""
    if lo >= hi:
        return []
    if len(shape) == 1:
        return [((), lo, hi)]
    inner = math.prod(shape[1:])
    r0, o0 = divmod(lo, inner)
    r1, o1 = divmod(hi, inner)
    if r0 == r1:
        return [((r0,) + p, a, b) for p, a, b in _range_pieces(shape[1:], o0, o1)]
    out = []
    if o0:
        out += [((r0,) + p, a, b) for p, a, b in _range_pieces(shape[1:], o0, inner)]
        r0 += 1
    if r1 > r0:
        out.append(((), r0, r1))
    if o1:
        out += [((r1,) + p, a, b) for p, a, b in _range_pieces(shape[1:], 0, o1)]
    return out


def put_window(x: torch.Tensor, meta: BlockMeta, start: int,
               lanes: torch.Tensor) -> None:
    """Write an int32 ``(n, lanes_per_block)`` window over blocks ``[start,
    start + n)`` of a contiguous leaf ``x``, in place (the lanes past the
    leaf's end, :func:`to_lanes`'s padding, are dropped)."""
    per_block = meta.lanes_per_block * meta.elems_per_word
    lo = start * per_block
    m = max(0, min(lo + lanes.shape[0] * per_block, meta.n_elems) - lo)
    x.view(-1)[lo:lo + m].copy_(lanes.reshape(-1).view(x.dtype)[:m])


def from_lanes(lanes: torch.Tensor, meta: BlockMeta) -> torch.Tensor:
    """Inverse of :func:`to_lanes` (a view of ``lanes`` where it can be)."""
    flat = lanes.reshape(-1)[: meta.n_lanes].view(meta.torch_dtype)
    return flat[: meta.n_elems].reshape(meta.shape)


def stripe_dirty_mask(meta: BlockMeta, block_dirty: torch.Tensor) -> torch.Tensor:
    """bool[n_stripes] of stripes containing at least one dirty block."""
    return stripe_dirty_rows(meta, block_dirty[None])[0]


def stripe_dirty_rows(meta: BlockMeta, block_dirty: torch.Tensor) -> torch.Tensor:
    """bool[k, n_stripes] of a (k, n_blocks) block mask, shard by shard
    (a stripe never spans shards)."""
    k = block_dirty.shape[0]
    padded = torch.zeros((k, meta.padded_blocks), dtype=torch.bool,
                         device=block_dirty.device)
    padded[:, : meta.n_blocks] = block_dirty
    return padded.view(k, meta.n_stripes, meta.stripe_data_blocks).any(dim=2)


def _split_view(x: torch.Tensor, splits):
    """``(splits, local, view)``: the per-dim shard counts, the local shape,
    and the leaf as a view ``(*splits, *local)`` (chunk axes first, so that
    flattening them gives the reference's row-major shard index)."""
    shape = tuple(x.shape)
    splits = tuple(splits) + (1,) * (len(shape) - len(splits))
    local = tuple(d // s for d, s in zip(shape, splits))
    nd = len(shape)
    split = x.reshape(tuple(v for d, s in zip(local, splits) for v in (s, d)))
    order = [2 * i for i in range(nd)] + [2 * i + 1 for i in range(nd)]
    return splits, local, split.permute(order)


def shard_view(x: torch.Tensor, splits) -> torch.Tensor:
    """``(k, *local)`` of a leaf split into ``splits[i]`` chunks along each
    dim ``i`` (dims past ``splits`` whole), shard ``s`` being the row-major
    index of its chunk indices, dim by dim: the reference's shard order.

    A view of the leaf's memory when only dim 0 is split (each shard a
    contiguous row range); a contiguous staged copy, shard after shard,
    when another dim is split (a KV cache under ``cache_specs``).
    """
    splits, local, perm = _split_view(x, splits)
    k = math.prod(splits)
    if not is_strided(splits):
        return x.contiguous().reshape((k,) + local)
    return perm.reshape((k,) + local)


def is_strided(splits) -> bool:
    """Does a split make shards that are not contiguous row ranges?"""
    return any(s > 1 for s in tuple(splits)[1:])


def shard_lanes(x: torch.Tensor, meta: BlockMeta, splits) -> torch.Tensor:
    """int32 ``(k, n_blocks, lanes_per_block)`` lane view of every shard of
    a leaf (``meta`` is the shard-local geometry, ``splits`` as in
    :func:`shard_view`).

    A view of the leaf's memory when each shard is a contiguous row range
    filling its blocks exactly; a zero-padded copy where a shard's last
    block is partial, as :func:`to_lanes` pads one leaf.  Strided shards
    are staged with one copy (one read and one write of the leaf) straight
    into that layout, padded where it must be.
    """
    epw, n = meta.elems_per_word, meta.n_elems
    exact = n == meta.padded_lanes * epw
    if not is_strided(splits):
        k = math.prod(splits)
        flat = x.contiguous().reshape(k, -1)
        if exact:
            return flat.view(torch.int32).view(k, meta.n_blocks, meta.lanes_per_block)
        out = torch.empty((k, meta.padded_lanes * epw), dtype=x.dtype, device=x.device)
        out[:, :n] = flat
    else:
        splits, local, perm = _split_view(x, splits)
        k = math.prod(splits)
        out = torch.empty((k, meta.padded_lanes * epw), dtype=x.dtype, device=x.device)
        out[:, :n].view(splits + local).copy_(perm)
    if not exact:
        out[:, n:].zero_()                # each shard's partial last block
    return out.view(torch.int32).view(k, meta.n_blocks, meta.lanes_per_block)


def shard_slice(leaf: torch.Tensor, meta: BlockMeta, shards: int, shard: int):
    """One shard's rows of a dim0-sharded global leaf.

    Sharded redundancy state is addressed in *global block space*: shard
    ``s``'s local block ``b`` is global block ``s * meta.n_blocks + b``
    (``meta`` is the shard-local geometry).  Host-side surgery on that
    space (fault injection, parity reconstruction) needs the shard's local
    lane view back.  Supported for leading-axis sharding only, as in the
    reference; other specs raise its ``ValueError``.

    Returns ``(sub_leaf, put)``: ``sub_leaf`` is a view of the shard's
    rows, and ``put(new_sub)`` writes a modified shard back into ``leaf``
    in place (the reference returns a new global leaf) and returns it.
    """
    if shards == 1:
        return leaf, (lambda new: new)
    rows = meta.shape[0] if meta.shape else 1
    if (not meta.shape or leaf.shape[0] != rows * shards
            or tuple(leaf.shape[1:]) != tuple(meta.shape[1:])):
        raise ValueError(
            f"global-block addressing needs dim0-only sharding: global "
            f"{tuple(leaf.shape)} vs local {tuple(meta.shape)} x {shards}")
    lo = shard * rows
    sub = leaf[lo:lo + rows]

    def put(new):
        if new.data_ptr() != sub.data_ptr():
            sub.copy_(new)
        return leaf

    return sub, put


def global_stripe_id(meta: BlockMeta, block: int) -> int:
    """Global stripe id of a global block id (shard-local geometry ``meta``).

    Parity groups never span shards, so shard ``s`` owns stripes
    ``[s * n_stripes, (s+1) * n_stripes)``: the one formula repair
    grouping, parity-fault placement and clean-stripe planning share.
    """
    s, b = divmod(int(block), meta.n_blocks)
    return s * meta.n_stripes + b // meta.stripe_data_blocks


def _row_geometry(meta: BlockMeta, row_dims: int):
    """(row_lanes, blocks_per_row) for rows over the first ``row_dims`` axes."""
    row_elems = (math.prod(meta.shape[row_dims:])
                 if len(meta.shape) > row_dims else 1)
    row_lanes = -(-row_elems // meta.elems_per_word)
    blocks_per_row = max(
        1, -(-row_elems // (meta.lanes_per_block * meta.elems_per_word)) + 1)
    return row_lanes, blocks_per_row


def _mask_from_ids(meta: BlockMeta, ids: torch.Tensor) -> torch.Tensor:
    """bool[n_blocks] with ``ids`` set; ids == n_blocks are dropped.

    Torch has no ``mode="drop"`` scatter: the sentinel lands in one extra
    slot that is sliced away, so nothing synchronises with the host.
    """
    mask = torch.zeros((meta.n_blocks + 1,), dtype=torch.bool, device=ids.device)
    # ``index_fill_``, not ``mask[ids] = True``: on the card the latter
    # copies its value from the host and so waits for the stream.
    mask.index_fill_(0, ids.reshape(-1), True)
    return mask[: meta.n_blocks]


def row_block_mask(meta: BlockMeta, row_ids: torch.Tensor,
                   row_dims: int = 1) -> torch.Tensor:
    """bool[n_blocks] mask of all blocks touched by the given rows (ids < 0
    ignored); handles rows straddling several blocks.  Offsets are int64:
    flat lane offsets reach 2^31 on multi-GiB leaves."""
    if not meta.shape:
        return torch.ones((meta.n_blocks,), dtype=torch.bool, device=row_ids.device)
    row_lanes, blocks_per_row = _row_geometry(meta, row_dims)
    valid = row_ids >= 0
    first_lane = torch.where(valid, row_ids, 0).to(torch.int64) * row_lanes
    first_block = first_lane // meta.lanes_per_block
    offs = torch.arange(blocks_per_row, dtype=torch.int64, device=row_ids.device)
    ids = first_block[:, None] + offs[None, :]
    last_block = (first_lane + row_lanes - 1) // meta.lanes_per_block
    live = (ids <= last_block[:, None]) & valid[:, None]
    return _mask_from_ids(meta, torch.where(live, ids, meta.n_blocks))


def row_mask_block_mask(meta: BlockMeta, row_mask: torch.Tensor,
                        row_dims: int = 1) -> torch.Tensor:
    """bool[n_blocks] of blocks touched by set rows of a bool row mask.

    When rows pack evenly into blocks the translation is a reshape-any
    reduction; otherwise it is a masked scatter over the row range — cost
    tracks the event shape, never the leaf size.
    """
    if not meta.shape:
        return row_mask.any().expand(meta.n_blocks).clone()
    row_mask = row_mask.reshape(-1)
    nb, L = meta.n_blocks, meta.lanes_per_block
    row_lanes, blocks_per_row = _row_geometry(meta, row_dims)
    R = row_mask.shape[0]
    dev = row_mask.device
    if row_lanes <= L and L % row_lanes == 0:
        # Rows never straddle a block boundary: block b = row // rows_per_block.
        rpb = L // row_lanes
        n_pb = -(-R // rpb)
        padded = torch.zeros((n_pb * rpb,), dtype=torch.bool, device=dev)
        padded[:R] = row_mask
        per_block = padded.view(n_pb, rpb).any(dim=1)
        if n_pb >= nb:
            return per_block[:nb]
        out = torch.zeros((nb,), dtype=torch.bool, device=dev)
        out[:n_pb] = per_block
        return out
    first_lane = torch.arange(R, dtype=torch.int64, device=dev) * row_lanes
    first_block = first_lane // L
    last_block = (first_lane + row_lanes - 1) // L
    offs = torch.arange(blocks_per_row, dtype=torch.int64, device=dev)
    ids = first_block[:, None] + offs[None, :]
    live = (ids <= last_block[:, None]) & row_mask[:, None]
    return _mask_from_ids(meta, torch.where(live, ids, nb))
