"""Cost of one traced step and its roofline: the counterpart of the
reference's ``repro.launch.hlo_analysis`` (``src/repro/launch/hlo_analysis.py``).

The reference reads FLOPs and bytes from XLA's cost analysis of a compiled
HLO module and parses the partitioned module's text for collectives.
PyTorch runs eagerly and has no HLO, so :func:`count_costs` counts a step
as it dispatches, on any device (the ``meta`` device included, where
nothing is computed):

- FLOPs of aten ops, from ``torch.utils.flop_counter``'s registered
  formulas (matrix products; elementwise ops count none, as there);
- bytes accessed: each op's tensor inputs and outputs (view and
  allocation ops move none), the counterpart of XLA's "bytes accessed";
- launches of the four hand kernels, each with its work by its own
  formula below (the wrappers report them: :func:`launch`), and the
  aten ops inside a wrapper (a plain version on the CPU, a scratch
  buffer on the card) not counted again, so a kernel counts the same on
  the meta device, on the CPU and on the card;
- collectives dispatched (``c10d`` ops), with :func:`effective_bytes`.
  The port runs on one card and dispatches none: its sharded store
  simulates the mesh on that card, and the record says so.

No counterpart: ``parse_collectives``, ``_shape_bytes`` and
``_group_size`` parse HLO text, and there is none here.

The peaks are one NVIDIA H100 SXM's (data sheet, dense, at its 700 W power
limit; a card set below it runs slower under load).  Each kernel's work
(:func:`checksum_work`, :func:`parity_work`, :func:`fused_update_work`,
:func:`flash_work`) and :func:`bound` are the definitions ``chip_smoke.py``
prints its bounds with.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# H100 SXM peaks at 700 W: dense bf16 tensor cores, the HBM3 rate and
# NVLink's rate each way (data sheet); the INT32 rate for the redundancy
# kernels' integer operations, 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (the data sheet's 67 TFLOP/s float32 figure counts 128 FP32 lanes and an
# FMA as two operations).
PEAK_BF16_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
ALU_OPS_PER_SEC = 132 * 64 * 1.98e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d op names (``torch.ops.c10d`` / ``_c10d_functional``) -> the
# reference's collective kinds.
_C10D_KINDS = {
    "allgather": "all-gather", "all_gather": "all-gather",
    "allreduce": "all-reduce", "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
    "alltoall": "all-to-all", "send": "collective-permute",
    "recv": "collective-permute"}
ONE_CARD_NOTE = ("one card: the port's sharded store simulates the mesh on "
                 "that card, so a step dispatches no collective")

aten = torch.ops.aten
# Ops that allocate or alias and move no bytes (views are found by schema).
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.detach.default,
               aten.alias.default, aten.lift_fresh.default,
               aten._unsafe_view.default}


# ------------------------------------------------------------ kernels' work
def bound(bytes_moved: float, ops: float, ops_per_sec: float = ALU_OPS_PER_SEC,
          hbm_bw: float = HBM_BW) -> Tuple[float, str]:
    """The least time in ms the card could take for the work, and what
    bounds it (``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = bytes_moved / hbm_bw, ops / ops_per_sec
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def checksum_work(n_blocks: int, L: int) -> Tuple[int, int]:
    """K1 over ``n_blocks`` blocks of ``L`` lanes (every shard's): the
    lanes read and the checksums written once; 12 integer operations a
    lane.  Returns ``(bytes, ops)``."""
    return n_blocks * L * 4 + n_blocks * 4, n_blocks * L * 12


def parity_work(n_blocks: int, n_stripes: int, L: int) -> Tuple[int, int]:
    """K2: the lanes read, each stripe's parity row written; one XOR a
    lane.  Returns ``(bytes, ops)``."""
    return n_blocks * L * 4 + n_stripes * L * 4, n_blocks * L


def fused_update_work(stripes: int, stripe_width: int, L: int, n_words: int,
                      checksums: Optional[int] = None) -> Tuple[int, int]:
    """K3 over ``stripes`` dirty stripes: their members read, their parity
    rows and ``checksums`` checksums written (every member's by default),
    the ``n_words`` packed dirty words read; 13 integer operations a lane.
    Returns ``(bytes, ops)``."""
    if checksums is None:
        checksums = stripes * stripe_width
    n_bytes = (stripes * stripe_width * L * 4 + stripes * L * 4 + checksums * 4
               + n_words * 4)
    return n_bytes, stripes * stripe_width * L * 13


def attention_flops(B: int, Sq: int, Sk: int, H: int, hd: int, causal: bool) -> int:
    """Both products over the (query, key) pairs the mask keeps: row r sees
    min(r + 1, Sk) keys when causal, all Sk otherwise."""
    if not causal:
        return 4 * B * H * hd * Sq * Sk
    n = min(Sq, Sk)
    pairs = n * (n + 1) // 2 + max(0, Sq - Sk) * Sk
    return 4 * B * H * hd * pairs


def flash_work(q, k, v, causal: bool) -> Tuple[int, int]:
    """The flash kernel: ``(flops, bytes)``, q, k and v read once and the
    output (q's shape and dtype) written once."""
    B, Sq, H, hd = q.shape
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    return attention_flops(B, Sq, k.shape[1], H, hd, causal), n_bytes


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N per token, plus causal
    attention's two products over S (S + 1) / 2 (query, key) pairs a
    head, three times (forward and backward), in every layer.  Per-slot
    recomputation is not counted."""
    attn = 3 * 4 * batch * cfg.n_heads * cfg.hd * seq * (seq + 1) // 2
    return 6 * n_params * batch * seq + attn * cfg.n_layers


def xlstm_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one xLSTM training step: 6 N per token, plus each
    mLSTM layer's chunkwise products (the intra-chunk q k and scores v
    over 256 keys, masked half included, and the inter-chunk reads and
    updates of the hd x hd state), three times (forward and backward).
    The per-slot and per-chunk recomputes are not counted."""
    tokens, d = batch * seq, cfg.d_model
    hd = d // cfg.n_heads
    chunk = min(256, seq)
    per_layer = 2 * 2 * tokens * chunk * d + 2 * 2 * tokens * d * hd
    n_mlstm = sum(cfg.layer_kind(i) == "mlstm" for i in range(cfg.n_layers))
    return 6 * n_params * tokens + 3 * per_layer * n_mlstm


def due_tick_bound(store, words: Dict[str, torch.Tensor]) -> dict:
    """K3's bound for a due tick from the snapshot it consumed (``words``,
    each leaf's packed in-flight bits, shard after shard): every dirty
    stripe's members read, its parity row and its blocks' checksums
    written, the words read.  Counting the stripes reads the words (a
    host wait: for a check, off any timed path)."""
    from ..core import bits, blocks
    n_bytes = ops = stripes = 0
    for n, w in words.items():
        meta = store.metas[n]
        live = bits.unpack_rows(w, store.shard_factor(n), meta.n_blocks)
        ns = int(blocks.stripe_dirty_rows(meta, live).sum())
        b, o = fused_update_work(ns, meta.stripe_data_blocks, meta.lanes_per_block,
                                 w.numel())
        n_bytes, ops, stripes = n_bytes + b, ops + o, stripes + ns
    bms, by = bound(n_bytes, ops)
    return {"stripes": stripes, "gb": n_bytes / 1e9, "bound_ms": bms, "bound_by": by}


# -------------------------------------------------------------- collectives
def effective_bytes(op: str, result_bytes: int, g: int) -> float:
    """Ring-transfer bytes per chip of a collective over a group of ``g``."""
    if op == "collective-permute":  # point to point
        return float(result_bytes)
    if g <= 1:
        return 0.0
    if op == "all-gather":          # result is the gathered buffer
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":      # result is the scattered shard
        return result_bytes * (g - 1)
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, float]
    per_op_count: Dict[str, int]
    total_bytes: float

    def summary(self) -> Dict:
        return {"total_bytes": self.total_bytes,
                "per_op_bytes": self.per_op, "per_op_count": self.per_op_count}


# ----------------------------------------------------------------- roofline
@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float
    useful_ratio: float
    bottleneck: str
    roofline_fraction: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, chips: int, model_flops: float,
                   peak_flops: float = PEAK_BF16_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = NVLINK_BW) -> Roofline:
    """The reference's roofline terms (its field names: ``hlo_*`` are the
    counted step's), against the H100's peaks unless others are given."""
    compute_s = flops_per_chip / peak_flops
    memory_s = bytes_per_chip / hbm_bw
    collective_s = coll_bytes_per_chip / link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops_per_chip * chips
    useful = model_flops / total_flops if total_flops else 0.0
    # Useful model FLOPs over what the dominant term's time could have
    # delivered at peak compute.
    dom = max(terms.values())
    frac = (model_flops / chips / peak_flops) / dom if dom > 0 else 0.0
    return Roofline(compute_s, memory_s, collective_s, flops_per_chip,
                    bytes_per_chip, coll_bytes_per_chip, model_flops,
                    useful, bottleneck, frac)


# ------------------------------------------------------------------ counter
@dataclasses.dataclass
class KernelCount:
    launches: int = 0
    flops: int = 0
    bytes: int = 0
    ops: int = 0            # integer operations (K1-K3)


@dataclasses.dataclass
class Costs:
    """What :func:`count_costs` counted: the aten ops' ``flops`` and
    ``bytes``, each hand kernel's launches and work, the named copies the
    kernels' wrappers made (``copies``: bytes by name), the collectives,
    and the aten ops by name (``by_op``: count, FLOPs, bytes)."""
    flops: int = 0
    bytes: int = 0
    n_ops: int = 0
    kernels: Dict[str, KernelCount] = dataclasses.field(default_factory=dict)
    copies: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: CollectiveStats = dataclasses.field(
        default_factory=lambda: CollectiveStats({}, {}, 0.0))
    by_op: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    @property
    def total_flops(self) -> int:
        """The aten ops' FLOPs and the kernels' (flash's products)."""
        return self.flops + sum(k.flops for k in self.kernels.values())

    @property
    def total_bytes(self) -> int:
        return self.bytes + sum(k.bytes for k in self.kernels.values())

    def launches(self) -> Dict[str, int]:
        return {n: k.launches for n, k in self.kernels.items()}

    def key(self) -> dict:
        """The integers a trace and a run of the same step must share:
        FLOPs, bytes, and each kernel's launches and work."""
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": {n: dataclasses.astuple(k) for n, k in
                            sorted(self.kernels.items())}}

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "aten_ops": self.n_ops,
                "total_flops": self.total_flops, "total_bytes": self.total_bytes,
                "kernels": {n: dataclasses.asdict(k) for n, k in self.kernels.items()},
                "copies": dict(self.copies),
                "collectives": {**self.collectives.summary(),
                                **({} if self.collectives.per_op_count
                                   else {"note": ONE_CARD_NOTE})}}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.suspended = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.suspended:
            return func(*args, **kwargs)
        # A composite op (``matmul`` under inference mode) is counted as
        # the ops it decomposes into, as FlopCounterMode counts it: the
        # same ops, whatever the grad mode.
        if func._overloadpacket not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        c = self.costs
        name = str(func.name())
        ns = name.split("::")[0]
        if ns in ("c10d", "_c10d_functional"):
            base = name.split("::")[1].rstrip("_")
            kind = next((v for k, v in _C10D_KINDS.items() if base.startswith(k)), None)
            if kind is not None:
                eb = effective_bytes(kind, _nbytes(out), _group_size())
                st = c.collectives
                st.per_op[kind] = st.per_op.get(kind, 0.0) + eb
                st.per_op_count[kind] = st.per_op_count.get(kind, 0) + 1
                st.total_bytes += eb
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        n_bytes = 0
        if not func.is_view and func not in _NO_TRAFFIC:
            n_bytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        c.flops += flops
        c.bytes += n_bytes
        c.n_ops += 1
        row = c.by_op.setdefault(str(func), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += n_bytes
        return out


_ACTIVE: List[_Counter] = []


@contextlib.contextmanager
def count_costs():
    """Count every aten op, hand-kernel launch and collective dispatched
    in the block, on any device; yields the :class:`Costs` it fills."""
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            yield counter.costs
    finally:
        _ACTIVE.remove(counter)


@contextlib.contextmanager
def launch(name: str, work: Callable[[], Tuple[int, int, int, int]]):
    """Around a hand kernel's wrapper: the aten ops inside are not counted,
    and, if the block returns, every active counter gets the kernel's
    ``work()``, ``(launches, flops, bytes, integer ops)``."""
    counters = list(_ACTIVE)
    for c in counters:
        c.suspended += 1
    try:
        yield
    finally:
        for c in counters:
            c.suspended -= 1
    if counters:
        n, flops, n_bytes, ops = work()
        for c in counters:
            k = c.costs.kernels.setdefault(name, KernelCount())
            k.launches += n
            k.flops += flops
            k.bytes += n_bytes
            k.ops += ops


def note_copy(name: str, n_bytes: int) -> None:
    """A copy a wrapper makes on the card only (a layout its kernel cannot
    read in place), counted under its own name."""
    for c in _ACTIVE:
        c.costs.copies[name] = c.costs.copies.get(name, 0) + n_bytes


def assert_no_collectives(fn: Callable[[], object], where: str = "program") -> None:
    """Run ``fn()`` under the counter and assert it dispatched no
    collective: the machine-locality check (paper §3.3) that the
    reference makes on a lowered program's HLO."""
    with count_costs() as costs:
        fn()
    found = sorted(costs.collectives.per_op_count)
    if found:
        raise AssertionError(f"{where}: collectives dispatched: {found}")


__all__ = ["ALU_OPS_PER_SEC", "COLLECTIVES", "CollectiveStats", "Costs", "HBM_BW",
           "KernelCount", "NVLINK_BW", "PEAK_BF16_FLOPS", "Roofline",
           "assert_no_collectives", "attention_flops", "bound", "checksum_work",
           "count_costs", "due_tick_bound", "effective_bytes", "flash_work",
           "fused_update_work", "launch", "note_copy", "parity_work",
           "roofline_terms", "train_flops", "xlstm_flops"]
