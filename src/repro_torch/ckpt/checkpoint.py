"""Fault-tolerant checkpointing with Vilamb meta-checksums.

The port of ``repro.ckpt.checkpoint``, with the same on-disk format, so a
checkpoint written by either package restores in the other:
``step_N/manifest.json`` and ``step_N/state.npz``, one array ``a{i}`` per
leaf in the reference's flatten order of ``TrainState`` (key paths
``params/...``, ``opt/count``, ``opt/m/...``, ``opt/v/...``,
``red/<leaf>/<field>``, ``step``) or of the crash machine's
``StoreState`` (``leaves/<leaf>``, ``red/<leaf>/<field>``, ``step``),
bf16 leaves stored as ``uint16`` and
named in the manifest's ``bf16`` list, the redundancy fields as
``uint32``, ``step`` and ``count`` as int32 0-d arrays.

- **Atomic**: written to ``step_N.tmp/`` and renamed, so a crash mid-save
  never corrupts the latest checkpoint.
- **Self-verifying**: every leaf carries an fmix32 XOR-fold file checksum
  (:func:`file_checksum`), verified at restore; a mismatch rejects the
  checkpoint and the previous one is tried.  The checksum is computed on
  the leaf's own device, in int32 torch ops and in chunks, before the
  device-to-host copy on save and after the host-to-device copy on
  restore: the host never holds more than the leaf's own bytes.
- **Redundancy-aware**: the Vilamb state (checksums, parity, dirty and
  shadow bitvectors, meta-checksum) is saved with the leaves, so a restart
  resumes with the coverage the shadow protocol guarantees.
- **Async**: the device-to-host copy is synchronous; serialisation runs
  on a background thread.
- **Store-verified**: ``restore_verified`` scrubs the restored leaves
  against their restored redundancy and repairs single-block corruption
  from parity instead of discarding the checkpoint.

Reading ``state.red`` mid-run: on the card a due tick's update refreshes
the live view's checksums and parity in place on the store's side stream,
so ``save(..., store=store)`` orders its copies after the store's
in-flight updates first (``ProtectedStore.await_inflight``).  The saved
state is then the live view after the update: new checksums, parity and
meta-checksum, with ``shadow`` still marking the in-flight blocks.

No ``ml_dtypes`` is needed: bf16 travels as ``uint16`` bits and is viewed
as ``torch.bfloat16`` on the device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import shutil
import struct
import threading
import time
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import flatten_dict, replace_leaves, resolve_device
from ..common.device import DeviceLike
from ..core.state import FIELDS, LeafRedundancy
from ..kernels.common import GOLDEN, fmix32_, i32, xor_fold

# Words per chunk of the on-device file checksum (256 MiB of int32; the
# temporaries are a few times that).
CHUNK_WORDS = 1 << 26
# Bytes of the pinned buffer that copies between the card and the host.
STAGING_BYTES = 256 << 20


@dataclasses.dataclass
class RestoreReport:
    """What ``restore_verified`` did.

    ``tried`` records one ``(step, outcome)`` pair per candidate in the
    order attempted; outcomes: ``ok``, ``ok_repaired``, ``load_failed``,
    ``file_checksum``, ``meta_checksum``, ``unrecoverable``,
    ``repair_failed``.  ``step`` is the checkpoint finally returned (None =
    every candidate rejected).  ``repaired_blocks`` counts parity rebuilds
    on the returned candidate; ``lost_blocks`` accumulates the unrepairable
    blocks of rejected candidates; ``unrecoverable`` names them, one
    :class:`~repro_torch.core.repairs.UnrecoverableBlock` per refused
    stripe.
    """
    tried: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    step: Optional[int] = None
    repaired_blocks: int = 0
    lost_blocks: int = 0
    unrecoverable: List[Any] = dataclasses.field(default_factory=list)


def _path_str(kp) -> str:
    """``/``-joined key path (the reference's, from the parts of a path)."""
    return "/".join(str(k) for k in kp)


def _is_store_state(state) -> bool:
    """A crash checkpoint's ``StoreState`` (``leaves``, ``red``, ``step``:
    a raw store's protected leaves, flat by name) rather than a
    ``TrainState``."""
    return hasattr(state, "leaves") and not hasattr(state, "params")


def state_leaves(state) -> Dict[str, Any]:
    """Every leaf of a ``TrainState`` or a ``StoreState`` by the reference's
    key path, in the order ``jax.tree_util`` flattens the reference's
    dataclass: the fields in declaration order, dict keys sorted, each
    ``LeafRedundancy`` in field order.  Empty subtrees have no leaves;
    ``step`` and ``count`` stay Python ints."""
    out: Dict[str, Any] = {}
    if _is_store_state(state):
        for k in sorted(state.leaves):
            out[_path_str(("leaves", k))] = state.leaves[k]
    else:
        for k, v in flatten_dict(state.params).items():
            out[_path_str(("params", k))] = v
        for key in sorted(state.opt):
            sub = state.opt[key]
            if isinstance(sub, dict):
                for k, v in flatten_dict(sub).items():
                    out[_path_str(("opt", key, k))] = v
            else:
                out[_path_str(("opt", key))] = sub
    for name in sorted(state.red):
        for f in FIELDS:
            out[_path_str(("red", name, f))] = getattr(state.red[name], f)
    out["step"] = state.step
    return out


def state_from_leaves(template, flat: Dict[str, Any]):
    """Inverse of :func:`state_leaves`: ``template``'s structure with every
    leaf taken from ``flat``."""
    red = {name: LeafRedundancy(**{f: flat[f"red/{name}/{f}"] for f in FIELDS})
           for name in template.red}
    if _is_store_state(template):
        return dataclasses.replace(
            template, leaves={k: flat[f"leaves/{k}"] for k in template.leaves},
            red=red, step=flat["step"])

    def sub(prefix):
        return {k[len(prefix) + 1:]: v for k, v in flat.items()
                if k.startswith(prefix + "/")}
    opt = {key: replace_leaves(v, sub(f"opt/{key}")) if isinstance(v, dict)
           else flat[f"opt/{key}"] for key, v in template.opt.items()}
    return dataclasses.replace(template, params=replace_leaves(template.params,
                                                               sub("params")),
                               opt=opt, red=red, step=flat["step"])


def _np_checksum(a: np.ndarray) -> int:
    """fmix32 XOR-fold over the raw bytes: the reference's host function,
    kept as the plain version of :func:`file_checksum`."""
    raw = np.frombuffer(a.tobytes() + b"\x00" * (-a.nbytes % 4), dtype=np.uint32)
    idx = np.arange(raw.size, dtype=np.uint32)
    x = raw ^ (idx * np.uint32(0x9E3779B9))
    x ^= x >> 16
    x = (x * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> 13
    x = (x * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    x ^= x >> 16
    return int(np.bitwise_xor.reduce(x)) if x.size else 0


def file_checksum(t: torch.Tensor, chunk_words: int = CHUNK_WORDS) -> int:
    """:func:`_np_checksum` of ``t``'s bytes, computed where ``t`` lies.

    The bytes are read as little-endian uint32 words (carried as int32, a
    partial last word zero-padded); word ``i`` is salted with
    ``i * GOLDEN mod 2^32``, mixed by fmix32 and XOR-folded.  Chunks of
    ``chunk_words`` words keep the temporaries small; the salt of a chunk
    starting at word ``s`` is ``j * GOLDEN + s * GOLDEN`` (mod 2^32), so
    the result does not depend on the chunking.  Returns the uint32 value.
    """
    if t.numel() == 0:
        return 0
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if flat.storage_offset() % 4:
        flat = flat.clone()
    n_full, rem = divmod(flat.numel(), 4)
    dev = flat.device
    acc = torch.zeros((), dtype=torch.int32, device=dev)
    if n_full:
        words = flat[: 4 * n_full].view(torch.int32)
        base = torch.arange(min(chunk_words, n_full), dtype=torch.int32, device=dev)
        for s in range(0, n_full, chunk_words):
            w = words[s: s + chunk_words]
            x = base[: w.numel()] * GOLDEN
            x += i32(s * GOLDEN)
            x ^= w
            acc ^= xor_fold(fmix32_(x), 0)
    if rem:
        tail = torch.zeros(4, dtype=torch.uint8, device=dev)
        tail[:rem] = flat[4 * n_full:]
        x = tail.view(torch.int32) ^ i32(n_full * GOLDEN)
        acc ^= fmix32_(x)[0]
    return int(acc.item()) & 0xFFFFFFFF


def _leaf_tensor(v) -> torch.Tensor:
    """A leaf as a tensor (``step`` and ``count`` are Python ints)."""
    return torch.tensor(v, dtype=torch.int32) if isinstance(v, int) else v.detach()


class _Staging:
    """Copies between the card and host memory through one reused pinned
    buffer of ``STAGING_BYTES``: a pageable copy runs through the CUDA runtime's
    own small staging at a fraction of the link's rate."""

    def __init__(self):
        self.buf = torch.empty(STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
        self.host = self.buf.numpy()

    def to_host(self, src: torch.Tensor, dst: np.ndarray) -> None:
        """The bytes of the card tensor ``src`` (uint8) into ``dst``."""
        for off in range(0, src.numel(), STAGING_BYTES):
            n = min(STAGING_BYTES, src.numel() - off)
            self.buf[:n].copy_(src[off: off + n], non_blocking=True)
            torch.cuda.current_stream(src.device).synchronize()
            dst[off: off + n] = self.host[:n]

    def from_file(self, f, dst: torch.Tensor) -> None:
        """``dst.numel()`` bytes read from ``f`` into the card tensor ``dst``."""
        for off in range(0, dst.numel(), STAGING_BYTES):
            n = min(STAGING_BYTES, dst.numel() - off)
            if f.readinto(memoryview(self.host[:n])) != n:
                raise ValueError("checkpoint array is truncated")
            dst[off: off + n].copy_(self.buf[:n], non_blocking=True)
            torch.cuda.current_stream(dst.device).synchronize()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as a flat uint8 tensor."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _to_host(key: str, t: torch.Tensor, staging) -> Tuple[np.ndarray, str]:
    """``(array, manifest dtype)``: bf16 as its uint16 bits, the
    redundancy fields as uint32, everything else as itself; a card tensor
    is copied through ``staging``."""
    if t.dtype == torch.bfloat16:
        np_dtype, name = np.dtype(np.uint16), "bfloat16"
    elif key.startswith("red/"):
        np_dtype, name = np.dtype(np.uint32), "uint32"
    else:
        np_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        name = np_dtype.name
    a = np.empty(tuple(t.shape), np_dtype)
    if t.numel():
        flat = a.reshape(-1).view(np.uint8)
        if t.device.type == "cuda":
            staging.to_host(_bytes(t), flat)
        else:
            flat[:] = _bytes(t).numpy()
    return a, name


class _NpzReader:
    """The arrays of an ``np.savez`` file, each read once straight from its
    stored zip member (the npy header, then the raw bytes) onto a device.

    ``np.load`` reads a member in 256 KiB pieces through ``zipfile``, which
    also folds a CRC-32 over them: under 1 GB/s.  Here the bytes go into
    the destination with one ``readinto`` (through the pinned staging
    buffer on the card); their integrity is the manifest's file checksum,
    and the header's shape and dtype are held to the manifest's.  Both
    packages write stored (uncompressed) members; any other is refused."""

    def __init__(self, path):
        self.zip = zipfile.ZipFile(path)
        self.raw = open(path, "rb")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.raw.close()
        self.zip.close()

    def read(self, key: str, meta: dict, bf16: bool, device: torch.device,
             staging) -> torch.Tensor:
        info = self.zip.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{key}: compressed zip member")
        f = self.raw
        f.seek(info.header_offset)
        head = f.read(30)
        if len(head) != 30 or head[:4] != b"PK\x03\x04":
            raise ValueError(f"{key}: bad zip member header")
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        nbytes = math.prod(shape) * dtype.itemsize
        if fortran or f.tell() - start + nbytes != info.file_size:
            raise ValueError(f"{key}: unexpected npy layout")
        dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
        if nbytes and device.type == "cuda":
            staging.from_file(f, dst)
        elif nbytes and f.readinto(memoryview(dst.numpy())) != nbytes:
            raise ValueError(f"{key}: truncated")
        return self._typed(dst, shape, dtype, meta, bf16)

    @staticmethod
    def _typed(raw: torch.Tensor, shape, dtype: np.dtype, meta: dict,
               bf16: bool) -> torch.Tensor:
        """``raw`` bytes as the leaf's tensor (bf16 from its uint16 bits,
        uint32 as the port's int32), after holding the header to the
        manifest."""
        want = "bfloat16" if bf16 else dtype.name
        if list(shape) != list(meta["shape"]) or want != meta["dtype"] or (
                bf16 and dtype != np.uint16):
            raise ValueError(f"header {shape} {dtype} against manifest {meta}")
        if bf16:
            tdtype = torch.bfloat16
        elif dtype == np.uint32:
            tdtype = torch.int32
        else:
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return raw.view(tdtype).reshape(tuple(shape))


class CheckpointManager:
    """Numbered checkpoints in ``directory``, the last ``keep`` kept.

    ``device`` is where restored tensors land and where restore verifies
    the file checksums: the GPU unless the caller passes ``device="cpu"``.
    ``last_save`` and ``last_restore`` hold the byte counts and the
    seconds of each part of the latest save (``checksum_s``, ``copy_s``,
    ``write_s``) and restore (``read_s``: load and host-to-device copy;
    ``verify_s``: the file checksums).
    """

    def __init__(self, directory, keep: int = 3, device: DeviceLike = None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.device = resolve_device(device, "CheckpointManager")
        self._thread: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self.last_restore_report: Optional[RestoreReport] = None
        self.last_save: Dict[str, Any] = {}
        self.last_restore: Dict[str, Any] = {}
        self._pinned: Optional[_Staging] = None

    def _staging(self) -> Optional[_Staging]:
        """The pinned copy buffer (made at first use on the card)."""
        if self._pinned is None and self.device.type == "cuda":
            self._pinned = _Staging()
        return self._pinned

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Any, blocking: bool = True,
             store=None) -> None:
        """Snapshot ``state`` to the host and write it as ``step_{step}``
        (on a background thread unless ``blocking``).

        Pass the ``store`` whose updates may be in flight (a save right
        after a due tick on the card): the copies are then ordered after
        them on the device (``store.await_inflight()``)."""
        if store is not None:
            store.await_inflight()
        flat = {k: _leaf_tensor(v) for k, v in state_leaves(state).items()}
        t0 = time.perf_counter()
        sums = {k: file_checksum(t) for k, t in flat.items()}
        t1 = time.perf_counter()
        host = {k: _to_host(k, t, self._staging()) for k, t in flat.items()}
        t2 = time.perf_counter()
        self.wait()
        self.last_save = {"step": int(step), "checksum_s": t1 - t0, "copy_s": t2 - t1,
                          "bytes": sum(a.nbytes for a, _ in host.values())}
        if blocking:
            self._write(step, host, sums)
        else:
            self._thread = threading.Thread(target=self._write_async,
                                            args=(step, host, sums))
            self._thread.start()

    def _write_async(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:      # re-raised by wait()
            self._write_error = e

    def wait(self) -> None:
        """Join the background write; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               sums: Dict[str, int]) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {"step": step, "leaves": {}, "bf16": []}
        arrays = {}
        for i, (k, (a, dtype)) in enumerate(host.items()):
            key = f"a{i}"
            if dtype == "bfloat16":
                manifest["bf16"].append(k)
            arrays[key] = a
            manifest["leaves"][k] = {
                "shape": list(a.shape), "dtype": dtype,
                "checksum": sums[k], "file_key": key,
            }
        np.savez(tmp / "state.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        self.last_save["write_s"] = time.perf_counter() - t0

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def restore_flat(self, step: Optional[int] = None,
                     verify: bool = True) -> Optional[Dict[str, Any]]:
        """Newest-first restore with checksum verification; a corrupted
        checkpoint is rejected and the previous one tried (paper §2.2).
        Returns ``{key path: tensor on the manager's device}`` (bf16 as
        bfloat16, uint32 fields as int32) plus ``__step__``, or None."""
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        for s in reversed(candidates):
            d = self.dir / f"step_{s}"
            rec = {"step": s, "read_s": 0.0, "verify_s": 0.0, "bytes": 0}
            self.last_restore = rec
            try:
                manifest = json.loads((d / "manifest.json").read_text())
                out: Dict[str, Any] = {}
                ok = True
                bf16 = set(manifest.get("bf16", []))
                with _NpzReader(d / "state.npz") as z:
                    for k, meta in manifest["leaves"].items():
                        t0 = time.perf_counter()
                        v = z.read(meta["file_key"], meta, k in bf16, self.device,
                                   self._staging())
                        t1 = time.perf_counter()
                        rec["read_s"] += t1 - t0
                        rec["bytes"] += v.numel() * v.element_size()
                        if verify and file_checksum(v) != meta["checksum"]:
                            ok = False
                        rec["verify_s"] += time.perf_counter() - t1
                        if not ok:
                            break
                        out[k] = v
                if ok:
                    out["__step__"] = s
                    return out
            except Exception:
                continue
        return None

    def restore_verified(self, state_struct: Any, store, *,
                         leaves_of=None, replace_leaves=None,
                         step: Optional[int] = None) -> Optional[Any]:
        """Newest-first restore verified end to end by the ProtectedStore.

        File checksums (``restore_into``) catch storage corruption; this
        also checks the restored checksum-of-checksums and scrubs the
        restored protected leaves against their restored redundancy.
        Detected blocks are rebuilt from parity (in place) when their
        stripe permits; an unrecoverable checkpoint is skipped and the
        previous one tried.  ``store`` must have no update in flight (a
        fresh store, or one flushed): its scrub settles pending updates
        into the red it is given.

        ``leaves_of(state) -> flat leaves`` and ``replace_leaves(state,
        leaves) -> state`` default to the TrainState protected-leaf view.
        ``self.last_restore_report`` records the attempt trail.
        """
        if leaves_of is None or replace_leaves is None:
            from ..train.state import protected_leaves, replace_protected
            leaves_of = leaves_of or (
                lambda st: protected_leaves(st.params, st.opt))
            replace_leaves = replace_leaves or (
                lambda st, lv: replace_protected(st, lv))
        report = RestoreReport()
        self.last_restore_report = report
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        for s in reversed(candidates):
            try:
                state = self.restore_into(state_struct, step=s)
            except Exception as e:
                # Keep falling back through older checkpoints, but loudly: a
                # systematic failure (struct mismatch, permissions) would
                # otherwise masquerade as "no checkpoint, fresh start".
                warnings.warn(f"restore of step {s} failed: {e!r}; "
                              "trying the previous checkpoint")
                report.tried.append((s, "load_failed"))
                continue
            if state is None:
                report.tried.append((s, "file_checksum"))
                continue
            if store is None or not store.protects:
                report.tried.append((s, "ok"))
                report.step = s
                return state
            red = state.red
            leaves = leaves_of(state)
            if not all(bool(ok) for ok in store.verify_meta(red).values()):
                report.tried.append((s, "meta_checksum"))
                continue  # corrupted checksum pages: try the previous ckpt
            mm = store.scrub(leaves, red)
            if sum(int(v.sum()) for v in mm.values()) == 0:
                report.tried.append((s, "ok"))
                report.step = s
                return state
            details: List[Any] = []
            repaired, fixed, lost = store.repair(leaves, red, mm, details=details)
            if lost:
                report.tried.append((s, "unrecoverable"))
                report.lost_blocks += int(lost)
                report.unrecoverable.extend(details)
                continue  # vulnerable or multi-corrupt stripe: fall back
            mm2 = store.scrub(repaired, red)
            if sum(int(v.sum()) for v in mm2.values()) == 0:
                report.tried.append((s, "ok_repaired"))
                report.step = s
                report.repaired_blocks += int(fixed)
                return replace_leaves(state, repaired)
            report.tried.append((s, "repair_failed"))
        return None

    def restore_into(self, state_struct: Any,
                     step: Optional[int] = None) -> Optional[Any]:
        """Rebuild a state like ``state_struct`` (a ``TrainState`` or a
        ``StoreState`` whose leaves carry the shapes, e.g. meta tensors from
        ``Trainer.state_struct``) from the newest verified checkpoint.
        Every shard of a sharded store lives on one device, so the
        reference's ``shardings`` argument has no counterpart."""
        host = self.restore_flat(step)
        if host is None:
            return None
        host.pop("__step__", None)
        flat: Dict[str, Any] = {}
        for k, leaf in state_leaves(state_struct).items():
            v = host.get(k)
            if v is None:
                raise KeyError(f"checkpoint missing leaf {k}")
            shape = () if isinstance(leaf, int) else tuple(leaf.shape)
            if tuple(v.shape) != shape:
                raise ValueError(f"shape mismatch for {k}: ckpt {tuple(v.shape)} "
                                 f"vs {shape}")
            if not isinstance(leaf, int) and v.dtype != leaf.dtype:
                raise ValueError(f"dtype mismatch for {k}: ckpt {v.dtype} vs {leaf.dtype}")
            flat[k] = int(v) if isinstance(leaf, int) else v
        return state_from_leaves(state_struct, flat)
