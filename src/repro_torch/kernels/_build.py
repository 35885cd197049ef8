"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``.cu`` source compiles with its own ``nvcc`` process, all started
together, for ``sm_90a``; one link step makes one shared library with a
plain C interface, loaded with ``ctypes``.  The library goes to
``build/repro_torch/<hash>/`` at the repository root, keyed by a hash of
the sources and flags, so the first call after a change rebuilds and every
later call loads.  Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "libvilamb.so"

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    # lanes, out, blocks a shard, L, block offset, shards, lanes from one
    # shard to the next, stream.
    "vilamb_checksum": (_P, _P, _I, _I, _I, _I, _I, _P),
    # lanes, parity, blocks a shard, L, stripe, shards, stream.
    "vilamb_parity": (_P, _P, _I, _I, _I, _I, _P),
    # descriptors, n_jobs, total items, items a grab, stripe, tile columns,
    # ticket, counters, partials, stream.
    "vilamb_fused_update_many": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "vilamb_fused_update_max_jobs": (),
    "vilamb_fused_update_grid": (_I, _I),
    # q, k, v, out; B, S, H, KV, hd, dtype, causal; 4 x (head, seq, batch)
    # byte strides; scale; stream.
    "vilamb_flash_attn": (_P, _P, _P, _P) + (_I,) * 8 + (_I,) * 12 + (_D, _P),
    "vilamb_flash_smem_bytes": (_I,),
}


def nvcc() -> str:
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); returns the
    library's path.  A failed compile raises with nvcc's stderr."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        cu, _ = _sources()
        exe = nvcc()
        procs = [(src, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", str(src),
             "-o", str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for src in cu]
        log, failed = [], []
        for src, p in procs:
            out, err = p.communicate()
            log.append(f"== {src.name}\n{out}{err}")
            if p.returncode:
                failed.append(f"nvcc failed on {src.name} (exit {p.returncode}):\n{err}")
        (tmp / "nvcc.log").write_text("".join(log))
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run(
            [exe, *NVCC_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / (s.stem + ".o")) for s in cu)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        try:
            tmp.rename(out_dir)
        except OSError:          # built meanwhile by another process
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory use) of the build."""
    return (build().parent / "nvcc.log").read_text()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error (its cudaGetLastError)."""
    if rc:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def stream_handle(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_lanes(lanes: torch.Tensor, kernel: str,
                  strided_shards: bool = False) -> None:
    """Validate a lane view for the kernels' 16-byte loads.  With
    ``strided_shards`` a (shards, n_blocks, L) view need only hold each
    shard's rows contiguous, the shards a multiple of 4 lanes apart (a
    window of every shard of a leaf, in place).  A ``meta`` view (the dry
    run) is held to the same rules; its alignment is its offset's."""
    if lanes.device.type not in ("cuda", "meta"):
        raise ValueError(f"{kernel}: lanes must be a CUDA tensor, got {lanes.device}")
    if lanes.dtype != torch.int32 or lanes.dim() not in (2, 3):
        raise ValueError(f"{kernel}: want an int32 (n_blocks, L) or (shards, "
                         f"n_blocks, L) lane view, got "
                         f"{lanes.dtype} {tuple(lanes.shape)}")
    if strided_shards and lanes.dim() == 3:
        ok = (lanes[0].is_contiguous() and lanes.stride(0) % 4 == 0
              and (lanes.shape[0] == 1 or lanes.stride(0) >= lanes[0].numel()))
    else:
        ok = lanes.is_contiguous()
    if not ok:
        raise ValueError(f"{kernel}: lane view must be contiguous"
                         + (" within each shard" if strided_shards else ""))
    if lanes.shape[-1] % 4 or lanes.data_ptr() % 16:
        raise ValueError(f"{kernel}: L must be a multiple of 4 and the view "
                         "16-byte aligned")


def require(t: torch.Tensor, like: torch.Tensor, dtype: torch.dtype, shape,
            what: str) -> None:
    if (t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{what}: want contiguous {dtype} {tuple(shape)} on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
