"""Shared harness of the tests that hold the port's sharded store against
the reference's on an 8-device forced host mesh.

Each test file runs the reference once, in one subprocess
(``tests/subproc.py``'s ``run_py`` and ``MESH_PRELUDE``), which writes
every array the file compares into one ``.npz``; the port's side runs
in-process on the CPU over a simulated (2, 2, 2) mesh.

``FAST_MARK`` is prepended to the subprocess's code: the reference's
``ProtectedStore.on_write`` under a mesh runs an eager ``shard_map`` that
is traced and compiled again on every call (seconds each on the CPU), so
the subprocess routes array events through one ``jax.jit`` of the same
call per store and fires the ``on_write`` phase hook after it, as the
eager call does.  The arrays it computes are the eager call's.
"""
import textwrap

import numpy as np
import torch

from subproc import MESH_PRELUDE, run_py
from repro_torch.dist import P
from repro_torch.launch.mesh import make_mesh

FIELDS = ("checksums", "parity", "dirty", "shadow", "meta_ck")

FAST_MARK = """
_orig_on_write = ProtectedStore.on_write

def _fast_on_write(self, red, events=None, old=None, new=None, row_diffs=None):
    if (old is not None or new is not None or row_diffs or not events
            or any(isinstance(e, str) for e in events.values())):
        return _orig_on_write(self, red, events=events, old=old, new=new,
                              row_diffs=row_diffs)
    fn = self.__dict__.get("_test_mark_jit")
    if fn is None:
        fn = self.__dict__["_test_mark_jit"] = jax.jit(
            lambda r, ev: _orig_on_write(self, r, events=ev))
    out = fn(red, dict(events))
    if self._phase_hooks:
        self._phase("on_write", red=dict(out))
    return out

ProtectedStore.on_write = _fast_on_write
OUT = {}

def rec(prefix, red):
    for k, v in red.items():
        for f in FIELDS:
            OUT[f"{prefix}/{k}/{f}"] = np.asarray(getattr(v, f))
"""


def run_reference(body: str, out_path, inputs=None, timeout: int = 600) -> dict:
    """Run ``body`` (after ``MESH_PRELUDE`` and ``FAST_MARK``) in the
    8-device subprocess; ``IN`` is the npz of ``inputs``, and whatever the
    body puts in ``OUT`` comes back as a dict of numpy arrays."""
    out_path = str(out_path)
    in_path = out_path + ".in.npz"
    np.savez(in_path, **(inputs or {"_": np.zeros(1)}))
    code = (MESH_PRELUDE + FAST_MARK + f"IN = np.load({in_path!r})\n"
            + textwrap.dedent(body) + f"\nnp.savez({out_path!r}, **OUT)\nprint('REF_OK')\n")
    r = run_py(code, timeout=timeout)
    assert "REF_OK" in r.stdout, (
        f"reference subprocess failed (exit {r.returncode})\n"
        f"--- stdout ---\n{r.stdout[-3000:]}\n--- stderr ---\n{r.stderr[-6000:]}")
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def mesh():
    return make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")


SPECS = {"w": P(("pod", "data", "model"), None), "e": P(("pod", "data"), None)}


def u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def assert_fields_equal(ref: dict, prefix: str, red, msg=""):
    """Every field of every leaf of the port's ``red`` equals the
    reference's recorded under ``prefix``, bit for bit (shapes included)."""
    for k, v in red.items():
        for f in FIELDS:
            want = ref[f"{prefix}/{k}/{f}"].astype(np.uint32)
            got = u32(getattr(v, f))
            assert got.shape == want.shape, (msg, prefix, k, f, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f"{msg} {prefix} {k}.{f}")


def leaf_from_ref(ref: dict, key: str, dtype) -> torch.Tensor:
    """A leaf the reference recorded as its raw bits (uint16 for bf16)."""
    a = ref[key]
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.astype(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bf16_bits(x) -> np.ndarray:
    """The raw bits of a jax or ml_dtypes bf16 array as uint16."""
    return np.asarray(x).view(np.uint16)

