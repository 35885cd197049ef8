"""Shared helpers for the tests that hold ``repro_torch`` against ``repro``.

Inputs are made with numpy and fed to both packages; uint32 results are
compared bit for bit (tolerance 0) through numpy.
"""
import os

import numpy as np
import torch

from repro_torch.core import convert


def share_cores() -> None:
    """Give torch's intra-op threads each pytest-xdist worker's share of the
    cores this process may run on.  Left alone, every worker takes them
    all, and six workers on eight cores ran the port's tests about three
    times slower than with one thread each.  Outside xdist nothing changes.

    Every xdist worker imports every test module when it collects, so this
    module's import applies it to the whole run of each worker."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


share_cores()

RED_FIELDS = ("checksums", "parity", "dirty", "shadow", "meta_ck")


def u32(x) -> np.ndarray:
    """A jax uint32 array or an int32-carried torch tensor as np.uint32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def t32(a) -> torch.Tensor:
    """np.uint32 bits -> int32 torch tensor on the CPU."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def rand_u32(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def assert_bits_equal(a, b, msg=""):
    np.testing.assert_array_equal(u32(a), u32(b), err_msg=msg)


def assert_masks_equal(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a).astype(bool),
                                  b.cpu().numpy().astype(bool), err_msg=msg)


def red_jax_to_numpy(red):
    return {n: {f: np.asarray(getattr(r, f)) for f in RED_FIELDS}
            for n, r in red.items()}


def assert_red_equal(jred, tred, msg=""):
    """Every field of every leaf, bitwise."""
    assert set(jred) == set(tred), (set(jred), set(tred))
    tn = convert.red_to_numpy(tred)
    for n, fields in red_jax_to_numpy(jred).items():
        for f, v in fields.items():
            np.testing.assert_array_equal(v.astype(np.uint32), tn[n][f],
                                          err_msg=f"{msg} {n}.{f}")


def jnp_leaves(np_leaves):
    """The leaves as jax arrays of their own: on the CPU ``jnp.asarray``
    aliases a numpy buffer, so an in-place numpy write after an async
    dispatch could reach a program that has not run yet."""
    import jax.numpy as jnp
    return {k: jnp.asarray(np.array(v)) for k, v in np_leaves.items()}


# Adversarial payloads: float32 NaN/Inf patterns, zeros and saturated words
# (the reference's tests/test_kernels.py SPECIALS).
SPECIALS = np.array([0x7FC00000, 0x7F800000, 0xFF800000, 0x7F800001,
                     0x00000000, 0xFFFFFFFF], dtype=np.uint32)


def special_lanes(nb, L, offset=0) -> np.ndarray:
    return SPECIALS[(np.arange(nb * L) + offset) % len(SPECIALS)].reshape(nb, L)
