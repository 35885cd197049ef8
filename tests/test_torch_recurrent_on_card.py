"""jamba's and xlstm's smoke models served on the card, their recurrent
caches under a vilamb store; and training through the three mixers.

Each test needs a CUDA device and skips without one (decided at run
time).  ``Server.generate`` runs with the overlapped store, with a
blocking twin and with no store: the tokens and the caches are identical,
no scrub finds a mismatch, and after the final ``settle`` every field of
the overlapped store's state equals the twin's bit for bit; after a flush
it equals a fresh init.  Before every tick of the overlapped store a spin
is queued on its side stream, so each update runs late.  A decode step
right after a due tick whose update is held behind a spin rewrites every
recurrent state in place: the update must still read the states as they
were at the tick (the step waits for it on the device), so the adopted
checksums are those of the data before the step; with that wait removed
they are not.  The last test takes each mixer's gradients (Mamba, mLSTM,
sLSTM, bf16 and fp32) with every chunk checkpointed and without, under
deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS
first runs): the same bits.  The module imports no JAX, so on the card it
runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_recurrent_on_card.py
"""
import dataclasses
import os

import pytest
import torch

from repro_torch.common import flatten_dict
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy, blocks
from repro_torch.core.state import FIELDS
from repro_torch.kernels.checksum import ref as ck_ref
from repro_torch.models import build_model, mamba, xlstm
from repro_torch.serve import Server, make_decode_step
from repro_torch.train.train_loop import deterministic

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

B, S, GEN = 2, 16, 12         # 29 cache rows: jamba's KV leaves end inside a block
SLEEP_CYCLES = 20_000_000             # about 10 ms of one SM's clock
HOLD_CYCLES = 200_000_000             # about 100 ms


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the store's side stream and kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _model(arch, dev):
    """The smoke model at one group; d 256 gives jamba's attention heads of
    64, a width the flash kernel takes (the smoke's 16 is not)."""
    cfg = dataclasses.replace(get_smoke(arch), n_layers=8, d_model=256)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), dtype=torch.int32, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))}
    return model, params, batch


def _generate(model, params, batch, async_tick=None):
    """``generate`` with a vilamb store (overlapped, blocking) or none."""
    max_len = S + GEN + 1
    store = None
    if async_tick is not None:
        store = ProtectedStore(RedundancyPolicy.single(
            "vilamb", period_steps=4, max_vulnerable_steps=8, lanes_per_block=256,
            async_tick=async_tick, precompile=False), device=params["embed"].device
        ).attach(model.cache_shapes(B, max_len))
    if async_tick:
        tick = store.tick

        def late_tick(*a, **kw):
            with torch.cuda.stream(store._side_stream()):
                torch.cuda._sleep(SLEEP_CYCLES)
            return tick(*a, **kw)
        store.tick = late_tick
    toks, stats = Server(model=model, store=store, max_len=max_len).generate(
        params, batch, GEN, scrub_every=3)
    return store, toks, stats


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_recurrent_serving_overlapped_equals_blocking_on_card(cuda_device, arch):
    model, params, batch = _model(arch, cuda_device)
    store, toks, stats = _generate(model, params, batch, True)
    _, ttoks, tstats = _generate(model, params, batch, False)
    _, bare, bstats = _generate(model, params, batch)
    assert torch.equal(toks, ttoks) and torch.equal(toks, bare)
    assert stats["mismatches"] == tstats["mismatches"] == 0
    leaves, tleaves = flatten_dict(stats["caches"]), flatten_dict(tstats["caches"])
    for n, t in flatten_dict(bstats["caches"]).items():
        assert torch.equal(leaves[n], t) and torch.equal(tleaves[n], t), n
    assert any(m.n_elems != m.padded_lanes * m.elems_per_word
               for m in store.metas.values()), "no leaf whose lane view is a padded copy"
    red, tred = stats["red"], tstats["red"]
    for n in red:
        for f in FIELDS:
            assert torch.equal(getattr(red[n], f), getattr(tred[n], f)), (n, f)
    with torch.inference_mode():
        assert store.scrub_check(leaves, red) == 0
        assert all(bool(v) for v in store.verify_meta(red).values())
        red = store.flush(leaves, red, step=GEN)
        fresh = store.init(leaves)
    for n in red:
        for f in FIELDS:
            assert torch.equal(getattr(red[n], f), getattr(fresh[n], f)), (n, f)


@pytest.mark.parametrize("wait", [True, False], ids=["waits", "wait_removed"])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_decode_step_waits_for_the_inflight_update_on_card(cuda_device, arch, wait,
                                                           monkeypatch):
    """With the wait the adopted checksums are the tick's data's; with it
    removed (``await_inflight`` a no-op) the held update reads the states
    the next step rewrote, so some differ: the check can tell."""
    if not wait:
        monkeypatch.setattr(ProtectedStore, "await_inflight", lambda self: self)
    model, params, batch = _model(arch, cuda_device)
    max_len = S + GEN + 1
    store = ProtectedStore(RedundancyPolicy.single(
        "vilamb", period_steps=1, lanes_per_block=256, async_tick=True,
        precompile=False), device=cuda_device).attach(model.cache_shapes(B, max_len))
    step = make_decode_step(model, store)
    with torch.inference_mode():
        logits, caches, pos = model.prefill(params, batch, max_len)
        red = store.init(flatten_dict(caches))
        token = torch.argmax(logits, -1).to(torch.int32)
        for t in range(0, 4, 2):      # the first round is the store's first use
            _, caches, red, token = step(params, caches, red, token, pos + t)
            leaves = flatten_dict(caches)
            want = {n: ck_ref.block_checksums(blocks.to_lanes(leaves[n], m))
                    for n, m in store.metas.items()}
            with torch.cuda.stream(store._side_stream()):
                torch.cuda._sleep(HOLD_CYCLES)
            red, report = store.tick(leaves, red, t + 1)
            assert report.updated
            _, caches, red, token = step(params, caches, red, token, pos + t + 1)
            red = store.settle(red, flatten_dict(caches), step=t + 1)
            same = {n: torch.equal(red[n].checksums, w) for n, w in want.items()}
            if wait:
                assert all(same.values()), (t, same)
    if not wait:                          # the last (warm) round
        assert not all(same.values()), "the late read went unseen"


MIXERS = {"mamba": ("jamba-1.5-large-398b", mamba.mamba_init, mamba.mamba_apply),
          "mlstm": ("xlstm-1.3b", xlstm.mlstm_init, xlstm.mlstm_apply),
          "slstm": ("xlstm-1.3b", xlstm.slstm_init, xlstm.slstm_apply)}


def _mixer_grads(kind, dtype, remat, dev):
    """One mixer at (2, 64, 64), chunk 16: its output and the gradients of
    x and every parameter for a fixed cotangent."""
    arch, init, apply = MIXERS[kind]
    cfg = dataclasses.replace(get_smoke(arch), remat=remat)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = {k: v.requires_grad_() for k, v in init(gen, cfg, dtype, dev).items()}
    x = torch.randn(2, 64, 64, generator=gen, device=dev).to(dtype).requires_grad_()
    with deterministic():
        y, _ = apply(params, x, cfg, chunk=16)
        ct = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
        grads = torch.autograd.grad(y, [x, *params.values()], ct, materialize_grads=True)
    return y, grads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_chunk_checkpoint_changes_no_gradient_bit_on_card(cuda_device, kind, dtype):
    y, full = _mixer_grads(kind, dtype, "full", cuda_device)
    y_none, none = _mixer_grads(kind, dtype, "none", cuda_device)
    assert torch.equal(y, y_none)
    for g, h in zip(full, none):
        assert g.is_cuda and bool(torch.isfinite(g).all()) and torch.equal(g, h)
