"""internvl2-1b's vision front end in the port against the JAX package, on
the CPU.

The smoke config (3 layers, d 56, 14 / 2 heads of 4, 16 patches) in fp32
with the reference's own weights carried across: the patches go in front
of the prompt, so the prefill, the caches and every decode position are
that much longer; the loss covers the text alone.  Tolerances: fp32 values
at rtol = atol = 1e-5 (summation order only), losses at rtol 1e-5,
gradients at 1e-4 of each leaf's largest |g|; tokens, batches and every
redundancy field bitwise.  The reference's serving launcher sizes its
caches without the patches and cannot serve this arch; the port's counts
them (ROADMAP.md, Queue 3).
"""
import numpy as np
import pytest

import _torch_multimodal as mm
import _torch_recurrent as rec_mod
import test_torch_models as tmod
from repro.launch import serve as jlauncher
from repro_torch.configs import get_arch, get_smoke
from repro_torch.launch import serve as launcher, train as train_launcher

ARCH = "internvl2-1b"


@pytest.fixture(scope="module")
def pair():
    return tmod._pair(ARCH)


@pytest.fixture(scope="module")
def generated(pair):
    jm, jp, tm, _ = pair
    batch = rec_mod.inputs(tm.cfg)
    return batch, rec_mod.reference_generate(jm, jp, batch)


@pytest.fixture(scope="module")
def runs(pair, generated):
    jm, _, tm, tp = pair
    return rec_mod.port_runs(ARCH, jm, tm, tp, *generated)


def test_full_config():
    c = get_arch(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd, c.d_ff) == \
        (24, 896, 14, 2, 64, 4864)
    assert (c.vocab_size, c.padded_vocab, c.frontend, c.frontend_len, c.enc_dec,
            c.tie_embeddings) == (151655, 153600, "vision", 256, False, False)
    assert get_smoke(ARCH).frontend_len == 16


def test_prefill_matches_reference(runs):
    """Logits and every cache, the patches' rows included."""
    assert runs["pos"] == get_smoke(ARCH).frontend_len + rec_mod.S
    tmod.test_prefill_matches_reference(runs)


def test_decode_matches_reference(runs):
    tmod.test_decode_matches_reference(runs)


def test_dirty_events_decode_match_reference(runs):
    tmod.test_dirty_events_decode_match_reference(runs)


def test_decode_equals_prefill():
    rec_mod.check_decode_equals_prefill(get_smoke(ARCH))


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_generate_matches_reference(pair, generated, async_tick):
    _, _, tm, tp = pair
    rec_mod.check_generate(tm, tp, *generated, async_tick)


def test_generate_without_a_store_matches_reference(pair, generated):
    mm.check_generate_without_store(pair, generated)


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_store_matches_reference_tick_by_tick(pair, generated, async_tick):
    jm, _, tm, _ = pair
    rec_mod.replay_store(jm, tm, generated[1], async_tick)


@pytest.mark.parametrize("norm_vjp", ["autodiff", "custom"])
def test_loss_and_grads_match_reference(norm_vjp):
    mm.check_loss_and_grads(ARCH, norm_vjp, seq=48)       # 16 patches, 32 tokens


def test_batches_equal_the_reference_bitwise():
    mm.check_batches(ARCH, 48, ("frontend", "tokens", "labels"))


def test_launcher_serves_where_the_reference_launcher_cannot(capsys):
    """The port's launcher counts the patches in ``max_len``; the
    reference's leaves them out and fails writing the prefill's caches."""
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    tokens, stats = launcher.main(argv + ["--device", "cpu", "--scrub-every", "2",
                                          "--period", "2"])
    assert "scrub mismatches=0" in capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 4) and stats["mismatches"] == 0
    assert stats["pos"] == get_smoke(ARCH).frontend_len + 8 + 3
    bare, _ = launcher.main(argv + ["--device", "cpu", "--redundancy", "none"])
    np.testing.assert_array_equal(tokens.numpy(), bare.numpy())
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jlauncher.main(argv)


def test_train_launcher_runs_on_the_cpu(capsys):
    state = train_launcher.main(["--arch", ARCH, "--smoke", "--steps", "4", "--seq", "48",
                                 "--batch", "2", "--log-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert state.step == 4 and "[train] step 4 loss" in out and "alarms=0" in out
