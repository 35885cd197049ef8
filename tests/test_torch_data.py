"""The port's synthetic data pipeline against the JAX package's, on the CPU.

Batches are drawn from the same numpy ``default_rng((seed, step))`` in
both packages, so they must be equal bit for bit (tolerance 0), for every
dense smoke arch and several seeds and steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, get_smoke as jget_smoke
from repro.data import SyntheticPipeline as JPipeline
from repro.data.pipeline import batch_structs as jbatch_structs
from repro.models.config import SHAPES as JSHAPES, ShapeConfig as JShape
from repro_torch.configs import get_arch, get_smoke
from repro_torch.data import SyntheticPipeline, batch_shapes
from repro_torch.models import SHAPES, ShapeConfig

ARCHS = ["llama3.2-3b", "olmo-1b", "glm4-9b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_equal_the_reference_bitwise(arch, seed):
    jp = JPipeline(jget_smoke(arch), JShape("t", 64, 4, "train"), seed=seed)
    tp = SyntheticPipeline(get_smoke(arch), ShapeConfig("t", 64, 4, "train"),
                           seed=seed, device="cpu")
    for step in (0, 1, 17):
        jb, tb = jp.get(step), tp.get(step)
        assert set(tb) == set(jb) == {"tokens", "labels"}
        for k in jb:
            assert tb[k].device.type == "cpu" and tb[k].dtype.is_floating_point is False
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def test_full_vocab_batches_equal_the_reference_bitwise():
    """llama3.2-3b's vocabulary (128,256) at train_4k's sequence length."""
    jp = JPipeline(jget_arch("llama3.2-3b"),
                   dataclasses.replace(JSHAPES["train_4k"], global_batch=1), seed=3)
    tp = SyntheticPipeline(get_arch("llama3.2-3b"),
                           dataclasses.replace(SHAPES["train_4k"], global_batch=1),
                           seed=3, device="cpu")
    for k, v in tp.get(2).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp.get(2)[k]), err_msg=k)


def test_labels_are_next_token_and_zipf_skewed():
    cfg = get_smoke("olmo-1b")
    b = SyntheticPipeline(cfg, ShapeConfig("t", 512, 8, "train"), device="cpu").get(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(), b["labels"][:, :-1].numpy())
    counts = np.bincount(b["tokens"].numpy().ravel(), minlength=cfg.vocab_size)
    assert np.sort(counts)[::-1][:10].sum() > 0.3 * counts.sum()
    assert (counts == 0).sum() > 0


def test_batch_shapes_match_the_reference_structs():
    cfg = get_smoke("glm4-9b")
    got = batch_shapes(cfg, SHAPES["train_4k"])
    want = jbatch_structs(jget_smoke("glm4-9b"), JSHAPES["train_4k"])
    assert set(got) == set(want)
    for k, s in got.items():
        assert s.shape == tuple(want[k].shape) and str(s.dtype) == f"torch.{want[k].dtype}"
    assert SHAPES == {k: ShapeConfig(**dataclasses.asdict(v)) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium"])
def test_multimodal_inputs_equal_the_reference_bitwise(arch):
    """The vision patches and the encoder frames are drawn before the token
    stream, in the reference's order: every key equal bit for bit, at the
    full config's widths and the smoke's.  ``batch_shapes`` has the
    reference structs' keys and shapes; its patches and frames are fp32,
    as both pipelines yield them (the reference's structs say bf16)."""
    for get, jget in ((get_arch, jget_arch), (get_smoke, jget_smoke)):
        jp = JPipeline(jget(arch), JShape("t", 384, 2, "train"), seed=4)
        tp = SyntheticPipeline(get(arch), ShapeConfig("t", 384, 2, "train"), seed=4,
                               device="cpu")
        jb, tb = jp.get(1), tp.get(1)
        assert set(tb) == set(jb) and len(tb) == 3
        for k in jb:
            assert tb[k].dtype == {"int32": torch.int32, "float32": torch.float32}[
                str(np.asarray(jb[k]).dtype)]
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        got = batch_shapes(get(arch), ShapeConfig("t", 384, 2, "train"))
        want = jbatch_structs(jget(arch), JShape("t", 384, 2, "train"))
        assert {k: s.shape for k, s in got.items()} == \
            {k: tuple(s.shape) for k, s in want.items()}
        assert {k: tuple(v.shape) for k, v in tb.items()} == \
            {k: s.shape for k, s in got.items()}
