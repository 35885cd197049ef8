"""Shared checks of the encoder-decoder (seamless-m4t-medium) and vision
front-end (internvl2-1b) archs against the JAX package, for
tests/test_torch_encdec.py and tests/test_torch_vlm.py.

Both serve through ``_torch_recurrent``'s record of the reference's
``generate`` with ``inputs(cfg)``'s batch (the prompt's tokens, and the
patches or the encoder frames).  Here: ``generate`` with no store, the
loss and every gradient on the pipelines' batches (which are equal bit
for bit), and the launchers.  Tolerances are ``test_torch_models``' and
``test_torch_train``'s: fp32 values at rtol = atol = 1e-5, losses at rtol
1e-5 and gradients at 1e-4 of each leaf's largest |g| (summation order
only); tokens, batches and redundancy state bitwise.
"""
import jax
import numpy as np
import torch

import _torch_recurrent as rec_mod
import test_torch_train as ttrain
from repro.data import SyntheticPipeline as JPipeline
from repro.models.config import ShapeConfig as JShape
from repro_torch.data import SyntheticPipeline
from repro.models import build_model as jbuild
from repro_torch.models import ShapeConfig, build_model, params_from_numpy
from repro_torch.serve import Server
from repro_torch.train.train_loop import loss_and_grads


def check_generate_without_store(pair, generated):
    """``Server.generate`` with no store: the reference's tokens, and no
    redundancy state."""
    _, _, tm, tp = pair
    batch, rec = generated
    max_len = rec_mod.lengths(batch)[2]
    tokens, stats = Server(model=tm, max_len=max_len).generate(
        tp, rec_mod.tbatch(batch), rec_mod.GEN)
    np.testing.assert_array_equal(tokens.numpy(), rec["tokens"])
    assert stats["red"] == {} and stats["pos"] == int(rec["stats"]["pos"])


def pipeline_pair(arch, seq: int, batch: int = 2, seed: int = 1):
    """The reference's and the port's pipelines on the smoke config."""
    jcfg, tcfg = ttrain._cfgs(arch)
    return (JPipeline(jcfg, JShape("t", seq, batch, "train"), seed=seed),
            SyntheticPipeline(tcfg, ShapeConfig("t", seq, batch, "train"), seed=seed,
                              device="cpu"))


def check_batches(arch, seq: int, keys):
    """The port's batches equal the reference's bit for bit, key for key."""
    jp, tp = pipeline_pair(arch, seq)
    for step in (0, 3):
        jb, tb = jp.get(step), tp.get(step)
        assert set(tb) == set(jb) == set(keys)
        for k in jb:
            assert tb[k].device.type == "cpu"
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def check_loss_and_grads(arch, norm_vjp: str, seq: int):
    """``Model.loss`` and every leaf's gradient (the encoder's and the
    cross attention's included) against ``jax.value_and_grad``, fp32, on
    the pipelines' step-0 batch, four attention tiles."""
    jcfg, tcfg = ttrain._cfgs(arch, norm_vjp=norm_vjp, attn_tile=8)
    jm, tm = jbuild(jcfg), build_model(tcfg, "cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))   # one compile, not one per op
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    jpipe, tpipe = pipeline_pair(arch, seq)
    jb, tb = jpipe.get(0), tpipe.get(0)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    tl, taux, tg = loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=ttrain.RTOL)
    for k in ("ce", "aux_loss", "logits_mean"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=ttrain.RTOL,
                                   err_msg=k)
    ttrain._grads_close(tg, jg, arch)
    assert all(not p.requires_grad for p in ttrain.flatten_dict(tp).values())
    assert torch.isfinite(tl)
