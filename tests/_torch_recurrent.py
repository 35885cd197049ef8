"""Shared checks of served archs against the JAX package: the recurrent
ones (jamba's Mamba, xLSTM's mLSTM and sLSTM) for tests/test_torch_mamba.py
and tests/test_torch_xlstm.py, and the encoder-decoder and vision ones for
tests/test_torch_encdec.py and tests/test_torch_vlm.py.

Models run in fp32 with the reference's own weights carried across
(``test_torch_models._pair``).  ``reference_generate`` runs the
reference's ``Server.generate`` under a blocking vilamb store and records
the prefill's and every decode step's logits, tokens and caches (one
compile of the reference's serving programs serves every check);
``port_runs`` runs the port's prefill and decode steps beside that record
in the form of ``test_torch_models``' ``runs`` fixture, so that file's
checks apply; ``replay_store`` drives the port's store through that
record (each model's own dirty events, the caches carried across bit for
bit) and holds every field of the redundancy state equal to the
reference's bit for bit after every write, tick, settle and flush: on the
blocking tick to the states the record holds, on the overlapped tick to a
reference store driven beside it.  Before each tick of the overlapped
stores the reference's update is waited for, so both adopt at the next
tick (the port's CPU dispatch runs to completion).

The prompt is ``prompt(cfg)``'s tokens, or ``inputs(cfg)``'s numpy batch:
the tokens and, where the model takes them, vision patches ``frontend``
(put in front of the prompt, so the caches and positions are that much
longer) or encoder frames ``enc_input`` (ENC_LEN of them, a length other
than the prompt's, filling the cross-attention caches).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import RED_FIELDS, assert_red_equal, jnp_leaves
from repro.common import flatten_dict as jflatten, unflatten_dict as junflatten
from repro.core import ProtectedStore as JStore, RedundancyPolicy as JPolicy
from repro.serve import Server as JServer
from repro_torch.common import flatten_dict, unflatten_dict
from repro_torch.core import ProtectedStore, RedundancyPolicy, convert
from repro_torch.models import build_model
from repro_torch.serve import Server

B, S, GEN, L = 2, 16, 12, 128      # generate: batch, prompt, new tokens, lanes a block
ENC_LEN = 24                       # encoder frames (cross attention: Sk != Sq)
SCRUB = 3
REPORT_FIELDS = ("updated", "coalesced", "overflowed", "deadline_fired",
                 "scrubbed", "mismatches", "alarms")


def policy(cls, async_tick):
    extra = dict(precompile=False, dispatcher_thread=False) if cls is JPolicy else {}
    return cls.single("vilamb", period_steps=4, max_vulnerable_steps=8,
                      lanes_per_block=L, async_tick=async_tick, **extra)


def prompt(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def inputs(cfg) -> dict:
    """The numpy batch of a generate: ``prompt``'s tokens, then from the
    same generator the vision patches or the encoder frames (fp32)."""
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["enc_input"] = rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
    return batch


def _batch(tokens) -> dict:
    """A numpy batch from ``prompt``'s tokens or ``inputs``' batch."""
    return dict(tokens) if isinstance(tokens, dict) else {"tokens": tokens}


def lengths(tokens):
    """``(patches, enc_len, max_len)`` of a batch: the vision patches in
    front of the prompt, the encoder frames, and the caches' length."""
    batch = _batch(tokens)
    patches = batch["frontend"].shape[1] if "frontend" in batch else 0
    enc_len = batch["enc_input"].shape[1] if "enc_input" in batch else 0
    return patches, enc_len, patches + S + GEN + 1


def jbatch(tokens) -> dict:
    return {k: jnp.asarray(v) for k, v in _batch(tokens).items()}


def tbatch(tokens) -> dict:
    return {k: torch.from_numpy(v) for k, v in _batch(tokens).items()}


def _snap(red):
    """numpy copies of a reference redundancy state's fields."""
    return {n: types.SimpleNamespace(**{f: np.array(getattr(r, f)) for f in RED_FIELDS})
            for n, r in red.items()}


def reference_generate(jm, jp, tokens):
    """The reference's generate of GEN tokens under a blocking vilamb store.

    Returns its tokens and stats, the prefill's logits and flat numpy
    caches, each decode step's ``(logits, next tokens)``, and the ``(step,
    flat numpy caches)`` each tick saw."""
    _, enc_len, max_len = lengths(tokens)
    store = JStore(policy(JPolicy, False)).attach(
        jflatten(jax.eval_shape(lambda: jm.init_caches(B, max_len, enc_len))))
    srv = JServer(model=jm, store=store, max_len=max_len)
    rec = {"ticks": [], "decode": []}
    prefill, decode, tick = srv.prefill, srv.decode, store.tick

    def recorded_prefill(params, batch):
        logits, caches, pos = prefill(params, batch)
        rec["prefill"] = (np.array(logits), {n: np.array(a) for n, a in
                                             jflatten(caches).items()}, int(pos))
        return logits, caches, pos

    def recorded_decode(*a):
        logits, caches, red, token = decode(*a)
        rec["decode"].append((np.array(logits), np.array(token)))
        return logits, caches, red, token

    def recorded_tick(leaves, red, step, **kw):
        lv = leaves() if callable(leaves) else leaves
        written = _snap(red)           # the tick and the next decode donate red
        out, report = tick(lv, red, step, **kw)
        rec["ticks"].append((step, {n: np.array(a) for n, a in lv.items()}, written,
                             _snap(out), report))
        return out, report

    init = srv.init_redundancy

    def recorded_init(caches):
        red = init(caches)
        rec["init"] = _snap(red)
        return red

    srv.prefill, srv.decode, store.tick = recorded_prefill, recorded_decode, recorded_tick
    srv.init_redundancy = recorded_init
    jtok, jstats = srv.generate(jp, jbatch(tokens), GEN, scrub_every=SCRUB)
    rec["tokens"], rec["stats"], rec["batch"] = np.asarray(jtok), jstats, _batch(tokens)
    return rec


def port_runs(arch, jm, tm, tp, tokens, rec):
    """The port's prefill and GEN - 1 greedy decode steps beside the
    reference's record, as ``test_torch_models``' ``runs`` fixture holds
    them (the reference's caches as nested numpy trees)."""
    jl, jc, jpos = rec["prefill"]
    with torch.inference_mode():
        tl, tc, tpos = tm.prefill(tp, tbatch(tokens), lengths(tokens)[2])
        out = {"arch": arch, "jm": jm, "tm": tm, "pos": lengths(tokens)[0] + S,
               "prefill": (jl, junflatten(jc), jpos, tl.clone(),
                           {s: {k: t.clone() for k, t in c.items()} for s, c in tc.items()},
                           tpos)}
        tt = torch.argmax(tl, -1).to(torch.int32)
        steps = []
        for i, (jl, jt) in enumerate(rec["decode"]):
            tl, tc, tt = tm.decode_step(tp, tc, tt, tpos + i)
            steps.append((jl, jt, tl.clone(), tt.clone()))
    out["decode"] = steps
    out["final_caches"] = (junflatten(rec["ticks"][-1][1]), tc)
    return out


def check_generate(tm, tp, tokens, rec, async_tick):
    """The port's generate under a vilamb store: the reference's tokens, no
    mismatch, the settled dirty bitvectors equal, the caches close, and a
    clean scrub of the settled state."""
    _, enc_len, max_len = lengths(tokens)
    store = ProtectedStore(policy(RedundancyPolicy, async_tick), device="cpu").attach(
        tm.cache_shapes(B, max_len, enc_len))
    srv = Server(model=tm, store=store, max_len=max_len)
    ttok, tstats = srv.generate(tp, tbatch(tokens), GEN, scrub_every=SCRUB)
    jstats = rec["stats"]
    assert set(tstats) == set(jstats)
    np.testing.assert_array_equal(ttok.numpy(), rec["tokens"])
    assert tstats["mismatches"] == int(jstats["mismatches"]) == 0
    for n, r in jstats["red"].items():
        for f in ("dirty", "shadow"):
            np.testing.assert_array_equal(
                getattr(tstats["red"][n], f).numpy().view(np.uint32),
                np.asarray(getattr(r, f)).astype(np.uint32), err_msg=f"{n}.{f}")
    tc = flatten_dict(tstats["caches"])
    for n, a in jflatten(jstats["caches"]).items():
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(a), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    with torch.inference_mode():
        assert store.scrub_check(tc, tstats["red"]) == 0


def replay_store(jm, tm, rec, async_tick):
    """The port's store through the reference generate's record, its whole
    state equal to the reference's bit for bit after every write (the
    reference's from inside its decode step), tick, settle and flush.  On
    the blocking tick the reference's states are those the record holds;
    on the overlapped tick a reference store of its own runs beside."""
    patches, enc_len, max_len = lengths(rec["batch"])
    ts = ProtectedStore(policy(RedundancyPolicy, async_tick), device="cpu").attach(
        tm.cache_shapes(B, max_len, enc_len))
    js = None
    if async_tick:
        js = JStore(policy(JPolicy, True)).attach(
            jflatten(jax.eval_shape(lambda: jm.init_caches(B, max_len, enc_len))))
    leaves = rec["prefill"][1]
    jred = rec["init"] if js is None else js.init(jnp_leaves(leaves))
    tred = ts.init(convert.leaves_from_numpy(leaves, "cpu"))
    assert_red_equal(jred, tred, "init")
    updated = 0
    for step, leaves, jwritten, jticked, jrep in rec["ticks"]:
        pos = patches + S + step - 1
        jl, tl = jnp_leaves(leaves), convert.leaves_from_numpy(leaves, "cpu")
        tred = ts.on_write(tred, events=tm.dirty_events_decode(unflatten_dict(tl), pos))
        if js is None:
            jred = jwritten
        else:
            jred = js.on_write(jred, events=jm.dirty_events_decode(junflatten(jl), pos))
        assert_red_equal(jred, tred, f"on_write {step}")
        if js is None:
            jred = jticked
        else:
            js.sync_inflight()
            jred, jrep = js.tick(jl, jred, step, scrub_period=SCRUB)
        tred, trep = ts.tick(tl, tred, step, scrub_period=SCRUB)
        assert_red_equal(jred, tred, f"tick {step}")
        for f in REPORT_FIELDS:
            assert getattr(trep, f) == getattr(jrep, f), (step, f)
        updated += bool(trep.updated)
    assert updated == (GEN - 1) // 4
    tred = ts.settle(tred, tl, step=GEN - 1)
    jred = rec["stats"]["red"] if js is None else js.settle(jred, jl, step=GEN - 1)
    assert_red_equal(jred, tred, "settle")
    tred = ts.flush(tl, tred, step=GEN - 1)
    assert ts.scrub_check(tl, tred) == 0
    if js is not None:
        jred = js.flush(jl, jred, step=GEN - 1)
        assert_red_equal(jred, tred, "flush")
    assert_red_equal(ts.init(tl), tred, "flush against a fresh init")


def check_decode_equals_prefill(cfg, seed=1):
    """The port alone: one decode step after a prefill of S tokens gives
    the logits of a prefill of the S + 1 tokens (fp32, no MoE drops; the
    same patches or encoder frames in front or beside), to
    1e-4 of their scale as tests/test_decode_consistency.py holds the
    reference."""
    kw = {"param_dtype": "float32"}
    if cfg.n_experts:
        kw["capacity_factor"] = float(cfg.n_experts)
    model = build_model(dataclasses.replace(cfg, **kw), "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    batch = tbatch(inputs(cfg))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    max_len = lengths(inputs(cfg))[0] + 64
    with torch.inference_mode():
        logits, caches, pos = model.prefill(params, dict(batch, tokens=tokens), max_len)
        tok = torch.argmax(logits, -1).to(torch.int32)
        got, _, _ = model.decode_step(params, caches, tok, pos)
        want, _, _ = model.prefill(
            params, dict(batch, tokens=torch.cat([tokens, tok[:, None]], 1)), max_len)
    err = float((got - want).abs().max()) / (float(want.abs().max()) + 1e-9)
    assert err < 1e-4, f"{cfg.name}: rel err {err:.2e}"
