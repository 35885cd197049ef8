"""The port's serving path against the JAX package's, on the CPU.

``Server.generate`` runs prefill and greedy decode with the KV caches
under a ``ProtectedStore``.  Against the reference (``repro.serve.Server``
with a blocking store, fp32, its prefill on the Pallas flash kernel in
interpret mode): the greedy tokens and the scrub counts are equal, and so
are the dirty bitvectors of the settled state, bit for bit.  On caches
carried across bit for bit, the whole redundancy state after ``on_write``
and a due tick is equal bit for bit.  Policies parsed by ``from_spec``
resolve to the same ``LeafPolicy`` per leaf.  The launcher runs with
``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_red_equal
from repro.common import flatten_dict as jflatten
from repro.configs import get_smoke as jget_smoke
from repro.core import ProtectedStore as JStore, RedundancyPolicy as JPolicy
from repro.models import build_model as jbuild
from repro.serve import Server as JServer
from repro_torch.common import flatten_dict
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy, bits, convert
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Server, make_decode_step

B, S, GEN, L = 2, 16, 12, 128
STORE_KW = dict(lanes_per_block=L)


def _policy(cls, mode="vilamb", async_tick=False, **kw):
    """The blocking tick unless asked for the overlapped one, on both sides."""
    extra = dict(precompile=False) if cls is JPolicy else {}
    return cls.single(mode, period_steps=4, max_vulnerable_steps=8, **STORE_KW,
                      async_tick=async_tick, **extra, **kw)


def _pair(arch="llama3.2-3b"):
    jcfg = dataclasses.replace(jget_smoke(arch), param_dtype="float32",
                               use_flash_kernel=True)
    tcfg = dataclasses.replace(get_smoke(arch), param_dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jp, build_model(tcfg, "cpu"), tp, tokens


def _tstore(tm, policy, max_len):
    return ProtectedStore(policy, device="cpu").attach(
        tm.cache_shapes(B, max_len))


def _jstore(jm, policy, max_len):
    caches0 = jax.eval_shape(lambda: jm.init_caches(B, max_len, 0))
    return JStore(policy).attach(jflatten(caches0))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _generate_both(arch, async_tick):
    jm, jp, tm, tp, tokens = _pair(arch)
    max_len = S + GEN + 1
    jsrv = JServer(model=jm, store=_jstore(jm, _policy(JPolicy, async_tick=async_tick),
                                           max_len), max_len=max_len)
    jtok, jstats = jsrv.generate(jp, {"tokens": jnp.asarray(tokens)}, GEN, scrub_every=3)
    tsrv = Server(model=tm, store=_tstore(tm, _policy(RedundancyPolicy,
                                                      async_tick=async_tick), max_len),
                  max_len=max_len)
    ttok, tstats = tsrv.generate(tp, {"tokens": torch.from_numpy(tokens)}, GEN,
                                 scrub_every=3)
    assert set(tstats) == set(jstats)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats["mismatches"] == int(jstats["mismatches"]) == 0
    assert tstats["pos"] == int(jstats["pos"])
    for n, r in jstats["red"].items():
        for f in ("dirty", "shadow"):
            np.testing.assert_array_equal(getattr(tstats["red"][n], f).numpy().view(np.uint32),
                                          np.asarray(getattr(r, f)).astype(np.uint32),
                                          err_msg=f"{n}.{f}")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "glm4-9b", "qwen3-moe-235b-a22b",
                                  "arctic-480b"])
def test_generate_matches_reference(arch):
    _generate_both(arch, async_tick=False)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "glm4-9b"])
def test_generate_overlapped_matches_reference(arch):
    """Both servers on the overlapped tick: generate settles the last
    in-flight update, and the settled bitvectors agree."""
    _generate_both(arch, async_tick=True)


@pytest.mark.parametrize("mode", ["vilamb", "sync"])
def test_generate_is_clean_and_observational(pair, mode):
    """0 mismatches; tokens equal to a run with no store; the settled state
    verifies, and after a flush it equals a fresh init, bit for bit."""
    _, _, tm, tp, tokens = pair
    max_len = S + GEN + 1
    batch = {"tokens": torch.from_numpy(tokens)}
    store = _tstore(tm, _policy(RedundancyPolicy, mode, async_tick=True), max_len)
    srv = Server(model=tm, store=store, max_len=max_len)
    toks, stats = srv.generate(tp, batch, GEN, scrub_every=3)
    bare, bare_stats = Server(model=tm, max_len=max_len).generate(tp, batch, GEN)
    assert torch.equal(toks, bare) and toks.shape == (B, GEN)
    assert stats["mismatches"] == 0 and bare_stats["red"] == {}
    with torch.inference_mode():
        leaves = flatten_dict(stats["caches"])
        assert store.scrub_check(leaves, stats["red"]) == 0
        assert all(bool(v) for v in store.verify_meta(stats["red"]).values())
        red = store.flush(leaves, stats["red"], step=GEN)
        assert_red_equal(store.init(leaves), red, "flushed vs fresh init")


def test_decode_dirties_one_row_per_group(pair):
    """One decode step marks exactly the blocks holding row ``pos`` of each
    group, in every K and V leaf."""
    _, _, tm, tp, tokens = pair
    max_len = S + GEN + 1
    store = _tstore(tm, _policy(RedundancyPolicy), max_len)
    step = make_decode_step(tm, store)
    with torch.inference_mode():
        logits, caches, pos = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, max_len)
        red = store.init(flatten_dict(caches))
        _, _, red, _ = step(tp, caches, red, torch.argmax(logits, -1).int(), pos)
    for n, meta in store.metas.items():
        G, S_max = meta.shape[:2]
        row_lanes = int(np.prod(meta.shape[2:])) // meta.elems_per_word
        want = sorted({(g * S_max + pos) * row_lanes // L for g in range(G)})
        got = torch.nonzero(bits.unpack(red[n].dirty, meta.n_blocks)).flatten().tolist()
        assert got == want, n


def test_dirty_and_red_after_on_write_match_reference(pair):
    """Caches carried across bit for bit: init, a write at ``pos`` with each
    model's own dirty events, and a due tick give the same redundancy state."""
    jm, jp, tm, tp, tokens = pair
    max_len = S + GEN + 1
    _, jc, pos = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, max_len)
    np_caches = jax.tree_util.tree_map(np.array, jc)
    tc = convert.leaves_from_numpy(np_caches, "cpu")
    js = _jstore(jm, _policy(JPolicy), max_len)
    ts = _tstore(tm, _policy(RedundancyPolicy), max_len)
    jred, tred = js.init(jflatten(jc)), ts.init(flatten_dict(tc))
    assert_red_equal(jred, tred, "init")
    rng = np.random.default_rng(5)
    for t in range(1, 5):                  # steps 1..4: due at 4
        row = rng.standard_normal(np_caches["slot_0"]["k"][:, 0].shape).astype(np.float32)
        for k in ("k", "v"):
            np_caches["slot_0"][k][:, pos + t] = row
            tc["slot_0"][k][:, pos + t] = torch.from_numpy(row)
        jc = jax.tree_util.tree_map(jnp.asarray, np_caches)
        jred = js.on_write(jred, events=jm.dirty_events_decode(jc, pos + t))
        tred = ts.on_write(tred, events=tm.dirty_events_decode(tc, pos + t))
        assert_red_equal(jred, tred, f"on_write {t}")
        jred, jrep = js.tick(jflatten(jc), jred, t)
        tred, trep = ts.tick(flatten_dict(tc), tred, t)
        assert_red_equal(jred, tred, f"tick {t}")
        assert bool(trep.updated) == bool(jrep.updated) == (t == 4)


SPECS = ["", "*/k=vilamb:8,*/v=vilamb:64", "slot_0/k=sync,*=none",
         "*/v=vilamb,slot_*/k=sync:3"]


@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_matches_reference(spec):
    kw = dict(default_mode="vilamb", period_steps=16, max_vulnerable_steps=32,
              scrub_period_steps=5)
    jpol, tpol = JPolicy.from_spec(spec, **kw), RedundancyPolicy.from_spec(spec, **kw)
    fields = [f.name for f in dataclasses.fields(tpol.default)]
    for name in ("slot_0/k", "slot_0/v", "slot_1/k", "other"):
        jl, tl = jpol.leaf_policy(name), tpol.leaf_policy(name)
        assert {f: getattr(tl, f) for f in fields} == {f: getattr(jl, f) for f in fields}


def test_single_matches_reference():
    kw = dict(period_steps=16, max_vulnerable_steps=32, scrub_period_steps=4,
              max_vulnerable_seconds=1.5, lanes_per_block=L, stripe_data_blocks=3)
    jpol, tpol = JPolicy.single("vilamb", **kw), RedundancyPolicy.single("vilamb", **kw)
    fields = [f.name for f in dataclasses.fields(tpol.default)]
    assert {f: getattr(tpol.default, f) for f in fields} == \
        {f: getattr(jpol.default, f) for f in fields}
    assert (tpol.lanes_per_block, tpol.stripe_data_blocks) == (L, 3)
    with pytest.raises(ValueError, match="bad policy clause"):
        RedundancyPolicy.from_spec("*/k")


def test_settle_and_take_repaired_are_blocking(pair):
    """On the blocking tick nothing is in flight: settle returns ``red`` as
    it is, and no background drain replaced a leaf."""
    _, _, tm, _, _ = pair
    store = _tstore(tm, _policy(RedundancyPolicy), 8)
    nested = tm.init_caches(B, 8)
    caches = flatten_dict(nested)
    red = store.init(caches)
    red = store.on_write(red, events=tm.dirty_events_decode(nested, 1))
    red, rep = store.tick(caches, red, 4)
    assert rep.updated and all(g.pending is None for g in store.groups.values())
    settled = store.settle(red, step=4)
    assert settled == red and settled is not red
    assert store.take_repaired() == {}


def test_settle_adopts_the_overlapped_update(pair):
    """On the overlapped tick a due tick leaves the update in flight with
    its blocks in ``shadow``; settle adopts it, equal to the blocking tick's
    state, and the pending is gone."""
    _, _, tm, _, _ = pair
    nested = tm.init_caches(B, 8)
    caches = flatten_dict(nested)
    states = []
    for async_tick in (True, False):
        store = _tstore(tm, _policy(RedundancyPolicy, async_tick=async_tick), 8)
        red = store.init(caches)
        red = store.on_write(red, events=tm.dirty_events_decode(nested, 1))
        red, rep = store.tick(caches, red, 4)
        assert rep.updated
        if async_tick:
            assert all(g.pending is not None for g in store.groups.values())
            assert any(int(bits.popcount(r.shadow)) for r in red.values())
            red = store.settle(red, caches, step=4)
            assert all(g.pending is None for g in store.groups.values())
            assert store.take_repaired() == {}
        states.append(convert.red_to_numpy(red))
    for n, fields in states[0].items():
        for f, v in fields.items():
            np.testing.assert_array_equal(v, states[1][n][f], f"{n}.{f}")


def test_generate_with_patrol_and_health_equals_reference(pair, monkeypatch):
    """``generate`` with the caches under the overlapped store, the scrub
    patroller and the health governor: tokens equal to a run with no store
    and to the reference's, the last tick's health report equal to the
    reference's, and every probe clean.  Readiness is pinned to "ready" in
    the reference (inline resolution), as the port's CPU dispatch is."""
    from repro.core import store as jstore_mod
    from repro.health import HealthPolicy as JHealthPolicy
    from repro.scrub import patrol as jpatrol
    from repro_torch.health import HEALTHY, HealthPolicy
    monkeypatch.setattr(jstore_mod, "_ready", lambda x: True)
    monkeypatch.setattr(jpatrol, "_ready", lambda x: True)
    jm, jp, tm, tp, tokens = pair
    max_len = S + GEN + 1
    kw = dict(async_tick=True, patrol_bytes_per_tick=16 * L * 4)
    jsrv = JServer(model=jm, store=_jstore(jm, _policy(
        JPolicy, dispatcher_thread=False, health=JHealthPolicy(), **kw), max_len),
        max_len=max_len)
    jtok, jstats = jsrv.generate(jp, {"tokens": jnp.asarray(tokens)}, GEN, scrub_every=0)
    tsrv = Server(model=tm, store=_tstore(tm, _policy(
        RedundancyPolicy, health=HealthPolicy(), **kw), max_len), max_len=max_len)
    batch = {"tokens": torch.from_numpy(tokens)}
    ttok, tstats = tsrv.generate(tp, batch, GEN, scrub_every=0)
    bare, _ = Server(model=tm, max_len=max_len).generate(tp, batch, GEN)
    assert torch.equal(ttok, bare)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    h, jh = tstats["health"], jstats["health"]
    assert h.worst == HEALTHY and h.step == jh.step == GEN - 1
    for f in ("states", "transitions", "violations", "backpressure_events",
              "patrol_starved_ticks", "rebuild_active", "remesh_active"):
        assert getattr(h, f) == getattr(jh, f), f
    assert [(a.group, a.rung, a.kind) for a in h.actions] == \
        [(a.group, a.rung, a.kind) for a in jh.actions]
    assert {k: v[0] for k, v in h.ages.items()} == {k: v[0] for k, v in jh.ages.items()}
    assert tstats["health_actions"] == jstats["health_actions"] == 0
    pat, jpat = tsrv.store.patroller, jsrv.store.patroller
    assert pat.blocks_scanned == jpat.blocks_scanned > 0
    assert dict(pat.cursor) == dict(jpat.cursor)
    assert not pat.detections and not jpat.detections and not pat.unrecoverable


def test_read_verified_is_not_ported(pair):
    _, _, tm, _, _ = pair
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item"):
        Server(model=tm, max_len=8).read_verified({}, {}, "slot_0/k", [0])


def test_launcher_runs_on_the_cpu(capsys):
    tokens, stats = launcher.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                                   "--batch", "2", "--prompt-len", "8", "--gen", "6",
                                   "--scrub-every", "2", "--period", "2"])
    out = capsys.readouterr().out
    assert "scrub mismatches=0" in out and "on cpu" in out
    assert tuple(tokens.shape) == (2, 6) and stats["mismatches"] == 0
    bare, _ = launcher.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8", "--gen", "6",
                             "--redundancy", "none"])
    assert torch.equal(tokens, bare)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised on it")
    cfg = get_smoke("llama3.2-3b")
    tree = {"embed": np.zeros((cfg.padded_vocab, cfg.d_model), np.float32)}
    for call in (lambda: launcher.main(["--arch", "llama3.2-3b", "--smoke"]),
                 lambda: params_from_numpy(tree, cfg),
                 lambda: build_model(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
