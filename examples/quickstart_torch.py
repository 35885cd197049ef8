"""Quickstart: protect any state dict of torch tensors with Vilamb.

The PyTorch port of ``examples/quickstart.py``.  One facade owns the whole
redundancy lifecycle:

    store = ProtectedStore(policy).attach(state)   # what / how to protect
    red   = store.init(state)                      # full pass at creation
    red   = store.on_write(red, events=...)        # inside each write step
    red, _ = store.tick(state, red, step)          # once per host step

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Its printed lines equal the JAX quickstart's: the written rows are the
reference's ``jax.random.randint`` draws, checked in as ``ROWS``
(tests/test_torch_examples.py regenerates them with JAX), and nothing
printed depends on the random values of the state.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.common import resolve_device
from repro_torch.core import LeafPolicy, ProtectedStore, RedundancyPolicy
from repro_torch.core import blocks as B

# The heap rows written at steps 1..8:
# jax.random.randint(jax.random.PRNGKey(step), (16,), 0, 1024).
ROWS = [
    [764, 943, 736, 873, 416, 684, 278, 405, 850, 770, 32, 65, 514, 354, 1006, 26],
    [79, 636, 841, 959, 73, 424, 44, 493, 972, 21, 562, 491, 686, 825, 136, 303],
    [587, 627, 413, 682, 12, 616, 879, 604, 522, 234, 518, 54, 638, 322, 1023, 681],
    [854, 866, 909, 34, 124, 643, 283, 389, 508, 620, 382, 374, 171, 775, 787, 645],
    [769, 64, 247, 520, 316, 565, 411, 733, 901, 81, 556, 499, 624, 535, 389, 638],
    [270, 182, 124, 679, 328, 716, 696, 374, 335, 379, 281, 855, 772, 558, 941, 280],
    [799, 358, 380, 1005, 222, 870, 364, 402, 269, 511, 756, 403, 556, 826, 241, 525],
    [951, 577, 563, 309, 334, 20, 110, 147, 188, 540, 920, 689, 798, 14, 304, 188],
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device, "the example")

    # 1) Any dict of tensors is protectable state (here: a hot heap plus a
    #    cold param blob).  Policies are declarative and per leaf: the heap
    #    runs the paper's asynchronous mode with period T=8 and a freshness
    #    deadline of 16 steps; params use the sync (Pangolin) mode.
    g = torch.Generator(device=dev).manual_seed(0)
    state = {"heap": torch.randn((1024, 1024), generator=g, device=dev),
             "params": torch.randn((512, 512), generator=g, device=dev)}
    policy = RedundancyPolicy(
        default=LeafPolicy(mode="vilamb", period_steps=8, max_vulnerable_steps=16),
        rules=(("params*", LeafPolicy(mode="sync")),))

    store = ProtectedStore(policy, device=dev).attach(state)
    red = store.init(state)
    print("blocks:", store.metas["heap"].n_blocks,
          "stripes:", store.metas["heap"].n_stripes,
          "| groups:", [(g.policy.mode, g.names) for g in store.groups.values()])

    # 2) Writes report to the store: dirty marks for vilamb leaves, the
    #    old/new diff for sync leaves.  tick() owns the Algorithm-1
    #    schedule, scrubbing, straggler back-off and the freshness deadline.
    for step in range(1, 9):
        rows = torch.tensor(ROWS[step - 1], device=dev)
        old = dict(state)
        state["heap"].index_add_(0, rows, torch.ones((16, 1024), device=dev))
        state["params"] = state["params"] * 0.999
        ev = torch.zeros(1024, dtype=torch.bool, device=dev).index_fill_(0, rows, True)
        red = store.on_write(red, events={"heap": ev}, old=old, new=state)
        red, report = store.tick(state, red, step)
        if report.updated:
            print(f"step {step}: Algorithm 1 ran for {report.updated}")
    stats = store.dirty_stats(red)["heap"]
    print(f"dirty blocks after 8 steps: {int(stats['dirty_blocks'])} "
          f"(vulnerable stripes: {int(stats['vulnerable_stripes'])})")
    red = store.flush(state, red)  # preemption/battery path: force updates now

    # 3) Scrub detects silent corruption; parity repairs it (in place).
    meta = store.metas["heap"]
    B.to_lanes(state["heap"], meta)[5, 99] += 0xBAD              # SDC!
    bad = store.scrub(state, red)["heap"]
    print("scrub flagged blocks:", [int(i) for i in torch.nonzero(bad).flatten()])
    fixed, ok = store.recover_block(state["heap"], red["heap"], "heap", 5)
    state["heap"] = fixed
    print("parity reconstruction succeeded:", bool(ok),
          "- scrub after repair:",
          int(store.scrub(state, red)["heap"].sum()))


if __name__ == "__main__":
    main()
