"""Serve a small model with batched requests; the KV cache is protected by
Vilamb (block-granular dirty tracking, periodic redundancy, scrubbing
between decode steps).  The PyTorch port of ``examples/serve_decode.py``.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]

Shapes and scrub mismatch counts equal the JAX run's.  The weights and
prompts come from torch generators seeded like the reference's keys (0
for the weights, the wave number for its prompts), not from
``jax.random``, so the generated token ids are the port's own.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy
from repro_torch.models import build_model
from repro_torch.serve import Server

BATCH, PROMPT, GEN = 4, 24, 40


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device, "the example")

    cfg = get_smoke("glm4-9b")
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    max_len = PROMPT + GEN + 1

    store = ProtectedStore(RedundancyPolicy.single("vilamb", period_steps=16),
                           device=dev).attach(model.cache_shapes(BATCH, max_len))
    server = Server(model=model, store=store, max_len=max_len)

    for req in range(3):  # batched request waves
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (BATCH, PROMPT), dtype=torch.int32, device=dev,
            generator=torch.Generator(device=dev).manual_seed(req))}
        t0 = time.time()
        tokens, stats = server.generate(params, batch, GEN, scrub_every=10)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        print(f"request wave {req}: {tuple(tokens.shape)} in {dt:.2f}s "
              f"({BATCH*GEN/dt:.1f} tok/s), KV scrub mismatches={stats['mismatches']}")
        print("  first seq:", tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
