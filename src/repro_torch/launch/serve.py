"""Serving launcher: batched prefill + decode with Vilamb-protected caches
(the KV caches, the recurrent states of jamba and xlstm-1.3b, and
seamless-m4t-medium's cross-attention caches).

Example (on the card; ``--device cpu`` runs the plain versions instead):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --smoke \\
      --batch 4 --prompt-len 32 --gen 64 --redundancy vilamb --period 16

Per-leaf policies (e.g. protect K pages harder than V pages):
  ... --policy "*/k=vilamb:8,*/v=vilamb:64" --max-vulnerable-steps 128

The weights come from a generator seeded 0 and the prompt from one seeded
7, on the chosen device; internvl2-1b's image patches (``frontend_len`` of
them) and seamless-m4t-medium's encoder frames (``--prompt-len`` of them,
the reference's convention) are standard normals from the prompt's
generator.  The caches hold the patches, the prompt and the new tokens:
``max_len`` counts the patches, where the reference's launcher leaves them
out and cannot serve internvl2-1b (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--redundancy", default="vilamb", choices=["none", "sync", "vilamb"])
    ap.add_argument("--period", type=int, default=16)
    ap.add_argument("--scrub-every", type=int, default=16)
    ap.add_argument("--policy", default="",
                    help='per-leaf rules "pattern=mode[:period],..." '
                         "(fnmatch over flat cache paths)")
    ap.add_argument("--max-vulnerable-steps", type=int, default=0,
                    help="freshness deadline: force an update after this "
                         "many decode steps regardless of period")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..common import resolve_device
    from ..configs import get_arch, get_smoke
    from ..core import ProtectedStore, RedundancyPolicy
    from ..models import build_model
    from ..serve import Server

    device = resolve_device(args.device, "repro_torch.launch.serve")
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    patches = cfg.frontend_len if cfg.frontend == "vision" else 0
    max_len = patches + args.prompt_len + args.gen + 1
    enc_len = args.prompt_len if cfg.enc_dec else 0
    gen = torch.Generator(device=device).manual_seed(7)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=torch.int32,
        generator=gen, device=device)}
    if patches:
        batch["frontend"] = torch.randn((args.batch, patches, cfg.d_model),
                                        generator=gen, device=device)
    if enc_len:
        batch["enc_input"] = torch.randn((args.batch, enc_len, cfg.d_model),
                                         generator=gen, device=device)

    store = None
    if args.redundancy != "none" or args.policy:
        policy = RedundancyPolicy.from_spec(
            args.policy, default_mode=args.redundancy, period_steps=args.period,
            max_vulnerable_steps=args.max_vulnerable_steps)
        store = ProtectedStore(policy, device=device).attach(
            model.cache_shapes(args.batch, max_len, enc_len))

    srv = Server(model=model, store=store, max_len=max_len)
    t0 = time.perf_counter()
    tokens, stats = srv.generate(params, batch, args.gen, scrub_every=args.scrub_every)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[serve] generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {device} "
          f"scrub mismatches={stats['mismatches']}")
    print("[serve] first sequence:", tokens[0, :16].tolist())
    return tokens, stats


if __name__ == "__main__":
    main()
