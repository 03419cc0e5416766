"""End-to-end serving on the port: batched decode with the ring cache.

Twin of ``examples/serve_batched.py``.  Builds a small decoder (the arch's
smoke config), teacher-forces a batch of prompts through the decode path,
then serves new tokens with the production ``make_serve_step`` —
including the sliding-window ring cache (``--window``) that makes the
500k-context dry-run shape feasible for full-attention architectures.

Weights and prompts come from ``--seed`` through explicit generators on
``--device`` (``cuda`` unless given; without CUDA and without ``--device``
it raises).

Usage:
  PYTHONPATH=src python examples/torch/serve_batched.py [--arch qwen1.5-0.5b]
                                                        [--tokens 48] [--window 64]
  PYTHONPATH=src python examples/torch/serve_batched.py --device cpu --tokens 4
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=[a for a in list_archs() if not get_config(a).is_encoder])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: serve through a ring cache of this width")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, remat="none")
    params, _ = model.init(gen, device=dev)
    print(f"serving {cfg.name} ({cfg.arch_type}); batch={args.batch}, "
          f"window={'full' if args.window == 0 else args.window}")

    total = args.prompt_len + args.tokens
    cache = model.init_cache(args.batch, total, window=args.window or None, device=dev)
    serve = make_serve_step(model, window=args.window)

    # "prefill" by teacher-forcing the prompt through the decode path (the
    # smoke model is small; the full prefill is the dry run's and the smoke's)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=dev, dtype=torch.int32)
    tok = prompt[:, 0]
    for t in range(1, args.prompt_len):
        _, cache = serve(params, cache, tok)
        tok = prompt[:, t]

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    generated = []
    for _ in range(args.tokens):
        tok, cache = serve(params, cache, tok)
        generated.append(tok)
    # the steps only enqueue work: retire it before reading the clock
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    gen_ids = torch.stack(generated, dim=1)
    print(f"generated {args.tokens} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print("sample token ids:", gen_ids[0, :16].tolist())
    print(f"cache position: {int(cache['pos'])} (physical cache length "
          f"{'= window (ring)' if args.window else '= context'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
