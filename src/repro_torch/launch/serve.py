"""Serving launcher: batched greedy decode for every decoder of the zoo
(hubert-xlarge, the encoder, has no decode step and is not offered).

Twin of ``repro/launch/serve.py``.  Usage:
  python -m repro_torch.launch.serve --arch qwen3-32b                  # on the card
  python -m repro_torch.launch.serve --arch qwen3-32b --smoke --device cpu --tokens 3

Weights are drawn from ``--seed`` on ``--device`` (``cuda`` unless given;
without CUDA and without ``--device`` it raises).  tok/s is read after the
device has finished the loop.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(model, params, batch: int, context: int, tokens: int, window: int = 0,
               device=None):
    """The CLI's loop: ``tokens`` greedy steps for ``batch`` sequences from
    token 0 against a fresh cache of ``context`` (a ring of ``window`` if
    > 0).  Returns (last tokens (B,) int32, cache, seconds)."""
    dev = resolve_device(device)
    cache = model.init_cache(batch, context, window=window or None, device=dev)
    serve = make_serve_step(model, window=window)
    tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(tokens):
        tok, cache = serve(params, cache, tok)
    _sync(dev)            # the loop only enqueues work; retire it before reading the clock
    return tok, cache, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=[a for a in list_archs() if not get_config(a).is_encoder])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: sliding-window ring cache (long-context mode)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    tok, cache, dt = serve_loop(model, params, args.batch, args.context, args.tokens,
                                args.window, dev)
    print(f"[serve] {cfg.name}: {args.tokens} tokens x {args.batch} seqs "
          f"in {dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s), "
          f"cache pos={int(cache['pos'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
