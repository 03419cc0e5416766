"""End to end: federated LLM training through the port's production step.

Twin of ``examples/federated_llm_train.py``.  Trains a qwen-family decoder
through ``repro_torch.launch.steps.make_fl_train_step``, the step
``repro_torch.launch.train`` runs at full scale, with GLR-CUCB channel
scheduling, adaptive matching, zeta-weighted masked aggregation and AoI
accounting in every round.

Default is a ~15M-param model / 60 rounds; ``--size 100m --steps 300``
is the deliverable-scale run.  Weights, env and the rounds' uniforms are
drawn from ``--seed`` on ``--device`` (``cuda`` unless given; without
CUDA and without ``--device`` it raises), the tokens from ``--seed`` with
numpy.

Usage:
  PYTHONPATH=src python examples/torch/federated_llm_train.py               # on the card
  PYTHONPATH=src python examples/torch/federated_llm_train.py --device cpu --steps 5
  PYTHONPATH=src python examples/torch/federated_llm_train.py --size 100m --steps 300
"""
import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bandits import GLRCUCB
from repro_torch.core.channels import random_piecewise_env
from repro_torch.data.synthetic import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_fl_train_step, make_train_state_init
from repro_torch.models import build_model
from repro_torch.optim import adamw

SIZES = {
    "15m": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                d_ff=1024, vocab_size=8192),
    "100m": dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
                 d_ff=2560, vocab_size=32768),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="15m", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ModelConfig(name=f"fed-qwen-{args.size}", arch_type="dense",
                      attention="gqa", qkv_bias=True, mlp_act="silu",
                      **SIZES[args.size])
    model = build_model(cfg, remat="none")
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params), "
          f"{args.clients} FL clients over {args.channels} channels on {dev}")

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(args.seed + offset)

    sched = GLRCUCB(args.channels, args.clients, history=256)
    env = random_piecewise_env(gen(1), args.channels, args.steps,
                               max(args.steps // 40, 1), device=dev)
    opt = adamw(args.lr)
    state = make_train_state_init(model, opt, sched, args.clients)(gen(0), device=dev)
    step = make_fl_train_step(model, opt, sched, env, args.clients)

    data = synthetic_lm_batches(args.batch, args.seq, cfg.vocab_size, seed=args.seed)
    uniforms = gen(2)
    t_start = time.time()
    for t in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(data)).to(dev)}
        u = torch.rand((2, args.channels), generator=uniforms, device=dev)
        state, mets = step(state, batch, u[0], u[1])
        if t % max(args.steps // 12, 1) == 0 or t == args.steps - 1:
            toks_s = args.batch * args.seq * (t + 1) / (time.time() - t_start)
            print(f"  step {t:4d}  loss={float(mets['loss']):7.4f}  "
                  f"|S_t|={int(mets['n_success']):2d}/{args.clients}  "
                  f"mean_aoi={float(mets['mean_aoi']):5.2f}  "
                  f"aoi_var={float(mets['aoi_var']):6.2f}  "
                  f"tok/s={toks_s:,.0f}")
    if args.ckpt:
        path = save_checkpoint(args.ckpt, args.steps,
                               {"params": state.params, "fl": state.fl._asdict()})
        print(f"checkpoint written: {path}")
    print(f"done in {time.time() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
