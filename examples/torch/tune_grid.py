"""Hyper-parameter tuning on the port's batched engine: the gamma x delta surface.

Twin of ``examples/tune_grid.py``.  GLR-CUCB leaves two scalar knobs free:
the UCB exploration scale ``gamma`` (Eq. 30 bonus multiplier) and the GLR
detection confidence ``delta`` (restart sensitivity).  This script sweeps
the ``gamma x delta`` grid, averaged over seeds, as one batch:

* every grid point is ``base.replace_traced(gamma=..., delta=...)``: the
  same structural config, other scalars, stacked by ``stack_params``;
* the grid (G points) and the seeds (S uniform streams, the same S at
  every point) are flattened into one G*S-run batch over one env: on the
  card one ``regret_scan`` launch;
* ``--shard`` runs it through ``sharded_aoi_regret_batch`` (a mesh of the
  one card: the same results).

The env and the seeds' uniforms are drawn from ``--seed`` through
explicit generators on ``--device`` (``cuda`` unless given; without CUDA
and without ``--device`` it raises).

Run it:

    PYTHONPATH=src python examples/torch/tune_grid.py                  # 4x4 grid
    PYTHONPATH=src python examples/torch/tune_grid.py --grid 6 --seeds 8 --shard
    PYTHONPATH=src python examples/torch/tune_grid.py --device cpu --horizon 200 --grid 2 --seeds 2

Output: a regret table (mean over seeds) with the best cell marked.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.bandits import GLRCUCB, stack_params
from repro_torch.core.channels import make_scenario
from repro_torch.device import resolve_device
from repro_torch.sim import sharded_aoi_regret_batch, simulate_aoi_regret_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--horizon", type=int, default=4000)
    ap.add_argument("--grid", type=int, default=4, help="grid side (G x G points)")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--channels", type=int, default=5)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--breakpoints", type=int, default=5)
    ap.add_argument("--scenario", default="piecewise",
                    choices=("piecewise", "gilbert_elliott", "mobility", "shadowing"),
                    help="registry scenario family to tune against")
    ap.add_argument("--shard", action="store_true",
                    help="run the batch through the sharded engine (one card)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    t_run, n, m, s = args.horizon, args.channels, args.clients, args.seeds
    gammas = np.linspace(0.5, 1.5, args.grid)
    deltas = np.logspace(-4, -1, args.grid)
    base = GLRCUCB(n, m, history=1024, detector_stride=5)
    env = make_scenario(args.scenario, n_channels=n, horizon=t_run,
                        **({"n_breakpoints": args.breakpoints}
                           if args.scenario == "piecewise" else {})
                        ).realize(torch.Generator(device=dev).manual_seed(args.seed), device=dev)

    # flatten (G*G grid) x (S seeds) into one batch: each point repeated for
    # its seeds, the seeds' uniform streams repeated for every point
    grid = [base.replace_traced(gamma=float(g), delta=float(d)) for g in gammas for d in deltas]
    hparams = stack_params([cfg for cfg in grid for _ in range(s)], device=dev)
    seeds = torch.rand((s, t_run, 2, n), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    uniforms = seeds.repeat(len(grid), 1, 1, 1)

    engine = sharded_aoi_regret_batch if args.shard else simulate_aoi_regret_batch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = engine(base, env, t_run, uniforms=uniforms, collect_curve=False, env_axis=None,
                 uniforms_axis=0, hparams=hparams, hp_axis=0, device=dev)
    regret = out["final_regret"].cpu().numpy()          # reading it waits for the device
    wall = time.perf_counter() - t0

    regret = regret.reshape(len(gammas), len(deltas), s)
    mean, std = regret.mean(-1), regret.std(-1)
    bi, bj = np.unravel_index(np.argmin(mean), mean.shape)

    print(f"# GLR-CUCB gamma x delta regret surface "
          f"(T={t_run}, {len(grid)} points x {s} seeds = {len(grid) * s} runs, one batch on "
          f"{dev} ({out.get('route', '-')} route){', sharded' if args.shard else ''}, "
          f"{wall:.2f}s)")
    print("gamma\\delta " + " ".join(f"{d:>10.1e}" for d in deltas))
    for i, g in enumerate(gammas):
        cells = []
        for j in range(len(deltas)):
            mark = "*" if (i, j) == (bi, bj) else " "
            cells.append(f"{mean[i, j]:>9.0f}{mark}")
        print(f"{g:>11.2f} " + " ".join(cells))
    print(f"# best: gamma={gammas[bi]:.2f} delta={deltas[bj]:.1e} "
          f"regret={mean[bi, bj]:.0f}±{std[bi, bj]:.0f}  (* marks the cell)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
