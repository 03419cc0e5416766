#!/usr/bin/env python3
"""Where the rows of a batched FL run part from their serial runs, on one GPU.

    python3 tools/fl_batch_rows.py [--seed S] [--rounds R]

Runs the FL round with a run axis (``AsyncFLTrainer._run`` on a state from
``init_batch``: the batched code itself, never the serial loop that
``simulate_fl_batch`` takes for a batch of one) at B = 1, 2 and 8, and
holds each row against ``run()`` on the same data and uniforms, for three
trainers of ``chip_smoke.py``: ``fl_batch_bench``'s MLP (M = 4, N = 6),
phase 4's Fig. 3 trainer (N = 30, M = 20; its data shared by the runs) and
the chaos suite's linear model under burst(sign_flip) x coordinate median.
Prints, a row a line, whether the row is bit for bit and which state and
metric leaves differ.  Needs CUDA; exits 2 without it.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rows(torch, cs, label, tr, params, bx, by, u, fu=None):
    """Each row of the batched round at B = 1, 2, 8 against ``run()``."""
    for b in (1, 2, 8):
        st, mt = tr._run(tr.init_batch(params, b), bx[:b], by[:b], u[:b],
                         None if fu is None else fu[:b], tr.env)
        for i in range(b):
            want = tr.run(tr.init(params), bx[i], by[i], uniforms=u[i],
                          fault_uniforms=None if fu is None else fu[i])
            got = (cs.run_of(st, i), cs.run_of(mt, i))
            differ = sorted({p for (p, x), (_, y) in zip(cs.tensor_leaves(want),
                                                          cs.tensor_leaves(got))
                             if not torch.equal(x, y)})
            print(f"{label} B={b} row {i}: bit for bit {cs.same_tensors(torch, want, got)}; "
                  f"leaves that differ {differ}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fl_batch_rows: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core.aggregation import make_aggregator
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_stationary
    from repro_torch.core.faults import make_fault
    from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    r, gen = args.rounds, torch.Generator(device="cuda").manual_seed(args.seed + 5)

    B = cs.fl_bench_setup(torch, args.seed, r)
    rows(torch, cs, "fl_bench", B["tr"], B["params"], B["bx"], B["by"], B["uniforms"])

    S = cs.fig3_setup(torch, args.seed)
    tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"])
    u = torch.cat([S["uniforms"][None, :r],
                   torch.rand((7, r, 2, S["n"]), generator=gen, device="cuda")])
    shared = lambda x: x[:r].expand(8, *x[:r].shape)
    rows(torch, cs, "fig3", tr, S["params"], shared(S["bx"]), shared(S["by"]), u)

    m, n, d = 6, 9, 12
    bx = torch.randn((8, r, m, 1, 4, d), generator=gen, device="cuda")
    chaos = AsyncFLTrainer(AsyncFLConfig(n_clients=m, n_channels=n), GLRCUCB(n, m, history=64),
                           make_stationary(torch.full((n,), 0.8, device="cuda")),
                           lambda p, x, y: torch.mean((x @ p["w"] - y) ** 2),
                           faults=make_fault("burst", base=make_fault("sign_flip", rate=0.3,
                                                                      scale=6.0),
                                             p_on=0.15, p_off=0.35),
                           aggregator=make_aggregator("coordinate_median"))
    rows(torch, cs, "chaos burst", chaos, {"w": torch.full((d,), 0.5, device="cuda")}, bx,
         bx.sum(-1) * 0.3, torch.rand((8, r, 2, n), generator=gen, device="cuda"),
         torch.rand((8, r, chaos.n_fault_uniforms()), generator=gen, device="cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
