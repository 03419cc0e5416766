"""Quickstart: MAB channel scheduling for async FL, on the port.

Twin of ``examples/quickstart.py``.  Runs the paper's core loop at
miniature scale:
  1. a piecewise-stationary wireless environment (unknown, breaking means),
  2. GLR-CUCB vs random scheduling: the AoI regret comparison and its curve,
  3. a federated training run with adaptive fairness-aware matching.

Every draw comes from ``--seed`` through explicit generators on
``--device`` (``cuda`` unless given; without CUDA and without
``--device`` it raises); the data from ``--seed`` with numpy.

Usage:
  PYTHONPATH=src python examples/torch/quickstart.py                  # on the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu --rounds 500 --fl-rounds 20
"""
import argparse

import torch

from repro_torch.core.bandits import AoIAware, GLRCUCB, RandomScheduler
from repro_torch.core.channels import make_scenario
from repro_torch.core.regret import simulate_aoi_regret, sublinearity_index
from repro_torch.data import FederatedLoader, make_federated_classification
from repro_torch.device import resolve_device
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer

N_CHANNELS, N_CLIENTS = 8, 4


def ascii_curve(values, width=60, height=8, label=""):
    v = values.detach().float().cpu()
    idx = torch.linspace(0, len(v) - 1, width).long()
    samp = v[idx]
    top = float(samp.max()) or 1.0
    rows = []
    for r in range(height, 0, -1):
        line = "".join("#" if float(s) / top >= (r - 0.5) / height else " " for s in samp)
        rows.append("  |" + line)
    rows.append("  +" + "-" * width + f"  {label} (max={top:.0f})")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5000, help="regret horizon T")
    ap.add_argument("--fl-rounds", type=int, default=150)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = lambda offset: torch.Generator(device=dev).manual_seed(args.seed + offset)
    t_run = args.rounds

    print("=== 1. Non-stationary channel environment ===")
    # a registry scenario (swap "piecewise" for "gilbert_elliott" / "mobility" /
    # "shadowing" / "jamming"), realized to a canonical env from a generator
    scenario = make_scenario("piecewise", n_channels=N_CHANNELS, horizon=t_run, n_breakpoints=4)
    env = scenario.realize(gen(0), device=dev)
    print(f"{N_CHANNELS} Bernoulli sub-channels, 4 hidden breakpoints, "
          f"T={t_run} rounds, {N_CLIENTS} clients\n")

    print("=== 2. AoI regret: scheduling policies (paper Fig. 2a) ===")
    for sched in [
        RandomScheduler(N_CHANNELS, N_CLIENTS),
        GLRCUCB(N_CHANNELS, N_CLIENTS, history=512, detector_stride=4),
        AoIAware(GLRCUCB(N_CHANNELS, N_CLIENTS, history=512, detector_stride=4)),
    ]:
        out = simulate_aoi_regret(sched, env, t_run, generator=gen(1), device=dev)
        print(f"  {sched.name:14s} regret={float(out['final_regret']):8.0f}  "
              f"success={float(out['success_rate']):.3f}  "
              f"sublinearity={float(sublinearity_index(out['regret'])):.3f}")
        if sched.name == "glr-cucb":
            curve = out["regret"]
    print()
    print(ascii_curve(curve, label="GLR-CUCB cumulative AoI regret"))

    print("\n=== 3. Async FL with adaptive channel matching (Sec. V) ===")
    cx, cy, tx, ty, _, _ = make_federated_classification(
        N_CLIENTS, samples_per_client=256, alpha=0.3, seed=args.seed)
    loader = FederatedLoader(cx, cy, batch_size=32, local_epochs=2, seed=args.seed)
    g = gen(2)
    params = {"w1": torch.randn((64, 128), generator=g, device=dev) * 0.1,
              "b1": torch.zeros(128, device=dev),
              "w2": torch.randn((128, 10), generator=g, device=dev) * 0.1,
              "b2": torch.zeros(10, device=dev)}

    def loss_fn(p, x, y):
        h = torch.relu(x @ p["w1"] + p["b1"])
        lg = torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1)
        return -torch.mean(torch.gather(lg, 1, y[:, None].long()))

    cfg = AsyncFLConfig(n_clients=N_CLIENTS, n_channels=N_CHANNELS, local_epochs=2,
                        client_lr=0.08, server_lr=0.08)
    env_fl = make_scenario("piecewise", n_channels=N_CHANNELS, horizon=200,
                           n_breakpoints=3).realize(gen(3), device=dev)
    trainer = AsyncFLTrainer(cfg, GLRCUCB(N_CHANNELS, N_CLIENTS, history=128), env_fl, loss_fn,
                             device=dev)
    state = trainer.init(params)
    rounds = gen(4)
    for t in range(args.fl_rounds):
        bx, by = loader.next_round()
        state, mets = trainer.round(state, torch.as_tensor(bx, device=dev),
                                    torch.as_tensor(by, device=dev), generator=rounds)
        if t % 30 == 0:
            print(f"  round {t:3d}  local_loss={float(mets['local_loss']):.3f}  "
                  f"|S_t|={int(mets['n_success'])}  "
                  f"mean_aoi={float(mets['mean_aoi']):.2f}  "
                  f"beta_t={float(mets['beta_t']):.2f}")

    p = state.params
    h = torch.relu(torch.as_tensor(tx, device=dev) @ p["w1"] + p["b1"])
    pred = torch.argmax(h @ p["w2"] + p["b2"], dim=1)
    acc = float(torch.mean((pred == torch.as_tensor(ty, device=dev)).float()))
    print(f"\n  final test accuracy: {acc:.3f}")
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
