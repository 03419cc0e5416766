#!/usr/bin/env python3
"""Hold the port's Fig. 2 regret run against the JAX reference at full length.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fig2_reference.py [--seeds 42 0 1] [--horizon 20000]
        [--env '{"means": [[...]], "breaks": [...]}']

For each seed: the paper's Fig. 2 setup (N=5 channels, M=2 clients, a
piecewise env with 5 breakpoints, GLR-CUCB with history 1024 and detector
stride 5), realized by the JAX package from ``PRNGKey(seed)`` as
``benchmarks/run.py`` does it.  The JAX ``simulate_aoi_regret`` runs from
that key; the port's runs on the CPU on the same env (carried across by
``repro_torch.convert``) and on the uniforms behind JAX's own per-round
keys, so the two compute the same trajectory.  Each seed prints one line:
both packages' final regret, restarts and ``sublinearity_index``, and the
first round where their regret curves differ (``null`` if they are
bitwise equal).  With ``--env`` (the ``fig2 env`` line that
``chip_smoke.py`` prints), each seed runs on that env instead, with the
seed's key for the randomness only.  Both packages run on the CPU; no time
is reported.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.bandits import GLRCUCB as JaxGLRCUCB
from repro.core.channels import make_piecewise, random_piecewise_env
from repro.core.regret import simulate_aoi_regret as jax_simulate
from repro.core.regret import sublinearity_index as jax_sublinearity
from repro_torch import convert
from repro_torch.core.bandits import GLRCUCB
from repro_torch.core.regret import simulate_aoi_regret, sublinearity_index

N, M, HISTORY, STRIDE, BREAKPOINTS = 5, 2, 1024, 5, 5


def jax_uniforms(key, horizon, n):
    """(T, 2, N): the uniforms behind each round's ``k_env``/``k_sel``
    (``bernoulli(k, p)`` is ``uniform(k, p.shape) < p``)."""
    def draws(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (n,)), jax.random.uniform(k_sel, (n,))])

    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    return np.array(jax.vmap(draws)(keys))


def compare(seed: int, horizon: int, env_spec=None) -> dict:
    key = jax.random.PRNGKey(seed)
    if env_spec is None:
        env = random_piecewise_env(key, N, horizon, BREAKPOINTS)
    else:
        env = make_piecewise(np.asarray(env_spec["means"], np.float32),
                             np.asarray(env_spec["breaks"], np.int32))
    ref = jax_simulate(JaxGLRCUCB(N, M, history=HISTORY, detector_stride=STRIDE), env, key, horizon)
    tenv = convert.channel_env(env.form, env.means, env.breaks, env.table, device="cpu")
    u = torch.from_numpy(jax_uniforms(key, horizon, N))
    port = simulate_aoi_regret(GLRCUCB(N, M, history=HISTORY, detector_stride=STRIDE), tenv,
                               horizon, uniforms=u, device="cpu")
    r_ref, r_port = np.asarray(ref["regret"]), port["regret"].numpy()
    diff = np.flatnonzero(r_ref != r_port)
    return dict(
        seed=seed, horizon=horizon, breaks=np.asarray(env.breaks).tolist(),
        jax=dict(final_regret=float(ref["final_regret"]), restarts=int(ref["restarts"]),
                 sublinearity_index=float(jax_sublinearity(ref["regret"]))),
        port=dict(final_regret=float(port["final_regret"]), restarts=int(port["restarts"]),
                  sublinearity_index=float(sublinearity_index(port["regret"]))),
        first_differing_round=int(diff[0]) if diff.size else None,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 0, 1])
    ap.add_argument("--horizon", type=int, default=20000)
    ap.add_argument("--env", type=json.loads, default=None,
                    help="JSON {means: (S, N), breaks: (S-1,)} of a piecewise env")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(compare(seed, args.horizon, args.env)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
