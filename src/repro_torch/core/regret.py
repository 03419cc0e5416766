"""AoI-regret simulation harness (Eq. 14).

Runs a scheduling policy and the clairvoyant oracle side by side through a
channel environment for T rounds (the paper's Fig. 2):

    R_pi(T) = sum_i sum_t E[ a_i^pi(t) - a_i^*(t) ]

Twin of ``repro/core/regret.py``.  Its ``lax.scan`` over the horizon has
two counterparts, for one run (``simulate_aoi_regret``) and for a batch of
runs with a leading run axis (``repro_torch.sim.simulate_aoi_regret_batch``,
whose batched loop is ``_simulate_rounds`` too): on the card, a GLR-CUCB
run or batch of runs is one launch of the ``regret_scan`` kernel (one
thread block a run); every other policy, and every run elsewhere, a Python
loop over the rounds, which is that kernel's plain version.  Each round
consumes two (N,) f32 uniforms, ``u[t, 0]`` for the channel draw and
``u[t, 1]`` for the policy, as the JAX harness splits each round key into
``k_env, k_sel``.  The loop never waits on the device: the round index is
a Python int and every decision stays a tensor.  The port's envs are all
open-loop (the ``"reactive"`` form is not ported), so the loop reads the
env's dense per-round means and threads no interaction carry.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.aoi import aoi_variance, init_aoi, update_aoi
from repro_torch.core.bandits.base import init_with_hp
from repro_torch.core.bandits.oracle import oracle_assign
from repro_torch.core.channels import ChannelEnv, ChannelProcess, dense_means
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import regret_scan as _rs


def policy_round(scheduler, sched_state, aoi, t, u_sel, ch_states, ring=None):
    """One policy-side round: select -> observe -> update -> AoI.

    ``ch_states`` is the (N,) realized channel-state vector for round ``t``;
    the observed rewards are its scheduled entries (semi-bandit feedback).
    Returns ``(sched_state, aoi, channels, rewards)``.

    The batched twin, for the scheduler service: with ``ring`` (a
    ``SlotRing``) the state leaves, ``aoi`` (B, M), ``u_sel`` and
    ``ch_states`` (B, N) carry a tenant axis, ``t`` is (B,) int32, and the
    update is ``scheduler.update_rows`` on the ring; each row's result
    equals the unbatched round on it.
    """
    channels, aux = scheduler.select(sched_state, t, u_sel, aoi)
    rewards = ch_states.gather(-1, channels)
    if ring is None:
        sched_state = scheduler.update(sched_state, t, channels, rewards, aux)
    else:
        sched_state = scheduler.update_rows(sched_state, t, channels, rewards, ring)
    aoi = update_aoi(aoi, rewards > 0.5)
    return sched_state, aoi, channels, rewards


def offline_round_stream(env, uniforms: torch.Tensor, horizon: int):
    """The ``(u_sel, states)`` stream ``simulate_aoi_regret`` consumes:
    ``u_sel[t]`` (N,) is round t's policy uniform ``uniforms[t, 1]`` and
    ``states[t]`` (N,) the channel realization drawn from ``uniforms[t, 0]``,
    both (T, N).  Serving this stream one request per round reproduces the
    offline run of the same ``uniforms`` (T, 2, N) bit for bit.  The port's
    envs are all open-loop, so ``sample`` is the draw.
    """
    if uniforms.shape[0] < horizon:
        raise ValueError(f"offline_round_stream: {uniforms.shape[0]} rounds of uniforms, "
                         f"horizon {horizon}")
    states = (uniforms[:horizon, 0] < dense_means(env, horizon)).to(torch.float32)
    return uniforms[:horizon, 1], states


IMPLS = (None, "scan", "rounds")


def simulate_aoi_regret(
    scheduler,
    env,
    horizon: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    collect_curve: bool = True,
    hp=None,
    return_state: bool = False,
    device=None,
    impl: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Simulate ``scheduler`` vs the oracle for ``horizon`` rounds.

    ``env`` is a ``ChannelEnv`` or a ``ChannelProcess`` (realized here from
    ``generator``).  The randomness is ``uniforms`` (T, 2, N) when given,
    else drawn from ``generator`` on ``device`` (default ``cuda``).

    ``impl`` picks the route: ``"scan"``, one launch of the ``regret_scan``
    kernel for all T rounds (raises ``ValueError`` naming the condition
    where ``kernels.regret_scan.refusal`` refuses the run); ``"rounds"``, the
    per-round loop (on the card through ``ops.glr_step``/``ops.glr_scan``);
    ``None``, the scan wherever ``refusal`` accepts the run, else the loop.
    The choice reads only types, fields and shapes: no device sync.

    Returns a dict with ``regret`` ((T,) cumulative AoI-regret curve, or the
    final scalar), ``final_regret``, ``cum_aoi_var`` / ``final_cum_aoi_var``
    (the policy's cumulative AoI variance, Fig. 4), ``oracle_cum_aoi_var``,
    ``aoi_pi`` / ``aoi_star`` (final per-client AoI), ``success_rate``,
    ``restarts`` for restart-counting detectors (also under AoI-Aware),
    ``exploit_rounds`` for AoI-Aware, ``channels`` ((T, M), the policy's
    schedule) and, with ``return_state``, ``final_sched_state``.
    """
    if impl not in IMPLS:
        raise ValueError(f"simulate_aoi_regret: unknown impl {impl!r}; use one of {IMPLS}")
    dev = resolve_device(device)
    if isinstance(env, ChannelProcess):
        env = env.realize(generator, device=dev)
    if not isinstance(env, ChannelEnv):
        raise TypeError(f"simulate_aoi_regret: env must be a ChannelEnv, got {type(env)}")
    env = env.to(dev)
    n = env.n_channels
    if uniforms is None:
        uniforms = torch.rand((horizon, 2, n), generator=generator, device=dev)
    elif tuple(uniforms.shape) != (horizon, 2, n):
        raise ValueError(
            f"simulate_aoi_regret: uniforms must be ({horizon}, 2, {n}), "
            f"got {tuple(uniforms.shape)}")
    uniforms = uniforms.to(device=dev, dtype=torch.float32)
    sched_state = init_with_hp(scheduler, dev, hp)
    if impl != "rounds":
        refusal = _rs.refusal(scheduler, env, sched_state, uniforms)
        if refusal is None:
            return ops.regret_scan(scheduler, env, sched_state, uniforms, collect_curve,
                                   return_state)
        if impl == "scan":
            raise ValueError(f"simulate_aoi_regret: impl='scan' does not apply: {refusal}")
    return _simulate_rounds(scheduler, env, sched_state, uniforms, collect_curve, return_state)


def _simulate_rounds(scheduler, env, sched_state, uniforms, collect_curve: bool,
                     return_state: bool, batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The per-round loop from ``sched_state`` over the rounds of ``uniforms``
    (T, 2, N): the plain version of the ``regret_scan`` kernel.  With
    ``batch`` B the state carries a leading (B,) run axis (``init_batch``),
    and so may ``env`` (stacked) and ``uniforms`` (B, T, 2, N); an operand
    without it is shared by every run.  Every output then has the run axis;
    each run's equals the unbatched loop's on that run bit for bit."""
    dev = uniforms.device
    horizon, n, m = uniforms.shape[-3], env.n_channels, scheduler.n_clients
    lead = () if batch is None else (batch,)
    mu = dense_means(env, horizon)
    aoi_pi = aoi_star = init_aoi(m, dev).expand(*lead, m)
    zero = torch.zeros(lead, device=dev)
    cum_regret, cum_var_pi, cum_var_star, successes = zero, zero, zero, zero
    regret_curve = torch.zeros(lead + (horizon,), device=dev) if collect_curve else None
    var_curve = torch.zeros(lead + (horizon,), device=dev) if collect_curve else None
    schedule = torch.zeros(lead + (horizon, m), dtype=torch.int64, device=dev)
    for t in range(horizon):
        u_t = uniforms[..., t, :, :]
        states = (u_t[..., 0, :] < mu[..., t, :]).to(torch.float32).expand(*lead, n)
        sched_state, aoi_pi, channels, rewards = policy_round(
            scheduler, sched_state, aoi_pi, t, u_t[..., 1, :].expand(*lead, n), states)
        # the oracle is the clairvoyant counterfactual on the same channel states
        _, star_success = oracle_assign(states, aoi_star, m)
        aoi_star = update_aoi(aoi_star, star_success)

        cum_regret = cum_regret + (aoi_pi - aoi_star).sum(-1)
        cum_var_pi = cum_var_pi + aoi_variance(aoi_pi)
        cum_var_star = cum_var_star + aoi_variance(aoi_star)
        successes = successes + rewards.sum(-1)
        schedule[..., t, :] = channels
        if collect_curve:
            regret_curve[..., t] = cum_regret
            var_curve[..., t] = cum_var_pi

    out = {
        "regret": regret_curve if collect_curve else cum_regret,
        "final_regret": cum_regret,
        "cum_aoi_var": var_curve if collect_curve else cum_var_pi,
        "final_cum_aoi_var": cum_var_pi,
        "oracle_cum_aoi_var": cum_var_star,
        "aoi_pi": aoi_pi,
        "aoi_star": aoi_star,
        "success_rate": successes / (horizon * m),
        "channels": schedule,
    }
    out.update(state_counters(sched_state))
    if return_state:
        out["final_sched_state"] = sched_state
    return out


def state_counters(sched_state) -> Dict[str, torch.Tensor]:
    """The policy's counters: GLR-CUCB's ``restarts``, AoI-Aware's
    ``exploit_rounds``, each read from the state or, through ``base``, from
    the state of the policy it wraps."""
    out = {}
    for name in ("restarts", "exploit_rounds"):
        state = sched_state
        while isinstance(state, tuple) and not hasattr(state, name):
            state = getattr(state, "base", None)
        if isinstance(state, tuple):
            out[name] = getattr(state, name)
    return out


def regret_growth_exponent(regret_curve: torch.Tensor, burn_in: int = 100) -> float:
    """Least-squares slope of log R(t) vs log t — the empirical growth
    exponent.  The paper's bounds predict ~0.5 (sqrt(T)); 1.0 = linear."""
    t = torch.arange(burn_in, regret_curve.shape[0], device=regret_curve.device) + 1.0
    r = regret_curve[burn_in:].clamp_min(1.0)
    x, y = torch.log(t), torch.log(r)
    xm, ym = x.mean(), y.mean()
    return float(((x - xm) * (y - ym)).sum() / ((x - xm) ** 2).sum())


def sublinearity_index(regret_curve: torch.Tensor) -> torch.Tensor:
    """Ratio of the second-half regret growth rate to the first half.
    < 1.0 indicates sub-linear growth (the paper's headline property)."""
    t = regret_curve.shape[0]
    half = t // 2
    first = regret_curve[half - 1] / max(half, 1)
    second = (regret_curve[-1] - regret_curve[half - 1]) / max(t - half, 1)
    return second / first.clamp_min(1e-9)
