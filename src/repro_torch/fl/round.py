"""Asynchronous FL round runtime (Sec. II-A Steps 1-4 + Sec. IV/V policies).

One round:

  Step 1  clients in S_{t-1} receive w_t (everyone else trains nothing and
          keeps its buffered update G~, Eq. 6)
  Step 2  E local SGD epochs, vmapped over clients (Eq. 5); an optional
          ``FaultProcess`` (``repro_torch.core.faults``) then corrupts the
          fresh updates / drops clients, between local training and the
          Eq.-6 buffer carry
  Step 3  the scheduler picks M channels; the adaptive matcher assigns
          them to clients by priority (Eq. 39-40); the channel env draws
          Good/Bad (a ``"reactive"`` env from its carried load, which the
          round then advances with the channels the matcher used); S_t =
          clients whose channel was Good
  Step 4  the server aggregates  w <- w - eta_s/|S_t| * sum_{i in S_t} zeta_i G~_i
          through the ``weighted_aggregate`` kernel (Eq. 7), or through
          an ``Aggregator`` (``repro_torch.core.aggregation``: the robust
          families run the ``robust_trimmed`` kernel), updates AoI
          (Eq. 8), the contribution buffers (Eq. 41-42), zeta (Eq. 43)
          and the bandit statistics.

          With ``cfg.quarantine`` (default on), Step 4 is gated: buffer
          rows that are non-finite or (with ``cfg.max_update_norm > 0``)
          norm-exploded are zeroed out of the aggregation, their
          ``has_update`` is revoked and the owner re-enters S_t.  A
          staleness cap (``cfg.staleness_cap > 0``) rejects buffered
          updates older than tau rounds.  AoI resets only on aggregated
          deliveries, and an all-Bad round is a bitwise no-op on
          ``params`` (a ``where`` on |S_t| > 0, not an add of zero).
          ``aggregate_step`` is this Step 4; the sparse round
          (``repro_torch.fl.sparse``) runs it on its slot rows too.

Client updates are carried flattened (M, P), sorted-key order.  Each
round draws two (N,) f32 uniforms, ``u_env`` for the channel states and
``u_sel`` for the scheduler, as the JAX round splits its key into
``k_env, k_sel``; with ``faults`` it also draws the family's
``n_uniforms(M)`` uniforms ``u_fault``, which stand for the JAX round's
draws on ``fold_in(key, 0xFA17)`` (see ``repro_torch.core.faults``).
``run_served`` takes each round's schedule from a ``SchedServer``
instead; the trainer owns the env, so a reactive env's loop closes there
too.  The env may be handed in unrealized (a ``ChannelProcess``): the
trainer realizes it from ``realize_generator``, the twin of JAX's
``realize_key``, and keeps the process as ``scenario``.

The run axis.  ``round`` and ``run`` also take a batch of B independent
runs: a state from ``init_batch`` (every tensor leaf (B, ...), the
round index shared), (B, ...) data and uniforms.  It is the same round:
every per-client tensor is (B, M), every reduction runs over the client
or parameter axis of its own run, local SGD maps the runs around the
client map, and Step 4 is one batched kernel launch for the whole batch.
The env is an operand of the round (``_round``/``_run``): the trainer's
own, or a stacked env (``stack_envs``), one a run, from the batched FL
engine (``repro_torch.sim.simulate_fl_batch``), which sweep buckets of
equal ``bucket_signature()`` run through.  Twin of ``repro/fl/round.py``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.aggregation import MeanAgg
from repro_torch.core.aoi import aoi_variance, init_aoi, mean_aoi, update_aoi
from repro_torch.core.bandits.base import init_batch as init_sched_batch
from repro_torch.core.bandits.base import init_with_hp
from repro_torch.core.channels import ChannelEnv, ChannelProcess
from repro_torch.core.contribution import (
    ContributionBuffer,
    aggregation_weights,
    init_buffer,
    marginal_contribution,
    update_buffer,
)
from repro_torch.core.matching import AdaptiveMatcher, MatcherState, matcher_scores
from repro_torch.device import resolve_device
from repro_torch.fl.client import local_updates
from repro_torch.sim.serve import ServeRequest
from repro_torch.utils.tree import tree_flatten_concat, tree_map, tree_unflatten_concat

_MEAN = MeanAgg()


def dispatch_aggregate(aggregator, buffers, mask, zeta, n_succ, params=None):
    """Step-4 aggregation through a ``repro_torch.core.aggregation``
    ``Aggregator`` with its knobs ``params`` (default ``params()``);
    ``aggregator=None`` is ``MeanAgg``, the zeta-weighted masked mean of
    Eq. 7.  ``buffers`` arrive quarantine-masked; returns the (P,) f32
    aggregate, zeros when nothing participates ((B, P) for a batch)."""
    return (aggregator or _MEAN).aggregate(buffers, mask, zeta, n_succ, params)


def _lead(state) -> Tuple[int, ...]:
    """The state's run axis: () for one run, (B,) for a batch."""
    return tuple(state.aoi.shape[:-1])


def _over(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) or 0-d per-run value shaped to broadcast against ``like``
    (B, ...) or (...)."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def realized_env(env, realize_generator: Optional[torch.Generator], device,
                 owner: str) -> Tuple[ChannelEnv, Optional[ChannelProcess]]:
    """A trainer's ``(env, scenario)`` on ``device``: a ``ChannelEnv`` as
    given (no scenario), or a ``ChannelProcess`` realized from
    ``realize_generator`` (seeded 0 with a warning when None, JAX's
    ``PRNGKey(0)`` fallback) and kept as the scenario."""
    scenario = None
    if isinstance(env, ChannelProcess):
        scenario = env
        if realize_generator is None:
            warnings.warn(
                f"{owner}: ChannelProcess env realized with the fixed generator seeded 0 — "
                "all seeds will share one realized channel trajectory.  Pass "
                "realize_generator= (e.g. scenario_realize_generator(seed, device)) for "
                "per-seed scenario draws.", stacklevel=3)
            realize_generator = torch.Generator(device=device).manual_seed(0)
        env = env.realize(realize_generator, device)
    if not isinstance(env, ChannelEnv):
        raise TypeError(f"{owner}: env must be a ChannelEnv or a ChannelProcess, "
                        f"got {type(env).__name__}")
    return env.to(device), scenario


def batched_init(trainer, params: Dict[str, Any], batch: int, params_axis: Optional[int],
                 hp: Any, hp_axis: Optional[int]):
    """``trainer.init``'s state with a leading (B,) on every tensor leaf,
    the ``init_batch`` of the dense and the sparse trainer: ``params``
    shared or stacked (``params_axis=0``), ``hp`` shared or a
    ``stack_params`` grid (``hp_axis=0``); ``t`` stays one int."""
    for name, axis in (("params_axis", params_axis), ("hp_axis", hp_axis)):
        if axis not in (0, None):
            raise ValueError(f"init_batch: {name} is 0 or None, got {axis}")
    if hp_axis == 0 and not hp:
        raise ValueError("init_batch: hp_axis=0 needs an hp grid (stack_params)")
    dev = trainer.device
    params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    if params_axis == 0:
        bad = {k: tuple(v.shape) for k, v in params.items() if v.shape[:1] != (batch,)}
        if bad:
            raise ValueError(f"init_batch: params_axis=0 takes ({batch}, ...) leaves, "
                             f"got {bad}")
    one = trainer.init({k: v[0] for k, v in params.items()} if params_axis == 0 else params)

    def rows(x):
        return x.unsqueeze(0).repeat(batch, *([1] * x.dim()))

    return one._replace(
        params=params if params_axis == 0 else {k: rows(v) for k, v in params.items()},
        sched_state=init_sched_batch(trainer.scheduler, batch, dev, hp),
        **{f: tree_map(rows, getattr(one, f)) for f in one._fields
           if f not in ("params", "sched_state", "t")})


class Step4(NamedTuple):
    """What Step 4 leaves for the bookkeeping after it."""

    params: Dict[str, torch.Tensor]  # the new global model
    agg_mask: torch.Tensor           # (..., M) rows aggregated (S_t after the gates)
    n_succ: torch.Tensor             # (...) |S_t|
    agg_buffers: torch.Tensor        # (..., M, P) the rows the aggregator saw
    has_update: torch.Tensor         # (..., M) poisoned buffers revoked
    last_success: torch.Tensor       # (..., M) who retrains at the next grant


def aggregate_step(cfg, m: int, aggregator, agg_params, params, buffers, success, staleness,
                   has_update, zeta) -> Step4:
    """Step 4 on M client rows, shared by the dense and the sparse round:
    the quarantine gate and staleness cap of ``cfg``, Eq. 7 through
    ``dispatch_aggregate`` (the CUDA kernel on the card), the gated server
    step, and the degraded-path bookkeeping (poisoned buffers discarded;
    quarantined or stale-rejected-but-delivered clients re-enter S_t).
    Every tensor may lead with a run axis."""
    lead, dev = tuple(success.shape[:-1]), success.device
    if cfg.quarantine:
        row_ok = torch.isfinite(buffers).all(dim=-1)
        if cfg.max_update_norm > 0.0:
            row_ok = row_ok & (torch.linalg.vector_norm(buffers, dim=-1)
                               <= cfg.max_update_norm)
        row_ok = row_ok.to(torch.float32)
    else:
        row_ok = torch.ones(lead + (m,), device=dev)
    if cfg.staleness_cap > 0:
        fresh_ok = (staleness <= float(cfg.staleness_cap)).to(torch.float32)
    else:
        fresh_ok = torch.ones(lead + (m,), device=dev)
    agg_mask = success * row_ok * fresh_ok
    n_succ = agg_mask.sum(dim=-1)

    if cfg.quarantine:
        # zero quarantined rows BEFORE the aggregator: 0 * NaN = NaN
        agg_buffers = torch.where(agg_mask[..., None] > 0.5, buffers, 0.0)
    else:
        agg_buffers = buffers
    agg_flat = dispatch_aggregate(aggregator, agg_buffers, agg_mask, zeta, n_succ,
                                  agg_params)  # (P,) or (B, P) f32
    step_vec = -cfg.server_lr / m * agg_flat
    delta = tree_unflatten_concat(step_vec, params, len(lead))
    if cfg.quarantine:
        any_agg = n_succ > 0.0
        params = {k: torch.where(_over(any_agg, p_), p_ + delta[k].to(p_.dtype), p_)
                  for k, p_ in params.items()}
    else:
        params = {k: p_ + delta[k].to(p_.dtype) for k, p_ in params.items()}

    bad_row = 1.0 - row_ok
    stale_reject = success * row_ok * (1.0 - fresh_ok)
    return Step4(params=params, agg_mask=agg_mask, n_succ=n_succ, agg_buffers=agg_buffers,
                 has_update=has_update * row_ok,
                 last_success=torch.maximum(agg_mask, torch.maximum(bad_row, stale_reject)))


class AsyncFLState(NamedTuple):
    """One run's state; with a run axis (``init_batch``) every tensor leaf
    has a leading (B,) (a shared hyper-parameter of the scheduler stays
    0-d) and ``t`` is shared."""

    params: Dict[str, torch.Tensor]  # global model w_t
    buffers: torch.Tensor            # (M, P) flattened G~_i (Eq. 6)
    has_update: torch.Tensor         # (M,) G~ validity
    last_success: torch.Tensor       # (M,) S_{t-1} indicator
    aoi: torch.Tensor                # (M,)
    contrib_buf: ContributionBuffer
    contrib: torch.Tensor            # (M,) C~
    zeta: torch.Tensor               # (M,) aggregation weights
    sched_state: Any
    matcher_state: MatcherState
    t: int                           # round index (a Python int: no device sync)
    env_state: torch.Tensor          # (N,) interaction carry (dead for open-loop envs)
    staleness: torch.Tensor          # (M,) age of the buffered G~ in rounds
    fault_state: torch.Tensor        # () fault-schedule carry (burst on/off; a
                                     # dead zero for memoryless families and
                                     # faultless trainers)


class _RoundPre(NamedTuple):
    """A round's state before the schedule is decided (Steps 1-2)."""

    buffers: torch.Tensor          # (M, P) after the Eq.-6 carry
    has_update: torch.Tensor       # (M,)
    staleness: torch.Tensor        # (M,)
    active: torch.Tensor           # (M,) clients that trained this round
    dropped: Optional[torch.Tensor]  # (M,) fault drops, None without faults
    local_losses: torch.Tensor     # (M,)
    ch_states: torch.Tensor        # (N,) the round's channel realization
    fault_state: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AsyncFLConfig:
    n_clients: int
    n_channels: int
    local_epochs: int = 1
    client_lr: float = 0.05
    server_lr: float = 0.05        # eta_s
    matcher_beta: float = 0.5
    use_matching: bool = True      # ablation switch (paper's "aware allocation")
    use_zeta: bool = True          # ablation: Eq. 43 weights vs uniform
    quarantine: bool = True        # mask non-finite buffer rows out of Eq. 7
    max_update_norm: float = 0.0   # >0: also quarantine rows with ||G~|| above
    staleness_cap: int = 0         # >0: reject buffered G~ older than tau rounds


class AsyncFLTrainer:
    """The asynchronous FL trainer on ``device`` (default ``cuda``).

    ``env`` is a ``ChannelEnv`` of any form, or an unrealized
    ``ChannelProcess``, realized here on the trainer's device from
    ``realize_generator`` (a ``torch.Generator`` on that device; derive one
    a seed, e.g. ``scenario_realize_generator(seed, device)``) and kept as
    ``scenario``.  Without a generator it is realized from a generator
    seeded 0, with a warning: every trainer built so then shares one
    channel trajectory (JAX's ``PRNGKey(0)`` fallback).
    ``loss_fn(params, x, y)`` is a scalar loss of a parameter dict;
    ``proxy_loss_fn(flat_params)`` the optional server proxy loss (Eq. 35);
    ``faults`` an optional ``FaultProcess``; ``aggregator`` an optional
    ``Aggregator`` (None: the zeta-weighted mean of Eq. 7).
    """

    def __init__(self, cfg: AsyncFLConfig, scheduler, env, loss_fn: Callable,
                 proxy_loss_fn: Optional[Callable] = None, device=None, faults=None,
                 aggregator=None, realize_generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.env, self.scenario = realized_env(env, realize_generator, self.device,
                                               type(self).__name__)
        self.cfg = cfg
        self.scheduler = scheduler
        self.loss_fn = loss_fn
        self.proxy_loss_fn = proxy_loss_fn
        self.faults = faults
        self.aggregator = aggregator
        # knobs made on the device once: a tensor built from a Python float
        # per round would be a blocking host-to-device copy
        self._fault_params = faults.params(self.device) if faults is not None else None
        self._agg_params = aggregator.params(self.device) if aggregator is not None else None

    def n_fault_uniforms(self) -> int:
        """f32 uniforms the fault family consumes a round (0 without one)."""
        return 0 if self.faults is None else self.faults.n_uniforms(self.cfg.n_clients)

    def bucket_signature(self) -> Tuple:
        """What two trainers must share to run as one batch: the config,
        the scheduler's ``hp_signature`` (its traced scalars may differ:
        they ride the batch's hyper-parameter axis), the env's form and
        shapes (or the scenario's ``env_signature``: the values may differ,
        envs are stacked), the identity of the loss and proxy functions,
        and the fault and aggregator instances (compared by value)."""
        sig = getattr(self.scheduler, "hp_signature", None)
        sched_sig = sig() if sig is not None else self.scheduler
        env_sig = (("scenario",) + self.scenario.env_signature() if self.scenario is not None
                   else self.env.signature())
        return ("async_fl", self.cfg, sched_sig, env_sig, self.loss_fn, self.proxy_loss_fn,
                self.faults, self.aggregator)

    # ------------------------------------------------------------------ init
    def init(self, params: Dict[str, Any], hp: Any = None) -> AsyncFLState:
        dev, m = self.device, self.cfg.n_clients
        params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
        p = int(tree_flatten_concat(params).shape[0])
        return AsyncFLState(
            params=params,
            buffers=torch.zeros((m, p), device=dev),
            has_update=torch.zeros((m,), device=dev),
            last_success=torch.ones((m,), device=dev),    # round 0: all start fresh
            aoi=init_aoi(m, dev),
            contrib_buf=init_buffer(m, p, dev),
            contrib=torch.ones((m,), device=dev),
            zeta=torch.full((m,), 1.0 / m, device=dev),
            sched_state=init_with_hp(self.scheduler, dev, hp),
            matcher_state=AdaptiveMatcher(self.cfg.matcher_beta).init(dev),
            t=0,
            env_state=self.env.interact_init(),
            staleness=torch.ones((m,), device=dev),
            fault_state=(self.faults.schedule_init(dev) if self.faults is not None
                         else torch.zeros((), device=dev)),
        )

    def init_batch(self, params: Dict[str, Any], batch: int, params_axis: Optional[int] = None,
                   hp: Any = None, hp_axis: Optional[int] = None) -> AsyncFLState:
        """The state of ``batch`` independent runs, the input of the batched
        FL engine: ``init``'s state with a leading (B,) on every tensor leaf.
        ``params`` is one model shared by every run (``params_axis=None``)
        or stacked, one a run (``params_axis=0``).  ``hp`` overrides the
        scheduler's hyper-parameters: one ``params()`` dict for every run
        (``hp_axis=None``) or a ``stack_params`` grid of (B,) values
        (``hp_axis=0``), which turns the batch into a tuning axis."""
        return batched_init(self, params, batch, params_axis, hp, hp_axis)

    # ------------------------------------------------------------------ round
    def _round_pre(self, state: AsyncFLState, batches_x, batches_y, u_env, u_fault, env):
        """Steps 1-2, the Eq.-6 carry and the round's channel realization:
        everything before the schedule is decided."""
        dev = self.device
        # ---- Steps 1-2: local training for clients in S_{t-1} ------------
        fresh_updates, local_losses = local_updates(
            self.loss_fn, state.params, batches_x.to(dev), batches_y.to(dev),
            self.cfg.client_lr, batched=bool(_lead(state)))

        # ---- fault injection: between training and the Eq.-6 carry ---------
        # A dropped client neither refreshes its buffer nor transmits; the
        # faultless path multiplies by no all-ones mask (same values, fewer ops)
        if self.faults is not None:
            fresh_updates, dropped, fault_state = self.faults.inject_sched(
                u_fault.to(dev), state.t, fresh_updates, state.fault_state, self._fault_params)
            active = state.last_success * (1.0 - dropped)
        else:
            dropped, fault_state = None, state.fault_state
            active = state.last_success

        # Eq. 6 via `where`: a corrupted fresh row must not leak NaN into an
        # inactive client's kept buffer (0 * NaN)
        return _RoundPre(
            buffers=torch.where(active[..., None] > 0.5, fresh_updates, state.buffers),
            has_update=torch.maximum(state.has_update, active),
            staleness=torch.where(active > 0.5, 1.0, state.staleness + 1.0),
            active=active, dropped=dropped, local_losses=local_losses,
            ch_states=env.sample_dyn(state.t, u_env.to(dev), state.env_state),
            fault_state=fault_state)

    def _round_post(self, state: AsyncFLState, pre: "_RoundPre", assignment, matcher_state,
                    sched_state, env) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """Step 3 after the decision (transmit), Step 4 and the bookkeeping,
        given the round's ``assignment``, post-step matcher state and
        scheduler state."""
        cfg, dev = self.cfg, self.device
        m, n, t = cfg.n_clients, cfg.n_channels, state.t
        lead = _lead(state)
        buffers, has_update, staleness = pre.buffers, pre.has_update, pre.staleness
        sched_mask = torch.zeros(lead + (n,), device=dev).scatter_(-1, assignment, 1.0)
        env_state = env.interact_step(state.env_state, t, sched_mask)
        success = (pre.ch_states.gather(-1, assignment) > 0.5).to(torch.float32)
        success = success * has_update        # a client with no update yet can't help
        if pre.dropped is not None:
            success = success * (1.0 - pre.dropped)   # and a dropped one can't transmit

        # ---- Step 4: quarantine gate + aggregate (Eq. 7, CUDA kernel) -------
        zeta = state.zeta if cfg.use_zeta else torch.full(lead + (m,), 1.0 / m, device=dev)
        step4 = aggregate_step(cfg, m, self.aggregator, self._agg_params, state.params,
                               buffers, success, staleness, has_update, zeta)
        params, agg_mask, agg_buffers = step4.params, step4.agg_mask, step4.agg_buffers

        # ---- bookkeeping: AoI, contribution, zeta ---------------------------
        aoi = update_aoi(state.aoi, agg_mask > 0.5)
        params_flat = tree_flatten_concat(params, len(lead))
        contrib_buf = update_buffer(state.contrib_buf, agg_mask > 0.5, agg_buffers,
                                    params_flat[..., None, :].expand_as(buffers))
        contrib = marginal_contribution(contrib_buf, zeta, self.proxy_loss_fn)
        new_zeta = aggregation_weights(contrib)

        new_state = AsyncFLState(
            params=params, buffers=buffers, has_update=step4.has_update,
            last_success=step4.last_success, aoi=aoi, contrib_buf=contrib_buf,
            contrib=contrib, zeta=new_zeta, sched_state=sched_state,
            matcher_state=matcher_state, t=t + 1, env_state=env_state,
            staleness=staleness, fault_state=pre.fault_state,
        )
        # losses of clients that actually trained this round, kept finite
        loss_ok = torch.isfinite(pre.local_losses).to(torch.float32)
        loss_w = pre.active * loss_ok
        metrics = {
            "local_loss": (torch.where(loss_ok > 0.5, pre.local_losses, 0.0) * pre.active
                           ).sum(dim=-1) / loss_w.sum(dim=-1).clamp_min(1.0),
            "n_success": step4.n_succ,
            "mean_aoi": mean_aoi(aoi),
            "aoi_var": aoi_variance(aoi),
            "beta_t": matcher_state.beta_t,
            "zeta_max": new_zeta.amax(dim=-1),
        }
        return new_state, metrics

    def _draw(self, generator, u_env, u_sel, u_fault, caller: str, lead=()):
        """The round's uniforms: as given, else drawn from ``generator``
        in the order u_env, u_sel, u_fault."""
        n, k = self.cfg.n_channels, self.n_fault_uniforms()
        if (u_env is None) != (u_sel is None):
            raise ValueError(f"{caller}: pass both u_env and u_sel, or neither")
        if k and (u_env is None) != (u_fault is None):
            raise ValueError(f"{caller}: with faults, pass u_env, u_sel and u_fault, or none")
        if not k and u_fault is not None:
            raise ValueError(f"{caller}: u_fault given to a trainer without faults")
        if u_env is None:
            u_env, u_sel = torch.rand(lead + (2, n), generator=generator,
                                      device=self.device).unbind(-2)
            if k:
                u_fault = torch.rand(lead + (k,), generator=generator, device=self.device)
        return u_env, u_sel, u_fault

    def round(
        self,
        state: AsyncFLState,
        batches_x: torch.Tensor,    # (M, E, B, ...), or (B, M, E, B, ...) for a batch
        batches_y: torch.Tensor,    # (M, E, B)
        generator: Optional[torch.Generator] = None,
        u_env: Optional[torch.Tensor] = None,
        u_sel: Optional[torch.Tensor] = None,
        u_fault: Optional[torch.Tensor] = None,
    ) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """One round.  The round's randomness is ``u_env``/``u_sel`` ((N,)
        uniforms) and, with ``faults``, ``u_fault`` ((K,) uniforms,
        ``K = n_fault_uniforms()``) when given, else drawn from
        ``generator`` in that order.  A batched state (``init_batch``) takes
        (B, ...) data and (B, N) / (B, K) uniforms and gives (B,) metrics."""
        u_env, u_sel, u_fault = self._draw(generator, u_env, u_sel, u_fault, "round",
                                           _lead(state))
        return self._round(state, batches_x, batches_y, u_env, u_sel, u_fault, self.env)

    def _round(self, state, batches_x, batches_y, u_env, u_sel, u_fault, env):
        """One round against ``env`` (the trainer's, or a stacked env for a
        batch), with or without a run axis."""
        pre = self._round_pre(state, batches_x, batches_y, u_env, u_fault, env)

        # ---- Step 3: schedule + match ---------------------------------------
        t = state.t
        channels, aux = self.scheduler.select(state.sched_state, t, u_sel, state.aoi)
        matcher = AdaptiveMatcher(self.cfg.matcher_beta)
        if self.cfg.use_matching:
            scores = matcher_scores(self.scheduler, state.sched_state, t, env)
            assignment, matcher_state = matcher.match(
                state.matcher_state, channels, scores, state.contrib, state.aoi)
        else:
            assignment = channels
            _, matcher_state = matcher.priorities(state.matcher_state, state.contrib, state.aoi)
        rewards = pre.ch_states.gather(-1, assignment)
        sched_state = self.scheduler.update(state.sched_state, t, assignment, rewards, aux)
        return self._round_post(state, pre, assignment, matcher_state, sched_state, env)

    # ------------------------------------------------------------------ run
    def _operands(self, state, batches_x, batches_y, generator, uniforms, fault_uniforms,
                  caller: str):
        """``run``'s checks: the rounds' data and uniforms, ``uniforms`` and
        ``fault_uniforms`` drawn from ``generator`` (in that order) when
        not given.  Returns (R, uniforms, fault_uniforms)."""
        lead, n, k = _lead(state), self.cfg.n_channels, self.n_fault_uniforms()
        r = int(batches_x.shape[len(lead)])
        if tuple(batches_x.shape[:len(lead)]) != lead:
            raise ValueError(f"{caller}: batches_x must lead with the run axis {lead}, "
                             f"got {tuple(batches_x.shape)}")
        if tuple(batches_y.shape[:len(lead) + 1]) != lead + (r,):
            raise ValueError(f"{caller}: batches_y leading axes {tuple(batches_y.shape)} != "
                             f"{lead + (r,)}")
        if k and (uniforms is None) != (fault_uniforms is None):
            raise ValueError(f"{caller}: with faults, pass uniforms and fault_uniforms, "
                             "or neither")
        if not k and fault_uniforms is not None:
            raise ValueError(f"{caller}: fault_uniforms given to a trainer without faults")
        if uniforms is None:
            uniforms = torch.rand(lead + (r, 2, n), generator=generator, device=self.device)
            if k:
                fault_uniforms = torch.rand(lead + (r, k), generator=generator,
                                            device=self.device)
        elif tuple(uniforms.shape) != lead + (r, 2, n):
            raise ValueError(f"{caller}: uniforms must be {lead + (r, 2, n)}, "
                             f"got {tuple(uniforms.shape)}")
        if k and tuple(fault_uniforms.shape) != lead + (r, k):
            raise ValueError(f"{caller}: fault_uniforms must be {lead + (r, k)}, "
                             f"got {tuple(fault_uniforms.shape)}")
        return r, uniforms, fault_uniforms

    def run(
        self,
        state: AsyncFLState,
        batches_x: torch.Tensor,    # (R, M, E, B, ...), or (B, R, M, E, B, ...) for a batch
        batches_y: torch.Tensor,    # (R, M, E, B)
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[torch.Tensor] = None,   # (R, 2, N)
        fault_uniforms: Optional[torch.Tensor] = None,   # (R, K)
    ) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """``R`` sequential rounds; metrics come back stacked as (R,) tensors.
        Round r uses ``uniforms[r, 0]`` / ``uniforms[r, 1]`` and, with
        ``faults``, ``fault_uniforms[r]`` (K = ``n_fault_uniforms()``) when
        given; with neither, both are drawn from ``generator``.  A batched
        state takes every operand with its run axis first, (B, R, ...), and
        gives (B, R) metrics (``repro_torch.sim.simulate_fl_batch`` adds
        shared operands and stacked envs)."""
        _, uniforms, fault_uniforms = self._operands(state, batches_x, batches_y, generator,
                                                     uniforms, fault_uniforms, "run")
        return self._run(state, batches_x, batches_y, uniforms, fault_uniforms, self.env)

    def _run(self, state, batches_x, batches_y, uniforms, fault_uniforms, env):
        """The rounds of checked operands against ``env``: the data goes to
        the device once, then one ``_round`` a round."""
        dev, lead = self.device, _lead(state)
        batches_x, batches_y = batches_x.to(dev), batches_y.to(dev)
        at = (lambda x, i: x[:, i]) if lead else (lambda x, i: x[i])
        per_round = []
        for i in range(int(batches_x.shape[len(lead)])):
            u = at(uniforms, i)
            state, mets = self._round(state, at(batches_x, i), at(batches_y, i),
                                      u[..., 0, :], u[..., 1, :],
                                      None if fault_uniforms is None else at(fault_uniforms, i),
                                      env)
            per_round.append(mets)
        return state, {k: torch.stack([mm[k] for mm in per_round], dim=-1)
                       for k in per_round[0]}

    # ------------------------------------------------- served (SchedServer)
    def _validate_server(self, server, n_clients: Optional[int] = None) -> None:
        """``run_served``'s checks of ``server`` against this trainer; the
        server's client dimension must be ``n_clients`` (default
        ``cfg.n_clients``; the sparse trainer passes its slot count)."""
        m = self.cfg.n_clients if n_clients is None else n_clients
        if not (self.cfg.use_matching and server.use_matching):
            raise ValueError(
                "run_served: requires use_matching=True on both the trainer cfg and the "
                "SchedServer (the server's non-matching path owns AoI semantics the trainer "
                "cannot override)")
        if float(server.matcher_beta) != float(self.cfg.matcher_beta):
            raise ValueError(f"run_served: matcher_beta mismatch (trainer "
                             f"{self.cfg.matcher_beta}, server {server.matcher_beta})")
        if (server.scheduler.n_channels != self.cfg.n_channels
                or server.scheduler.n_clients != m):
            raise ValueError(
                f"run_served: server scheduler dims (N={server.scheduler.n_channels}, "
                f"M={server.scheduler.n_clients}) do not match the trainer "
                f"(N={self.cfg.n_channels}, M={m})")
        want = "mean" if (getattr(self.env, "score_kind", "ucb") == "mean"
                          and getattr(self.scheduler, "mean_scores", None) is not None) \
            else "ucb"
        if server.score_kind != want:
            raise ValueError(f"run_served: this trainer's env routes matcher scores via "
                             f"{want!r} but the server was built with "
                             f"score_kind={server.score_kind!r}")

    def run_served(self, state: AsyncFLState, batches_x: torch.Tensor, batches_y: torch.Tensor,
                   server, tenant, generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None,
                   fault_uniforms: Optional[torch.Tensor] = None,
                   ) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """``run`` with the schedule taken from ``server`` (a
        ``repro_torch.sim.SchedServer``).  Each round the trainer does Steps
        1-2, posts its channel vector, selection uniform, contributions and
        AoI as ``tenant``'s request, and finishes the round with the
        returned assignment and matcher row; the policy state lives in the
        server's tenant row (``state.sched_state`` is carried unchanged).
        ``tenant`` must be joined (with this trainer's hp to reproduce
        ``run()``, which it then does bit for bit).  The randomness is
        ``run``'s.  Each round waits for the server's decision."""
        self._validate_server(server)
        r, n, k = int(batches_x.shape[0]), self.cfg.n_channels, self.n_fault_uniforms()
        if int(batches_y.shape[0]) != r:
            raise ValueError(f"run_served: batches_y leading axis {batches_y.shape[0]} != {r}")
        if k and (uniforms is None) != (fault_uniforms is None):
            raise ValueError("run_served: with faults, pass uniforms and fault_uniforms, "
                             "or neither")
        if uniforms is None:
            uniforms = torch.rand((r, 2, n), generator=generator, device=self.device)
            if k:
                fault_uniforms = torch.rand((r, k), generator=generator, device=self.device)
        elif tuple(uniforms.shape) != (r, 2, n):
            raise ValueError(f"run_served: uniforms must be ({r}, 2, {n}), "
                             f"got {tuple(uniforms.shape)}")
        dev = self.device
        per_round = []
        for i in range(r):
            pre = self._round_pre(state, batches_x[i], batches_y[i], uniforms[i, 0],
                                  fault_uniforms[i] if k else None, self.env)
            dec = server.serve_decisions([ServeRequest(
                tenant, rewards=pre.ch_states.cpu().numpy(), u=uniforms[i, 1].cpu().numpy(),
                contrib=state.contrib.cpu().numpy(), aoi=state.aoi.cpu().numpy())])[0]
            mstate = MatcherState(*[torch.tensor(x, device=dev) for x in dec.matcher_state])
            assignment = torch.as_tensor(dec.assignment, dtype=torch.int64).to(dev)
            state, mets = self._round_post(state, pre, assignment, mstate, state.sched_state,
                                           self.env)
            per_round.append(mets)
        return state, {k: torch.stack([mm[k] for mm in per_round]) for k in per_round[0]}
