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
          Good/Bad; S_t = clients whose channel was Good
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

Client updates are carried flattened (M, P), sorted-key order.  Each
round draws two (N,) f32 uniforms, ``u_env`` for the channel states and
``u_sel`` for the scheduler, as the JAX round splits its key into
``k_env, k_sel``; with ``faults`` it also draws the family's
``n_uniforms(M)`` uniforms ``u_fault``, which stand for the JAX round's
draws on ``fold_in(key, 0xFA17)`` (see ``repro_torch.core.faults``).
``run_served`` takes each round's schedule from a ``SchedServer``
instead.  Twin of ``repro/fl/round.py``; the batched FL engine is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.aggregation import MeanAgg
from repro_torch.core.aoi import aoi_variance, init_aoi, mean_aoi, update_aoi
from repro_torch.core.bandits.base import init_with_hp
from repro_torch.core.channels import ChannelEnv
from repro_torch.core.contribution import (
    ContributionBuffer,
    aggregation_weights,
    init_buffer,
    marginal_contribution,
    update_buffer,
)
from repro_torch.core.matching import AdaptiveMatcher, MatcherState, matcher_scores
from repro_torch.device import resolve_device
from repro_torch.fl.client import local_sgd
from repro_torch.sim.serve import ServeRequest
from repro_torch.utils.tree import tree_flatten_concat, tree_unflatten_concat

_MEAN = MeanAgg()


def dispatch_aggregate(aggregator, buffers, mask, zeta, n_succ, params=None):
    """Step-4 aggregation through a ``repro_torch.core.aggregation``
    ``Aggregator`` with its knobs ``params`` (default ``params()``);
    ``aggregator=None`` is ``MeanAgg``, the zeta-weighted masked mean of
    Eq. 7.  ``buffers`` arrive quarantine-masked; returns the (P,) f32
    aggregate, zeros when nothing participates."""
    return (aggregator or _MEAN).aggregate(buffers, mask, zeta, n_succ, params)


class AsyncFLState(NamedTuple):
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

    ``loss_fn(params, x, y)`` is a scalar loss of a parameter dict;
    ``proxy_loss_fn(flat_params)`` the optional server proxy loss (Eq. 35);
    ``faults`` an optional ``FaultProcess``; ``aggregator`` an optional
    ``Aggregator`` (None: the zeta-weighted mean of Eq. 7).
    """

    def __init__(self, cfg: AsyncFLConfig, scheduler, env: ChannelEnv,
                 loss_fn: Callable, proxy_loss_fn: Optional[Callable] = None,
                 device=None, faults=None, aggregator=None):
        if not isinstance(env, ChannelEnv):
            raise TypeError(
                "AsyncFLTrainer: env must be a realized ChannelEnv "
                "(call ChannelProcess.realize(generator) first)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scheduler = scheduler
        self.env = env.to(self.device)
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

    # ------------------------------------------------------------------ round
    def _local_updates(self, params, batches_x, batches_y):
        """Steps 1-2 for every client: (M, P) flattened G~ and (M,) losses."""
        lr = self.cfg.client_lr

        def one_client(bx, by):
            g, loss = local_sgd(self.loss_fn, params, bx, by, lr)
            return tree_flatten_concat(g), loss

        return torch.func.vmap(one_client)(batches_x, batches_y)

    def _round_pre(self, state: AsyncFLState, batches_x, batches_y, u_env, u_fault):
        """Steps 1-2, the Eq.-6 carry and the round's channel realization:
        everything before the schedule is decided."""
        dev = self.device
        # ---- Steps 1-2: local training for clients in S_{t-1} ------------
        fresh_updates, local_losses = self._local_updates(state.params, batches_x.to(dev),
                                                          batches_y.to(dev))

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
            buffers=torch.where(active[:, None] > 0.5, fresh_updates, state.buffers),
            has_update=torch.maximum(state.has_update, active),
            staleness=torch.where(active > 0.5, 1.0, state.staleness + 1.0),
            active=active, dropped=dropped, local_losses=local_losses,
            ch_states=self.env.sample_dyn(state.t, u_env.to(dev), state.env_state),
            fault_state=fault_state)

    def _round_post(self, state: AsyncFLState, pre: "_RoundPre", assignment, matcher_state,
                    sched_state) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """Step 3 after the decision (transmit), Step 4 and the bookkeeping,
        given the round's ``assignment``, post-step matcher state and
        scheduler state."""
        cfg, dev = self.cfg, self.device
        m, n, t = cfg.n_clients, cfg.n_channels, state.t
        buffers, has_update, staleness = pre.buffers, pre.has_update, pre.staleness
        sched_mask = torch.zeros((n,), device=dev).index_fill(0, assignment, 1.0)
        env_state = self.env.interact_step(state.env_state, t, sched_mask)
        success = (pre.ch_states[assignment] > 0.5).to(torch.float32)
        success = success * has_update        # a client with no update yet can't help
        if pre.dropped is not None:
            success = success * (1.0 - pre.dropped)   # and a dropped one can't transmit

        # ---- Step 4: quarantine gate + aggregate (Eq. 7, CUDA kernel) -------
        if cfg.quarantine:
            row_ok = torch.isfinite(buffers).all(dim=1)
            if cfg.max_update_norm > 0.0:
                row_ok = row_ok & (torch.linalg.vector_norm(buffers, dim=1)
                                   <= cfg.max_update_norm)
            row_ok = row_ok.to(torch.float32)
        else:
            row_ok = torch.ones((m,), device=dev)
        if cfg.staleness_cap > 0:
            fresh_ok = (staleness <= float(cfg.staleness_cap)).to(torch.float32)
        else:
            fresh_ok = torch.ones((m,), device=dev)
        agg_mask = success * row_ok * fresh_ok
        n_succ = agg_mask.sum()

        zeta = state.zeta if cfg.use_zeta else torch.full((m,), 1.0 / m, device=dev)
        if cfg.quarantine:
            # zero quarantined rows BEFORE the aggregator: 0 * NaN = NaN
            agg_buffers = torch.where(agg_mask[:, None] > 0.5, buffers, 0.0)
        else:
            agg_buffers = buffers
        agg_flat = dispatch_aggregate(self.aggregator, agg_buffers, agg_mask, zeta, n_succ,
                                      self._agg_params)  # (P,) f32
        step_vec = -cfg.server_lr / m * agg_flat
        delta = tree_unflatten_concat(step_vec, state.params)
        if cfg.quarantine:
            any_agg = n_succ > 0.0
            params = {k: torch.where(any_agg, p_ + delta[k].to(p_.dtype), p_)
                      for k, p_ in state.params.items()}
        else:
            params = {k: p_ + delta[k].to(p_.dtype) for k, p_ in state.params.items()}

        # degraded-path bookkeeping: poisoned buffers are discarded, and
        # quarantined or stale-rejected-but-delivered clients re-enter S_t
        bad_row = 1.0 - row_ok
        stale_reject = success * row_ok * (1.0 - fresh_ok)
        has_update = has_update * row_ok
        last_success = torch.maximum(agg_mask, torch.maximum(bad_row, stale_reject))

        # ---- bookkeeping: AoI, contribution, zeta ---------------------------
        aoi = update_aoi(state.aoi, agg_mask > 0.5)
        params_flat = tree_flatten_concat(params)
        contrib_buf = update_buffer(state.contrib_buf, agg_mask > 0.5, agg_buffers,
                                    params_flat.expand_as(buffers))
        contrib = marginal_contribution(contrib_buf, zeta, self.proxy_loss_fn)
        new_zeta = aggregation_weights(contrib)

        new_state = AsyncFLState(
            params=params, buffers=buffers, has_update=has_update,
            last_success=last_success, aoi=aoi, contrib_buf=contrib_buf,
            contrib=contrib, zeta=new_zeta, sched_state=sched_state,
            matcher_state=matcher_state, t=t + 1, env_state=env_state,
            staleness=staleness, fault_state=pre.fault_state,
        )
        # losses of clients that actually trained this round, kept finite
        loss_ok = torch.isfinite(pre.local_losses).to(torch.float32)
        loss_w = pre.active * loss_ok
        metrics = {
            "local_loss": (torch.where(loss_ok > 0.5, pre.local_losses, 0.0) * pre.active).sum()
            / loss_w.sum().clamp_min(1.0),
            "n_success": n_succ,
            "mean_aoi": mean_aoi(aoi),
            "aoi_var": aoi_variance(aoi),
            "beta_t": matcher_state.beta_t,
            "zeta_max": new_zeta.max(),
        }
        return new_state, metrics

    def _draw(self, generator, u_env, u_sel, u_fault, caller: str):
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
            u_env, u_sel = torch.rand((2, n), generator=generator, device=self.device)
            if k:
                u_fault = torch.rand((k,), generator=generator, device=self.device)
        return u_env, u_sel, u_fault

    def round(
        self,
        state: AsyncFLState,
        batches_x: torch.Tensor,    # (M, E, B, ...)
        batches_y: torch.Tensor,    # (M, E, B)
        generator: Optional[torch.Generator] = None,
        u_env: Optional[torch.Tensor] = None,
        u_sel: Optional[torch.Tensor] = None,
        u_fault: Optional[torch.Tensor] = None,
    ) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """One round.  The round's randomness is ``u_env``/``u_sel`` ((N,)
        uniforms) and, with ``faults``, ``u_fault`` ((K,) uniforms,
        ``K = n_fault_uniforms()``) when given, else drawn from
        ``generator`` in that order."""
        u_env, u_sel, u_fault = self._draw(generator, u_env, u_sel, u_fault, "round")
        pre = self._round_pre(state, batches_x, batches_y, u_env, u_fault)

        # ---- Step 3: schedule + match ---------------------------------------
        t = state.t
        channels, aux = self.scheduler.select(state.sched_state, t, u_sel, state.aoi)
        matcher = AdaptiveMatcher(self.cfg.matcher_beta)
        if self.cfg.use_matching:
            scores = matcher_scores(self.scheduler, state.sched_state, t, self.env)
            assignment, matcher_state = matcher.match(
                state.matcher_state, channels, scores, state.contrib, state.aoi)
        else:
            assignment = channels
            _, matcher_state = matcher.priorities(state.matcher_state, state.contrib, state.aoi)
        rewards = pre.ch_states[assignment]
        sched_state = self.scheduler.update(state.sched_state, t, assignment, rewards, aux)
        return self._round_post(state, pre, assignment, matcher_state, sched_state)

    # ------------------------------------------------------------------ run
    def run(
        self,
        state: AsyncFLState,
        batches_x: torch.Tensor,    # (R, M, E, B, ...)
        batches_y: torch.Tensor,    # (R, M, E, B)
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[torch.Tensor] = None,   # (R, 2, N)
        fault_uniforms: Optional[torch.Tensor] = None,   # (R, K)
    ) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """``R`` sequential rounds; metrics come back stacked as (R,) tensors.
        Round r uses ``uniforms[r, 0]`` / ``uniforms[r, 1]`` and, with
        ``faults``, ``fault_uniforms[r]`` (K = ``n_fault_uniforms()``) when
        given; with neither, both are drawn from ``generator``."""
        r, n, k = int(batches_x.shape[0]), self.cfg.n_channels, self.n_fault_uniforms()
        if int(batches_y.shape[0]) != r:
            raise ValueError(f"run: batches_y leading axis {batches_y.shape[0]} != {r}")
        if k and (uniforms is None) != (fault_uniforms is None):
            raise ValueError("run: with faults, pass uniforms and fault_uniforms, or neither")
        if not k and fault_uniforms is not None:
            raise ValueError("run: fault_uniforms given to a trainer without faults")
        if uniforms is None:
            uniforms = torch.rand((r, 2, n), generator=generator, device=self.device)
            if k:
                fault_uniforms = torch.rand((r, k), generator=generator, device=self.device)
        elif tuple(uniforms.shape) != (r, 2, n):
            raise ValueError(f"run: uniforms must be ({r}, 2, {n}), got {tuple(uniforms.shape)}")
        if k and tuple(fault_uniforms.shape) != (r, k):
            raise ValueError(
                f"run: fault_uniforms must be ({r}, {k}), got {tuple(fault_uniforms.shape)}")
        per_round = []
        for i in range(r):
            state, mets = self.round(state, batches_x[i], batches_y[i],
                                     u_env=uniforms[i, 0], u_sel=uniforms[i, 1],
                                     u_fault=fault_uniforms[i] if k else None)
            per_round.append(mets)
        return state, {k: torch.stack([mm[k] for mm in per_round]) for k in per_round[0]}

    # ------------------------------------------------- served (SchedServer)
    def _validate_server(self, server) -> None:
        m = self.cfg.n_clients
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
                                  fault_uniforms[i] if k else None)
            dec = server.serve_decisions([ServeRequest(
                tenant, rewards=pre.ch_states.cpu().numpy(), u=uniforms[i, 1].cpu().numpy(),
                contrib=state.contrib.cpu().numpy(), aoi=state.aoi.cpu().numpy())])[0]
            mstate = MatcherState(*[torch.tensor(x, device=dev) for x in dec.matcher_state])
            assignment = torch.as_tensor(dec.assignment, dtype=torch.int64).to(dev)
            state, mets = self._round_post(state, pre, assignment, mstate, state.sched_state)
            per_round.append(mets)
        return state, {k: torch.stack([mm[k] for mm in per_round]) for k in per_round[0]}
