"""Asynchronous FL round runtime (Sec. II-A Steps 1-4 + Sec. IV/V policies).

One round:

  Step 1  clients in S_{t-1} receive w_t (everyone else trains nothing and
          keeps its buffered update G~, Eq. 6)
  Step 2  E local SGD epochs, vmapped over clients (Eq. 5)
  Step 3  the scheduler picks M channels; the adaptive matcher assigns
          them to clients by priority (Eq. 39-40); the channel env draws
          Good/Bad; S_t = clients whose channel was Good
  Step 4  the server aggregates  w <- w - eta_s/|S_t| * sum_{i in S_t} zeta_i G~_i
          through the ``weighted_aggregate`` kernel (Eq. 7), updates AoI
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
``k_env, k_sel``.  Twin of ``repro/fl/round.py``; fault injection, the
robust aggregators, ``run_served`` and the batched engine are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.aoi import aoi_variance, init_aoi, update_aoi
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
from repro_torch.kernels import ops
from repro_torch.utils.tree import tree_flatten_concat, tree_unflatten_concat


def dispatch_aggregate(aggregator, buffers, mask, zeta, n_succ):
    """Step-4 aggregation: the zeta-weighted masked mean of Eq. 7 through
    ``ops.weighted_aggregate``.  ``buffers`` arrive quarantine-masked;
    returns the (P,) f32 aggregate.  Only the default ``aggregator=None``
    is ported."""
    if aggregator is not None:
        raise NotImplementedError(
            "dispatch_aggregate: only the default zeta-weighted mean (aggregator=None) is ported")
    m = buffers.shape[0]
    scale = mask * zeta * (m / n_succ.clamp_min(1.0))
    return ops.weighted_aggregate(buffers, scale)


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
    ``proxy_loss_fn(flat_params)`` the optional server proxy loss (Eq. 35).
    """

    def __init__(self, cfg: AsyncFLConfig, scheduler, env: ChannelEnv,
                 loss_fn: Callable, proxy_loss_fn: Optional[Callable] = None,
                 device=None):
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
        )

    # ------------------------------------------------------------------ round
    def _local_updates(self, params, batches_x, batches_y):
        """Steps 1-2 for every client: (M, P) flattened G~ and (M,) losses."""
        lr = self.cfg.client_lr

        def one_client(bx, by):
            g, loss = local_sgd(self.loss_fn, params, bx, by, lr)
            return tree_flatten_concat(g), loss

        return torch.func.vmap(one_client)(batches_x, batches_y)

    def round(
        self,
        state: AsyncFLState,
        batches_x: torch.Tensor,    # (M, E, B, ...)
        batches_y: torch.Tensor,    # (M, E, B)
        generator: Optional[torch.Generator] = None,
        u_env: Optional[torch.Tensor] = None,
        u_sel: Optional[torch.Tensor] = None,
    ) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """One round.  The round's randomness is ``u_env``/``u_sel`` ((N,)
        uniforms) when given, else two draws from ``generator``."""
        cfg, dev = self.cfg, self.device
        m, n = cfg.n_clients, cfg.n_channels
        if (u_env is None) != (u_sel is None):
            raise ValueError("round: pass both u_env and u_sel, or neither")
        if u_env is None:
            u_env, u_sel = torch.rand((2, n), generator=generator, device=dev)
        env, t = self.env, state.t
        batches_x = batches_x.to(dev)
        batches_y = batches_y.to(dev)

        # ---- Steps 1-2: local training for clients in S_{t-1} ------------
        fresh_updates, local_losses = self._local_updates(state.params, batches_x, batches_y)
        # Eq. 6 via `where`: a corrupted fresh row must not leak NaN into an
        # inactive client's kept buffer (0 * NaN)
        active = state.last_success
        buffers = torch.where(active[:, None] > 0.5, fresh_updates, state.buffers)
        has_update = torch.maximum(state.has_update, active)
        staleness = torch.where(active > 0.5, 1.0, state.staleness + 1.0)

        # ---- Step 3: schedule + match + transmit ---------------------------
        channels, aux = self.scheduler.select(state.sched_state, t, u_sel, state.aoi)
        matcher = AdaptiveMatcher(cfg.matcher_beta)
        if cfg.use_matching:
            scores = matcher_scores(self.scheduler, state.sched_state, t, env)
            assignment, matcher_state = matcher.match(
                state.matcher_state, channels, scores, state.contrib, state.aoi)
        else:
            assignment = channels
            _, matcher_state = matcher.priorities(state.matcher_state, state.contrib, state.aoi)
        ch_states = env.sample_dyn(t, u_env.to(dev), state.env_state)
        sched_mask = torch.zeros((n,), device=dev).index_fill(0, assignment, 1.0)
        env_state = env.interact_step(state.env_state, t, sched_mask)
        success = (ch_states[assignment] > 0.5).to(torch.float32)
        success = success * has_update        # a client with no update yet can't help

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
        agg_flat = dispatch_aggregate(None, agg_buffers, agg_mask, zeta, n_succ)  # (P,) f32
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

        # ---- bookkeeping: AoI, bandit, contribution, zeta -------------------
        aoi = update_aoi(state.aoi, agg_mask > 0.5)
        rewards = ch_states[assignment]
        sched_state = self.scheduler.update(state.sched_state, t, assignment, rewards, aux)
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
            staleness=staleness,
        )
        # losses of clients that actually trained this round, kept finite
        loss_ok = torch.isfinite(local_losses).to(torch.float32)
        loss_w = active * loss_ok
        metrics = {
            "local_loss": (torch.where(loss_ok > 0.5, local_losses, 0.0) * active).sum()
            / loss_w.sum().clamp_min(1.0),
            "n_success": n_succ,
            "mean_aoi": aoi.mean(),
            "aoi_var": aoi_variance(aoi),
            "beta_t": matcher_state.beta_t,
            "zeta_max": new_zeta.max(),
        }
        return new_state, metrics

    # ------------------------------------------------------------------ run
    def run(
        self,
        state: AsyncFLState,
        batches_x: torch.Tensor,    # (R, M, E, B, ...)
        batches_y: torch.Tensor,    # (R, M, E, B)
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[torch.Tensor] = None,   # (R, 2, N)
    ) -> Tuple[AsyncFLState, Dict[str, torch.Tensor]]:
        """``R`` sequential rounds; metrics come back stacked as (R,) tensors.
        Round r uses ``uniforms[r, 0]`` / ``uniforms[r, 1]`` when given."""
        r, n = int(batches_x.shape[0]), self.cfg.n_channels
        if int(batches_y.shape[0]) != r:
            raise ValueError(f"run: batches_y leading axis {batches_y.shape[0]} != {r}")
        if uniforms is None:
            uniforms = torch.rand((r, 2, n), generator=generator, device=self.device)
        elif tuple(uniforms.shape) != (r, 2, n):
            raise ValueError(f"run: uniforms must be ({r}, 2, {n}), got {tuple(uniforms.shape)}")
        per_round = []
        for i in range(r):
            state, mets = self.round(state, batches_x[i], batches_y[i],
                                     u_env=uniforms[i, 0], u_sel=uniforms[i, 1])
            per_round.append(mets)
        return state, {k: torch.stack([mm[k] for mm in per_round]) for k in per_round[0]}
