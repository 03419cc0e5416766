"""Sparse event-driven FL substrate: the client axis at N = 10^5 clients.

The dense runtime (``repro_torch.fl.round``) sizes every per-client tensor
to the client count and trains ALL clients each round: exact, but O(N*P)
memory and O(N) training a round.  Here per-client state is O(1) scalars
in (N,) tensors, and only the M **scheduled** clients a round pay the
O(P) cost: their flattened updates sit in the (M, P) slot rows that Step 4
(``weighted_aggregate`` on the card) consumes.  A round costs O(N)
element-wise work and one sort of N keys, plus O(M * (E * B + P)).

One round:

  Select   matcher priorities (Eq. 39) over all N clients, masked by the
           availability process's schedulable set; the top M by a stable
           descending sort (ties and masked clients lowest id first, as
           ``jax.lax.top_k``), ascending ids.  The matcher state is not
           committed here: the round's Step-3 ``match`` does that.
  Gather   the M selected clients' mini-batches drawn on the device
           (``repro_torch.data.pipeline.client_batch_indices``, a hash of
           (data seed, round, client id), or rows of a given
           ``batch_indices`` operand) and their carried state gathered
           into (M,) / (M, P) slot rows.
  Round    Steps 1-4 of the dense round on the slot rows (local SGD, fault
           injection, the Eq.-6 carry, scheduling + matching + transmission,
           the quarantine gate, Eq. 7, contribution / zeta), through the
           dense round's own pieces (``local_updates``, ``aggregate_step``).
  Scatter  per-client scalars back to their (N,) tensors; the slot pool
           turns over to this round's selection.  A slot's previous owner
           that was not re-selected is **evicted**: its buffered G~ is
           discarded and ``last_success`` set, so its next grant retrains
           from the current model (eviction cannot starve a client).
  Step     the availability process advances on this round's grants,
           giving the NEXT round's schedulable set.

Randomness.  Each round takes ``u_env`` and ``u_sel`` ((n_channels,) f32
uniforms, JAX's ``uniform`` on ``k_env, k_sel = split(key)``), with
``faults`` ``u_fault`` (``faults.n_uniforms(M)``, JAX's draws on
``fold_in(key, 0xFA17)``) and with ``availability`` ``u_avail``
(``availability.n_uniforms(N)``, JAX's draws on ``fold_in(key, 0xA7A1)``;
see ``repro_torch.core.availability``).  The batch draw is a pure function
of (``data_seed``, round, client id); a ``batch_indices`` operand
(R, N, E, B) replaces it (parity tests fill it from JAX's
``client_batch_indices``).

Dense parity.  At M = N with every client available, selection is the
identity, every gather and scatter an identity move, and the round is the
dense round's arithmetic: the dense trainer fed the same batches
(``client_batch_indices`` over all N ids) gives the same bits.

The run axis.  ``round``/``run`` also take a batch of B runs: a state from
``init_batch`` (every tensor leaf (B, ...)), (B, R, ...) uniforms and
batch indices, a (B,) int64 ``data_seed`` or one int; the client datasets
are shared.  Twin of ``repro/fl/sparse.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.aoi import aoi_variance, init_aoi, mean_aoi, update_aoi
from repro_torch.core.availability import AvailabilityProcess
from repro_torch.core.bandits.base import init_with_hp
from repro_torch.core.contribution import (
    ContributionBuffer,
    aggregation_weights,
    init_buffer,
    marginal_contribution,
    update_buffer,
)
from repro_torch.core.matching import AdaptiveMatcher, MatcherState, matcher_scores
from repro_torch.data.pipeline import client_batch_indices, gather_client_batches
from repro_torch.device import resolve_device
from repro_torch.fl.client import local_updates
from repro_torch.fl.round import AsyncFLTrainer, aggregate_step, batched_init, realized_env
from repro_torch.sim.serve import ServeRequest
from repro_torch.utils.tree import tree_flatten_concat


class SparseFLState(NamedTuple):
    """One run's state; with a run axis (``init_batch``) every tensor leaf
    has a leading (B,) (a shared hyper-parameter of the scheduler stays
    0-d) and ``t`` is shared."""

    params: Dict[str, torch.Tensor]  # global model w_t
    # ---- (M,) / (M, P) slot pool: this round's scheduled clients --------
    buffers: torch.Tensor            # (M, P) flattened G~ of the slot owners
    slot_clients: torch.Tensor       # (M,) int64 owner client ids (-1 empty)
    contrib_buf: ContributionBuffer  # (M, P)/(M,) Eq. 41-42 slot rows
    # ---- (N,) per-client scalars ----------------------------------------
    slot_of: torch.Tensor            # (N,) int64 client -> slot (-1 none)
    has_update: torch.Tensor         # (N,) G~ validity
    last_success: torch.Tensor       # (N,) "trains at next grant" indicator
    aoi: torch.Tensor                # (N,) Eq. 8
    staleness: torch.Tensor          # (N,) age of the buffered G~ in rounds
    contrib: torch.Tensor            # (N,) C~
    zeta: torch.Tensor               # (N,) aggregation weights
    avail: torch.Tensor              # (N,) schedulable mask for THIS round
    avail_state: Any                 # availability process state ({} if none)
    # ---- shared with the dense runtime ----------------------------------
    sched_state: Any
    matcher_state: MatcherState
    t: int                           # round index (a Python int: no device sync)
    env_state: torch.Tensor
    fault_state: torch.Tensor        # fault-schedule carry (a dead zero without one)


class _SparsePre(NamedTuple):
    """A round before the schedule is decided (Select, Gather, Steps 1-2,
    the Eq.-6 carry and the channel realization)."""

    sel: torch.Tensor                # (M,) selected client ids, ascending
    avail_sel: torch.Tensor          # (M,)
    carried_cb: ContributionBuffer
    buffers: torch.Tensor            # (M, P)
    has_update: torch.Tensor         # (M,)
    stale_sel: torch.Tensor          # (M,)
    active: torch.Tensor             # (M,)
    dropped: Optional[torch.Tensor]  # (M,) fault drops, None without faults
    local_losses: torch.Tensor       # (M,)
    ch_states: torch.Tensor          # (n_channels,)
    aoi_sel: torch.Tensor            # (M,) posted to the server
    contrib_sel: torch.Tensor        # (M,) posted to the server
    fault_state: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparseFLConfig:
    n_clients: int                 # N — total population (10^5 is the point)
    n_sched: int                   # M — clients granted (and slots) a round
    n_channels: int
    batch_size: int                # mini-batch draw per local step
    local_epochs: int = 1
    client_lr: float = 0.05
    server_lr: float = 0.05
    matcher_beta: float = 0.5
    use_matching: bool = True
    use_zeta: bool = True
    quarantine: bool = True
    max_update_norm: float = 0.0
    staleness_cap: int = 0


def _lead(state) -> Tuple[int, ...]:
    return tuple(state.aoi.shape[:-1])


def _set_drop(x: torch.Tensor, idx: torch.Tensor, value: float) -> torch.Tensor:
    """``x.at[idx].set(value, mode="drop")`` over the last axis: an index
    equal to N (the "none" id) writes into a pad entry that is cut off."""
    pad = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    return pad.scatter(-1, idx, value)[..., :-1]


class SparseAsyncFLTrainer:
    """The sparse FL trainer on ``device`` (default ``cuda``).

    The arguments are the dense ``AsyncFLTrainer``'s (``env`` a
    ``ChannelEnv`` or an unrealized ``ChannelProcess``, realized from
    ``realize_generator``), plus ``availability``, an optional
    ``AvailabilityProcess`` (None: every client always schedulable).
    """

    def __init__(self, cfg: SparseFLConfig, scheduler, env, loss_fn: Callable,
                 proxy_loss_fn: Optional[Callable] = None, device=None, faults=None,
                 availability: Optional[AvailabilityProcess] = None, aggregator=None,
                 realize_generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.env, self.scenario = realized_env(env, realize_generator, self.device,
                                               type(self).__name__)
        self.cfg = cfg
        self.scheduler = scheduler
        self.loss_fn = loss_fn
        self.proxy_loss_fn = proxy_loss_fn
        self.faults = faults
        self.availability = availability
        self.aggregator = aggregator
        # knobs made on the device once (a per-round copy would block)
        self._fault_params = faults.params(self.device) if faults is not None else None
        self._agg_params = aggregator.params(self.device) if aggregator is not None else None
        self._avail_params = (availability.params(self.device) if availability is not None
                              else None)

    def n_fault_uniforms(self) -> int:
        """f32 uniforms the fault family consumes a round (0 without one)."""
        return 0 if self.faults is None else self.faults.n_uniforms(self.cfg.n_sched)

    def n_avail_uniforms(self) -> int:
        """f32 uniforms the availability process consumes a round (0 without one)."""
        return (0 if self.availability is None
                else self.availability.n_uniforms(self.cfg.n_clients))

    # ------------------------------------------------------------------ init
    def init(self, params: Dict[str, Any], hp: Any = None) -> SparseFLState:
        cfg, dev = self.cfg, self.device
        n, m = cfg.n_clients, cfg.n_sched
        params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
        p = int(tree_flatten_concat(params).shape[0])
        ones = lambda: torch.ones((n,), device=dev)
        return SparseFLState(
            params=params,
            buffers=torch.zeros((m, p), device=dev),
            slot_clients=torch.full((m,), -1, dtype=torch.int64, device=dev),
            contrib_buf=init_buffer(m, p, dev),
            slot_of=torch.full((n,), -1, dtype=torch.int64, device=dev),
            has_update=torch.zeros((n,), device=dev),
            last_success=ones(),                       # round 0: all fresh
            aoi=init_aoi(n, dev),
            staleness=ones(),
            contrib=ones(),
            zeta=torch.full((n,), 1.0 / m, device=dev),  # the dense init at M = N
            avail=ones(),
            avail_state=(self.availability.init_state(n, dev)
                         if self.availability is not None else {}),
            sched_state=init_with_hp(self.scheduler, dev, hp),
            matcher_state=AdaptiveMatcher(cfg.matcher_beta).init(dev),
            t=0,
            env_state=self.env.interact_init(),
            fault_state=(self.faults.schedule_init(dev) if self.faults is not None
                         else torch.zeros((), device=dev)),
        )

    def init_batch(self, params: Dict[str, Any], batch: int, params_axis: Optional[int] = None,
                   hp: Any = None, hp_axis: Optional[int] = None) -> SparseFLState:
        """The state of ``batch`` independent runs: ``init``'s state with a
        leading (B,) on every tensor leaf (``batched_init``, the dense
        ``init_batch``'s contract)."""
        return batched_init(self, params, batch, params_axis, hp, hp_axis)

    # ---------------------------------------------------------------- select
    def _select(self, state: SparseFLState) -> torch.Tensor:
        """The top-M schedulable clients by matcher priority, ascending ids:
        a stable descending sort, so equal priorities (every client at round
        0) and masked clients go lowest id first, as ``jax.lax.top_k``.  At
        M = N with every client available this is the identity."""
        lam, _ = AdaptiveMatcher(self.cfg.matcher_beta).priorities(
            state.matcher_state, state.contrib, state.aoi)
        masked = torch.where(state.avail > 0.5, lam, -torch.inf)
        top = torch.sort(masked, dim=-1, descending=True, stable=True).indices
        return top[..., :self.cfg.n_sched].sort(dim=-1).values

    # ----------------------------------------------------------------- round
    def _pre(self, state: SparseFLState, client_x, client_y, u_env, u_fault, batch_idx,
             data_seed, env) -> _SparsePre:
        """Select, Gather, Steps 1-2, the Eq.-6 carry on the slot rows and
        the round's channel realization."""
        cfg = self.cfg
        m, t, lead = cfg.n_sched, state.t, _lead(state)
        sel = self._select(state)
        take = lambda x: x.gather(-1, sel)
        avail_sel = take(state.avail)
        # carried slot rows: each selected client's previous slot (or none)
        prev_slot = take(state.slot_of)
        carry_ok = prev_slot >= 0
        src = prev_slot.clamp(0, m - 1)
        rows = lambda x: torch.where(carry_ok[..., None],
                                     x.gather(-2, src[..., None].expand(src.shape + x.shape[-1:])),
                                     0.0)
        cb = state.contrib_buf
        carried_cb = ContributionBuffer(grads=rows(cb.grads), params=rows(cb.params),
                                        fresh=torch.where(carry_ok, cb.fresh.gather(-1, src), 0.0))

        # ---- Gather: the scheduled clients' mini-batches, on the device ----
        if batch_idx is None:
            idx = client_batch_indices(data_seed, t, sel, int(client_y.shape[1]),
                                       cfg.local_epochs, cfg.batch_size)
        else:
            idx = batch_idx.gather(-3, sel[..., None, None].expand(
                sel.shape + tuple(batch_idx.shape[-2:])))
        batches_x, batches_y = gather_client_batches(client_x, client_y, sel, idx)

        # ---- Steps 1-2: local training, then faults -------------------------
        fresh_updates, local_losses = local_updates(
            self.loss_fn, state.params, batches_x, batches_y, cfg.client_lr,
            batched=bool(lead))
        last_sel = take(state.last_success)
        if self.faults is not None:
            fresh_updates, dropped, fault_state = self.faults.inject_sched(
                u_fault, t, fresh_updates, state.fault_state, self._fault_params)
            last_sel = last_sel * (1.0 - dropped)
        else:
            dropped, fault_state = None, state.fault_state
        # Eq. 6 on the slot rows (`where`, as the dense round); a granted
        # client that is not available neither trains nor transmits
        active = torch.where(avail_sel > 0.5, last_sel, 0.0)
        return _SparsePre(
            sel=sel, avail_sel=avail_sel, carried_cb=carried_cb,
            buffers=torch.where(active[..., None] > 0.5, fresh_updates, rows(state.buffers)),
            has_update=torch.maximum(take(state.has_update), active),
            stale_sel=torch.where(active > 0.5, 1.0, take(state.staleness) + 1.0),
            active=active, dropped=dropped, local_losses=local_losses,
            ch_states=env.sample_dyn(t, u_env, state.env_state),
            aoi_sel=take(state.aoi), contrib_sel=take(state.contrib),
            fault_state=fault_state)

    def _post(self, state: SparseFLState, pre: _SparsePre, assignment, matcher_state,
              sched_state, u_avail, env) -> Tuple[SparseFLState, Dict[str, torch.Tensor]]:
        """Step 3 after the decision (transmit), Step 4, the scatter back to
        the (N,) tensors and the availability step."""
        cfg = self.cfg
        n, m, t, lead = cfg.n_clients, cfg.n_sched, state.t, _lead(state)
        sel, avail_sel = pre.sel, pre.avail_sel
        # a channel repeated in the assignment (M > N) sets the same 1.0
        sched_mask = torch.zeros(lead + (cfg.n_channels,), device=self.device).scatter_(
            -1, assignment, 1.0)
        env_state = env.interact_step(state.env_state, t, sched_mask)
        success = (pre.ch_states.gather(-1, assignment) > 0.5).to(torch.float32)
        success = success * pre.has_update
        if pre.dropped is not None:
            success = success * (1.0 - pre.dropped)
        success = torch.where(avail_sel > 0.5, success, 0.0)

        # ---- Step 4 on the slot rows (Eq. 7, CUDA kernel) -------------------
        zeta = (state.zeta.gather(-1, sel) if cfg.use_zeta
                else torch.full(lead + (m,), 1.0 / m, device=self.device))
        step4 = aggregate_step(cfg, m, self.aggregator, self._agg_params, state.params,
                               pre.buffers, success, pre.stale_sel, pre.has_update, zeta)
        params_flat = tree_flatten_concat(step4.params, len(lead))
        contrib_buf = update_buffer(pre.carried_cb, step4.agg_mask > 0.5, step4.agg_buffers,
                                    params_flat[..., None, :].expand_as(pre.buffers))
        contrib_rows = marginal_contribution(contrib_buf, zeta, self.proxy_loss_fn)
        zeta_rows = aggregation_weights(contrib_rows)

        # ---- Scatter: per-client scalars + slot ownership turnover ----------
        put = lambda x, v: x.scatter(-1, sel, v)
        zeros = torch.zeros_like(state.aoi)
        aoi = update_aoi(state.aoi, put(zeros, step4.agg_mask) > 0.5)
        # clients not granted age their buffer; the granted take this round's
        staleness = put(state.staleness + 1.0, pre.stale_sel)
        prev = state.slot_clients
        slot_of = _set_drop(state.slot_of, torch.where(prev >= 0, prev, n), -1)
        slot_of = put(slot_of, torch.arange(m, device=self.device).expand_as(sel))
        # eviction: previous owners not re-selected lose their buffered G~
        # and re-enter S_t, so their next grant retrains (starvation-free)
        still = torch.where(prev >= 0, slot_of.gather(-1, prev.clamp(0, n - 1)) >= 0, True)
        evicted = (prev >= 0) & ~still
        evict_ids = torch.where(evicted, prev, n)
        has_update = _set_drop(put(state.has_update, step4.has_update), evict_ids, 0.0)
        last_success = _set_drop(put(state.last_success, step4.last_success), evict_ids, 1.0)

        # ---- availability: advance on this round's grants -------------------
        if self.availability is not None:
            grant = put(zeros, (avail_sel > 0.5).to(torch.float32))
            avail_state, avail = self.availability.step(u_avail, t, state.avail_state, grant,
                                                        self._avail_params)
        else:
            avail_state, avail = state.avail_state, state.avail

        new_state = SparseFLState(
            params=step4.params, buffers=pre.buffers, slot_clients=sel,
            contrib_buf=contrib_buf, slot_of=slot_of, has_update=has_update,
            last_success=last_success, aoi=aoi, staleness=staleness,
            contrib=put(state.contrib, contrib_rows), zeta=put(state.zeta, zeta_rows),
            avail=avail, avail_state=avail_state, sched_state=sched_state,
            matcher_state=matcher_state, t=t + 1, env_state=env_state,
            fault_state=pre.fault_state)
        loss_ok = torch.isfinite(pre.local_losses).to(torch.float32)
        loss_w = pre.active * loss_ok
        metrics = {
            "local_loss": (torch.where(loss_ok > 0.5, pre.local_losses, 0.0) * pre.active
                           ).sum(dim=-1) / loss_w.sum(dim=-1).clamp_min(1.0),
            "n_success": step4.n_succ,
            "mean_aoi": mean_aoi(aoi),
            "aoi_var": aoi_variance(aoi),
            "beta_t": matcher_state.beta_t,
            "zeta_max": zeta_rows.amax(dim=-1),
            "n_evicted": evicted.to(torch.float32).sum(dim=-1),
            "n_available": state.avail.sum(dim=-1),
        }
        return new_state, metrics

    def _round(self, state, client_x, client_y, u_env, u_sel, u_fault, u_avail, batch_idx,
               data_seed, env):
        pre = self._pre(state, client_x, client_y, u_env, u_fault, batch_idx, data_seed, env)
        # ---- Step 3: schedule + match over the slot rows --------------------
        t = state.t
        channels, aux = self.scheduler.select(state.sched_state, t, u_sel, pre.aoi_sel)
        matcher = AdaptiveMatcher(self.cfg.matcher_beta)
        if self.cfg.use_matching:
            scores = matcher_scores(self.scheduler, state.sched_state, t, env)
            assignment, matcher_state = matcher.match(
                state.matcher_state, channels, scores, pre.contrib_sel, pre.aoi_sel)
        else:
            assignment = channels
            _, matcher_state = matcher.priorities(state.matcher_state, pre.contrib_sel,
                                                  pre.aoi_sel)
        rewards = pre.ch_states.gather(-1, assignment)
        sched_state = self.scheduler.update(state.sched_state, t, assignment, rewards, aux)
        return self._post(state, pre, assignment, matcher_state, sched_state, u_avail, env)

    def round(self, state: SparseFLState, client_x: torch.Tensor, client_y: torch.Tensor,
              generator: Optional[torch.Generator] = None, u_env=None, u_sel=None,
              u_fault=None, u_avail=None, batch_idx: Optional[torch.Tensor] = None,
              data_seed: Union[int, torch.Tensor] = 0):
        """One round on the (N, n, ...) / (N, n) client datasets: ``run``
        for one round, with that round's operands (``u_env``/``u_sel``
        (n_channels,), ``u_fault``, ``u_avail``, ``batch_idx`` (N, E, B))
        and unstacked metrics."""
        if (u_env is None) != (u_sel is None):
            raise ValueError("round: pass both u_env and u_sel, or neither")
        axis = len(_lead(state))
        lift = lambda x: None if x is None else x.unsqueeze(axis)
        _, u, fu, au, bi = self._operands(
            state, 1, generator, lift(None if u_env is None else torch.stack([u_env, u_sel], -2)),
            lift(u_fault), lift(u_avail), lift(batch_idx), "round")
        state, mets = self._run(state, client_x, client_y, 1, u, fu, au, bi, data_seed, self.env)
        return state, {k: v[..., 0] for k, v in mets.items()}

    # ------------------------------------------------------------------- run
    @staticmethod
    def _at(state):
        """Round ``i`` of an (R, ...) or (B, R, ...) operand (None stays)."""
        lead = _lead(state)
        return lambda x, i: None if x is None else (x[:, i] if lead else x[i])

    def _operands(self, state, rounds, generator, uniforms, fault_uniforms, avail_uniforms,
                  batch_indices, caller: str):
        """Checks of the rounds' operands, the uniforms drawn from
        ``generator`` when not given (uniforms, fault, availability, in
        that order).  Returns (R, uniforms, fault, avail, batch_indices)."""
        lead, nch = _lead(state), self.cfg.n_channels
        kf, ka = self.n_fault_uniforms(), self.n_avail_uniforms()
        given = [x for x in (uniforms, batch_indices) if x is not None]
        r = int(given[0].shape[len(lead)]) if given and rounds is None else rounds
        if r is None:
            raise ValueError(f"{caller}: give rounds=, uniforms= or batch_indices=")
        for k, x, name in ((kf, fault_uniforms, "fault"), (ka, avail_uniforms, "avail")):
            if k and (uniforms is None) != (x is None):
                raise ValueError(f"{caller}: with a {name} process, pass uniforms and "
                                 f"{name}_uniforms, or neither")
            if not k and x is not None:
                raise ValueError(f"{caller}: {name}_uniforms given to a trainer without "
                                 f"that process")
        if uniforms is None:
            uniforms = torch.rand(lead + (r, 2, nch), generator=generator, device=self.device)
            fault_uniforms = (torch.rand(lead + (r, kf), generator=generator,
                                         device=self.device) if kf else None)
            avail_uniforms = (torch.rand(lead + (r, ka), generator=generator,
                                         device=self.device) if ka else None)
        # a process that draws nothing (always_on) takes (R, 0) uniforms
        if self.availability is not None and not ka and avail_uniforms is None:
            avail_uniforms = torch.zeros(lead + (r, 0), device=self.device)
        want = {"uniforms": (uniforms, lead + (r, 2, nch)),
                "fault_uniforms": (fault_uniforms, lead + (r, kf)),
                "avail_uniforms": (avail_uniforms, lead + (r, ka))}
        cfg = self.cfg
        if batch_indices is not None:
            want["batch_indices"] = (batch_indices, lead + (r, cfg.n_clients, cfg.local_epochs,
                                                            cfg.batch_size))
        for name, (x, shape) in want.items():
            if x is not None and tuple(x.shape) != shape:
                raise ValueError(f"{caller}: {name} must be {shape}, got {tuple(x.shape)}")
        dev = lambda x: None if x is None else x.to(self.device)
        return (r, dev(uniforms), dev(fault_uniforms), dev(avail_uniforms),
                dev(batch_indices))

    def run(
        self,
        state: SparseFLState,
        client_x: torch.Tensor,     # (N, n, ...) full per-client datasets
        client_y: torch.Tensor,     # (N, n)
        rounds: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[torch.Tensor] = None,        # (R, 2, n_channels)
        fault_uniforms: Optional[torch.Tensor] = None,  # (R, n_fault_uniforms())
        avail_uniforms: Optional[torch.Tensor] = None,  # (R, n_avail_uniforms())
        batch_indices: Optional[torch.Tensor] = None,   # (R, N, E, B)
        data_seed: Union[int, torch.Tensor] = 0,
    ) -> Tuple[SparseFLState, Dict[str, torch.Tensor]]:
        """``R`` sequential rounds (``rounds``, or the leading axis of the
        operands given); metrics come back stacked as (R,) tensors.  Round r
        takes ``uniforms[r]`` (u_env, u_sel), ``fault_uniforms[r]`` and
        ``avail_uniforms[r]``, all drawn from ``generator`` when none is
        given, and draws its batches from (``data_seed``, round, client id)
        unless ``batch_indices[r]`` is given.  The datasets go to the device
        once; a round never waits for the device."""
        r, u, fu, au, bi = self._operands(state, rounds, generator, uniforms, fault_uniforms,
                                          avail_uniforms, batch_indices, "run")
        return self._run(state, client_x, client_y, r, u, fu, au, bi, data_seed, self.env)

    def _run(self, state, client_x, client_y, r, u, fu, au, bi, data_seed, env):
        cx, cy = client_x.to(self.device), client_y.to(self.device)
        if isinstance(data_seed, torch.Tensor):
            data_seed = data_seed.to(self.device)
        at = self._at(state)
        per_round = []
        for i in range(r):
            ui = at(u, i)
            state, mets = self._round(state, cx, cy, ui[..., 0, :], ui[..., 1, :], at(fu, i),
                                      at(au, i), at(bi, i), data_seed, env)
            per_round.append(mets)
        return state, {k: torch.stack([mm[k] for mm in per_round], dim=-1)
                       for k in per_round[0]}

    # ------------------------------------------------- served (SchedServer)
    def run_served(self, state: SparseFLState, client_x: torch.Tensor, client_y: torch.Tensor,
                   server, tenant, rounds: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None,
                   fault_uniforms: Optional[torch.Tensor] = None,
                   avail_uniforms: Optional[torch.Tensor] = None,
                   batch_indices: Optional[torch.Tensor] = None,
                   data_seed: int = 0) -> Tuple[SparseFLState, Dict[str, torch.Tensor]]:
        """``run`` with the schedule taken from ``server`` (a
        ``repro_torch.sim.SchedServer`` whose scheduler has M = ``n_sched``
        clients).  Each round the trainer selects, gathers and trains its
        top-M clients, posts the channel vector, the selection uniform and
        the SELECTED clients' contributions and AoI as ``tenant``'s request,
        and finishes the round with the returned assignment and matcher
        row; the policy state lives in the server's tenant row.  ``tenant``
        joined with this trainer's hp reproduces ``run()`` bit for bit.
        One run (no run axis); each round waits for the server."""
        AsyncFLTrainer._validate_server(self, server, n_clients=self.cfg.n_sched)
        if _lead(state):
            raise ValueError("run_served: one run at a time (the state has a run axis)")
        r, u, fu, au, bi = self._operands(state, rounds, generator, uniforms, fault_uniforms,
                                          avail_uniforms, batch_indices, "run_served")
        cx, cy, dev = client_x.to(self.device), client_y.to(self.device), self.device
        at = self._at(state)
        per_round = []
        for i in range(r):
            pre = self._pre(state, cx, cy, u[i, 0], at(fu, i), at(bi, i), data_seed, self.env)
            dec = server.serve_decisions([ServeRequest(
                tenant, rewards=pre.ch_states.cpu().numpy(), u=u[i, 1].cpu().numpy(),
                contrib=pre.contrib_sel.cpu().numpy(), aoi=pre.aoi_sel.cpu().numpy())])[0]
            mstate = MatcherState(*[torch.tensor(x, device=dev) for x in dec.matcher_state])
            assignment = torch.as_tensor(dec.assignment, dtype=torch.int64).to(dev)
            state, mets = self._post(state, pre, assignment, mstate, state.sched_state,
                                     at(au, i), self.env)
            per_round.append(mets)
        return state, {k: torch.stack([mm[k] for mm in per_round]) for k in per_round[0]}
