"""Multi-tenant scheduler-as-a-service: one serve step for every job.

The paper's scheduler is the per-round decision loop of one federated job.
This module serves it as a shared online service: many concurrent FL
deployments (tenants) each submit ``(tenant, reward vector, uniform) ->
schedule`` requests, and every batch of requests, whichever tenants they
belong to, runs as one serve step over device-resident per-tenant state.
Twin of ``repro/sim/serve.py``; GLR-CUCB is the policy served (the port
has no other yet).

Tenant-axis state
-----------------
``TenantSlots`` stacks, per slot, a job's whole decision state: the
GLR-CUCB state (the streaming detector's prefix rings ``cum`` and totals
``total``/``base`` among it), the Sec.-V matcher normalizers, per-client
AoI, the tenant's round clock ``t``, a membership flag and decision and
success counters.  Every leaf has leading shape ``rows = capacity + 1``:
row ``capacity`` is a scratch slot that padding rows name and nothing
reads.

The serve step
--------------
Requests are batched into ``slots`` rows a step.  A step gathers the named
rows' small leaves, computes every row's transition (``policy_round``'s
batched twin, or select -> match -> update with the matcher), merges the
rows that are not live (padding, masked) back to what they read, and
writes the rows back by slot index.  The detector's rings never leave the
slot tensors: ``GLRCUCB.update_rows`` hands them, by slot, to
``ops.glr_step_tenants``, which appends in place and reads a ring only on
its tenant's detection round (on the card one kernel launch a step).  At
most one live request per tenant per step (a second is deferred to the next step), so live writes
never collide; padding rows all name the scratch slot and write back
identical values.

A step never waits on the device: its operands go up in one copy from
pinned host memory, its assignment comes back by an asynchronous copy
that an event guards.  ``serve()`` waits for each step's assignment before
packing the next; ``serve_stream()`` packs and dispatches step k+1 before
it waits for step k, so results come back with one step of latency, and
it sizes each step from the queue depth over a power-of-two ladder.

Boundary hygiene and crash recovery
-----------------------------------
Reward vectors are sanitized when packed (``_sanitize_rewards``): non-
finite entries become 0.0, finite ones clip to [0, 1], and the tenant's
``bad_rewards`` counter in ``stats()`` counts the request.  ``save()``/
``restore()`` snapshot the slot state through ``repro_torch.checkpoint``
plus a JSON sidecar for the host bookkeeping, so a server killed mid-
stream resumes with the decisions the uninterrupted run would give.

Parity with the offline simulator and the FL trainers
-----------------------------------------------------
The transition is ``policy_round``'s, so one tenant served one request a
round on ``offline_round_stream`` reproduces ``simulate_aoi_regret`` on
the same uniforms bit for bit (state, AoI, restarts).  FL trainers post
their realized channel vector, selection uniform, contributions and AoI
and get back the assignment and the post-step matcher row
(``AsyncFLTrainer.run_served``), which reproduces ``run()`` bit for bit.

What the JAX module has for XLA alone: there are no executables to build,
so ``warm()`` prepares the per-size host templates and the compile counts
are not reported; ``shard=True`` on one device is the identity (rows are
rounded up to the device count, 1); a ``mesh`` raises: the port serves on
one card, with no split of the slots across cards.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.core.aoi import update_aoi
from repro_torch.core.bandits.glr_cucb import GLRCUCB, GLRCUCBState, SlotRing
from repro_torch.core.matching import AdaptiveMatcher, MatcherState
from repro_torch.core.regret import offline_round_stream, policy_round
from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_map

__all__ = ["TenantSlots", "ServeRequest", "ServeDecision", "init_slots", "make_serve_step",
           "make_admit", "offline_round_stream", "SchedServer"]


class TenantSlots(NamedTuple):
    """Device-resident state of ``capacity`` tenants and the scratch row;
    every leaf's leading axis is ``rows = capacity + 1``."""

    sched_state: GLRCUCBState     # leaves (rows, ...), the prefix rings among them
    matcher_state: MatcherState   # Sec.-V normalizers, leaves (rows,)
    aoi: torch.Tensor             # (rows, M) per-client AoI
    t: torch.Tensor               # (rows,) int32 per-tenant round clock
    active: torch.Tensor          # (rows,) bool membership
    decisions: torch.Tensor       # (rows,) int32 requests served
    successes: torch.Tensor       # (rows,) f32 successful transmissions


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One tenant's per-round decision request.

    ``rewards`` is the tenant's realized (N,) channel-state vector for this
    round (its scheduled entries are the policy's semi-bandit feedback);
    ``u`` the round's (N,) f32 selection uniform, the draw behind the JAX
    request key's ``k_sel`` (``offline_round_stream`` gives the offline
    run's).  ``contrib`` (optional, (M,)) carries the job's per-client
    contributions for the matcher (default uniform); ``aoi`` (optional,
    (M,)) replaces the server's AoI row for this request's select and match
    (FL trainers own their AoI and post it)."""

    tenant: Any
    rewards: Any
    u: Any
    contrib: Any = None
    aoi: Any = None


class ServeDecision(NamedTuple):
    """One request's decision: the (M,) assignment and the post-step matcher
    row (``v_max``/``a_max``/``beta_t`` f32 scalars)."""

    assignment: np.ndarray
    matcher_state: MatcherState


class _FreePool:
    """O(1)-per-op free-slot pool over ``capacity`` slots: fresh slots come
    from a counter (0, 1, 2, ...), returned ones from a LIFO stack, so no
    O(capacity) structure ever exists."""

    __slots__ = ("_capacity", "_next_fresh", "_recycled")

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._next_fresh = 0
        self._recycled: List[int] = []

    def __len__(self) -> int:
        return (self._capacity - self._next_fresh) + len(self._recycled)

    def pop(self) -> int:
        if self._recycled:
            return self._recycled.pop()
        if self._next_fresh < self._capacity:
            slot = self._next_fresh
            self._next_fresh += 1
            return slot
        raise IndexError("pop from empty _FreePool")

    def push(self, slot: int) -> None:
        self._recycled.append(slot)


def _fresh_row(scheduler, matcher_beta: float, device) -> TenantSlots:
    """One slot's contents before a join: the scheduler's initial state."""
    dev = resolve_device(device)
    return TenantSlots(
        sched_state=scheduler.init(dev),
        matcher_state=AdaptiveMatcher(matcher_beta).init(dev),
        aoi=torch.ones((scheduler.n_clients,), device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        active=torch.zeros((), dtype=torch.bool, device=dev),
        decisions=torch.zeros((), dtype=torch.int32, device=dev),
        successes=torch.zeros((), device=dev))


def init_slots(scheduler, capacity: int, matcher_beta: float = 0.5,
               rows: Optional[int] = None, device=None) -> TenantSlots:
    """All-inactive slot state, ``rows`` (default ``capacity + 1``) of it."""
    rows = capacity + 1 if rows is None else rows
    return tree_map(lambda x: x.unsqueeze(0).repeat(rows, *([1] * x.dim())).contiguous(),
                     _fresh_row(scheduler, matcher_beta, device))


def make_serve_step(scheduler, use_matching: bool = False, matcher_beta: float = 0.5,
                    score_kind: str = "ucb"):
    """The serve step ``(state, slots, rewards, u, contrib, aoi, aoi_set,
    mask) -> (assignment, matcher rows)``, updating ``state`` (a
    ``TenantSlots``) in place.

    ``slots`` (B,) int64 names each request row's slot (padding rows the
    scratch slot); ``rewards``/``u`` (B, N); ``contrib``/``aoi`` (B, M),
    the AoI override applied where ``aoi_set`` (B,); ``mask`` (B,) marks
    the real rows.  Returns the (B, M) assignment (-1 on rows that
    are not live) and the (B,)-leaved post-step ``MatcherState``.
    """
    matcher = AdaptiveMatcher(matcher_beta)
    stride = scheduler.detector_stride

    def scores_of(rows, t):
        if score_kind == "mean":
            return scheduler.mean_scores(rows, t)
        return scheduler.channel_scores(rows, t)

    def serve_step(state: TenantSlots, slots, rewards, u, contrib, aoi, aoi_set, mask):
        ss = state.sched_state
        take = lambda x: x.index_select(0, slots)
        live = mask & take(state.active)
        t, old_aoi = take(state.t), take(state.aoi)
        row_aoi = torch.where(aoi_set[:, None], aoi, old_aoi)
        rows = ss._replace(mu_tilde=take(ss.mu_tilde), counts=take(ss.counts),
                           tau=take(ss.tau), restarts=take(ss.restarts),
                           hp={k: take(v) for k, v in ss.hp.items()})
        ring = SlotRing(ss.cum, ss.total, ss.base, slots, live, live & (t % stride == 0))
        old_m = MatcherState(*[take(x) for x in state.matcher_state])
        if use_matching:
            channels, _ = scheduler.select(rows, t, u, row_aoi)
            assignment, new_m = matcher.match(old_m, channels, scores_of(rows, t), contrib,
                                              row_aoi)
            rewards = rewards.gather(1, assignment)
            new = scheduler.update_rows(rows, t, assignment, rewards, ring)
            new_aoi = update_aoi(row_aoi, rewards > 0.5)
        else:
            new, new_aoi, assignment, rewards = policy_round(scheduler, rows, row_aoi, t, u,
                                                             rewards, ring)
            new_m = old_m

        # rows that are not live merge back to what they read, so their
        # write is a no-op (the padding rows' duplicate writes to the scratch
        # slot all carry the same values)
        def put(dst, new_rows, old_rows):
            keep = live.view((-1,) + (1,) * (new_rows.dim() - 1))
            merged = torch.where(keep, new_rows, old_rows)
            dst.index_copy_(0, slots, merged)
            return merged

        for f in ("mu_tilde", "counts", "tau", "restarts"):
            put(getattr(ss, f), getattr(new, f), getattr(rows, f))
        merged_m = MatcherState(*[put(d, a, b) for d, a, b in zip(state.matcher_state, new_m,
                                                                   old_m)])
        put(state.aoi, new_aoi, old_aoi)
        put(state.t, t + 1, t)
        decisions = take(state.decisions)
        put(state.decisions, decisions + 1, decisions)
        successes = take(state.successes)
        put(state.successes, successes + rewards.sum(-1), successes)
        return torch.where(live[:, None], assignment, -1), merged_m

    return serve_step


def make_admit(scheduler, matcher_beta: float = 0.5, device=None):
    """The join/leave program ``(state, slot, hp, active)``: overwrite one
    slot with a fresh tenant row, its hyper-parameters ``hp`` ({name:
    float}) and membership ``active``, in place, by device-side copies and
    fills (no host-to-device transfer, so no wait on the device)."""
    fresh = _fresh_row(scheduler, matcher_beta, device)

    def admit(state: TenantSlots, slot: int, hp: Dict[str, float], active: bool):
        tree_map(lambda dst, src: dst[slot].copy_(src), state, fresh)
        for k, v in hp.items():
            state.sched_state.hp[k][slot].fill_(float(v))
        state.active[slot].fill_(bool(active))

    return admit


def _sched_sig(scheduler) -> str:
    """Structural identity of a scheduler config: every field by value,
    the traced hyper-parameters by name only."""
    traced = set(getattr(scheduler, "TRACED", ()))
    parts = tuple((f.name, "<traced>" if f.name in traced else getattr(scheduler, f.name))
                  for f in dataclasses.fields(scheduler))
    return str((type(scheduler).__name__, parts))


class _Inflight(NamedTuple):
    """A dispatched step: request indices, host copies of its results
    (filled by asynchronous copies) and the event that says they landed."""

    indices: List[int]
    assignment: torch.Tensor
    matcher_rows: Optional[torch.Tensor]
    done: Optional[torch.cuda.Event]


class SchedServer:
    """Online scheduling service over a fixed-capacity tenant pool, on
    ``device`` (default ``cuda``).

    ``serve(requests)`` batches requests into ``slots``-row steps (padding
    short batches with scratch-slot rows, deferring a tenant's second
    request to the next step) and returns each request's (M,) assignment in
    request order, waiting for every step.  ``serve_stream(requests)`` is
    the pipelined loop (results one step behind dispatch);
    ``serve_decisions(requests)`` also returns the post-step matcher rows
    (the FL trainers' protocol).
    """

    def __init__(self, scheduler, capacity: int = 256, slots: int = 16,
                 use_matching: bool = False, matcher_beta: float = 0.5,
                 score_kind: str = "ucb", shard: bool = False, mesh=None, device=None):
        if not isinstance(scheduler, GLRCUCB):
            raise ValueError(f"SchedServer: only GLR-CUCB is served by the port, got "
                             f"{type(scheduler).__name__}; M-Exp3, AoI-Aware, random, "
                             "round-robin, channel-aware and Lyapunov are ported but not "
                             "served yet")
        if scheduler.detector_impl != "streaming":
            raise ValueError("SchedServer: the service runs the streaming detector; "
                             "detector_impl='recompute' is not served")
        if capacity < 1:
            raise ValueError(f"SchedServer: capacity must be >= 1, got {capacity}")
        if capacity + 1 >= 2**24:
            raise ValueError(f"SchedServer: capacity {capacity} too large (slot indices "
                             f"travel as f32)")
        if slots < 1:
            raise ValueError(f"SchedServer: slots must be >= 1, got {slots}")
        if score_kind not in ("ucb", "mean"):
            raise ValueError(f"SchedServer: score_kind must be 'ucb' or 'mean', "
                             f"got {score_kind!r}")
        if mesh is not None:
            raise ValueError("SchedServer: the port serves on one card; a device mesh (a "
                             "split of the slots across cards) is not ported")
        self.device = resolve_device(device)
        self.scheduler = scheduler
        self.capacity = capacity
        self.slots = slots
        self.use_matching = use_matching
        self.matcher_beta = matcher_beta
        self.score_kind = score_kind
        self.shard = bool(shard)
        # sharded rows round up to the device count: one device, so capacity + 1
        self.rows = capacity + 1
        self._state = init_slots(scheduler, capacity, matcher_beta, rows=self.rows,
                                 device=self.device)
        self._tenants: Dict[Any, int] = {}
        self._free = _FreePool(capacity)
        self._hp_defaults = {k: float(v) for k, v in
                             scheduler.params(torch.device("cpu")).items()}
        self._served = 0
        self._steps = 0
        self._stream_steps = 0
        self._rows_dispatched = 0
        self._sizes_used: Dict[int, int] = {}
        self._bad_rewards: Dict[Any, int] = {}
        self._sig = _sched_sig(scheduler)
        self._step = make_serve_step(scheduler, use_matching=use_matching,
                                     matcher_beta=matcher_beta, score_kind=score_kind)
        self._admit = make_admit(scheduler, matcher_beta=matcher_beta, device=self.device)
        self._pin = self.device.type == "cuda"
        n, m = scheduler.n_channels, scheduler.n_clients
        # one f32 row a request: slot | rewards (N) | u (N) | contrib (M) | aoi (M) | aoi_set | mask
        self._cols = 1 + 2 * n + 2 * m + 2
        # batch-size ladder for serve_stream autosizing: powers of two up to
        # `slots`, and `slots` itself
        self._ladder = sorted({1 << i for i in range(slots.bit_length())
                               if (1 << i) <= slots} | {slots})
        self._templates: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ set-up
    def warm(self, sizes: Optional[Sequence[int]] = None) -> None:
        """Prepare the host templates of the step sizes ``sizes`` (default:
        the autosizing ladder)."""
        for b in (self._ladder if sizes is None else sizes):
            self._template(int(b))

    def _template(self, b: int) -> np.ndarray:
        """The (b, cols) operand block of an all-padding step."""
        tmpl = self._templates.get(b)
        if tmpl is None:
            n, m = self.scheduler.n_channels, self.scheduler.n_clients
            tmpl = np.zeros((b, self._cols), np.float32)
            tmpl[:, 0] = self.capacity                       # the scratch slot
            tmpl[:, 1 + 2 * n:1 + 2 * n + m] = 1.0           # uniform contributions
            self._templates[b] = tmpl
        return tmpl

    def _pick_size(self, depth: int) -> int:
        """Smallest ladder batch size covering ``depth`` queued requests."""
        for b in self._ladder:
            if b >= depth:
                return b
        return self.slots

    # ------------------------------------------------------------ tenants
    def join(self, tenant, hp: Optional[Dict[str, Any]] = None) -> int:
        """Admit ``tenant`` into a free slot (fresh policy, matcher and AoI
        state).  ``hp`` overrides traced hyper-parameters for this tenant
        (per-job gamma/delta/min_samples); unknown names raise.  Returns the
        slot."""
        if tenant in self._tenants:
            raise ValueError(f"SchedServer.join: tenant {tenant!r} already live")
        if not len(self._free):
            raise RuntimeError(
                f"SchedServer.join: at capacity ({self.capacity} tenants live) — leave() an "
                f"existing tenant or construct the server with a larger capacity")
        overrides = dict(hp or {})
        unknown = set(overrides) - set(self._hp_defaults)
        if unknown:
            raise ValueError(f"SchedServer.join: unknown hyper-parameters {sorted(unknown)} "
                             f"(traced: {sorted(self._hp_defaults)})")
        slot = self._free.pop()
        self._admit(self._state, slot,
                    {k: float(overrides.get(k, v)) for k, v in self._hp_defaults.items()}, True)
        self._tenants[tenant] = slot
        return slot

    def leave(self, tenant) -> None:
        """Evict ``tenant``: reset its slot and free it."""
        slot = self._tenants.pop(tenant, None)
        if slot is None:
            raise KeyError(f"SchedServer.leave: unknown tenant {tenant!r}")
        self._admit(self._state, slot, self._hp_defaults, False)
        self._free.push(slot)

    @property
    def tenants(self) -> Dict[Any, int]:
        return dict(self._tenants)

    def tenant_state(self, tenant) -> TenantSlots:
        """A copy of this tenant's row of every leaf."""
        slot = self._tenants[tenant]
        return tree_map(lambda x: x[slot].clone(), self._state)

    # -------------------------------------------------------- persistence
    def save(self, directory: str, step: int = 0) -> str:
        """Snapshot the serving state: the slot state through
        ``save_checkpoint`` (``step_{step}.npz``) and the host bookkeeping
        in a ``serve_{step}.json`` sidecar.  Tenant ids must round-trip
        through JSON.  Waits for the device; safe between steps of a
        stream."""
        path = save_checkpoint(directory, step, self._state)
        meta = {
            "sig": self._sig, "capacity": self.capacity, "rows": self.rows,
            "slots": self.slots,
            "tenants": [[t, int(s)] for t, s in self._tenants.items()],
            "free_next_fresh": self._free._next_fresh,
            "free_recycled": list(self._free._recycled),
            "served": self._served, "steps": self._steps, "stream_steps": self._stream_steps,
            "rows_dispatched": self._rows_dispatched,
            "sizes_used": [[int(b), int(c)] for b, c in self._sizes_used.items()],
            "bad_rewards": [[t, int(c)] for t, c in self._bad_rewards.items()],
        }
        with open(os.path.join(directory, f"serve_{step}.json"), "w") as f:
            json.dump(meta, f, indent=1)
        return path

    def restore(self, directory: str, step: Optional[int] = None, warm: bool = True) -> int:
        """Load a ``save()`` snapshot into this server; returns its step.
        The server must have the scheduler configuration, capacity and
        slots of the one that saved (checked against the sidecar).  Every
        leaf comes back with its exact dtype and bytes."""
        state, step = restore_checkpoint(directory, step=step, like=self._state)
        with open(os.path.join(directory, f"serve_{step}.json")) as f:
            meta = json.load(f)
        if meta["sig"] != self._sig:
            raise ValueError(f"SchedServer.restore: snapshot was saved by a different "
                             f"scheduler configuration ({meta['sig']} != {self._sig})")
        for field in ("capacity", "rows", "slots"):
            if meta[field] != getattr(self, field):
                raise ValueError(f"SchedServer.restore: snapshot {field}={meta[field]} != "
                                 f"server {field}={getattr(self, field)}")
        self._state = state
        self._tenants = {t: int(s) for t, s in meta["tenants"]}
        self._free = _FreePool(self.capacity)
        self._free._next_fresh = int(meta["free_next_fresh"])
        self._free._recycled = [int(s) for s in meta["free_recycled"]]
        for k in ("served", "steps", "stream_steps", "rows_dispatched"):
            setattr(self, f"_{k}", int(meta[k]))
        self._sizes_used = {int(b): int(c) for b, c in meta["sizes_used"]}
        self._bad_rewards = {t: int(c) for t, c in meta["bad_rewards"]}
        if warm:
            self.warm()
        return step

    # ------------------------------------------------------------ serving
    def _sanitize_rewards(self, tenant, rewards) -> np.ndarray:
        """Clip one request's reward vector to finite [0, 1]: non-finite
        entries become 0.0, finite ones clip, and the tenant's
        ``bad_rewards`` counter counts the request.  A valid vector comes
        back unchanged."""
        r = np.asarray(rewards, np.float32)
        finite = np.isfinite(r)
        if finite.all() and (r >= 0.0).all() and (r <= 1.0).all():
            return r
        self._bad_rewards[tenant] = self._bad_rewards.get(tenant, 0) + 1
        return np.clip(np.where(finite, r, 0.0), 0.0, 1.0).astype(np.float32)

    def _take_batch(self, pending: deque, limit: int):
        """Pop up to ``limit`` requests of distinct tenants off ``pending``,
        deferring a tenant's further requests back to the front in order
        (the packing rule of ``serve`` and ``serve_stream`` alike)."""
        batch, used, deferred = [], set(), []
        while pending and len(batch) < limit:
            i, rq = pending.popleft()
            slot = self._tenants.get(rq.tenant)
            if slot is None:
                raise KeyError(f"SchedServer.serve: unknown tenant {rq.tenant!r}")
            if slot in used:
                deferred.append((i, rq))
                continue
            used.add(slot)
            batch.append((i, rq, slot))
        pending.extendleft(reversed(deferred))
        return batch

    def _dispatch(self, batch, b: int, want_decisions: bool) -> _Inflight:
        """Pack ``batch`` into a ``b``-row step, run it and start copying
        its results back; waits on nothing."""
        n, m = self.scheduler.n_channels, self.scheduler.n_clients
        live = len(batch)
        host = torch.empty((b, self._cols), dtype=torch.float32, pin_memory=self._pin)
        a = host.numpy()
        a[:] = self._template(b)
        if live:
            a[:live, 0] = [s for (_, _, s) in batch]
            a[:live, 1:1 + n] = [self._sanitize_rewards(rq.tenant, rq.rewards)
                                 for (_, rq, _) in batch]
            a[:live, 1 + n:1 + 2 * n] = [np.asarray(rq.u, np.float32) for (_, rq, _) in batch]
            for j, (_, rq, _) in enumerate(batch):
                if rq.contrib is not None:
                    a[j, 1 + 2 * n:1 + 2 * n + m] = np.asarray(rq.contrib, np.float32)
                if rq.aoi is not None:
                    a[j, 1 + 2 * n + m:1 + 2 * n + 2 * m] = np.asarray(rq.aoi, np.float32)
                    a[j, -2] = 1.0
            a[:live, -1] = 1.0

        ops_ = host.to(self.device, non_blocking=True)
        c = 1 + 2 * n + 2 * m
        assignment, mrows = self._step(
            self._state, ops_[:, 0].to(torch.int64), ops_[:, 1:1 + n], ops_[:, 1 + n:1 + 2 * n],
            ops_[:, 1 + 2 * n:1 + 2 * n + m], ops_[:, 1 + 2 * n + m:c], ops_[:, c] > 0.5,
            ops_[:, c + 1] > 0.5)
        mstack = torch.stack(list(mrows), dim=-1) if want_decisions else None
        done = None
        if self.device.type == "cuda":
            assignment = assignment.to("cpu", non_blocking=True)
            if mstack is not None:
                mstack = mstack.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        self._served += live
        self._steps += 1
        self._rows_dispatched += b
        self._sizes_used[b] = self._sizes_used.get(b, 0) + 1
        return _Inflight([i for (i, _, _) in batch], assignment, mstack, done)

    @staticmethod
    def _retire(inflight: _Inflight):
        """Wait for a dispatched step's results: ``(assignment (b, M) int32,
        matcher rows (b, 3) f32 or None)`` as numpy."""
        if inflight.done is not None:
            inflight.done.synchronize()
        asg = inflight.assignment.numpy().astype(np.int32)
        mrows = None if inflight.matcher_rows is None else inflight.matcher_rows.numpy()
        return asg, mrows

    def _serve_sync(self, requests: Sequence[ServeRequest], want_decisions: bool):
        """The synchronous loop: pack, step, wait for the assignment, repeat."""
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        decs: List[Optional[ServeDecision]] = [None] * len(requests)
        pending = deque(enumerate(requests))
        while pending:
            batch = self._take_batch(pending, self.slots)
            asg, mrows = self._retire(self._dispatch(batch, self.slots, want_decisions))
            for j, (i, _, _) in enumerate(batch):
                out[i] = asg[j]
                if want_decisions:
                    decs[i] = ServeDecision(assignment=asg[j], matcher_state=MatcherState(
                        v_max=mrows[j, 0], a_max=mrows[j, 1], beta_t=mrows[j, 2]))
        return out, decs

    def serve(self, requests: Sequence[ServeRequest]) -> List[np.ndarray]:
        """Serve a batch of requests; returns each request's (M,) channel
        assignment, in request order.  Each step is waited for before the
        next is packed; see ``serve_stream`` for the pipelined loop."""
        return self._serve_sync(requests, want_decisions=False)[0]

    def serve_decisions(self, requests: Sequence[ServeRequest]) -> List[ServeDecision]:
        """``serve()`` returning ``ServeDecision``s (assignment and the
        post-step matcher row): the FL trainers' protocol."""
        return self._serve_sync(requests, want_decisions=True)[1]

    def serve_stream(self, requests: Iterable[Optional[ServeRequest]],
                     autosize: bool = True) -> Iterator[Tuple[int, np.ndarray]]:
        """Pipelined serving: a generator of ``(index, assignment)``.

        ``requests`` is any iterable of ``ServeRequest`` (a lazy generator
        whose side effects, ``join``/``leave`` churn, interleave with
        serving), optionally with ``None`` flush markers that dispatch what
        is pending without waiting for a full batch.  ``index`` counts the
        requests (not the markers); the assignments equal ``serve()``'s over
        the same trace.  While step k runs on the device the host packs and
        dispatches step k+1, and only then waits for step k: one step of
        latency.  With ``autosize`` a step takes the smallest ladder size
        covering the queue.
        """
        pending: deque = deque()
        inflight: Optional[_Inflight] = None
        it = iter(requests)
        exhausted = draining = False
        next_index = 0
        while True:
            # ---- pull from the source until a full batch / flush / end ----
            while not exhausted and not draining and len(pending) < self.slots:
                try:
                    rq = next(it)
                except StopIteration:
                    exhausted = draining = True
                    break
                if rq is None:
                    draining = True
                    break
                pending.append((next_index, rq))
                next_index += 1

            # ---- dispatch the next step ------------------------------------
            dispatched = None
            if pending and (draining or len(pending) >= self.slots):
                b = self._pick_size(min(len(pending), self.slots)) if autosize else self.slots
                dispatched = self._dispatch(self._take_batch(pending, b), b, False)
                self._stream_steps += 1
            if draining and not pending and not exhausted:
                draining = False          # flush satisfied; resume pulling

            # ---- retire the previous step while this one is in flight -------
            if inflight is not None:
                asg, _ = self._retire(inflight)
                for j, i in enumerate(inflight.indices):
                    yield i, asg[j]
            inflight = dispatched
            if inflight is None and not pending and exhausted:
                return

    def stats(self) -> Dict[str, Any]:
        rows = max(self._rows_dispatched, 1)
        return {"tenants": len(self._tenants), "capacity": self.capacity, "rows": self.rows,
                "slots": self.slots, "served": self._served, "steps": self._steps,
                "stream_steps": self._stream_steps, "rows_dispatched": self._rows_dispatched,
                "batch_occupancy": self._served / rows, "sizes_used": dict(self._sizes_used),
                "bad_rewards": dict(self._bad_rewards), "sharded": self.shard,
                "device": str(self.device)}
