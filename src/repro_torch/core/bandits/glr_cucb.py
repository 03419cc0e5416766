"""GLR-CUCB (Algorithm 2) — piecewise-stationary channel scheduling.

Combinatorial-UCB schedules the M highest-UCB channels each round
(Eq. 30); a Generalized-Likelihood-Ratio change-point detector watches
the per-channel reward streams and restarts the bandit when a breakpoint
is detected.  The GLR statistic for a stream z_1..z_n is

    gamma = sup_{1 <= s < n}  s * kl(mean(z_1..s), mean(z_1..n))
                            + (n-s) * kl(mean(z_s+1..n), mean(z_1..n))

against the threshold beta(n, delta) = (1 + 1/n) log(3 n sqrt(n) / delta).

Two detectors, as in the JAX package.  ``detector_impl="streaming"``
(the default) carries per-channel prefix-sum state (``cum``/``total``/
``base``) in ``GLRCUCBState``, one O(N) masked append per round, and
reads the statistic straight from the carried prefixes.  Two paths
compute it:

* the fused path: on a detection round one ``ops.glr_step`` (append +
  test, the CUDA kernel on the card), ``ref.glr_stream_append`` alone on
  the other rounds.  Taken whenever the state lives on CUDA, or with
  ``detector_backend="kernel"`` (which runs ``ref.glr_step`` on the CPU);
* the split path: the append on every round, the statistic on the M
  scheduled rows only (unscheduled channels can never fire).  The CPU
  default, or ``detector_backend="torch"``.

For {0, 1} rewards both paths give bitwise-equal prefix state and
statistics.

``detector_impl="recompute"`` is the legacy reference detector: a rolled
chronological (N, H) history ``hist``, whose prefix sum is rebuilt on
every detection round by ``ops.glr_scan`` (the CUDA kernel on the card,
``ref.glr_scan`` on the CPU).  It evaluates the dense split grid only.
For {0, 1} rewards every prefix is an exact integer and both kernels
share the split term (``csrc/glr_kl.cuh``), so the two detectors fire on
the same rounds and give the same trajectories.

Two batched forms, each row's bits those of the single-run call on it
(the JAX package ``vmap``s the single-run functions for both):

* the batched engine's runs (``repro_torch.sim``): ``select`` and
  ``update`` take state leaves with a leading (B,) axis and one Python
  int ``t``, written out explicitly (``base.py``).  The streaming
  detector's fused path is one ``ops.glr_step`` over (B, N, H), the split
  path the append over B*N rows and the statistic over the B*M scheduled
  rows; the recompute detector is one ``ops.glr_scan`` over B*N rows;
* the scheduler service's tenants (``repro_torch.sim.serve``):
  ``ucb``/``select``/``channel_scores``/``mean_scores`` take a (B,) int32
  ``t`` as well, and ``update_rows`` updates B rows whose streaming
  detector state stays in the service's slot tensors (a ``SlotRing``),
  through ``ops.glr_step_tenants`` in place.

Twin of ``repro/core/bandits/glr_cucb.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandits.base import TracedHyperParams, hp_tensors, rotate_assignment
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


def glr_threshold(n: torch.Tensor, delta) -> torch.Tensor:
    """beta(n, delta) = (1 + 1/n) log(3 n sqrt(n) / delta)."""
    n_f = n.to(torch.float32).clamp_min(1.0)
    return (1.0 + 1.0 / n_f) * torch.log(3.0 * n_f * torch.sqrt(n_f) / delta)


class GLRCUCBState(NamedTuple):
    mu_tilde: torch.Tensor  # (N,) empirical means since last restart
    counts: torch.Tensor    # (N,) f32 D_i — observations since last restart
    tau: torch.Tensor       # () int32 — last restart round
    hist: torch.Tensor      # (N, H) rolled chronological reward streams under
                            # "recompute"; (N, 0) under "streaming"
    restarts: torch.Tensor  # () int32 — number of detected change points
    hp: Dict[str, torch.Tensor]  # {gamma, delta, min_samples} 0-d f32
    cum: torch.Tensor       # (N, H) carried prefix sums: cum[j] = stream total
                            # at the sample last written to ring slot j
                            # ((N, 0) under "recompute")
    total: torch.Tensor     # (N,) running stream total since restart
    base: torch.Tensor      # (N,) stream total just before the window's
                            # oldest sample (0 until the ring wraps)


class SlotRing(NamedTuple):
    """The streaming detector state of a batch of B rows, kept in place in
    the scheduler service's slot tensors: ``cum`` (R, N, H) and ``total``/
    ``base`` (R, N), of which the rows ``slots`` (B,) are updated where
    ``live`` (B,) bool.  ``detect`` (B,) bool marks the rows on a detection
    round (it implies live): only their rings are read."""

    cum: torch.Tensor
    total: torch.Tensor
    base: torch.Tensor
    slots: torch.Tensor
    live: torch.Tensor
    detect: torch.Tensor


def _append(cum, total, base, counts, r_vec, sched):
    """``ref.glr_stream_append`` over the rows of (..., N, H) prefix rings."""
    h = cum.shape[-1]
    flat = lambda x: x.reshape(-1)
    out = ref.glr_stream_append(cum.reshape(-1, h), flat(total), flat(base), flat(counts),
                                flat(r_vec), flat(sched))
    return out[0].reshape(cum.shape), out[1].reshape(total.shape), out[2].reshape(base.shape)


@dataclasses.dataclass(frozen=True)
class GLRCUCB(TracedHyperParams):
    n_channels: int
    n_clients: int
    delta: float = 1e-3          # GLR confidence
    gamma: float = 1.0           # UCB exploration scale (Eq. 30 bonus)
    alpha: float = 0.0           # forced-exploration rate
    history: int = 2048          # H — per-channel ring length
    detector_stride: int = 1     # run the GLR detector every k rounds
    min_samples: int = 8         # don't test before this many samples
    detector_backend: Optional[str] = None  # None (auto: fused path iff the
                                            # state is on CUDA) | "kernel"
                                            # (fused) | "torch" (split)
    detector_impl: str = "streaming"  # "streaming" | "recompute"
    split_grid: str = "all"      # "all" | "geometric" | "auto"
    auto_split_h: int = 4096     # "auto": history above this is geometric
    name: str = "glr-cucb"

    TRACED = ("gamma", "delta", "min_samples")

    def __post_init__(self):
        if self.detector_backend not in (None, "kernel", "torch"):
            raise ValueError(
                f"GLRCUCB: unknown detector_backend {self.detector_backend!r}; "
                "use None (auto), 'kernel' or 'torch'")
        if self.detector_impl not in ("streaming", "recompute"):
            raise ValueError(
                f"GLRCUCB: unknown detector_impl {self.detector_impl!r}; "
                "use 'streaming' or 'recompute'")
        if self.split_grid not in ("all", "geometric", "auto"):
            raise ValueError(
                f"GLRCUCB: unknown split_grid {self.split_grid!r}; "
                "use 'all', 'geometric' or 'auto'")
        if self.detector_impl == "recompute" and self.split_grid != "all":
            raise ValueError(
                "GLRCUCB: split_grid='geometric'/'auto' needs the streaming "
                "detector (the recompute path always evaluates the dense grid)")
        if self.auto_split_h < 1:
            raise ValueError(f"GLRCUCB: auto_split_h must be >= 1, got {self.auto_split_h}")

    def resolved_split_grid(self) -> str:
        """The concrete split grid: ``"auto"`` is dense while
        ``history <= auto_split_h``, geometric above."""
        if self.split_grid != "auto":
            return self.split_grid
        return "geometric" if self.history > self.auto_split_h else "all"

    def _fused(self, state: GLRCUCBState) -> bool:
        return (self.detector_backend == "kernel"
                or (self.detector_backend is None and state.cum.is_cuda))

    # ------------------------------------------------------------------ api
    def init(self, device=None, hp: Optional[Dict[str, Any]] = None) -> GLRCUCBState:
        dev = resolve_device(device)
        n, h = self.n_channels, self.history
        streaming = self.detector_impl == "streaming"
        f32 = dict(dtype=torch.float32, device=dev)
        hp = self.params(dev) if hp is None else hp_tensors(hp, dev)
        return GLRCUCBState(
            mu_tilde=torch.zeros((n,), **f32),
            counts=torch.zeros((n,), **f32),
            tau=torch.zeros((), dtype=torch.int32, device=dev),
            hist=torch.zeros((n, 0 if streaming else h), **f32),
            restarts=torch.zeros((), dtype=torch.int32, device=dev),
            hp=hp,
            cum=torch.zeros((n, h if streaming else 0), **f32),
            total=torch.zeros((n,), **f32),
            base=torch.zeros((n,), **f32),
        )

    def ucb(self, state: GLRCUCBState, t) -> torch.Tensor:
        """Eq. 30: mu_tilde + gamma * sqrt(3 log(t - tau) / (2 D)); +inf unseen.

        ``t`` is the round (an int), or a (B,) int32 tensor for a batch of
        rows (state leaves with a leading (B,) axis); every element is
        computed by the same operations either way."""
        since = (t - state.tau).to(torch.float32).clamp_min(2.0)
        bonus = torch.sqrt(3.0 * torch.log(since)[..., None] / (2.0 * state.counts.clamp_min(1.0)))
        ucb = state.mu_tilde + state.hp["gamma"][..., None] * bonus
        return torch.where(state.counts > 0, ucb, torch.inf)

    def select(self, state: GLRCUCBState, t, u: torch.Tensor,
               aoi: torch.Tensor) -> Tuple[torch.Tensor, None]:
        """The M channels of round ``t``.  ``u`` is the round's (N,) uniform
        draw: it breaks ties among unseen arms (scaled to 1e6 so it survives
        f32 rounding on top of the 1e9 stand-in for +inf); seen arms rank by
        their Eq.-30 values alone.  The sort is stable, as ``jnp.argsort``.
        For a batch of rows ``t`` is (B,) int32, ``u`` (B, N), and the
        channels come back (B, M)."""
        n, m = self.n_channels, self.n_clients
        ucb = self.ucb(state, t)
        noise = torch.where(state.counts == 0, u * 1e6, 0.0)
        key = torch.where(torch.isinf(ucb), 1e9, ucb) + noise
        top = torch.argsort(-key, dim=-1, stable=True)[..., :m]
        # forced exploration (Alg. 2 line 3): at rate alpha, channel
        # i = (t - tau) mod floor(N / alpha) is scheduled when i < N
        if self.alpha > 0:
            period = max(int(n / self.alpha), n)
            slot = ((t - state.tau) % period).to(top.dtype)
            forced = slot < n
            present = (top == slot[..., None]).any(-1)
            swapped = top.clone()
            swapped[..., m - 1] = slot
            top = torch.where((forced & ~present)[..., None], swapped, top)
        return rotate_assignment(top, t, m), None

    def _observe(self, state: GLRCUCBState, channels, rewards):
        """The round's semi-bandit feedback folded into the means: returns
        ``(sched, r_vec, d_prev, mu, counts)``, per channel of each row."""
        # sanitize: the GLR statistics assume Bernoulli rewards in [0, 1];
        # the identity on valid {0, 1} streams
        rewards = torch.where(torch.isfinite(rewards), rewards, 0.0).clamp(0.0, 1.0)
        d_prev = state.counts
        sched = torch.zeros_like(d_prev, dtype=torch.bool).scatter(-1, channels, True)
        r_vec = torch.zeros_like(d_prev).scatter(-1, channels, rewards.to(torch.float32))
        mu = torch.where(sched, (state.mu_tilde * d_prev + r_vec) / (d_prev + 1.0),
                         state.mu_tilde)
        counts = torch.where(sched, d_prev + 1.0, d_prev)
        return sched, r_vec, d_prev, mu, counts

    def update(self, state: GLRCUCBState, t: int, channels: torch.Tensor,
               rewards: torch.Tensor, aux: Any) -> GLRCUCBState:
        sched, r_vec, d_prev, mu, counts = self._observe(state, channels, rewards)
        stride_ok = t % self.detector_stride == 0
        if self.detector_impl == "streaming":
            hist = state.hist                # (N, 0): prefix-only detector
            cum, total, base, change = self._detect_streaming(
                state, channels, sched, r_vec, d_prev, counts, stride_ok)
        else:
            hist, cum, total, base, change = self._detect_recompute(
                state, sched, r_vec, d_prev, counts, stride_ok)

        # restart (Alg. 2 line 21): D_i = 0 for all i, tau <- t.  The ring
        # stays in place: zeroed counts/total/base make every stale slot's
        # split position invalid.  The recompute history is zeroed.
        row = change[..., None]
        mu = mu.masked_fill(row, 0.0)
        counts = counts.masked_fill(row, 0.0)
        total = total.masked_fill(row, 0.0)
        base = base.masked_fill(row, 0.0)
        if self.detector_impl == "recompute":
            hist = hist.masked_fill(row[..., None], 0.0)
        tau = state.tau.masked_fill(change, t)
        restarts = state.restarts + change.to(torch.int32)
        return GLRCUCBState(mu, counts, tau, hist, restarts, state.hp,
                            cum, total, base)

    def update_rows(self, state: GLRCUCBState, t: torch.Tensor, channels: torch.Tensor,
                    rewards: torch.Tensor, ring: SlotRing) -> GLRCUCBState:
        """``update`` for a batch of B rows, each at its own round ``t`` (B,)
        int32 and with its own detection flag (``ring.detect``).  ``state``
        holds the rows' ``mu_tilde``/``counts`` (B, N), ``tau``/``restarts``
        (B,) and ``hp`` of (B,) tensors; its ``hist``/``cum``/``total``/
        ``base`` are not read: the streaming detector state stays in the
        slot tensors of ``ring``, which this updates in place (the append,
        then the restart's zeroed totals).  On CUDA every call is one
        ``ops.glr_step_tenants`` launch, which reads only the detecting
        rows' rings.  Never waits on the device.  Returns the rows' state,
        whose detector leaves are the ring's."""
        if self.detector_impl != "streaming":
            raise ValueError("GLRCUCB.update_rows: the scheduler service runs the streaming "
                             "detector only; detector_impl='recompute' is not served")
        sched, r_vec, d_prev, mu, counts = self._observe(state, channels, rewards)
        stats = ops.glr_step_tenants(ring.cum, ring.total, ring.base, ring.slots, ring.live,
                                     ring.detect, d_prev, r_vec, sched,
                                     split_grid=self.resolved_split_grid())
        change = self._fire(stats, sched, counts, state.hp)
        # restart, as in `update`; rows that do not restart write back what
        # they read (every row that is not live among them)
        rows = ring.slots.to(torch.int64)
        for x in (ring.total, ring.base):
            x.index_copy_(0, rows, x.index_select(0, rows).masked_fill(change[:, None], 0.0))
        mu = mu.masked_fill(change[:, None], 0.0)
        counts = counts.masked_fill(change[:, None], 0.0)
        tau = torch.where(change, t, state.tau)
        restarts = state.restarts + change.to(torch.int32)
        return GLRCUCBState(mu, counts, tau, state.hist, restarts, state.hp,
                            ring.cum, ring.total, ring.base)

    def _fire(self, stats, sched, counts, hp) -> torch.Tensor:
        """Restart decision from per-channel statistics: () bool, or (B,) for
        a batch of rows."""
        n_valid = counts.clamp_max(float(self.history)).to(torch.int32)
        thresh = glr_threshold(n_valid, hp["delta"][..., None])
        fire = (sched & (stats >= thresh)
                & (n_valid.to(torch.float32) >= hp["min_samples"][..., None]))
        return fire.any(-1)

    def _detect_streaming(self, state, channels, sched, r_vec, d_prev, counts,
                          stride_ok: bool):
        """Carried-prefix-sum detector; returns ``(cum, total, base, change)``."""
        grid = self.resolved_split_grid()
        if self._fused(state):
            if stride_ok:
                cum, total, base, stats = ops.glr_step(
                    state.cum, state.total, state.base, d_prev, r_vec, sched,
                    split_grid=grid)
            else:
                cum, total, base = _append(state.cum, state.total, state.base, d_prev, r_vec,
                                           sched)
                stats = torch.full_like(d_prev, -torch.inf)
        else:
            cum, total, base = _append(state.cum, state.total, state.base, d_prev, r_vec, sched)
            stats = torch.full_like(d_prev, -torch.inf)
            if stride_ok:
                h = cum.shape[-1]
                pick = lambda x: x.gather(-1, channels).reshape(-1)
                rows = cum.gather(-2, channels[..., None].expand(*channels.shape, h))
                stats = stats.scatter(-1, channels, ref.glr_stream_stat(
                    rows.reshape(-1, h), pick(total), pick(base), pick(counts),
                    grid).reshape(channels.shape))
        change = self._fire(stats, sched, counts, state.hp)
        return cum, total, base, change

    def _detect_recompute(self, state, sched, r_vec, d_prev, counts, stride_ok: bool):
        """Legacy reference detector: rolled chronological history, prefix
        sum rebuilt by ``ops.glr_scan`` on detection rounds; returns
        ``(hist, cum, total, base, change)``."""
        h = self.history
        # history write: append at D_prev, or shift the row when it is full
        full = d_prev >= h
        writepos = d_prev.to(torch.int64).clamp(0, h - 1)
        onehot = torch.nn.functional.one_hot(writepos, h).to(torch.float32)
        appended = state.hist * (1.0 - onehot) + r_vec[..., None] * onehot
        rolled = torch.cat([state.hist[..., 1:], r_vec[..., None]], dim=-1)
        hist = torch.where(sched[..., None], torch.where(full[..., None], rolled, appended),
                           state.hist)
        if stride_ok:
            stats = ops.glr_scan(hist.reshape(-1, h), counts.clamp_max(float(h)).to(
                torch.int32).reshape(-1)).reshape(counts.shape)
        else:
            stats = torch.full_like(d_prev, -torch.inf)
        change = self._fire(stats, sched, counts, state.hp)
        return hist, state.cum, state.total, state.base, change

    def channel_scores(self, state: GLRCUCBState, t) -> torch.Tensor:
        """UCB values (Eq. 30) rank channels for the Sec.-V matcher."""
        ucb = self.ucb(state, t)
        return torch.where(torch.isinf(ucb), 1e9, ucb)

    def mean_scores(self, state: GLRCUCBState, t) -> torch.Tensor:
        """Historical empirical means (Eq. 31) — the matcher's rank source
        under ``"mean"``-hint scenarios."""
        return state.mu_tilde
