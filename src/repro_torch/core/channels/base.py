"""Canonical channel environments (Sec. II-B).

The spectrum is divided into ``N`` orthogonal Bernoulli sub-channels with
state Good (1) / Bad (0).  Scenarios lower to one of the JAX package's
three canonical forms:

* ``"segments"`` — per-segment means ``(S, N)`` with ascending breakpoint
  rounds ``(S-1,)``; ``mu_k(t)`` is a ``searchsorted`` gather.  S = 1 is
  the stationary special case.
* ``"table"``    — a per-round mean table ``(T, N)``; ``mu_k(t)`` is a row.
* ``"reactive"`` — closed-loop: a ``(T, N)`` base table suppressed by a
  smooth threshold response on an (N,) carried load, the EMA of what the
  policy scheduled; the four reaction coefficients ``[decay, gain,
  thresh, sharp]`` are the ``react`` leaf (``N_REACT``).  The
  follower jammer and load congestion both lower to it.

Randomness enters through one seam: ``sample(t, u)`` takes the round's
(N,) f32 uniform draw and returns ``(u < mu(t)).float()``, which is how
``jax.random.bernoulli`` draws, so feeding both packages the same
uniforms gives the same channel states.  The two open-loop forms take
``means_at``/``sample``; the reactive form raises there and in
``dense_means`` (its means depend on the schedule) and is driven through
the closed-loop API, uniform across forms:

    istate = env.interact_init()                       # (N,) zeros
    states = env.sample_dyn(t, u, istate)              # == sample(t, u)
                                                       #    when open-loop
    istate = env.interact_step(istate, t, sched_mask)  # identity when
                                                       #    open-loop

Round t draws from the carry as it stood before round t: the env sees
the schedule one round late.  ``reactive_means`` spells the suppression's
sigmoid out as ``1 / (1 + exp(-x))`` (``torch.exp``, then a correctly
rounded reciprocal), the function the ``regret_scan`` kernel's reactive
template evaluates with ``expf`` and ``__fdiv_rn``, so the per-round route
and the kernel give the same bits on the card.

A batch of envs of one form and leaf shapes stacks on a leading run axis
(``stack_envs``): ``means`` (B, S, N), ``breaks`` (B, S-1), ``table`` (B,
T, N), ``react`` (B, 4) (``(B, 0)`` for the open-loop forms), the input of
the batched engine (``repro_torch.sim``), whose per-round loop reads
``dense_means`` (open-loop) or ``means_dyn`` on a (B, N) load (reactive).
Twin of ``repro/core/channels/base.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device

FORM_SEGMENTS = "segments"
FORM_TABLE = "table"
FORM_REACTIVE = "reactive"
FORMS = (FORM_SEGMENTS, FORM_TABLE, FORM_REACTIVE)
TABLE_FORMS = (FORM_TABLE, FORM_REACTIVE)    # the forms whose leading leaf is ``table``

# layout of the reactive form's ``react`` leaf: (4,) f32 [decay, gain, thresh, sharp]
N_REACT = 4


def scenario_realize_generator(seed: int, device=None) -> torch.Generator:
    """The generator a case's ``ChannelProcess`` is realized from: a
    ``torch.Generator`` on ``device`` seeded with
    ``((seed XOR 0x5EED) * 0x9E3779B1) mod 2**32``, a bijection of 32-bit
    seeds that sends small ones far from each other (32 bits, because
    torch's CPU generator keeps only those), so the env's draws and the
    run's uniforms (seeded with ``seed``) do not share a stream.  The
    sweep driver realizes a process case from it; the serial run of the
    case passes it to ``simulate_aoi_regret`` as ``generator`` (twin of
    ``repro.core.channels.scenario_realize_key``)."""
    gen = torch.Generator(device=resolve_device(device))
    return gen.manual_seed(((int(seed) ^ 0x5EED) * 0x9E3779B1) % 2**32)


@dataclasses.dataclass(frozen=True)
class ChannelEnv:
    """A scenario lowered to canonical form.

    form: ``"segments"`` | ``"table"`` | ``"reactive"``.
    means: (S, N) per-segment Bernoulli means; a (1, N) placeholder for the
        table forms.
    breaks: (S-1,) ascending breakpoint rounds (segment s covers
        ``[breaks[s-1], breaks[s])``).
    table: (T, N) per-round means for the table form, the base
        (pre-suppression) means for the reactive form, else (0, N).
    score_kind: ``"ucb"`` | ``"mean"`` — which scheduler score the Sec.-V
        matcher ranks channels by under this scenario.
    react: (4,) f32 ``[decay, gain, thresh, sharp]`` of the reactive form;
        a (0,) placeholder for the open-loop forms.
    """

    form: str
    means: torch.Tensor
    breaks: torch.Tensor
    table: torch.Tensor
    score_kind: str = "ucb"
    react: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.form not in FORMS:
            raise ValueError(f"ChannelEnv: form {self.form!r} is not one of {FORMS}")
        if self.react is None:
            lead = self.leaf.shape[:-2]
            object.__setattr__(self, "react", torch.zeros(
                lead + (0,), dtype=torch.float32, device=self.means.device))
        if self.form == FORM_REACTIVE and tuple(self.react.shape[-1:]) != (N_REACT,):
            raise ValueError(f"ChannelEnv: a reactive env's react leaf is (..., {N_REACT}) "
                             f"[decay, gain, thresh, sharp], got {tuple(self.react.shape)}")

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def leaf(self) -> torch.Tensor:
        """The leaf that carries the run axis when stacked: ``table`` for
        the table forms, ``means`` for segments."""
        return self.table if self.form in TABLE_FORMS else self.means

    def to(self, device) -> "ChannelEnv":
        return dataclasses.replace(self, means=self.means.to(device),
                                   breaks=self.breaks.to(device),
                                   table=self.table.to(device), react=self.react.to(device))

    def signature(self) -> Tuple:
        """What a batch of the engines needs equal: form, score hint and the
        leaves' shapes and dtypes (a sweep bucket's env key; the values may
        differ)."""
        return (self.form, self.score_kind) + tuple(
            (tuple(x.shape), str(x.dtype)) for x in (self.means, self.breaks, self.table,
                                                      self.react))

    @property
    def n_channels(self) -> int:
        return self.leaf.shape[-1]

    @property
    def horizon(self) -> int:
        """Table length T for the table forms; segment envs extend to any t
        (the last segment is open-ended) and report 0."""
        return self.table.shape[-2] if self.form in TABLE_FORMS else 0

    @property
    def kind(self) -> str:
        """The regime's name: ``"stationary"``/``"piecewise"`` (segments),
        ``"adversarial"`` (a table with the ``"mean"`` hint), ``"table"``,
        or ``"reactive"``."""
        if self.form == FORM_REACTIVE:
            return FORM_REACTIVE
        if self.form == FORM_TABLE:
            return "adversarial" if self.score_kind == "mean" else FORM_TABLE
        return "stationary" if self.means.shape[-2] == 1 else "piecewise"

    # -- behaviour ---------------------------------------------------------
    def _check_t(self, t: int, what: str) -> None:
        if not 0 <= t < self.table.shape[-2]:
            raise ValueError(
                f"ChannelEnv.{what}: round t={t} outside the table horizon "
                f"[0, {self.table.shape[-2]}); the scenario was realized for "
                f"{self.table.shape[-2]} rounds — realize it with a horizon >= the "
                "simulation horizon")

    def _check_open_loop(self, what: str) -> None:
        if self.form == FORM_REACTIVE:
            raise ValueError(
                f"ChannelEnv.{what}: a \"reactive\" env has no open-loop means — "
                "mu_k(t) depends on the carried interaction state (what the policy "
                "scheduled).  Thread the carry through the closed-loop API instead: "
                "istate = env.interact_init(); states = env.sample_dyn(t, u, istate); "
                "istate = env.interact_step(istate, t, sched_mask).  The engines "
                "(repro_torch.core.regret.simulate_aoi_regret, repro_torch.fl."
                "AsyncFLTrainer, repro_torch.sim.sweep) do this automatically; "
                "env.table holds the pre-suppression base means.")

    def means_at(self, t: int) -> torch.Tensor:
        """Instantaneous per-channel success means ``mu_k(t)`` — (N,), or
        (B, N) for a stacked env (each row its own env's).  Open-loop forms
        only; a reactive env raises (use ``means_dyn``)."""
        self._check_open_loop("means_at")
        if self.form == FORM_TABLE:
            self._check_t(t, "means_at")
            return self.table[..., t, :]
        if self.means.shape[-2] == 1:
            return self.means[..., 0, :]
        if self.means.dim() == 2:
            seg = torch.searchsorted(self.breaks, t, right=True)
            return self.means[seg]
        seg = (self.breaks <= t).sum(dim=-1)     # each run's segment: searchsorted, right
        return self.means.gather(-2, seg[:, None, None].expand(-1, 1, self.n_channels))[:, 0]

    def sample(self, t: int, u: torch.Tensor) -> torch.Tensor:
        """Good/Bad state of all N channels in round ``t`` from the round's
        (N,) uniform draw ``u`` — (N,) f32 in {0, 1}; (B, N) for (B, N)
        draws or a stacked env.  Open-loop forms only; a reactive env
        raises (use ``sample_dyn``)."""
        self._check_open_loop("sample")
        return (u < self.means_at(t)).to(torch.float32)

    # -- closed-loop API (uniform across forms) ----------------------------
    def interact_init(self) -> torch.Tensor:
        """Initial interaction carry, (N,) zeros for every form (open-loop
        forms never read it)."""
        return torch.zeros((self.n_channels,), dtype=torch.float32, device=self.device)

    def means_dyn(self, t: int, istate: torch.Tensor) -> torch.Tensor:
        """Per-channel means given the carry: ``means_at(t)`` for open-loop
        forms; for the reactive form the base row suppressed by the load,
        ``table[t] * (1 - clip(gain, 0, 1) * sigmoid(sharp * (load -
        thresh)))`` (``reactive_means``).  A stacked reactive env takes a
        (B, N) carry and gives (B, N)."""
        if self.form != FORM_REACTIVE:
            return self.means_at(t)
        self._check_t(t, "means_dyn")
        return reactive_means(self.table[..., t, :], self.react, istate)

    def sample_dyn(self, t: int, u: torch.Tensor, istate: torch.Tensor) -> torch.Tensor:
        """Closed-loop ``sample``: ``(u < means_dyn(t, istate)).float()``,
        identical to ``sample(t, u)`` for open-loop forms."""
        if self.form != FORM_REACTIVE:
            return self.sample(t, u)
        return (u < self.means_dyn(t, istate)).to(torch.float32)

    def interact_step(self, istate: torch.Tensor, t: int,
                      sched_mask: torch.Tensor) -> torch.Tensor:
        """Advance the carry with round ``t``'s schedule (``sched_mask``: the
        (N,) f32 {0, 1} indicator of the channels the policy used): the
        identity for open-loop forms; for the reactive form the leaky
        integrator ``clip(decay, 0, 1) * load + (1 - decay) * sched_mask``,
        in the JAX package's op order."""
        if self.form != FORM_REACTIVE:
            return istate
        decay = self.react[..., 0, None].clamp(0.0, 1.0)
        return decay * istate + (1.0 - decay) * sched_mask


def reactive_means(base: torch.Tensor, react: torch.Tensor, load: torch.Tensor) -> torch.Tensor:
    """The reactive form's means: ``base * (1 - g * s)`` with ``g =
    clip(react[1], 0, 1)`` and ``s = 1 / (1 + exp(-react[3] * (load -
    react[2])))``, each op rounded in this order (the JAX package's
    ``means_dyn``; ``regret_scan.cu``'s reactive template repeats it op by
    op).  ``react`` is (4,) or (B, 4); ``base`` and ``load`` (N,) or (B, N)."""
    gain = react[..., 1, None].clamp(0.0, 1.0)
    x = react[..., 3, None] * (load - react[..., 2, None])
    return base * (1.0 - gain * (1.0 / (1.0 + torch.exp(-x))))


def segment_env(segment_means, breakpoints=None, score_kind: str = "ucb",
                device=None) -> ChannelEnv:
    """Lower to the ``(S, N)`` segment-mean canonical form."""
    dev = resolve_device(device)
    means = torch.as_tensor(segment_means, dtype=torch.float32).to(dev)
    if means.dim() != 2:
        raise ValueError(f"segment_env: means must be (S, N), got {tuple(means.shape)}")
    if breakpoints is None:
        breakpoints = torch.zeros((0,), dtype=torch.int64)
    breaks = torch.as_tensor(breakpoints).to(device=dev, dtype=torch.int64)
    if breaks.shape != (means.shape[0] - 1,):
        raise ValueError(
            f"segment_env: {means.shape[0]} segments need {means.shape[0] - 1} "
            f"breakpoints, got {tuple(breaks.shape)}")
    return ChannelEnv(FORM_SEGMENTS, means, breaks,
                      torch.zeros((0, means.shape[1]), dtype=torch.float32, device=dev),
                      score_kind)


def table_env(table, score_kind: str = "ucb", device=None) -> ChannelEnv:
    """Lower to the ``(T, N)`` per-round mean-table canonical form."""
    dev = resolve_device(device)
    table = torch.as_tensor(table, dtype=torch.float32).to(dev)
    if table.dim() != 2:
        raise ValueError(f"table_env: table must be (T, N), got {tuple(table.shape)}")
    return ChannelEnv(FORM_TABLE, torch.zeros((1, table.shape[1]), device=dev),
                      torch.zeros((0,), dtype=torch.int64, device=dev), table, score_kind)


def reactive_env(table, decay, gain, thresh, sharp, score_kind: str = "ucb",
                 device=None) -> ChannelEnv:
    """Lower to the ``"reactive"`` closed-loop canonical form: ``table`` the
    (T, N) base (pre-suppression) means, the four reaction coefficients
    (floats or 0-d tensors) stacked into the (4,) f32 ``react`` leaf."""
    dev = resolve_device(device)
    table = torch.as_tensor(table, dtype=torch.float32).to(dev)
    if table.dim() != 2:
        raise ValueError(f"reactive_env: table must be (T, N), got {tuple(table.shape)}")
    react = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(dev)
                         for v in (decay, gain, thresh, sharp)])
    return ChannelEnv(FORM_REACTIVE, torch.zeros((1, table.shape[1]), device=dev),
                      torch.zeros((0,), dtype=torch.int64, device=dev), table, score_kind,
                      react)


def make_stationary(mus, device=None) -> ChannelEnv:
    """Fixed unknown means ``mu_k`` — the S = 1 segment form."""
    return segment_env(torch.as_tensor(mus, dtype=torch.float32)[None, :], device=device)


def make_piecewise(segment_means, breakpoints, device=None) -> ChannelEnv:
    """``segment_means``: (S, N); ``breakpoints``: (S-1,) ascending rounds."""
    return segment_env(segment_means, breakpoints, device=device)


def dense_means(env: ChannelEnv, horizon: int) -> torch.Tensor:
    """The env's per-round means for rounds ``0..horizon-1``: (T, N), or
    (B, T, N) for a stacked env; each row is ``means_at(t)``'s values.  A
    segment env extends to any horizon (its last segment is open-ended); a
    table env must cover ``horizon`` rounds.  A reactive env has no
    open-loop table and raises."""
    if env.form == FORM_REACTIVE:
        raise ValueError(
            "dense_means: a \"reactive\" env has no open-loop mean table — its "
            "per-round means are a function of the carried interaction state, so they "
            "only exist inside a simulation that threads the carry (repro_torch.core."
            "regret.simulate_aoi_regret / repro_torch.fl.AsyncFLTrainer / repro_torch."
            "sim.sweep).  env.table holds the pre-suppression base means if you need "
            "the open-loop component.")
    if env.form == FORM_TABLE:
        if env.table.shape[-2] < horizon:
            raise ValueError(
                f"dense_means: table horizon {env.table.shape[-2]} < requested {horizon}")
        return env.table[..., :horizon, :]
    lead, (n_seg, n) = env.means.shape[:-2], env.means.shape[-2:]
    if n_seg == 1:
        return env.means.expand(*lead, horizon, n)
    t = torch.arange(horizon, device=env.device)
    if not lead:
        return env.means[torch.searchsorted(env.breaks, t, right=True)]
    seg = torch.searchsorted(env.breaks, t.expand(*lead, horizon).contiguous(), right=True)
    return env.means.gather(-2, seg[..., None].expand(*lead, horizon, n))


def _leaf_shapes(env: ChannelEnv):
    return tuple((tuple(x.shape), x.dtype)
                 for x in (env.means, env.breaks, env.table, env.react))


def envs_stackable(envs) -> bool:
    """True iff the envs share form, score hint and leaf shapes (one batch
    of the engine).  The scenario family does not matter."""
    first = envs[0]
    return all(e.form == first.form and e.score_kind == first.score_kind
               and _leaf_shapes(e) == _leaf_shapes(first) for e in envs[1:])


def stack_envs(envs) -> ChannelEnv:
    """Stack envs of one form and leaf shapes on a new leading run axis.
    The result is the batched engine's env input, not an env ``sample``
    or ``means_at`` take."""
    envs = list(envs)
    if not envs:
        raise ValueError("stack_envs: empty env list")
    if not envs_stackable(envs):
        kinds = sorted({e.kind for e in envs})
        raise ValueError(
            f"stack_envs: envs must share kind (canonical form + score hint) and leaf "
            f"shapes (kinds={kinds}); group heterogeneous cases with repro_torch.sim.sweep "
            "instead")
    first = envs[0]
    return dataclasses.replace(first, means=torch.stack([e.means for e in envs]),
                               breaks=torch.stack([e.breaks for e in envs]),
                               table=torch.stack([e.table for e in envs]),
                               react=torch.stack([e.react for e in envs]))


def env_batch_size(env: ChannelEnv) -> int:
    """The leading run axis of a stacked env; 1 for an unbatched env."""
    lead = env.leaf.shape
    return 1 if len(lead) == 2 else lead[0]
