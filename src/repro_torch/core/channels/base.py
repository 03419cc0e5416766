"""Canonical channel environments (Sec. II-B).

The spectrum is divided into ``N`` orthogonal Bernoulli sub-channels with
state Good (1) / Bad (0).  Scenarios lower to one of the JAX package's
canonical open-loop forms:

* ``"segments"`` — per-segment means ``(S, N)`` with ascending breakpoint
  rounds ``(S-1,)``; ``mu_k(t)`` is a ``searchsorted`` gather.  S = 1 is
  the stationary special case.
* ``"table"``    — a per-round mean table ``(T, N)``; ``mu_k(t)`` is a row.

Randomness enters through one seam: ``sample(t, u)`` takes the round's
(N,) f32 uniform draw and returns ``(u < mu(t)).float()``, which is how
``jax.random.bernoulli`` draws, so feeding both packages the same
uniforms gives the same channel states.  The closed-loop API
(``interact_init``/``sample_dyn``/``interact_step``) is kept for the FL
trainer's loop and is the identity carry for these forms; the
``"reactive"`` form is not ported.

A batch of envs of one form and leaf shapes stacks on a leading run axis
(``stack_envs``): ``means`` (B, S, N), ``breaks`` (B, S-1), ``table`` (B,
T, N), the input of the batched engine (``repro_torch.sim``), whose
per-round loop reads ``dense_means``.  Twin of
``repro/core/channels/base.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

FORM_SEGMENTS = "segments"
FORM_TABLE = "table"


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

    form: ``"segments"`` | ``"table"``.
    means: (S, N) per-segment Bernoulli means; a (1, N) placeholder for the
        table form.
    breaks: (S-1,) ascending breakpoint rounds (segment s covers
        ``[breaks[s-1], breaks[s])``).
    table: (T, N) per-round means for the table form, else (0, N).
    score_kind: ``"ucb"`` | ``"mean"`` — which scheduler score the Sec.-V
        matcher ranks channels by under this scenario.
    """

    form: str
    means: torch.Tensor
    breaks: torch.Tensor
    table: torch.Tensor
    score_kind: str = "ucb"

    def __post_init__(self):
        if self.form not in (FORM_SEGMENTS, FORM_TABLE):
            raise ValueError(
                f"ChannelEnv: form {self.form!r} is not supported "
                f"(use {FORM_SEGMENTS!r} or {FORM_TABLE!r})")

    @property
    def device(self) -> torch.device:
        return self.means.device

    def to(self, device) -> "ChannelEnv":
        return dataclasses.replace(self, means=self.means.to(device),
                                   breaks=self.breaks.to(device),
                                   table=self.table.to(device))

    @property
    def n_channels(self) -> int:
        return self.table.shape[-1] if self.form == FORM_TABLE else self.means.shape[-1]

    @property
    def kind(self) -> str:
        """The regime's name: ``"stationary"``/``"piecewise"`` (segments),
        ``"adversarial"`` (a table with the ``"mean"`` hint) or ``"table"``."""
        if self.form == FORM_TABLE:
            return "adversarial" if self.score_kind == "mean" else FORM_TABLE
        return "stationary" if self.means.shape[-2] == 1 else "piecewise"

    # -- behaviour ---------------------------------------------------------
    def means_at(self, t: int) -> torch.Tensor:
        """Instantaneous per-channel success means ``mu_k(t)`` — (N,)."""
        if self.form == FORM_TABLE:
            if not 0 <= t < self.table.shape[0]:
                raise ValueError(
                    f"ChannelEnv.means_at: round t={t} outside the table "
                    f"horizon [0, {self.table.shape[0]})")
            return self.table[t]
        if self.means.shape[0] == 1:
            return self.means[0]
        seg = torch.searchsorted(self.breaks, t, right=True)
        return self.means[seg]

    def sample(self, t: int, u: torch.Tensor) -> torch.Tensor:
        """Good/Bad state of all N channels in round ``t`` from the round's
        (N,) uniform draw ``u`` — (N,) f32 in {0, 1}."""
        return (u < self.means_at(t)).to(torch.float32)

    def interact_init(self) -> torch.Tensor:
        """Initial interaction-state carry, (N,) zeros (dead for these forms)."""
        return torch.zeros((self.n_channels,), dtype=torch.float32, device=self.device)

    def sample_dyn(self, t: int, u: torch.Tensor, istate: torch.Tensor) -> torch.Tensor:
        """Closed-loop ``sample``: identical to ``sample(t, u)`` here."""
        return self.sample(t, u)

    def interact_step(self, istate: torch.Tensor, t: int,
                      sched_mask: torch.Tensor) -> torch.Tensor:
        """Advance the interaction carry: the identity for open-loop forms."""
        return istate


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
    table env must cover ``horizon`` rounds."""
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
    return tuple((tuple(x.shape), x.dtype) for x in (env.means, env.breaks, env.table))


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
                               table=torch.stack([e.table for e in envs]))


def env_batch_size(env: ChannelEnv) -> int:
    """The leading run axis of a stacked env; 1 for an unbatched env."""
    lead = env.table.shape if env.form == FORM_TABLE else env.means.shape
    return 1 if len(lead) == 2 else lead[0]
