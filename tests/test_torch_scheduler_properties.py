"""Property-based protocol invariants over every policy of the port.

The three contracts of ``tests/test_scheduler_properties.py``, for the
port's policies (``repro_torch.core.bandits``):

  * ``select`` returns M distinct channel ids in [0, N)  (constraint 9a/9b)
  * ``update`` keeps the state's structure, leaf shapes and dtypes (the
    per-round loop and the card's kernels read fixed layouts)
  * ``channel_scores`` is (N,) and finite (the Sec.-V matcher sorts on it)

Rounds draw their selection uniforms from a ``torch.Generator`` seeded by
the drawn seed.  Runs under the deterministic ``hypothesis`` stub of
``tests/conftest.py`` and under the real package; policies are drawn with
``sampled_from`` because the stub's ``given`` exposes a zero-argument
signature.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core.bandits import (  # noqa: E402
    GLRCUCB,
    AoIAware,
    ChannelAwareAsync,
    LyapunovSched,
    MExp3,
    RandomScheduler,
    RoundRobinScheduler,
)

N, M = 6, 3        # C(6, 3) = 20 super-arms

SCHEDULERS = [
    MExp3(N, M),
    MExp3(N, M, share_alpha=1e-3),
    GLRCUCB(N, M, history=32, detector_stride=2, min_samples=4),
    GLRCUCB(N, M, history=32, alpha=0.05),
    AoIAware(GLRCUCB(N, M, history=32)),
    AoIAware(MExp3(N, M)),
    RandomScheduler(N, M),
    RoundRobinScheduler(N, M),
    ChannelAwareAsync(N, M),
    LyapunovSched(N, M),
    LyapunovSched(N, M, v=0.0),          # pure fairness (queues only)
    AoIAware(ChannelAwareAsync(N, M)),
    AoIAware(LyapunovSched(N, M)),
]

STEPS = 4


def _drive(sched, seed: int, reward_bits: int, aoi_scale: float):
    """init + STEPS select/update rounds; returns (state0, state, selections).
    Rewards are decoded from ``reward_bits``; ``aoi_scale`` stresses the
    AoI-dependent branch of the AA wrapper."""
    gen = torch.Generator().manual_seed(seed)
    state0 = sched.init("cpu")
    state, aoi = state0, torch.ones(M) * aoi_scale
    selections = []
    for t in range(STEPS):
        channels, aux = sched.select(state, t, torch.rand(N, generator=gen), aoi)
        rewards = torch.tensor([(reward_bits >> ((t * M + j) % 16)) & 1 for j in range(M)],
                               dtype=torch.float32)
        state = sched.update(state, t, channels, rewards, aux)
        aoi = torch.where(rewards > 0.5, 1.0, aoi + 1.0)
        selections.append(channels)
    return state0, state, selections


def _leaves(x, path="state"):
    """(path, leaf) pairs of a state: NamedTuples and dicts walked in order."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [p for f in x._fields for p in _leaves(getattr(x, f), f"{path}.{f}")]
    if isinstance(x, dict):
        return [p for k in sorted(x) for p in _leaves(x[k], f"{path}[{k}]")]
    return [(path, x)]


def _structure(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, tuple((f, _structure(getattr(x, f))) for f in x._fields))
    if isinstance(x, dict):
        return tuple((k, _structure(x[k])) for k in sorted(x))
    return "leaf"


@given(st.sampled_from(SCHEDULERS), st.integers(0, 2**16 - 1),
       st.integers(0, 10**6), st.floats(1.0, 100.0))
@settings(max_examples=30, deadline=None)
def test_select_returns_m_distinct_valid_channels(sched, bits, seed, aoi_scale):
    _, _, selections = _drive(sched, seed, bits, aoi_scale)
    for channels in selections:
        c = channels.numpy()
        assert c.shape == (M,), (sched.name, c)
        assert channels.dtype == torch.int64, (sched.name, channels.dtype)
        assert len(set(c.tolist())) == M, (sched.name, c)      # no collisions
        assert (c >= 0).all() and (c < N).all(), (sched.name, c)


@given(st.sampled_from(SCHEDULERS), st.integers(0, 2**16 - 1),
       st.integers(0, 10**6), st.floats(1.0, 100.0))
@settings(max_examples=30, deadline=None)
def test_update_preserves_state_structure(sched, bits, seed, aoi_scale):
    state0, state, _ = _drive(sched, seed, bits, aoi_scale)
    assert _structure(state0) == _structure(state), sched.name
    for (p0, l0), (p1, l1) in zip(_leaves(state0), _leaves(state)):
        assert p0 == p1
        assert isinstance(l1, torch.Tensor), (sched.name, p1)
        assert l0.shape == l1.shape, (sched.name, p0, l0.shape, l1.shape)
        assert l0.dtype == l1.dtype, (sched.name, p0, l0.dtype, l1.dtype)


@given(st.sampled_from(SCHEDULERS), st.integers(0, 2**16 - 1),
       st.integers(0, 10**6), st.floats(1.0, 100.0))
@settings(max_examples=30, deadline=None)
def test_channel_scores_shape_and_finite(sched, bits, seed, aoi_scale):
    _, state, _ = _drive(sched, seed, bits, aoi_scale)
    s = sched.channel_scores(state, STEPS).numpy()
    assert s.shape == (N,), (sched.name, s.shape)
    assert np.isfinite(s).all(), (sched.name, s)
