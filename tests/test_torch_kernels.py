"""Parity of the port's kernel entry points with the JAX package's.

The port's CPU path (``repro_torch.kernels.ops`` on CPU tensors, i.e. the
plain versions in ``repro_torch.kernels.ref``) against the JAX Pallas
kernels in interpret mode and the JAX ``ref`` oracles, on the same numpy
inputs.  {0, 1} rewards keep every prefix an exact small integer, so the
carried ring, totals and bases are held bitwise; the GLR statistic goes
through ``log``, which differs by an ulp between XLA and torch on the
CPU, so it is held at rtol 1e-5 with -inf at the same places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _glr_inputs(shape, seed, binary=True):
    """A prefix state across ring wraparound: counts in [0, 3H), rows
    before, at and past the wrap, a mixed ``sched`` mask."""
    rng = np.random.default_rng(seed)
    h, rows = shape[-1], shape[:-1]
    counts = rng.integers(0, 3 * h, rows).astype(np.float32)
    counts.reshape(-1)[:3] = [0, h - 1, h][: counts.size]
    if binary:
        cum = rng.integers(0, 2 * h, shape).astype(np.float32)
        total = rng.integers(0, 3 * h, rows).astype(np.float32)
        base = rng.integers(0, h, rows).astype(np.float32)
        r_vec = rng.integers(0, 2, rows).astype(np.float32)
    else:
        cum = np.sort(rng.random(shape), axis=-1).astype(np.float32) * h
        total = (rng.random(rows) * 3 * h).astype(np.float32)
        base = rng.random(rows).astype(np.float32)
        r_vec = rng.random(rows).astype(np.float32)
    sched = rng.random(rows) < 0.7
    sched.reshape(-1)[0] = False           # an empty window: stat -inf
    return cum, total, base, counts, r_vec, sched


def _assert_stats_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(3, 8), (5, 64), (9, 130), (4, 3, 40)])
@pytest.mark.parametrize("split_grid", ["all", "geometric"])
def test_glr_step_matches_jax(shape, split_grid):
    args = _glr_inputs(shape, seed=sum(shape))
    want_pallas = jops.glr_step(*map(jnp.asarray, args), split_grid=split_grid,
                                backend="pallas_interpret")
    want_ref = jops.glr_step(*map(jnp.asarray, args), split_grid=split_grid, backend="jnp")
    got = ops.glr_step(*map(torch.from_numpy, args), split_grid=split_grid)
    for want in (want_pallas, want_ref):
        for g, w in zip(got[:3], want[:3]):          # cum, total, base: bitwise
            np.testing.assert_array_equal(g.numpy(), np.array(w))
        _assert_stats_close(got[3].numpy(), want[3])
    assert np.isneginf(got[3].numpy()).any()


@pytest.mark.parametrize("split_grid", ["all", "geometric"])
def test_glr_step_uniform_rewards_match_jax(split_grid):
    """Rewards uniform in [0, 1]: prefixes are no longer exact integers,
    but each is one f32 add on both sides (rtol 1e-6)."""
    args = _glr_inputs((7, 96), seed=5, binary=False)
    want = jref.glr_step(*map(jnp.asarray, args), split_grid=split_grid)
    got = ops.glr_step(*map(torch.from_numpy, args), split_grid=split_grid)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.array(w), rtol=1e-6, atol=0)
    _assert_stats_close(got[3].numpy(), want[3])


def test_glr_step_tenant_rows_equal_single_rows():
    """The (G, N, H) form is the same computation per row."""
    args = [torch.from_numpy(a) for a in _glr_inputs((3, 4, 32), seed=9)]
    got = ops.glr_step(*args)
    for g in range(3):
        one = ops.glr_step(*(a[g] for a in args))
        for x, y in zip(got, one):
            assert torch.equal(x[g], y)


def test_glr_stream_stat_empty_window_is_neg_inf():
    cum = torch.zeros((3, 16))
    z = torch.zeros(3)
    stats = ref.glr_stream_stat(cum, z, z, torch.tensor([0.0, 1.0, 2.0]))
    assert torch.isneginf(stats[:2]).all() and torch.isfinite(stats[2])


def _drive(sched, rounds, n, m, seed):
    """Drive ``sched.update`` with a piecewise {0, 1} stream and random
    schedules; returns the final state."""
    rng = np.random.default_rng(seed)
    state = sched.init("cpu")
    mu0 = rng.random(n)
    means = np.stack([mu0, 1.0 - mu0, mu0])          # strong shifts every 100 rounds
    for t in range(rounds):
        mu = means[min(t // 100, 2)]
        channels = torch.from_numpy(rng.permutation(n)[:m])
        rewards = torch.from_numpy((rng.random(m) < mu[channels.numpy()]).astype(np.float32))
        state = sched.update(state, t, channels, rewards, None)
    return state


@pytest.mark.parametrize("split_grid", ["all", "geometric"])
def test_fused_path_equals_split_path(split_grid):
    """``detector_backend="kernel"`` (the fused ``ops.glr_step`` path, as on
    the card) and ``"torch"`` (append + statistic on the scheduled rows)
    give bitwise-equal states over 300 updates, wraparound and restarts
    included."""
    n, m = 6, 3
    mk = lambda be: GLRCUCB(n, m, history=32, detector_stride=3, min_samples=4,
                            delta=0.05, split_grid=split_grid, detector_backend=be)
    fused = _drive(mk("kernel"), 300, n, m, seed=4)
    split = _drive(mk("torch"), 300, n, m, seed=4)
    assert int(fused.restarts) > 0
    for f in fused._fields:
        if f != "hp":
            assert torch.equal(getattr(fused, f), getattr(split, f)), f


@pytest.mark.parametrize("m,p", [(2, 64), (8, 5000), (5, 2049)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_aggregate_matches_jax(m, p, dtype):
    rng = np.random.default_rng(m * p)
    upd = (rng.standard_normal((m, p)) * 2).astype(np.float32)
    scale = rng.random(m).astype(np.float32)
    jupd, tupd = jnp.asarray(upd), torch.from_numpy(upd)
    if dtype == "bfloat16":
        jupd, tupd = jupd.astype(jnp.bfloat16), tupd.to(torch.bfloat16)
        np.testing.assert_array_equal(np.array(jupd.astype(jnp.float32)), tupd.float().numpy())
    got = ops.weighted_aggregate(tupd, torch.from_numpy(scale)).numpy()
    assert got.dtype == np.float32 and got.shape == (p,)
    for want in (jops.weighted_aggregate(jupd, jnp.asarray(scale), backend="pallas_interpret"),
                 jref.weighted_aggregate(jupd, jnp.asarray(scale))):
        np.testing.assert_allclose(got, np.array(want), rtol=1e-6, atol=1e-6)
