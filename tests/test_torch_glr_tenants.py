"""The scheduler service's detector step and the batched policy pieces.

``ref.glr_step_tenants`` (the plain version of the in-place CUDA kernel,
and the CPU path of ``ops.glr_step_tenants``) is held against the JAX
package's ``glr_step_tenants`` on the gathered rows, through its Pallas
kernel in interpret mode and through the jnp oracle: padding rows on the
scratch slot, live rows that do not detect, ring wraparound, both split
grids.  The carried state is bitwise on {0, 1} rewards (exact integer
prefixes); the statistic is held at rtol 1e-5 (``log`` differs by an ulp
between XLA and torch) with -inf at the same places; rows that are not
live are untouched.

The batched GLR-CUCB (``select``/``ucb``/``channel_scores``/``_fire`` on
rows, ``update_rows``) and matcher must give, row for row, the bits of the
unbatched calls: that is what makes a served tenant equal the offline run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.core.bandits import GLRCUCB, SlotRing  # noqa: E402
from repro_torch.core.matching import AdaptiveMatcher, MatcherState  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

R, B, N, H = 9, 6, 4, 64


def _inputs(seed, h=H, binary=True):
    rng = np.random.default_rng(seed)
    if binary:
        cum = rng.integers(0, 2 * h, (R, N, h)).astype(np.float32)
        total = rng.integers(0, 3 * h, (R, N)).astype(np.float32)
        base = rng.integers(0, h, (R, N)).astype(np.float32)
        r_vec = rng.integers(0, 2, (B, N)).astype(np.float32)
    else:
        cum = np.sort(rng.random((R, N, h)), -1).astype(np.float32) * h
        total = (rng.random((R, N)) * 3 * h).astype(np.float32)
        base = rng.random((R, N)).astype(np.float32)
        r_vec = rng.random((B, N)).astype(np.float32)
    counts = rng.integers(0, 3 * h, (B, N)).astype(np.float32)
    counts.reshape(-1)[:4] = [0, 1, h - 1, h]          # empty window, n = 1, the wrap
    slots = np.array([3, 0, R - 1, R - 1, 5, 1], np.int32)   # two padding rows on scratch
    live = np.array([1, 1, 0, 0, 1, 1], bool)
    detect = np.array([1, 0, 0, 0, 1, 1], bool)          # row 1 live but not detecting
    sched = rng.random((B, N)) < 0.6
    return cum, total, base, slots, live, detect, counts, r_vec, sched


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("backend", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("split_grid", ["all", "geometric"])
@pytest.mark.parametrize("binary", [True, False], ids=["bernoulli", "uniform"])
def test_plain_version_matches_jax_tenant_kernel(backend, split_grid, binary):
    cum, total, base, slots, live, detect, counts, r_vec, sched = _inputs(7, binary=binary)
    want = jax_ops.glr_step(jnp.asarray(cum[slots]), jnp.asarray(total[slots]),
                            jnp.asarray(base[slots]), jnp.asarray(counts), jnp.asarray(r_vec),
                            jnp.asarray(sched), split_grid=split_grid, backend=backend)
    want = [np.array(w) for w in want]
    state = [_torch(cum.copy()), _torch(total.copy()), _torch(base.copy())]
    stats = ops.glr_step_tenants(*state, _torch(slots), _torch(live), _torch(detect),
                                 _torch(counts), _torch(r_vec), _torch(sched),
                                 split_grid=split_grid).numpy()
    for b in range(B):
        s = slots[b]
        if live[b]:
            for got, w, name in zip(state, want[:3], ("cum", "total", "base")):
                if binary:
                    np.testing.assert_array_equal(got[s].numpy(), w[b], err_msg=name)
                else:
                    np.testing.assert_allclose(got[s].numpy(), w[b], rtol=1e-6, err_msg=name)
        if detect[b]:
            np.testing.assert_array_equal(np.isneginf(stats[b]), np.isneginf(want[3][b]))
            fin = np.isfinite(want[3][b])
            np.testing.assert_allclose(stats[b][fin], want[3][b][fin], rtol=1e-5, atol=1e-6)
        else:
            assert np.isneginf(stats[b]).all()
    untouched = np.setdiff1d(np.arange(R), slots[live])
    for got, old in zip(state, (cum, total, base)):
        np.testing.assert_array_equal(got.numpy()[untouched], old[untouched])


@pytest.mark.parametrize("h", [1, 33, 130])
def test_plain_version_is_glr_step_on_the_gathered_rows(h):
    """Row for row the bits of ``ref.glr_step``, at odd ring lengths."""
    cum, total, base, slots, live, detect, counts, r_vec, sched = _inputs(3, h=h)
    state = [_torch(cum.copy()), _torch(total.copy()), _torch(base.copy())]
    stats = ref.glr_step_tenants(*state, _torch(slots), _torch(live), _torch(detect),
                                 _torch(counts), _torch(r_vec), _torch(sched))
    idx = slots.astype(np.int64)
    want = ref.glr_step(_torch(cum[idx]).reshape(-1, h), _torch(total[idx]).reshape(-1),
                        _torch(base[idx]).reshape(-1), _torch(counts).reshape(-1),
                        _torch(r_vec).reshape(-1), _torch(sched).reshape(-1))
    for b in np.flatnonzero(live):
        assert torch.equal(state[0][slots[b]], want[0].reshape(B, N, h)[b])
        assert torch.equal(state[1][slots[b]], want[1].reshape(B, N)[b])
        assert torch.equal(state[2][slots[b]], want[2].reshape(B, N)[b])
    for b in range(B):
        expect = want[3].reshape(B, N)[b] if detect[b] else torch.full((N,), -torch.inf)
        assert torch.equal(stats[b], expect)


def test_append_alone_matches_the_step_append():
    """``glr_tenants_append``, the CPU plain version's append, is the append
    of ``glr_step_tenants``, and leaves rows that are not live alone."""
    cum, total, base, slots, live, detect, counts, r_vec, sched = _inputs(5)
    a = [_torch(cum.copy()), _torch(total.copy()), _torch(base.copy())]
    b = [_torch(cum.copy()), _torch(total.copy()), _torch(base.copy())]
    ops_args = (_torch(slots), _torch(live))
    ref.glr_tenants_append(*a, *ops_args, _torch(counts), _torch(r_vec), _torch(sched))
    ref.glr_step_tenants(*b, *ops_args, _torch(detect), _torch(counts), _torch(r_vec),
                         _torch(sched))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dispatch_refuses_unknown_grid_and_device():
    cum, total, base, slots, live, detect, counts, r_vec, sched = (_torch(x) for x in _inputs(1))
    with pytest.raises(ValueError, match="split_grid"):
        ops.glr_step_tenants(cum, total, base, slots, live, detect, counts, r_vec, sched,
                             split_grid="dense")
    # the meta route (the dry run's) takes meta tensors only: a meta ring
    # beside CPU operands is refused
    with pytest.raises(ValueError, match="meta route takes meta tensors"):
        ops.glr_step_tenants(cum.to("meta"), total, base, slots, live, detect, counts, r_vec,
                             sched)


# ---------------------------------------------------------------------------
# the batched policy: each row equals the unbatched call
# ---------------------------------------------------------------------------

def _row_states(sched, rng, rows):
    """``rows`` single-tenant states at assorted points of a run, and their
    stack (leaves (rows, ...))."""
    singles = []
    for i in range(rows):
        st = sched.init("cpu", hp={"gamma": 0.5 + 0.25 * i, "delta": 1e-3, "min_samples": 4.0})
        counts = torch.from_numpy(rng.integers(0, 3, sched.n_channels).astype(np.float32)
                                  * (i % 3))
        mu = torch.from_numpy(rng.random(sched.n_channels).astype(np.float32))
        singles.append(st._replace(mu_tilde=torch.where(counts > 0, mu, 0.0), counts=counts,
                                   tau=torch.tensor(i, dtype=torch.int32)))
    return singles, _stack(singles)


def _stack(singles):
    """Single-tenant states stacked into one state of leaves (rows, ...)."""
    return type(singles[0])(*[
        {k: torch.stack([s[f][k] for s in singles]) for k in singles[0][f]}
        if isinstance(singles[0][f], dict) else torch.stack([s[f] for s in singles])
        for f in range(len(singles[0]))])


@pytest.mark.parametrize("alpha", [0.0, 0.3])
def test_batched_select_and_scores_equal_rows(alpha):
    sched = GLRCUCB(6, 3, history=16, alpha=alpha)
    rng = np.random.default_rng(0)
    singles, stack = _row_states(sched, rng, 5)
    t = torch.tensor([0, 3, 7, 12, 40], dtype=torch.int32)
    u = torch.from_numpy(rng.random((5, 6)).astype(np.float32))
    aoi = torch.ones((5, 3))
    ch, _ = sched.select(stack, t, u, aoi)
    scores = sched.channel_scores(stack, t)
    for i, st in enumerate(singles):
        want, _ = sched.select(st, int(t[i]), u[i], aoi[i])
        assert torch.equal(ch[i], want)
        assert torch.equal(scores[i], sched.channel_scores(st, int(t[i])))
        assert torch.equal(sched.ucb(stack, t)[i], sched.ucb(st, int(t[i])))


def test_update_rows_equals_update_on_each_row():
    """``update_rows`` on a ring of slots equals ``update`` on each row (the
    single-tenant fused and split paths), restarts included."""
    n, m, h = 5, 2, 16
    sched = GLRCUCB(n, m, history=h, detector_stride=2, min_samples=2, delta=0.5)
    rng = np.random.default_rng(4)
    rows = 4
    singles = [sched.init("cpu") for _ in range(rows)]
    ring_cum = torch.zeros((rows + 1, n, h))
    ring_total = torch.zeros((rows + 1, n))
    ring_base = torch.zeros((rows + 1, n))
    slots = torch.tensor([2, 0, 3, 1])
    live = torch.tensor([True, True, True, False])
    restarts = 0
    for t in range(60):
        stack = _stack(singles)
        tt = torch.full((rows,), t, dtype=torch.int32)
        channels = torch.from_numpy(np.stack([rng.permutation(n)[:m] for _ in range(rows)]))
        p = 0.9 if t < 30 else 0.1
        rewards = torch.from_numpy((rng.random((rows, m)) < p).astype(np.float32))
        ring = SlotRing(ring_cum, ring_total, ring_base, slots, live,
                        live & (tt % sched.detector_stride == 0))
        new = sched.update_rows(stack, tt, channels, rewards, ring)
        for i in range(rows):
            if not live[i]:
                continue
            singles[i] = sched.update(singles[i], t, channels[i], rewards[i], None)
            for f in ("mu_tilde", "counts", "tau", "restarts"):
                assert torch.equal(getattr(new, f)[i], getattr(singles[i], f)), (t, i, f)
            s = int(slots[i])
            assert torch.equal(ring_cum[s], singles[i].cum)
            assert torch.equal(ring_total[s], singles[i].total)
            assert torch.equal(ring_base[s], singles[i].base)
        restarts = int(new.restarts[:3].sum())
    assert restarts > 0, "the trace never restarted: the restart path went untested"
    assert torch.equal(ring_cum[1], torch.zeros((n, h)))


def test_batched_matcher_equals_rows():
    matcher = AdaptiveMatcher(0.5)
    rng = np.random.default_rng(9)
    rows, m, n = 5, 4, 7
    state = MatcherState(v_max=torch.from_numpy(rng.random(rows).astype(np.float32)),
                         a_max=torch.from_numpy(1 + 5 * rng.random(rows).astype(np.float32)),
                         beta_t=torch.zeros(rows))
    aoi = torch.from_numpy(rng.integers(1, 9, (rows, m)).astype(np.float32))
    contrib = torch.from_numpy(rng.random((rows, m)).astype(np.float32))
    channels = torch.from_numpy(np.stack([rng.permutation(n)[:m] for _ in range(rows)]))
    scores = torch.from_numpy(rng.random((rows, n)).astype(np.float32))
    asg, new = matcher.match(state, channels, scores, contrib, aoi)
    for i in range(rows):
        one = MatcherState(*[x[i] for x in state])
        a, s = matcher.match(one, channels[i], scores[i], contrib[i], aoi[i])
        assert torch.equal(asg[i], a)
        for x, y in zip(new, s):
            assert torch.equal(x[i], y)
