"""The port's batched FL engine (``repro_torch.sim.simulate_fl_batch``) on the CPU.

* The JAX engine's FL contract (``tests/test_sim_engine.py:226-330``): a
  batch of 1 equals ``run()`` bit for bit, every state leaf and metric; a
  multi-seed batch equals the per-seed serial runs; one data stream
  shared by the seeds equals the stream tiled.  Rows of a batch of B > 1
  are held as JAX holds them: the discrete leaves (AoI, ``has_update``,
  ``last_success``, staleness, the fault carry, the bandit counts) and
  ``n_success`` bit for bit, the other floats at rtol 1e-6, the params at
  rtol 1e-5 / atol 1e-6.
* JAX against the port on the same inputs: the port's batch on the
  uniforms behind JAX's round keys (``k_env, k_sel = split(key)``, the
  seam of ``tests/test_torch_fl_round.py``) against JAX's
  ``simulate_fl_batch``, the hp grid of ``tests/test_hp_grid.py:275`` and
  a Byzantine cell (the fault uniforms behind ``fold_in(key, 0xFA17)``).
  n_success, AoI, ``has_update``, the fault carry and the bandit counts
  bit for bit; the float metrics and zeta at rtol 1e-6 / atol 1e-6, the
  params at rtol 1e-5 / atol 1e-6: JAX's own multi-seed tolerances hold
  across the two packages over these six rounds.
* The knob grids of ``tests/test_faults.py:100`` and
  ``tests/test_aggregation.py:105``, against JAX's vmapped calls.
* The batched plain versions of ``weighted_aggregate`` and
  ``robust_trimmed`` equal a loop over the runs bit for bit (n = 0, NaN,
  +-inf and tied rows included), and a (B, M, P) CUDA tensor reaches the
  batch launch once or raises: no loop over B, no plain fallback.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.bandits.base import stack_params as jax_stack_params  # noqa: E402
from repro.core.channels import make_stationary as jax_stationary  # noqa: E402
from repro.data import BatchedFederatedLoader as JaxBatchedLoader  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro.sim import simulate_fl_batch as jax_simulate_fl_batch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.bandits import GLRCUCB, stack_params  # noqa: E402
from repro_torch.core.channels import (  # noqa: E402
    make_piecewise,
    make_scenario,
    make_stationary,
    random_adversarial_env,
    realize_processes,
    stack_envs,
)
from repro_torch.core.contribution import (  # noqa: E402
    ContributionBuffer,
    aggregation_weights,
    loo_aggregates,
    marginal_contribution,
    update_buffer,
)
from repro_torch.data import (  # noqa: E402
    BatchedFederatedLoader,
    FederatedLoader,
    make_federated_classification,
)
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import robust_agg as robust_mod  # noqa: E402
from repro_torch.kernels import weighted_aggregate as wagg_mod  # noqa: E402
from repro_torch.sim import simulate_fl_batch  # noqa: E402
from repro_torch.utils.tree import tree_flatten_concat, tree_unflatten_concat  # noqa: E402
from test_torch_faults import FAULT_TAG, jax_fault_uniforms  # noqa: E402
from test_torch_sim_engine import _row  # noqa: E402

KEY = jax.random.PRNGKey(0)
M, N, R = 4, 6, 6
DIM, HID, C = 16, 32, 10
CPU = dict(device="cpu")
DISCRETE = ("aoi", "has_update", "last_success", "staleness", "fault_state")


def _jax_loss(p, x, y):
    lg = jax.nn.log_softmax(jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])
    return -jnp.mean(jnp.take_along_axis(lg, y[:, None].astype(jnp.int32), 1))


def _torch_loss(p, x, y):
    lg = torch.log_softmax(torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"], dim=-1)
    return -torch.gather(lg, -1, y[..., None].to(torch.int64)).mean()


@pytest.fixture(scope="module")
def fl():
    """The JAX test's FL setup (``tests/test_sim_engine.py:191``): M = 4
    clients, N = 6 channels, the 16 -> 32 -> 10 MLP, E = 2, Bsz = 8."""
    cx, cy, *_ = make_federated_classification(M, samples_per_client=64, dim=DIM, alpha=0.3)
    k1, k2 = jax.random.split(KEY)
    params = {"w1": np.array(jax.random.normal(k1, (DIM, HID)) * 0.2),
              "b1": np.zeros(HID, np.float32),
              "w2": np.array(jax.random.normal(k2, (HID, C)) * 0.2),
              "b2": np.zeros(C, np.float32)}
    means = np.linspace(0.9, 0.2, N).astype(np.float32)

    def batches(seeds, r=R):
        return BatchedFederatedLoader(cx, cy, batch_size=8, local_epochs=2,
                                      seeds=seeds).next_rounds(r)

    def trainer(sched=None, env=None, **kw):
        cfg = AsyncFLConfig(n_clients=M, n_channels=N, local_epochs=2, client_lr=0.1,
                            server_lr=0.1)
        return AsyncFLTrainer(cfg, sched or GLRCUCB(N, M, history=32),
                              env if env is not None else make_stationary(means, **CPU),
                              _torch_loss, **CPU, **kw)

    def jax_trainer(sched=None, **kw):
        cfg = JaxConfig(n_clients=M, n_channels=N, local_epochs=2, client_lr=0.1,
                        server_lr=0.1)
        return JaxTrainer(cfg, sched or JaxGLRCUCB(N, M, history=32),
                          jax_stationary(jnp.asarray(means)), _jax_loss, **kw)

    return dict(cx=cx, cy=cy, params=params, batches=batches, trainer=trainer,
                jax_trainer=jax_trainer, means=means)


def _tparams(fl):
    return convert.params(fl["params"], "cpu")


def _keys(r=R, tag=0):
    return jnp.stack([jax.random.fold_in(KEY, 1000 * tag + t) for t in range(r)])


def _uniforms(keys):
    """(R, 2, N) uniforms behind the round keys' ``k_env, k_sel`` split."""
    def env_sel(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (N,)), jax.random.uniform(k_sel, (N,))])

    return torch.from_numpy(np.array(jax.vmap(env_sel)(keys)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=""):
    """(path, tensor) for every tensor leaf of a state/metrics tree."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, tuple):
        for f, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from _flat(v, f"{prefix}.{f}")


def _bitwise(a, b, label):
    """Every tensor leaf equal bit for bit (NaN where NaN)."""
    for (pa, x), (pb, y) in zip(_flat(a), _flat(b), strict=True):
        assert pa == pb
        assert x.shape == y.shape and x.dtype == y.dtype, (label, pa)
        assert torch.equal(torch.isnan(x), torch.isnan(y)) if x.is_floating_point() else True
        ok = torch.equal(torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0)) \
            if x.is_floating_point() else torch.equal(x, y)
        assert ok, (label, pa)


def _hold_row(want_state, want_mets, got_state, got_mets, label):
    """A batch row against its serial run at JAX's multi-seed tolerances."""
    for f in DISCRETE:
        assert torch.equal(getattr(want_state, f), getattr(got_state, f)), (label, f)
    for f in ("counts", "restarts", "tau"):
        if hasattr(want_state.sched_state, f):
            assert torch.equal(getattr(want_state.sched_state, f),
                               getattr(got_state.sched_state, f)), (label, f)
    assert torch.equal(want_mets["n_success"], got_mets["n_success"]), label
    for k in want_mets:
        np.testing.assert_allclose(got_mets[k].numpy(), want_mets[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{label} {k}")
    for (p, a), (_, b) in zip(_flat(want_state), _flat(got_state), strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{label} {p}")


# ---------------------------------------------------------------------------
# data and tree helpers with a run axis
# ---------------------------------------------------------------------------

def test_batched_loader_reproduces_per_seed_serial_streams():
    """Twin of ``tests/test_fl_round.py:214``: slice b of the stacked (B, R,
    ...) batches is the serial ``FederatedLoader(seed=seeds[b])`` draw, and
    the stream continues aligned; the JAX loader draws the same arrays."""
    cx = np.arange(3 * 24 * 4, dtype=np.float32).reshape(3, 24, 4)
    cy = np.arange(3 * 24).reshape(3, 24) % 10
    seeds = [3, 11, 42]
    bl = BatchedFederatedLoader(cx, cy, batch_size=8, local_epochs=2, seeds=seeds)
    assert bl.n_seeds == len(seeds)
    xs, ys = bl.next_rounds(3)
    assert xs.shape[:2] == (len(seeds), 3)
    x1, y1 = bl.next_round()
    for b, s in enumerate(seeds):
        serial = FederatedLoader(cx, cy, batch_size=8, local_epochs=2, seed=s)
        for t in range(3):
            sx, sy = serial.next_round()
            np.testing.assert_array_equal(xs[b, t], sx)
            np.testing.assert_array_equal(ys[b, t], sy)
        sx, sy = serial.next_round()
        np.testing.assert_array_equal(x1[b], sx)
        np.testing.assert_array_equal(y1[b], sy)
    jx, jy = JaxBatchedLoader(cx, cy, batch_size=8, local_epochs=2, seeds=seeds).next_rounds(3)
    np.testing.assert_array_equal(jx, xs)
    np.testing.assert_array_equal(jy, ys)


def test_tree_flatten_with_a_run_axis():
    g = torch.Generator().manual_seed(0)
    rows = [{"w": torch.randn((3, 4), generator=g), "b": torch.randn(4, generator=g)}
            for _ in range(3)]
    batched = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    flat = tree_flatten_concat(batched, batch_dims=1)
    assert flat.shape == (3, 16)
    for i, r in enumerate(rows):
        assert torch.equal(flat[i], tree_flatten_concat(r))
    back = tree_unflatten_concat(flat, batched, batch_dims=1)
    assert all(torch.equal(back[k], batched[k]) for k in batched)


# ---------------------------------------------------------------------------
# the batched plain versions of the Step-4 kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,m,p,dtype", [(3, 4, 37, torch.float32), (5, 20, 5674, torch.float32),
                                         (2, 7, 129, torch.bfloat16), (1, 3, 8, torch.float32)])
def test_plain_weighted_aggregate_batch_equals_rows(b, m, p, dtype):
    g = torch.Generator().manual_seed(b * 100 + m)
    upd = torch.randn((b, m, p), generator=g).to(dtype)
    scale = torch.rand((b, m), generator=g)
    out = ref.weighted_aggregate(upd, scale)
    assert out.shape == (b, p) and out.dtype == torch.float32
    for i in range(b):
        assert torch.equal(out[i], ref.weighted_aggregate(upd[i], scale[i])), i
    assert torch.equal(ops.weighted_aggregate(upd, scale), out)


def _trim_batch(b, m, p, seed):
    """Half-integer values (ties), NaN, +-inf and +-0 in some rows, a mask a
    run with run 0 empty, and per-run depths: the median, 0 and between."""
    g = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn((b, m, p), generator=g) * 3.0) * 0.5
    x[0, 0, :3] = float("nan")
    x[-1, -1, :4] = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0])
    mask = (torch.rand((b, m), generator=g) < 0.7).to(torch.float32)
    mask[0] = 0.0
    n = mask.sum(-1)
    med = torch.floor((n - 1.0) / 2.0).clamp_min(0.0)
    k = torch.stack([med, torch.zeros_like(med), torch.floor(med / 2)])[torch.arange(b) % 3,
                                                                       torch.arange(b)]
    return x, mask, n, k


def _same_bits(a, b):
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and \
        bool(torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.mark.parametrize("b,m,p", [(4, 5, 41), (6, 20, 300), (3, 64, 33), (1, 9, 17)])
def test_plain_robust_trimmed_batch_equals_rows(b, m, p):
    x, mask, n, k = _trim_batch(b, m, p, seed=b + m)
    out = ref.robust_trimmed(x, mask, n, k)
    assert out.shape == (b, p)
    for i in range(b):
        assert _same_bits(out[i], ref.robust_trimmed(x[i], mask[i], n[i], k[i])), i
    assert not out[0].any()                   # n = 0: zeros
    assert _same_bits(ops.robust_trimmed(x, mask, n, k), out)


def test_plain_robust_trimmed_batch_chunks_leave_the_arithmetic_alone(monkeypatch):
    x, mask, n, k = _trim_batch(5, 8, 77, seed=3)
    whole = ref.robust_trimmed(x, mask, n, k)
    monkeypatch.setattr(ref, "_TRIM_CHUNK_ELEMS", 5 * 8 * 8 * 3)
    assert _same_bits(ref.robust_trimmed(x, mask, n, k), whole)


# ---------------------------------------------------------------------------
# a (B, M, P) CUDA tensor reaches the batch launch, once, or raises
# ---------------------------------------------------------------------------

class _FakeCuda:
    """Stands in for a CUDA tensor (see ``tests/test_torch_port_rules.py``)."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def to(self, *a, **k):
        return self

    def contiguous(self):
        return self

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_batched_aggregation_reaches_the_batch_launch_once(monkeypatch, dtype, code):
    calls = []

    def load(name, symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            calls.append((symbol, args))
            return 0
        return launch

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "stream", lambda index: 4242 + index)
    monkeypatch.setattr(ops.ref, "weighted_aggregate", lambda *a: pytest.fail("plain"))
    monkeypatch.setattr(ops.ref, "robust_trimmed", lambda *a: pytest.fail("plain"))
    before = (wagg_mod.weighted_aggregate.launches, wagg_mod.weighted_aggregate.batch_launches,
              robust_mod.robust_trimmed.launches, robust_mod.robust_trimmed.batch_launches)
    upd = _FakeCuda(torch.zeros((3, 5, 9), dtype=dtype))
    out = ops.weighted_aggregate(upd, _FakeCuda(torch.ones((3, 5))))
    assert out.shape == (3, 9) and out.dtype == torch.float32
    runs = _FakeCuda(torch.full((3,), 5.0))
    out = ops.robust_trimmed(upd, _FakeCuda(torch.ones((3, 5))), runs, runs)
    assert out.shape == (3, 9) and out.dtype == torch.float32
    assert [s for s, _ in calls] == ["weighted_aggregate_batch_launch",
                                     "robust_trimmed_batch_launch"]
    assert calls[0][1][3:7] == (3, 5, 9, code) and calls[1][1][5:9] == (3, 5, 9, code)
    assert all(args[-1] == 4242 + upd.get_device() for _, args in calls)
    after = (wagg_mod.weighted_aggregate.launches, wagg_mod.weighted_aggregate.batch_launches,
             robust_mod.robust_trimmed.launches, robust_mod.robust_trimmed.batch_launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]


def test_batched_aggregation_without_a_library_raises(monkeypatch):
    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    monkeypatch.setattr(ops.ref, "weighted_aggregate", lambda *a: pytest.fail("plain"))
    monkeypatch.setattr(ops.ref, "robust_trimmed", lambda *a: pytest.fail("plain"))
    before = (wagg_mod.weighted_aggregate.launches, robust_mod.robust_trimmed.launches)
    upd = _FakeCuda(torch.zeros((2, 4, 8)))
    with pytest.raises(RuntimeError, match="no library"):
        ops.weighted_aggregate(upd, _FakeCuda(torch.ones((2, 4))))
    runs = _FakeCuda(torch.full((2,), 4.0))
    with pytest.raises(RuntimeError, match="no library"):
        ops.robust_trimmed(upd, _FakeCuda(torch.ones((2, 4))), runs, runs)
    assert (wagg_mod.weighted_aggregate.launches, robust_mod.robust_trimmed.launches) == before


def test_batched_wrappers_refuse_what_the_batch_launch_does_not_take(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the loader"))
    upd = _FakeCuda(torch.zeros((2, 4, 8)))
    with pytest.raises(ValueError, match=r"scale must be a contiguous \(2, 4\)"):
        wagg_mod.weighted_aggregate(upd, _FakeCuda(torch.ones(4)))
    with pytest.raises(ValueError, match=r"mask must be a contiguous \(2, 4\)"):
        robust_mod.robust_trimmed(upd, _FakeCuda(torch.ones(4)), _FakeCuda(torch.ones(2)),
                                  _FakeCuda(torch.ones(2)))
    one = _FakeCuda(torch.tensor(4.0))
    with pytest.raises(ValueError, match=r"n_succ must be a contiguous \(2,\) f32"):
        robust_mod.robust_trimmed(upd, _FakeCuda(torch.ones((2, 4))), one, one)
    with pytest.raises(ValueError, match="must be \\(M, P\\) or \\(B, M, P\\)"):
        wagg_mod.weighted_aggregate(_FakeCuda(torch.zeros((2, 2, 4, 8))),
                                    _FakeCuda(torch.ones((2, 2, 4))))


# ---------------------------------------------------------------------------
# the round's modules with a run axis
# ---------------------------------------------------------------------------

def test_contribution_rows_equal_the_single_run_calls():
    g = torch.Generator().manual_seed(4)
    b, m, p = 3, 5, 11
    buf = ContributionBuffer(torch.randn((b, m, p), generator=g),
                             torch.randn((b, m, p), generator=g),
                             (torch.rand((b, m), generator=g) < 0.6).float())
    buf = buf._replace(fresh=buf.fresh.index_fill(0, torch.tensor([1]), 0.0))  # run 1 unseen
    zeta = torch.rand((b, m), generator=g)
    succ = torch.rand((b, m), generator=g) < 0.5
    new_g, new_p = torch.randn((b, m, p), generator=g), torch.randn((b, m, p), generator=g)
    proxy = lambda flat: (flat ** 2).mean()
    nb = update_buffer(buf, succ, new_g, new_p)
    loo = loo_aggregates(buf, zeta)
    contrib = marginal_contribution(buf, zeta, proxy)
    for i in range(b):
        bi = ContributionBuffer(*(x[i] for x in buf))
        assert all(torch.equal(x[i], y) for x, y in zip(nb, update_buffer(bi, succ[i], new_g[i],
                                                                          new_p[i])))
        assert all(torch.equal(x[i], y) for x, y in zip(loo, loo_aggregates(bi, zeta[i])))
        assert torch.equal(contrib[i], marginal_contribution(bi, zeta[i], proxy))
        assert torch.equal(aggregation_weights(contrib)[i], aggregation_weights(contrib[i]))
    assert torch.equal(contrib[1], torch.ones(m))      # never seen: the prior


@pytest.mark.parametrize("family", ["mean", "trimmed_mean", "coordinate_median", "norm_clip"])
def test_aggregator_rows_equal_the_single_run_calls(family):
    x, mask, n, _ = _trim_batch(4, 6, 29, seed=9)
    x = torch.nan_to_num(x, nan=1.5, posinf=4.0, neginf=-4.0)
    zeta = torch.rand((4, 6), generator=torch.Generator().manual_seed(2))
    agg = tagg.example_aggregator(family)
    out = agg.aggregate(x, mask, zeta, n)
    for i in range(4):
        assert torch.equal(out[i], agg.aggregate(x[i], mask[i], zeta[i], n[i])), i


@pytest.mark.parametrize("family", ["dropout", "nan_grads", "byte_flip", "sign_flip",
                                    "inner_product", "burst"])
def test_fault_rows_equal_the_single_run_calls(family):
    g = torch.Generator().manual_seed(5)
    fault = tfaults.example_fault(family)
    b, m = 3, 5
    upd = torch.randn((b, m, 7), generator=g)
    u = torch.rand((b, fault.n_uniforms(m)), generator=g)
    fstate = torch.tensor([0.0, 1.0, 1.0])
    out, dropped, nxt = fault.inject_sched(u, 4, upd, fstate)
    for i in range(b):
        o, d, s = fault.inject_sched(u[i], 4, upd[i], fstate[i])
        assert _same_bits(out[i].reshape(-1), o.reshape(-1)) and torch.equal(dropped[i], d)
        assert torch.equal(nxt[i], s)
    with pytest.raises(ValueError, match="uniforms"):
        fault.inject(u[:, :-1], 0, upd)


def test_fault_grids_flow_through_one_inject():
    """Twin of ``tests/test_faults.py:100``: a stacked grid of fault knobs
    flows through one ``inject`` over (G, ...) operands, one grid point a
    run, equal to JAX's vmapped inject on the same uniforms."""
    jgrid = [jfaults.make_fault("nan_grads", rate=r) for r in (0.0, 1.0)]
    grid = [convert.fault(f) for f in jgrid]
    sp = convert.hparams(jax_stack_params(jgrid), "cpu")
    assert set(sp) == set(stack_params(grid, "cpu"))
    keys = jax.random.split(KEY, 2)
    u = jnp.ones((2, M, 4))
    jout, _ = jax.vmap(lambda p, k: jgrid[0].inject(k, jnp.array(0), u[0], params=p))(
        jax_stack_params(jgrid), keys)
    tu = torch.from_numpy(np.stack([jax_fault_uniforms(jgrid[0], k, M) for k in keys]))
    out, _ = grid[0].inject(tu, 0, torch.ones((2, M, 4)), params=sp)
    assert [int((~torch.isfinite(o).all(-1)).sum()) for o in out] == [0, M]
    assert _same_bits(out.reshape(-1), _t(jout).reshape(-1))
    per_seed, dropped = tfaults.make_fault("dropout", rate=0.5).inject(
        torch.rand((4, M)), 0, torch.ones((4, M, 4)))
    assert per_seed.shape == (4, M, 4) and dropped.shape == (4, M)


def test_aggregator_grids_flow_through_one_call():
    """Twin of ``tests/test_aggregation.py:105``: a stacked grid of trim
    depths flows through one ``aggregate`` over the round's operands
    repeated a grid point, equal to JAX's vmapped call."""
    jgrid = [jagg.make_aggregator("trimmed_mean", trim_frac=v) for v in (0.0, 0.4)]
    grid = [convert.aggregator(a) for a in jgrid]
    g = np.random.default_rng(1)
    buffers = g.standard_normal((M + 3, 40)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0], np.float32)
    zeta = np.full((M + 3,), 1.0 / (M + 3), np.float32)
    n = np.float32(mask.sum())
    jout = jax.vmap(lambda p: jgrid[0].aggregate(jnp.asarray(buffers), jnp.asarray(mask),
                                                 jnp.asarray(zeta), jnp.asarray(n), params=p))(
        jax_stack_params(jgrid))
    rep = lambda a: torch.from_numpy(np.stack([a, a]))
    out = grid[0].aggregate(rep(buffers), rep(mask), rep(zeta), rep(n),
                            params=convert.hparams(jax_stack_params(jgrid), "cpu"))
    assert out.shape == (2, buffers.shape[1])
    assert not torch.equal(out[0], out[1])
    np.testing.assert_allclose(out.numpy(), np.array(jout), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the engine: batch of 1, seeds, shared operands
# ---------------------------------------------------------------------------

def test_fl_batch1_bitwise_matches_serial_run(fl):
    """Twin of ``tests/test_sim_engine.py:226``: every state leaf and metric."""
    tr = fl["trainer"]()
    bx, by = fl["batches"]([0])
    u = _uniforms(_keys())
    st_s, mets_s = tr.run(tr.init(_tparams(fl)), _t(bx[0]), _t(by[0]), uniforms=u)
    st_b, mets_b = simulate_fl_batch(tr, tr.init_batch(_tparams(fl), 1), _t(bx), _t(by),
                                     uniforms=u[None])
    _bitwise(st_s, _row(st_b, 0), "state")
    _bitwise(mets_s, _row(mets_b, 0), "metrics")
    assert mets_b["mean_aoi"].shape == (1, R)


def test_fl_batch_multi_seed_matches_per_seed_serial(fl):
    tr = fl["trainer"]()
    seeds = [0, 7, 23]
    bx, by = fl["batches"](seeds)
    u = torch.stack([_uniforms(_keys(tag=i)) for i in range(len(seeds))])
    st_b, mets_b = simulate_fl_batch(tr, tr.init_batch(_tparams(fl), 3), _t(bx), _t(by),
                                     uniforms=u)
    assert mets_b["n_success"].shape == (3, R) and st_b.t == R
    for i in range(len(seeds)):
        st_s, mets_s = tr.run(tr.init(_tparams(fl)), _t(bx[i]), _t(by[i]), uniforms=u[i])
        _hold_row(st_s, mets_s, _row(st_b, i), _row(mets_b, i), f"seed {i}")


def test_fl_batch_broadcasts_data_over_seeds(fl):
    """One data stream shared by B seeds (``data_axis=None``), per-seed
    uniforms: distinct trajectories, equal to the stream tiled."""
    tr = fl["trainer"]()
    b = 3
    bx, by = fl["batches"]([0])
    u = torch.stack([_uniforms(_keys(tag=i)) for i in range(b)])
    states = tr.init_batch(_tparams(fl), b)
    st_b, mets_b = simulate_fl_batch(tr, states, _t(bx[0]), _t(by[0]), uniforms=u,
                                     data_axis=None)
    assert mets_b["mean_aoi"].shape == (b, R) and st_b.t == R
    aoi = mets_b["mean_aoi"]
    assert not (torch.equal(aoi[0], aoi[1]) and torch.equal(aoi[0], aoi[2]))
    tiled = lambda x: _t(x).expand(b, *x.shape[1:]).contiguous()
    st_t, mets_t = simulate_fl_batch(tr, states, tiled(bx), tiled(by), uniforms=u)
    _bitwise(mets_b, mets_t, "metrics")
    _bitwise(st_b, st_t, "state")


def test_fl_batch_shares_uniforms_and_draws_them_from_the_generator(fl):
    tr = fl["trainer"]()
    bx, by = fl["batches"]([0, 1])
    u = _uniforms(_keys())
    states = tr.init_batch(_tparams(fl), 2)
    shared = simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=u, uniforms_axis=None)
    tiled = simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=u.expand(2, *u.shape))
    _bitwise(shared, tiled, "shared uniforms")
    drawn = simulate_fl_batch(tr, states, _t(bx), _t(by), generator=torch.Generator().manual_seed(3))
    given = simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=torch.rand(
        (2, R, 2, N), generator=torch.Generator().manual_seed(3)))
    _bitwise(drawn, given, "drawn uniforms")


def test_batched_round_rows_equal_the_serial_round(fl):
    """``round`` itself takes the run axis: a batched state, (B, ...) data
    and (B, N) uniforms; each row is the serial round on its run."""
    tr = fl["trainer"]()
    bx, by = fl["batches"]([0, 5])
    u = torch.stack([_uniforms(_keys(tag=i)) for i in range(2)])
    st, mets = tr.round(tr.init_batch(_tparams(fl), 2), _t(bx[:, 0]), _t(by[:, 0]),
                        u_env=u[:, 0, 0], u_sel=u[:, 0, 1])
    for i in range(2):
        s1, m1 = tr.round(tr.init(_tparams(fl)), _t(bx[i, 0]), _t(by[i, 0]),
                          u_env=u[i, 0, 0], u_sel=u[i, 0, 1])
        _hold_row(s1, m1, _row(st, i), _row(mets, i), f"run {i}")


@pytest.mark.parametrize("kind", ["piecewise", "adversarial", "reactive"])
def test_stacked_envs_each_run_its_own(fl, kind):
    """``env_axis=0``: each run against its own env (the per-round means of
    a stacked segment or table env, a reactive env's load a run)."""
    g = lambda s: torch.Generator().manual_seed(s)
    if kind == "piecewise":
        envs = [make_piecewise(torch.rand((3, N), generator=g(s)) * 0.8 + 0.1,
                               torch.tensor([2, 4]), **CPU) for s in range(3)]
    elif kind == "adversarial":
        envs = [random_adversarial_env(g(s), N, R, flip_prob=0.2, **CPU) for s in range(3)]
    else:
        proc = make_scenario("reactive_jammer", base=make_scenario(
            "piecewise", n_channels=N, horizon=R, n_breakpoints=2), horizon=R, strength=0.9)
        envs = [proc.realize(g(s), "cpu") for s in range(3)]
    tr = fl["trainer"](env=envs[0])
    bx, by = fl["batches"]([0, 1, 2])
    u = torch.stack([_uniforms(_keys(tag=i)) for i in range(3)])
    st_b, mets_b = simulate_fl_batch(tr, tr.init_batch(_tparams(fl), 3), _t(bx), _t(by),
                                     uniforms=u, envs=stack_envs(envs), env_axis=0)
    for i, env in enumerate(envs):
        tri = fl["trainer"](env=env)
        st_s, mets_s = tri.run(tri.init(_tparams(fl)), _t(bx[i]), _t(by[i]), uniforms=u[i])
        _hold_row(st_s, mets_s, _row(st_b, i), _row(mets_b, i), f"{kind} run {i}")
        assert torch.equal(st_s.env_state, st_b.env_state[i])
    if kind == "reactive":
        assert bool((st_b.env_state > 0).any())


def test_a_shared_env_is_broadcast(fl):
    envs = realize_processes([make_scenario("piecewise", n_channels=N, horizon=R,
                                            n_breakpoints=2)] * 1,
                             [torch.Generator().manual_seed(4)], "cpu")
    env = dataclasses.replace(envs, means=envs.means[0], breaks=envs.breaks[0],
                              table=envs.table[0], react=envs.react[0])
    tr = fl["trainer"]()
    bx, by = fl["batches"]([0, 1])
    u = torch.stack([_uniforms(_keys(tag=i)) for i in range(2)])
    states = tr.init_batch(_tparams(fl), 2)
    shared = simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=u, envs=env)
    stacked = simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=u,
                                envs=stack_envs([env, env]), env_axis=0)
    _bitwise(shared, stacked, "shared env")


@pytest.mark.parametrize("cell", [("sign_flip", "trimmed_mean"), ("burst", "coordinate_median"),
                                  ("inner_product", "norm_clip"), ("nan_grads", None),
                                  ("dropout", "mean")])
def test_faulty_batch_rows_equal_serial(fl, cell):
    fam, agg = cell
    fault = tfaults.example_fault(fam)
    tr = fl["trainer"](faults=fault, aggregator=None if agg is None else
                       tagg.example_aggregator(agg))
    bx, by = fl["batches"]([0, 1, 2])
    g = torch.Generator().manual_seed(8)
    u = torch.rand((3, R, 2, N), generator=g)
    fu = torch.rand((3, R, tr.n_fault_uniforms()), generator=g)
    states = tr.init_batch(_tparams(fl), 3)
    states = states._replace(fault_state=torch.tensor([0.0, 1.0, 0.0]))
    st_b, mets_b = simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=u, fault_uniforms=fu)
    for i in range(3):
        s0 = tr.init(_tparams(fl))._replace(fault_state=states.fault_state[i])
        st_s, mets_s = tr.run(s0, _t(bx[i]), _t(by[i]), uniforms=u[i], fault_uniforms=fu[i])
        _hold_row(st_s, mets_s, _row(st_b, i), _row(mets_b, i), f"{cell} run {i}")


def test_init_batch_forms(fl):
    tr = fl["trainer"]()
    p = _tparams(fl)
    shared = tr.init_batch(p, 3)
    stacked = tr.init_batch({k: v.expand(3, *v.shape).clone() for k, v in p.items()}, 3,
                            params_axis=0)
    _bitwise(shared, stacked, "params forms")
    one = tr.init(p)
    for f in ("buffers", "aoi", "zeta", "env_state", "staleness", "fault_state"):
        assert torch.equal(getattr(shared, f)[2], getattr(one, f)), f
    assert shared.t == 0 and shared.sched_state.counts.shape == (3, N)
    grid = stack_params([GLRCUCB(N, M, history=32, gamma=g) for g in (0.5, 1.0, 2.0)], "cpu")
    tuned = tr.init_batch(p, 3, hp=grid, hp_axis=0)
    assert torch.equal(tuned.sched_state.hp["gamma"], torch.tensor([0.5, 1.0, 2.0]))
    with pytest.raises(ValueError, match="params_axis=0"):
        tr.init_batch(p, 3, params_axis=0)
    with pytest.raises(ValueError, match="hp_axis=0 needs"):
        tr.init_batch(p, 3, hp_axis=0)
    with pytest.raises(ValueError, match="0 or None"):
        tr.init_batch(p, 3, params_axis=1)


def test_simulate_fl_batch_checks_its_operands(fl):
    tr = fl["trainer"]()
    bx, by = fl["batches"]([0, 1])
    states = tr.init_batch(_tparams(fl), 2)
    with pytest.raises(ValueError, match="must be batched"):
        simulate_fl_batch(tr, tr.init(_tparams(fl)), _t(bx[0]), _t(by[0]))
    with pytest.raises(ValueError, match="0 or None"):
        simulate_fl_batch(tr, states, _t(bx), _t(by), data_axis=1)
    with pytest.raises(ValueError, match="stacked envs for a batch of 2"):
        simulate_fl_batch(tr, states, _t(bx), _t(by), envs=stack_envs([tr.env] * 3),
                          env_axis=0)
    with pytest.raises(ValueError, match="env_axis=0 takes a stacked env"):
        simulate_fl_batch(tr, states, _t(bx), _t(by), envs=tr.env, env_axis=0)
    with pytest.raises(ValueError, match="uniforms must be"):
        simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=torch.rand((2, R, 2, N + 1)))
    with pytest.raises(ValueError, match="batches_x"):
        simulate_fl_batch(tr, states, _t(bx[:1]), _t(by[:1]))
    with pytest.raises(TypeError, match="ChannelEnv"):
        simulate_fl_batch(tr, states, _t(bx), _t(by), envs=make_scenario(
            "piecewise", n_channels=N, horizon=R, n_breakpoints=1), env_axis=None)


# ---------------------------------------------------------------------------
# JAX against the port on JAX's draws
# ---------------------------------------------------------------------------

def _hold_jax(tstate, tmets, jstate, jmets, label):
    np.testing.assert_array_equal(tmets["n_success"].numpy(), np.array(jmets["n_success"]),
                                  err_msg=label)
    np.testing.assert_allclose(tmets["mean_aoi"].numpy(), np.array(jmets["mean_aoi"]),
                               rtol=1e-6, err_msg=label)
    for k in ("local_loss", "zeta_max", "aoi_var"):
        np.testing.assert_allclose(tmets[k].numpy(), np.array(jmets[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{label} {k}")
    for f in ("aoi", "has_update", "last_success", "staleness", "fault_state"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.array(getattr(jstate, f)),
                                      err_msg=f"{label} {f}")
    for f in ("counts", "restarts", "tau"):
        np.testing.assert_array_equal(getattr(tstate.sched_state, f).numpy(),
                                      np.array(getattr(jstate.sched_state, f)),
                                      err_msg=f"{label} {f}")
    for k in tstate.params:
        np.testing.assert_allclose(tstate.params[k].numpy(), np.array(jstate.params[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{label} params {k}")
    np.testing.assert_allclose(tstate.zeta.numpy(), np.array(jstate.zeta), rtol=1e-6, atol=1e-6,
                               err_msg=f"{label} zeta")


def test_fl_batch_matches_jax_simulate_fl_batch(fl):
    """Three seeds, own data and round keys: the port's batch on the
    uniforms behind JAX's keys against JAX's ``simulate_fl_batch``, and
    JAX's batched state carried across by ``convert`` starts the port's
    batch where JAX's stands."""
    seeds = [0, 7, 23]
    bx, by = fl["batches"](seeds)
    rkeys = jnp.stack([_keys(tag=i) for i in range(len(seeds))])
    jtr = fl["jax_trainer"]()
    jparams = {k: jnp.asarray(v) for k, v in fl["params"].items()}
    init_keys = jnp.stack([jax.random.fold_in(KEY, 10 + i) for i in range(len(seeds))])
    jst, jm = jax_simulate_fl_batch(jtr, jtr.init_batch(jparams, init_keys), jnp.asarray(bx),
                                    jnp.asarray(by), rkeys)
    tr = fl["trainer"]()
    u = torch.stack([_uniforms(rkeys[i]) for i in range(len(seeds))])
    tst, tm = simulate_fl_batch(tr, tr.init_batch(_tparams(fl), 3), _t(bx), _t(by), uniforms=u)
    _hold_jax(tst, tm, jst, jm, "batch")

    # continue from JAX's batched state on both sides: two more rounds
    bx2, by2 = fl["batches"](seeds, r=R + 2)
    rk2 = jnp.stack([_keys(R + 2, tag=i)[R:] for i in range(len(seeds))])
    jst2, jm2 = jax_simulate_fl_batch(jtr, jst, jnp.asarray(bx2[:, R:]), jnp.asarray(by2[:, R:]),
                                      rk2)
    carried = convert.async_fl_state(jst, "cpu")
    assert carried.t == R and carried.aoi.shape == (3, M)
    u2 = torch.stack([_uniforms(rk2[i]) for i in range(len(seeds))])
    tst2, tm2 = simulate_fl_batch(tr, carried, _t(bx2[:, R:]), _t(by2[:, R:]), uniforms=u2)
    _hold_jax(tst2, tm2, jst2, jm2, "carried")


def test_fl_batch_hp_grid_matches_per_value_serial_and_jax():
    """The parity parts of ``tests/test_hp_grid.py:275``: three (gamma,
    delta) points of GLR-CUCB as one batch (data and round uniforms shared,
    ``data_axis=None``, ``uniforms_axis=None``); each grid point equals the
    port's serial run of a trainer with those values, and JAX's batch row.
    The JAX test's last line, that the three points' trajectories differ,
    is not asserted: on these inputs all three give the same 5-round mean
    AoI, [1.25, 1.75, 1.0, 1.25, 1.0], in both packages (the premise of
    that line, not the batched engine, fails there)."""
    m, n, r = 4, 6, 5
    k1, k2 = jax.random.split(KEY)
    jparams = {"w": jax.random.normal(k1, (8, 10)) * 0.2, "b": jnp.zeros(10)}

    def jloss(p, x, y):
        lg = jax.nn.log_softmax(x @ p["w"] + p["b"])
        return -jnp.mean(jnp.take_along_axis(lg, y[:, None].astype(jnp.int32), 1))

    def tloss(p, x, y):
        lg = torch.log_softmax(x @ p["w"] + p["b"], dim=-1)
        return -torch.gather(lg, -1, y[..., None].to(torch.int64)).mean()

    points = [(0.7, 1e-2), (1.0, 1e-3), (1.3, 1e-4)]
    jrep = JaxGLRCUCB(n, m, history=32)
    jgrid = [jrep.replace_traced(gamma=g, delta=d) for g, d in points]
    bx = jax.random.normal(k2, (r, m, 1, 8, 8))
    by = jax.random.randint(jax.random.fold_in(k2, 1), (r, m, 1, 8), 0, 10)
    rkeys = jnp.stack([jax.random.fold_in(KEY, 50 + t) for t in range(r)])
    jcfg = JaxConfig(n_clients=m, n_channels=n, local_epochs=1, client_lr=0.1, server_lr=0.1)
    jenv = jax_stationary(jnp.linspace(0.9, 0.2, n))
    jtr = JaxTrainer(jcfg, jrep, jenv, jloss)
    jst, jm = jax_simulate_fl_batch(
        jtr, jtr.init_batch(jparams, jnp.stack([KEY] * 3), hp=jax_stack_params(jgrid), hp_axis=0),
        bx, by, rkeys, data_axis=None, key_axis=None)

    cfg = AsyncFLConfig(n_clients=m, n_channels=n, local_epochs=1, client_lr=0.1, server_lr=0.1)
    env = make_stationary(np.array(jnp.linspace(0.9, 0.2, n)), **CPU)
    grid = [GLRCUCB(n, m, history=32).replace_traced(gamma=g, delta=d) for g, d in points]
    tr = AsyncFLTrainer(cfg, GLRCUCB(n, m, history=32), env, tloss, **CPU)
    tparams = convert.params(jparams, "cpu")
    u = torch.from_numpy(np.array(jax.vmap(lambda k: jnp.stack([
        jax.random.uniform(jax.random.split(k)[0], (n,)),
        jax.random.uniform(jax.random.split(k)[1], (n,))]))(rkeys)))
    states = tr.init_batch(tparams, 3, hp=stack_params(grid, "cpu"), hp_axis=0)
    st_b, mets_b = simulate_fl_batch(tr, states, _t(bx), _t(by), uniforms=u, data_axis=None,
                                     uniforms_axis=None)
    for i, sched in enumerate(grid):
        tri = AsyncFLTrainer(cfg, sched, env, tloss, **CPU)
        st_s, mets_s = tri.run(tri.init(tparams), _t(bx), _t(by), uniforms=u)
        _hold_row(st_s, mets_s, _row(st_b, i), _row(mets_b, i), f"grid[{i}]")
        np.testing.assert_allclose(mets_b["mean_aoi"][i].numpy(), np.array(jm["mean_aoi"][i]),
                                   rtol=1e-6, err_msg=f"grid[{i}] vs JAX")
        np.testing.assert_array_equal(mets_b["n_success"][i].numpy(),
                                      np.array(jm["n_success"][i]))
        for k in st_b.params:
            np.testing.assert_allclose(st_b.params[k][i].numpy(), np.array(jst.params[k][i]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"grid[{i}] params {k}")
    assert torch.equal(st_b.sched_state.hp["gamma"], torch.tensor([p[0] for p in points]))


def test_byzantine_batch_matches_jax(fl, monkeypatch):
    """A burst(sign_flip) x coordinate-median cell, two seeds: the port's
    batch (one ``robust_trimmed`` call a round for both runs) on the
    uniforms behind JAX's round and fault keys against JAX's batch."""
    jf = jfaults.make_fault("burst", base=jfaults.make_fault("sign_flip", rate=0.4, scale=6.0),
                            p_on=0.4, p_off=0.3)
    ja = jagg.make_aggregator("coordinate_median")
    jtr = fl["jax_trainer"](faults=jf, aggregator=ja)
    bx, by = fl["batches"]([3, 4])
    rkeys = jnp.stack([_keys(tag=5 + i) for i in range(2)])
    jparams = {k: jnp.asarray(v) for k, v in fl["params"].items()}
    jst, jm = jax_simulate_fl_batch(jtr, jtr.init_batch(jparams, jnp.stack([KEY, KEY])),
                                    jnp.asarray(bx), jnp.asarray(by), rkeys)
    tr = fl["trainer"](faults=convert.fault(jf), aggregator=convert.aggregator(ja))
    u = torch.stack([_uniforms(rkeys[i]) for i in range(2)])
    fu = torch.from_numpy(np.stack([np.stack([
        jax_fault_uniforms(jf, jax.random.fold_in(k, FAULT_TAG), M) for k in rkeys[i]])
        for i in range(2)]))
    calls, real = [], ops.robust_trimmed
    monkeypatch.setattr(ops, "robust_trimmed", lambda *a: calls.append(a[0].shape) or real(*a))
    tst, tm = simulate_fl_batch(tr, tr.init_batch(_tparams(fl), 2), _t(bx), _t(by),
                                uniforms=u, fault_uniforms=fu)
    assert calls == [(2, M, tst.buffers.shape[-1])] * R
    _hold_jax(tst, tm, jst, jm, "burst+coordinate_median")
