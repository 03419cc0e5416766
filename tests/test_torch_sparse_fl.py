"""The sparse client axis (``repro_torch.fl.sparse``) and the M > N repair.

Within the port: the twin of ``tests/test_sparse_fl.py``'s eight cases
(the sparse trainer equals the dense one bit for bit at M = N when the
dense trainer replays the sparse batch draw, clean and under NaN faults;
``always_on`` is inert; churn, quarantine, staleness and eviction
invariants; the client placement is inert), ``run_served`` against
``run()`` bit for bit, and a batch of runs (``init_batch``) against its
serial runs (discrete state bitwise, floats at rtol 1e-5 / atol 1e-6: the
nested ``vmap`` makes the linear model's matvec another product).

Against the JAX package, on JAX's own randomness (the uniforms behind
``k_env, k_sel = split(key)``, ``fold_in(key, 0xFA17)`` and
``fold_in(key, 0xA7A1)``; the batch indices of JAX's
``client_batch_indices`` on ``fold_in(key, 0xDA7A)``):

* a 10-round run at N = 40 clients, M = 8 slots over 6 channels (M > the
  channel count, as ``fl_substrate``), under ``markov_churn`` and
  ``NaNGradFaults``: the selection, slot maps, availability, AoI,
  ``has_update``, ``last_success``, staleness, bandit counts and the
  per-round ``n_success`` / ``n_evicted`` / ``n_available`` bitwise; the
  mean AoI at rtol 1e-6 (JAX's f32 mean against the port's f64 mean
  rounded once); params, buffers, contributions, zeta and the other
  metrics at rtol 1e-5 / atol 1e-6 (torch autograd against ``jax.grad``,
  sums in another order), as ``tests/test_torch_fl_round.py``;
* the stable top-M at N = 2,000 (all ties; a -inf mask with fewer
  available clients than slots) equals ``jax.lax.top_k``'s pick;
* GLR-CUCB (alpha 0 and 0.5) and Lyapunov at N = 16 channels, M = 64
  clients select, match and update bit for bit like JAX over 50 rounds
  (the parent raised ``IndexError``); M-Exp3 raises where JAX raises;
* ``exact_shapley`` and ``heterogeneity_index`` against JAX's (rtol 1e-6;
  the index bitwise).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.availability import MarkovChurn as JaxMarkovChurn  # noqa: E402
from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.bandits import LyapunovSched as JaxLyapunov  # noqa: E402
from repro.core.bandits import MExp3 as JaxMExp3  # noqa: E402
from repro.core.channels import make_stationary as jax_make_stationary  # noqa: E402
from repro.core.contribution import exact_shapley as jax_exact_shapley  # noqa: E402
from repro.core.faults import NaNGradFaults as JaxNaNGradFaults  # noqa: E402
from repro.core.matching import AdaptiveMatcher as JaxMatcher  # noqa: E402
from repro.data.dirichlet import dirichlet_partition as jax_partition  # noqa: E402
from repro.data.dirichlet import heterogeneity_index as jax_heterogeneity  # noqa: E402
from repro.data.pipeline import client_batch_indices as jax_batch_indices  # noqa: E402
from repro.fl import SparseAsyncFLTrainer as JaxSparseTrainer  # noqa: E402
from repro.fl import SparseFLConfig as JaxSparseConfig  # noqa: E402
from repro_torch.core.availability import AlwaysOn, MarkovChurn  # noqa: E402
from repro_torch.core.bandits import (  # noqa: E402
    GLRCUCB,
    LyapunovSched,
    MExp3,
    RandomScheduler,
)
from repro_torch.core.channels import make_scenario, make_stationary  # noqa: E402
from repro_torch.core.contribution import exact_shapley  # noqa: E402
from repro_torch.core.faults import NaNGradFaults  # noqa: E402
from repro_torch.core.matching import AdaptiveMatcher  # noqa: E402
from repro_torch.data import (  # noqa: E402
    client_batch_indices,
    dirichlet_partition,
    gather_client_batches,
    heterogeneity_index,
)
from repro_torch.fl import (  # noqa: E402
    AsyncFLConfig,
    AsyncFLTrainer,
    SparseAsyncFLTrainer,
    SparseFLConfig,
)
from repro_torch.sim import (  # noqa: E402
    SchedServer,
    init_slots,
    shard_clients,
    shard_slots,
    sweep_mesh,
)

from test_torch_availability import AVAIL_TAG, jax_avail_uniforms  # noqa: E402
from test_torch_faults import FAULT_TAG, jax_fault_uniforms  # noqa: E402

DATA_TAG = 0xDA7A
KEY = jax.random.PRNGKey(0)
D, NEX, B, E = 4, 12, 3, 2


def _loss(p, x, y):
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


def _jax_loss(p, x, y):
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def _params():
    return {"w": torch.zeros(D), "b": torch.zeros(())}


def _client_data(n, seed=0):
    rng = np.random.default_rng(seed)
    # continuous targets: local gradients are nonzero almost surely
    return (rng.normal(size=(n, NEX, D)).astype(np.float32),
            rng.normal(size=(n, NEX)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _flat(tree):
    if isinstance(tree, tuple):
        return [x for f in tree for x in _flat(f)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _equal(x, y):
    """Bit for bit, NaN where NaN."""
    if isinstance(x, int):
        return x == y
    if x.is_floating_point():
        nan = torch.isnan(x)
        return torch.equal(nan, torch.isnan(y)) and torch.equal(x[~nan], y[~nan])
    return torch.equal(x, y)


def _same(a, b, what):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert _equal(x, y), what


def _sparse(n, m, nch, env, sched=None, **kw):
    cfg = {k: kw.pop(k) for k in list(kw) if k in SparseFLConfig.__dataclass_fields__}
    return SparseAsyncFLTrainer(
        SparseFLConfig(n_clients=n, n_sched=m, n_channels=nch, batch_size=B,
                       **{"local_epochs": 1, **cfg}),
        sched or RandomScheduler(nch, m), env, _loss, device="cpu", **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the batch draw on the device
# ---------------------------------------------------------------------------

def test_client_batch_indices_are_a_function_of_seed_round_and_client():
    n, n_ex = 50, 7
    ids = torch.arange(n)
    dense = client_batch_indices(3, 5, ids, n_ex, E, B)
    assert dense.shape == (n, E, B) and dense.dtype == torch.int64
    assert int(dense.min()) >= 0 and int(dense.max()) < n_ex
    sub = torch.tensor([41, 2, 17])
    assert torch.equal(client_batch_indices(3, 5, sub, n_ex, E, B), dense[sub])
    assert not torch.equal(client_batch_indices(4, 5, ids, n_ex, E, B), dense)
    assert not torch.equal(client_batch_indices(3, 6, ids, n_ex, E, B), dense)
    # a batch of seeds: each row is its seed's draw
    seeds = torch.tensor([3, 9])
    rows = client_batch_indices(seeds, 5, torch.stack([sub, sub + 1]), n_ex, E, B)
    assert torch.equal(rows[0], dense[sub])
    assert torch.equal(rows[1], client_batch_indices(9, 5, sub + 1, n_ex, E, B))
    # roughly uniform over the examples (20000 draws, 7 bins)
    big = client_batch_indices(0, 0, torch.arange(10_000), n_ex, 1, 2).reshape(-1)
    counts = torch.bincount(big, minlength=n_ex).double()
    assert float(((counts - 20_000 / n_ex) ** 2 / (20_000 / n_ex)).sum()) < 30.0
    cx, cy = _t(*_client_data(n))
    bx, by = gather_client_batches(cx, cy, sub, dense[sub])
    assert torch.equal(bx[1, 1, 2], cx[2, dense[2, 1, 2]])
    assert torch.equal(by[0, 0, 1], cy[41, dense[41, 0, 1]])


# ---------------------------------------------------------------------------
# dense parity at M = N (within the port)
# ---------------------------------------------------------------------------

def _dense_batches(cx, cy, rounds, seed=0):
    """The dense side's round data: the sparse draw over all N ids."""
    ids = torch.arange(cx.shape[0])
    bxs, bys = zip(*[gather_client_batches(cx, cy, ids, client_batch_indices(
        seed, r, ids, cx.shape[1], E, B)) for r in range(rounds)])
    return torch.stack(bxs), torch.stack(bys)


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "nan_faults"])
def test_sparse_reproduces_dense_bitwise_at_m_equals_n(faulty):
    n, nch, r = 6, 8, 10
    cx, cy = _t(*_client_data(n))
    faults = NaNGradFaults(rate=0.3) if faulty else None
    proc = make_scenario("piecewise", n_channels=nch, horizon=r, n_breakpoints=2)
    common = dict(staleness_cap=3, max_update_norm=50.0)
    dense = AsyncFLTrainer(AsyncFLConfig(n_clients=n, n_channels=nch, local_epochs=E, **common),
                           GLRCUCB(nch, n, history=32), proc, _loss, device="cpu",
                           faults=faults, realize_generator=_gen(77))
    sparse = _sparse(n, n, nch, proc, GLRCUCB(nch, n, history=32), local_epochs=E,
                     faults=faults, realize_generator=_gen(77), **common)
    g = _gen(9)
    u = torch.rand((r, 2, nch), generator=g)
    fu = torch.rand((r, 2 * n), generator=g) if faulty else None
    bx, by = _dense_batches(cx, cy, r)
    ds, dm = dense.run(dense.init(_params()), bx, by, uniforms=u, fault_uniforms=fu)
    ss, sm = sparse.run(sparse.init(_params()), cx, cy, uniforms=u, fault_uniforms=fu)
    for f in ("params", "buffers", "has_update", "last_success", "aoi", "staleness",
              "contrib", "zeta", "contrib_buf", "sched_state", "env_state", "fault_state"):
        _same(getattr(ds, f), getattr(ss, f), f)
    for k in dm:
        assert _equal(dm[k], sm[k]), k
    # the selection was the identity every round
    assert torch.equal(ss.slot_clients, torch.arange(n))
    assert torch.equal(ss.slot_of, torch.arange(n))
    assert float(dm["n_success"].sum()) > 0


def test_always_on_availability_is_bitwise_inert():
    n, m, nch, r = 24, 4, 6, 8
    cx, cy = _t(*_client_data(n))
    env = make_stationary(torch.linspace(0.9, 0.3, nch), device="cpu")
    u = torch.rand((r, 2, nch), generator=_gen(1))
    runs = []
    for avail in (None, AlwaysOn()):
        tr = _sparse(n, m, nch, env, GLRCUCB(nch, m, history=32), local_epochs=E,
                     availability=avail)
        runs.append(tr.run(tr.init(_params()), cx, cy, uniforms=u))
    (s0, m0), (s1, m1) = runs
    for f in ("params", "aoi", "buffers", "slot_clients", "slot_of", "avail"):
        _same(getattr(s0, f), getattr(s1, f), f)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


# ---------------------------------------------------------------------------
# sparse regime: M << N
# ---------------------------------------------------------------------------

def test_sparse_run_finite_and_serves_population_under_churn():
    n, m, nch, r = 64, 4, 6, 40
    cx, cy = _t(*_client_data(n))
    tr = _sparse(n, m, nch, make_stationary(torch.linspace(0.9, 0.4, nch), device="cpu"),
                 GLRCUCB(nch, m, history=32), staleness_cap=5,
                 availability=MarkovChurn(p_drop=0.1, p_rejoin=0.5))
    st, mets = tr.run(tr.init(_params()), cx, cy, rounds=r, generator=_gen(1))
    for leaf in (*st.params.values(), st.aoi, st.zeta, mets["local_loss"]):
        assert bool(torch.isfinite(leaf).all())
    assert float(mets["n_success"].sum()) > 0
    assert float(mets["n_available"].min()) < n          # churn took clients away
    # AoI-driven priorities spread grants across the population
    assert int((st.aoi < r).sum()) > n // 2
    owners = st.slot_clients.tolist()
    assert len(set(owners)) == m
    for j, c in enumerate(owners):
        assert int(st.slot_of[c]) == j
    assert int((st.slot_of >= 0).sum()) == m


def test_all_quarantined_rounds_are_bitwise_noop_and_regrant():
    """Every upload quarantined (absurd norm cap): params stay bitwise at
    init, nothing aggregates, and the rejected clients re-enter S_t."""
    n, m, nch, r = 16, 4, 6, 12
    cx, cy = _t(*_client_data(n))
    good = make_stationary(torch.full((nch,), 1.0), device="cpu")
    tr = _sparse(n, m, nch, good, max_update_norm=1e-12)
    st0 = tr.init(_params())
    st, mets = tr.run(st0, cx, cy, rounds=r, generator=_gen(0))
    _same(st0.params, st.params, "params")
    assert float(mets["n_success"].sum()) == 0.0
    assert bool((st.last_success[st.slot_clients] == 1.0).all())
    assert bool((st.has_update[st.slot_clients] == 0.0).all())


def test_quarantined_nan_client_regrants_and_population_recovers():
    n, m, nch, r = 16, 4, 6, 48
    cx, cy = _t(*_client_data(n))
    tr = _sparse(n, m, nch, make_stationary(torch.full((nch,), 0.95), device="cpu"),
                 faults=NaNGradFaults(rate=0.3))
    st, mets = tr.run(tr.init(_params()), cx, cy, rounds=r, generator=_gen(5))
    for leaf in st.params.values():
        assert bool(torch.isfinite(leaf).all())
    assert float(mets["n_success"].sum()) > 0
    assert bool((st.aoi < r).all()), st.aoi      # no starvation


def test_buffer_age_is_distinct_from_aoi_under_sparse_scheduling():
    n, m, nch, r = 16, 4, 6, 10
    cx, cy = _t(*_client_data(n))
    tr = _sparse(n, m, nch, make_stationary(torch.zeros(nch), device="cpu"))
    st, mets = tr.run(tr.init(_params()), cx, cy, rounds=r, generator=_gen(0))
    assert float(mets["n_success"].sum()) == 0.0
    assert torch.equal(st.aoi, torch.full((n,), r + 1.0))
    assert bool((st.staleness < st.aoi).any()) and not torch.equal(st.staleness, st.aoi)


def test_shard_clients_placement_is_bitwise_inert():
    n, m, nch, r = 32, 4, 6, 6
    cx, cy = _t(*_client_data(n))
    tr = _sparse(n, m, nch, make_stationary(torch.linspace(0.9, 0.3, nch), device="cpu"))
    u = torch.rand((r, 2, nch), generator=_gen(2))
    plain = tr.run(tr.init(_params()), cx, cy, uniforms=u)
    cx_s, cy_s = shard_clients((cx, cy), sweep_mesh(["cpu"]))
    _same(plain, tr.run(tr.init(_params()), cx_s, cy_s, uniforms=u), "sharded run")
    with pytest.raises(ValueError, match="one card"):
        shard_clients((cx, cy), sweep_mesh(["cpu", "cpu"]))
    slots = init_slots(GLRCUCB(nch, m, history=32), 4, 0.5, device="cpu")
    _same(shard_slots(slots, sweep_mesh(["cpu"])), slots, "placed slots")
    with pytest.raises(ValueError, match="one card"):
        shard_slots(slots, sweep_mesh(["cpu", "cpu"]))


def test_run_checks_its_operands():
    n, m, nch = 12, 3, 5
    cx, cy = _t(*_client_data(n))
    tr = _sparse(n, m, nch, make_stationary(torch.full((nch,), 0.5), device="cpu"),
                 availability=MarkovChurn())
    st = tr.init(_params())
    assert tr.n_avail_uniforms() == 2 * n and tr.n_fault_uniforms() == 0
    with pytest.raises(ValueError, match="rounds"):
        tr.run(st, cx, cy)
    with pytest.raises(ValueError, match="avail_uniforms"):
        tr.run(st, cx, cy, uniforms=torch.rand(2, 2, nch))
    with pytest.raises(ValueError, match="uniforms must be"):
        tr.run(st, cx, cy, uniforms=torch.rand(2, 2, nch + 1),
               avail_uniforms=torch.rand(2, 2 * n))
    with pytest.raises(ValueError, match="batch_indices must be"):
        tr.run(st, cx, cy, rounds=2, generator=_gen(0),
               batch_indices=torch.zeros((2, n, 1, B + 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="fault_uniforms"):
        tr.run(st, cx, cy, rounds=2, generator=_gen(0), fault_uniforms=torch.rand(2, m))


# ---------------------------------------------------------------------------
# run_served and the run axis (within the port)
# ---------------------------------------------------------------------------

def test_sparse_run_served_matches_run_bitwise():
    n, m, nch, r = 10, 4, 8, 12
    cx, cy = _t(*_client_data(n))
    proc = make_scenario("piecewise", n_channels=nch, horizon=r, n_breakpoints=2)
    tr = _sparse(n, m, nch, proc, GLRCUCB(nch, m, history=32), local_epochs=E,
                 staleness_cap=3, realize_generator=_gen(77),
                 availability=MarkovChurn(p_drop=0.2, p_rejoin=0.5))
    g = _gen(9)
    u, au = torch.rand((r, 2, nch), generator=g), torch.rand((r, 2 * n), generator=g)
    ref_s, ref_m = tr.run(tr.init(_params()), cx, cy, uniforms=u, avail_uniforms=au)
    server = SchedServer(tr.scheduler, capacity=4, slots=2, use_matching=True,
                         matcher_beta=tr.cfg.matcher_beta, device="cpu")
    server.join("job")
    srv_s, srv_m = tr.run_served(tr.init(_params()), cx, cy, server, "job", uniforms=u,
                                 avail_uniforms=au)
    for f in ref_s._fields:
        if f != "sched_state":
            _same(getattr(ref_s, f), getattr(srv_s, f), f)
    _same(ref_s.sched_state, server.tenant_state("job").sched_state, "server sched_state")
    for k in ref_m:
        assert torch.equal(ref_m[k], srv_m[k]), k
    assert float(ref_m["n_success"].sum()) > 0
    with pytest.raises(ValueError, match="dims"):     # the server's M must be n_sched
        tr.run_served(tr.init(_params()), cx, cy,
                      SchedServer(GLRCUCB(nch, n, history=32), use_matching=True,
                                  device="cpu"), "job", uniforms=u, avail_uniforms=au)


def test_batched_run_rows_equal_serial_runs():
    n, m, nch, r, b = 20, 4, 6, 8, 3
    cx, cy = _t(*_client_data(n))
    tr = _sparse(n, m, nch, make_stationary(torch.linspace(0.9, 0.3, nch), device="cpu"),
                 GLRCUCB(nch, m, history=32), availability=MarkovChurn(p_drop=0.2),
                 faults=NaNGradFaults(rate=0.2))
    g = _gen(4)
    u = torch.rand((b, r, 2, nch), generator=g)
    fu = torch.rand((b, r, 2 * m), generator=g)
    au = torch.rand((b, r, 2 * n), generator=g)
    seeds = torch.tensor([0, 5, 11])
    bs, bm = tr.run(tr.init_batch(_params(), b), cx, cy, uniforms=u, fault_uniforms=fu,
                    avail_uniforms=au, data_seed=seeds)
    assert bs.aoi.shape == (b, n) and bm["n_success"].shape == (b, r)
    for i in range(b):
        ss, sm = tr.run(tr.init(_params()), cx, cy, uniforms=u[i], fault_uniforms=fu[i],
                        avail_uniforms=au[i], data_seed=int(seeds[i]))
        for f in ("slot_clients", "slot_of", "has_update", "last_success", "aoi",
                  "staleness", "avail", "avail_state", "fault_state"):
            _same(getattr(ss, f), {k: v[i] for k, v in getattr(bs, f).items()}
                  if f == "avail_state" else getattr(bs, f)[i], f)
        for k in ("n_success", "n_evicted", "n_available", "mean_aoi"):
            assert torch.equal(sm[k], bm[k][i]), k
        for x, y in zip(_flat((ss.params, ss.buffers, ss.contrib, ss.zeta, sm)),
                        _flat(({k: v[i] for k, v in bs.params.items()}, bs.buffers[i],
                               bs.contrib[i], bs.zeta[i], {k: v[i] for k, v in bm.items()}))):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_operands(jtr, keys, n, m, nch):
    """The port's operands behind JAX's round keys: (R, 2, nch) uniforms,
    fault and availability uniforms, (R, N, E, B) batch indices."""
    ids = jnp.arange(n, dtype=jnp.int32)
    u, fu, au, bi = [], [], [], []
    for k in keys:
        k_env, k_sel = jax.random.split(k)
        u.append(np.stack([np.array(jax.random.uniform(k_env, (nch,))),
                           np.array(jax.random.uniform(k_sel, (nch,)))]))
        fu.append(jax_fault_uniforms(jtr.faults, jax.random.fold_in(k, FAULT_TAG), m))
        au.append(jax_avail_uniforms(jtr.availability, jax.random.fold_in(k, AVAIL_TAG), n))
        bi.append(np.array(jax_batch_indices(jax.random.fold_in(k, DATA_TAG), ids, NEX,
                                             jtr.cfg.local_epochs, B)).astype(np.int64))
    return _t(*(np.stack(x) for x in (u, fu, au, bi)))


def test_ten_round_run_matches_jax():
    n, m, nch, r = 40, 8, 6, 10
    cx, cy = _client_data(n, seed=3)
    means = np.linspace(0.9, 0.3, nch).astype(np.float32)
    cfg = dict(n_clients=n, n_sched=m, n_channels=nch, batch_size=B, local_epochs=E,
               staleness_cap=4, max_update_norm=50.0)
    jtr = JaxSparseTrainer(JaxSparseConfig(**cfg), JaxGLRCUCB(nch, m, history=32),
                           jax_make_stationary(jnp.asarray(means)), _jax_loss,
                           faults=JaxNaNGradFaults(rate=0.2),
                           availability=JaxMarkovChurn(p_drop=0.2, p_rejoin=0.5))
    keys = jax.random.split(jax.random.PRNGKey(9), r)
    jparams = {"w": jnp.zeros((D,), jnp.float32), "b": jnp.zeros((), jnp.float32)}
    js, jm = jtr.run(jtr.init(jparams, KEY), jnp.asarray(cx), jnp.asarray(cy), keys)

    u, fu, au, bi = _jax_operands(jtr, keys, n, m, nch)
    tr = SparseAsyncFLTrainer(SparseFLConfig(**cfg), GLRCUCB(nch, m, history=32),
                              make_stationary(torch.from_numpy(means), device="cpu"), _loss,
                              device="cpu", faults=NaNGradFaults(rate=0.2),
                              availability=MarkovChurn(p_drop=0.2, p_rejoin=0.5))
    ts, tm = tr.run(tr.init(_params()), *_t(cx, cy), uniforms=u, fault_uniforms=fu,
                    avail_uniforms=au, batch_indices=bi)

    eq = lambda a, b, what: np.testing.assert_array_equal(np.asarray(a), np.array(b),
                                                          err_msg=what)
    close = lambda a, b, what, rtol=1e-5: np.testing.assert_allclose(
        np.asarray(a), np.array(b), rtol=rtol, atol=1e-6, err_msg=what)
    for f in ("slot_clients", "slot_of", "has_update", "last_success", "aoi", "staleness",
              "avail"):
        eq(getattr(ts, f).numpy(), getattr(js, f), f)
    for f in ("phase", "timer"):
        eq(ts.avail_state[f].numpy(), js.avail_state[f], f)
    for f in ("counts", "cum", "total", "base", "tau", "restarts"):
        eq(getattr(ts.sched_state, f).numpy(), getattr(js.sched_state, f), f)
    assert ts.t == int(js.t) == r
    for k in ("n_success", "n_evicted", "n_available"):
        eq(tm[k].numpy(), jm[k], k)
    close(tm["mean_aoi"].numpy(), jm["mean_aoi"], "mean_aoi", rtol=1e-6)
    for k in ("local_loss", "aoi_var", "beta_t", "zeta_max"):
        close(tm[k].numpy(), jm[k], k)
    for k in ("w", "b"):
        close(ts.params[k].numpy(), js.params[k], k)
    for f in ("buffers", "contrib", "zeta"):
        close(getattr(ts, f).numpy(), getattr(js, f), f)
    for f in ("grads", "params", "fresh"):
        close(getattr(ts.contrib_buf, f).numpy(), getattr(js.contrib_buf, f), f)
    for a, b in zip(ts.matcher_state, js.matcher_state):
        close(a.numpy(), b, "matcher_state")
    close(ts.sched_state.mu_tilde.numpy(), js.sched_state.mu_tilde, "mu_tilde")
    # the run exercised what it is meant to: churn, faults, eviction, aggregation
    assert float(tm["n_available"].min()) < n and float(tm["n_evicted"].sum()) > 0
    assert float(tm["n_success"].sum()) > 0


@pytest.mark.parametrize("case", ["ties", "masked", "mixed"])
def test_stable_top_m_matches_jax_top_k(case):
    n, m, nch = 2000, 64, 16
    rng = np.random.default_rng(5)
    cfg = dict(n_clients=n, n_sched=m, n_channels=nch, batch_size=B)
    jtr = JaxSparseTrainer(JaxSparseConfig(**cfg), JaxGLRCUCB(nch, m, history=16),
                           jax_make_stationary(jnp.full((nch,), 0.5)), _jax_loss)
    tr = SparseAsyncFLTrainer(SparseFLConfig(**cfg), GLRCUCB(nch, m, history=16),
                              make_stationary(torch.full((nch,), 0.5), device="cpu"), _loss,
                              device="cpu")
    contrib = np.ones(n, np.float32)
    aoi = np.ones(n, np.float32)
    avail = np.ones(n, np.float32)
    if case == "masked":                  # fewer available clients than slots
        avail = (rng.random(n) < 0.02).astype(np.float32)
        assert 0 < avail.sum() < m
    if case == "mixed":                   # tied groups of priorities, a mask
        contrib = rng.integers(1, 4, n).astype(np.float32)
        aoi = rng.integers(1, 6, n).astype(np.float32)
        avail = (rng.random(n) < 0.5).astype(np.float32)
    js = jtr.init({"w": jnp.zeros((D,)), "b": jnp.zeros(())}, KEY)._replace(
        contrib=jnp.asarray(contrib), aoi=jnp.asarray(aoi), avail=jnp.asarray(avail))
    ts = tr.init(_params())._replace(
        contrib=torch.from_numpy(contrib), aoi=torch.from_numpy(aoi),
        avail=torch.from_numpy(avail))
    want = np.array(jtr._select(js))
    got = tr._select(ts).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "ties":
        np.testing.assert_array_equal(got, np.arange(m))
    if case == "masked":
        assert set(np.flatnonzero(avail)) <= set(got.tolist())


def _mn_sched(kind):
    if kind == "glr":
        return JaxGLRCUCB(16, 64, history=128), GLRCUCB(16, 64, history=128)
    if kind == "glr-alpha":
        return (JaxGLRCUCB(16, 64, history=128, alpha=0.5),
                GLRCUCB(16, 64, history=128, alpha=0.5))
    return JaxLyapunov(16, 64), LyapunovSched(16, 64)


@pytest.mark.parametrize("kind", ["glr", "glr-alpha", "lyapunov"])
def test_m_greater_than_n_scheduling_matches_jax(kind):
    """16 channels scheduled over 64 clients (``fl_substrate``'s shape): the
    assignment repeats channels; select, match and update equal JAX's."""
    n, m, rounds = 16, 64, 50
    jsched, tsched = _mn_sched(kind)
    means = np.linspace(0.9, 0.3, n).astype(np.float32)
    contrib = np.random.default_rng(1).random(m).astype(np.float32)
    jst, tst = jsched.init(KEY), tsched.init("cpu")
    jm, tm = JaxMatcher(0.5).init(), AdaptiveMatcher(0.5).init("cpu")
    # JAX's select and match compiled (fast); its update eager, as the policy
    # runs alone (compiled, XLA contracts ``rho * x + y`` into an FMA)
    jselect, jscores = jax.jit(jsched.select), jax.jit(jsched.channel_scores)
    jmatch = jax.jit(JaxMatcher(0.5).match)
    aoi = np.ones(m, np.float32)
    for t in range(rounds):
        k_env, k_sel = jax.random.split(jax.random.fold_in(KEY, t))
        u_env = np.array(jax.random.uniform(k_env, (n,)))
        ch_states = (u_env < means).astype(np.float32)
        jch, jaux = jselect(jst, jnp.asarray(t), k_sel, jnp.asarray(aoi))
        tch, taux = tsched.select(tst, t, torch.from_numpy(
            np.array(jax.random.uniform(k_sel, (n,)))), torch.from_numpy(aoi))
        np.testing.assert_array_equal(tch.numpy(), np.array(jch), err_msg=f"select {t}")
        ja, jm = jmatch(jm, jch, jscores(jst, jnp.asarray(t)), jnp.asarray(contrib),
                        jnp.asarray(aoi))
        ta, tm = AdaptiveMatcher(0.5).match(tm, tch, tsched.channel_scores(tst, t),
                                            torch.from_numpy(contrib), torch.from_numpy(aoi))
        np.testing.assert_array_equal(ta.numpy(), np.array(ja), err_msg=f"match {t}")
        rewards = ch_states[np.array(ja)]
        jst = jsched.update(jst, jnp.asarray(t), ja, jnp.asarray(rewards), jaux)
        tst = tsched.update(tst, t, ta, torch.from_numpy(rewards), taux)
        for f in tst._fields:
            if f != "hp":
                np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                              np.array(getattr(jst, f)), err_msg=f"{f} {t}")
        aoi = np.where(rewards > 0.5, 1.0, aoi + 1.0).astype(np.float32)
    assert len(set(np.array(ja).tolist())) == n      # every channel in use


def test_m_greater_than_n_mexp3_raises_like_jax():
    with pytest.raises(ValueError):
        JaxMExp3(16, 64).select(JaxMExp3(16, 64).init(KEY), jnp.asarray(0),
                                jax.random.PRNGKey(1), jnp.ones(64))
    sched = MExp3(16, 64)
    with pytest.raises(ValueError, match="M > N"):
        sched.select(sched.init("cpu"), 0, torch.rand(16), torch.ones(64))


def test_exact_shapley_matches_jax():
    w = np.array([1.0, 2.0, 3.0, 0.5], np.float32)

    def jutil(mask):
        return jnp.sum(mask * w) + 0.7 * mask[0] * mask[1] - 0.3 * mask[2] * mask[3]

    def tutil(mask):
        return (mask * torch.from_numpy(w)).sum() + 0.7 * mask[0] * mask[1] \
            - 0.3 * mask[2] * mask[3]

    want = np.array(jax_exact_shapley(jutil, 4))
    got = exact_shapley(tutil, 4, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    total = float(tutil(torch.ones(4)) - tutil(torch.zeros(4)))
    np.testing.assert_allclose(float(got.sum()), total, rtol=1e-5)   # efficiency


def test_heterogeneity_index_matches_jax():
    labels = np.random.default_rng(0).integers(0, 10, 2000)
    for alpha in (100.0, 0.05):
        parts = dirichlet_partition(labels, 8, alpha, seed=2)
        jparts = jax_partition(labels, 8, alpha, seed=2)
        assert heterogeneity_index(parts, labels) == jax_heterogeneity(jparts, labels)
    h_iid = heterogeneity_index(dirichlet_partition(labels, 8, 100.0, seed=2), labels)
    h_skew = heterogeneity_index(dirichlet_partition(labels, 8, 0.05, seed=2), labels)
    assert h_skew > h_iid
