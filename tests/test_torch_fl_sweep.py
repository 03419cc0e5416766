"""FL cases in the port's sweep driver (``repro_torch.sim.sweep``) on the CPU.

Twins of the eight tests of ``tests/test_fl_sweep.py`` and of the mixed
sweep of ``tests/test_sim_engine.py``:

* scenario realization: an ``FLSweepCase`` whose trainer holds an
  unrealized process draws its channel table from
  ``scenario_realize_generator(case.seed)``, per case; a trainer built
  without ``realize_generator`` warns;
* value-based bucketing: trainers bucket by ``bucket_signature()`` (config,
  scheduler ``hp_signature``, env structure, loss identity, fault and
  aggregator values), so separately built equal trainers, and trainers
  that differ only in traced scheduler scalars or env values, share one
  bucket, each case with its own values;
* ``sweep(shard=True)`` runs FL buckets through ``sharded_fl_batch``, bit
  for bit the unsharded sweep on one device;
* a sweep mixes FL and regret cases, and a case of another kind raises.

A bucket of one case equals the serial run bit for bit (JAX's guarantee);
a case of a larger bucket is held as JAX holds it, its discrete leaves
and ``n_success`` bit for bit, its floats at rtol 1e-6 / atol 1e-7.  One
bucket is also held against JAX's ``sweep`` on JAX's draws.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.channels import make_stationary as jax_stationary  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro.sim.sweep import FLSweepCase as JaxFLSweepCase  # noqa: E402
from repro.sim.sweep import sweep as jax_sweep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.aggregation import make_aggregator  # noqa: E402
from repro_torch.core.channels import (  # noqa: E402
    make_scenario,
    make_stationary,
    scenario_realize_generator,
)
from repro_torch.core.faults import make_fault  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.data import BatchedFederatedLoader, make_federated_classification  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    FLSweepCase,
    SweepCase,
    clear_sweep_cache,
    group_cases,
    sweep,
    sweep_cache_stats,
)
from test_torch_fl_batch import _bitwise, _flat, _t  # noqa: E402

KEY = jax.random.PRNGKey(0)
M, NCH, R = 4, 6, 6
CPU = dict(device="cpu")


def _loss(p, x, y):
    lg = torch.log_softmax(x @ p["w"] + p["b"], dim=-1)
    return -torch.gather(lg, -1, y[..., None].to(torch.int64)).mean()


def _jax_loss(p, x, y):
    lg = jax.nn.log_softmax(x @ p["w"] + p["b"])
    return -jnp.mean(jnp.take_along_axis(lg, y[:, None].astype(jnp.int32), 1))


@pytest.fixture(scope="module")
def setup():
    cx, cy, *_ = make_federated_classification(M, samples_per_client=32, n_classes=4, dim=8,
                                              alpha=0.3)
    k1, _ = jax.random.split(KEY)
    params = {"w": np.array(jax.random.normal(k1, (8, 4)) * 0.2), "b": np.zeros(4, np.float32)}

    def batches(seed, r=R):
        bx, by = BatchedFederatedLoader(cx, cy, batch_size=4, local_epochs=1,
                                        seeds=[seed]).next_rounds(r)
        return _t(bx[0]), _t(by[0])

    return convert.params(params, "cpu"), batches


def _cfg():
    return AsyncFLConfig(n_clients=M, n_channels=NCH, local_epochs=1, client_lr=0.1,
                         server_lr=0.1)


def _scenario(family="piecewise"):
    if family == "gilbert_elliott":
        return make_scenario("gilbert_elliott", n_channels=NCH, horizon=R)
    return make_scenario("piecewise", n_channels=NCH, horizon=R, n_breakpoints=2)


def _env():
    return make_stationary(np.linspace(0.9, 0.2, NCH).astype(np.float32), **CPU)


def _trainer(sched=None, env=None, **kw):
    return AsyncFLTrainer(_cfg(), sched or tb.GLRCUCB(NCH, M, history=32),
                          env if env is not None else _env(), _loss, **CPU, **kw)


def _case(name, tr, params, seed, batches, **kw):
    bx, by = batches(seed)
    return FLSweepCase(name, tr, params, seed, bx, by, **kw)


def _serial(case, trainer=None):
    """The case's serial run: ``run`` with the case's generator."""
    tr = trainer or case.trainer
    return tr.run(tr.init(case.params), case.batches_x, case.batches_y,
                  generator=torch.Generator().manual_seed(case.seed))


def _hold(want, got, label):
    st, mets = want
    for f in ("aoi", "has_update", "last_success", "staleness", "fault_state"):
        assert torch.equal(getattr(st, f), getattr(got["state"], f)), (label, f)
    assert torch.equal(mets["n_success"], got["metrics"]["n_success"]), label
    for k in mets:
        np.testing.assert_allclose(got["metrics"][k].numpy(), mets[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=f"{label} {k}")
    for (p, a), (_, b) in zip(_flat(st), _flat(got["state"]), strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{label} {p}")


# ---------------------------------------------------------------------------
# scenario realization
# ---------------------------------------------------------------------------

def test_process_env_without_realize_generator_warns(setup):
    with pytest.warns(UserWarning, match="realize_generator="):
        _trainer(env=_scenario())


def test_process_env_with_realize_generator_does_not_warn(setup):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _trainer(env=_scenario(), realize_generator=scenario_realize_generator(0, "cpu"))


def test_fl_sweep_cases_draw_distinct_scenario_realizations(setup):
    """Two cases of one scenario trainer with the same data and uniforms:
    only the seed's realization differs, and so do the trajectories."""
    params, batches = setup
    tr = _trainer(env=_scenario(), realize_generator=scenario_realize_generator(0, "cpu"))
    bx, by = batches(0)
    u = torch.rand((R, 2, NCH), generator=torch.Generator().manual_seed(9))
    cases = [FLSweepCase(f"s{i}", tr, params, i, bx, by, uniforms=u) for i in (1, 2)]
    assert len(group_cases(cases)) == 1
    results, report = sweep(cases, block=False, **CPU)
    assert report[0].route == "fl" and report[0].batch == 2
    assert not torch.equal(results["s1"]["metrics"]["n_success"],
                           results["s2"]["metrics"]["n_success"])


@pytest.mark.parametrize("family", ["piecewise", "gilbert_elliott"])
def test_fl_sweep_scenario_serial_matches_sweep(setup, family):
    """A 1-case scenario bucket equals, bit for bit, the serial trainer built
    with ``realize_generator=scenario_realize_generator(seed)``; in a bucket
    of three, each case equals its own serial trainer."""
    params, batches = setup
    tr_sweep = _trainer(env=_scenario(family),
                        realize_generator=scenario_realize_generator(0, "cpu"))
    solo = _case("solo", tr_sweep, params, 5, batches)
    results, _ = sweep([solo], block=False, **CPU)
    tr_serial = _trainer(env=_scenario(family),
                         realize_generator=scenario_realize_generator(5, "cpu"))
    st, mets = _serial(solo, tr_serial)
    _bitwise(st, results["solo"]["state"], "state")
    _bitwise(mets, results["solo"]["metrics"], "metrics")

    cases = [_case(f"c{s}", tr_sweep, params, s, batches) for s in (3, 4, 6)]
    results, report = sweep(cases, block=False, **CPU)
    assert [r.batch for r in report] == [3]
    for c in cases:
        tr_c = _trainer(env=_scenario(family),
                        realize_generator=scenario_realize_generator(c.seed, "cpu"))
        _hold(_serial(c, tr_c), results[c.name], c.name)


# ---------------------------------------------------------------------------
# value-based bucketing
# ---------------------------------------------------------------------------

def test_equal_valued_trainer_instances_share_one_bucket(setup):
    params, batches = setup
    cases = [_case(f"tw{i}", _trainer(), params, i, batches) for i in (0, 1)]
    assert cases[0].trainer.bucket_signature() == cases[1].trainer.bucket_signature()
    assert [len(b) for b in group_cases(cases)] == [2]
    results, report = sweep(cases, block=False, **CPU)
    assert report[0].batch == 2
    for c in cases:
        _hold(_serial(c), results[c.name], c.name)


def test_traced_scalar_grid_shares_bucket_with_correct_per_case_values(setup):
    """Trainers that differ only in GLR-CUCB's gamma share a bucket, and
    each case trains with its own value."""
    params, batches = setup
    cases = [_case(f"g{g}", _trainer(tb.GLRCUCB(NCH, M, gamma=g, history=32)), params, 0,
                   batches) for g in (0.5, 2.0)]
    assert [len(b) for b in group_cases(cases)] == [2]
    results, _ = sweep(cases, block=False, **CPU)
    for c in cases:
        _hold(_serial(c), results[c.name], c.name)
        assert float(results[c.name]["state"].sched_state.hp["gamma"]) == \
            c.trainer.scheduler.gamma


def test_env_values_share_a_bucket_and_stay_per_case(setup):
    params, batches = setup
    envs = [make_stationary(np.linspace(a, 0.2, NCH).astype(np.float32), **CPU)
            for a in (0.9, 0.5)]
    cases = [_case(f"e{i}", _trainer(env=e), params, 1, batches) for i, e in enumerate(envs)]
    assert [len(b) for b in group_cases(cases)] == [2]
    results, _ = sweep(cases, block=False, **CPU)
    for c in cases:
        _hold(_serial(c), results[c.name], c.name)


def test_structurally_different_trainers_stay_separate(setup):
    params, batches = setup
    pairs = [(_trainer(tb.GLRCUCB(NCH, M, history=32)), _trainer(tb.GLRCUCB(NCH, M, history=64))),
             (_trainer(faults=make_fault("sign_flip", rate=0.2)),
              _trainer(faults=make_fault("sign_flip", rate=0.3))),
             (_trainer(aggregator=make_aggregator("coordinate_median")), _trainer()),
             (_trainer(tb.RandomScheduler(NCH, M)), _trainer())]
    for a, b in pairs:
        cases = [_case("ha", a, params, 0, batches), _case("hb", b, params, 0, batches)]
        assert [len(bk) for bk in group_cases(cases)] == [1, 1]


def test_sharded_fl_sweep_bitwise_identical_to_unsharded(setup):
    params, batches = setup
    cases = [_case(f"sh{i}", _trainer(), params, i, batches) for i in (0, 1, 2)]
    plain, _ = sweep(cases, block=False, **CPU)
    sharded, report = sweep(cases, block=False, shard=True, **CPU)
    assert all(r.sharded and r.route == "fl" for r in report)
    for name in plain:
        _bitwise(plain[name]["state"], sharded[name]["state"], name)
        _bitwise(plain[name]["metrics"], sharded[name]["metrics"], name)


# ---------------------------------------------------------------------------
# mixed sweeps, faults, the bucket report, JAX
# ---------------------------------------------------------------------------

def test_sweep_buckets_fl_cases_alongside_regret(setup):
    """Twin of ``tests/test_sim_engine.py``'s mixed sweep: FL cases bucket
    per trainer signature, regret cases as before, each result its serial
    run's."""
    params, batches = setup
    tr_a, tr_b = _trainer(), _trainer(tb.RandomScheduler(NCH, M))
    env = make_stationary(np.linspace(0.9, 0.1, 5).astype(np.float32), **CPU)
    cases = [_case("fl-a0", tr_a, params, 0, batches), _case("fl-a1", tr_a, params, 7, batches),
             _case("fl-b0", tr_b, params, 0, batches),
             SweepCase("regret-0", tb.RandomScheduler(5, 2), env, 0, 200),
             SweepCase("regret-1", tb.RandomScheduler(5, 2), env, 2, 200)]
    assert sorted(len(b) for b in group_cases(cases)) == [1, 2, 2]
    clear_sweep_cache()
    results, report = sweep(cases, **CPU)
    assert set(results) == {c.name for c in cases}
    assert sum(b.batch for b in report) == 5
    assert sorted(r.route for r in report) == ["fl", "fl", "rounds"]
    assert sweep_cache_stats() == {"hits": 0, "misses": 3}
    for c in cases[:2]:
        _hold(_serial(c), results[c.name], c.name)
    st, mets = _serial(cases[2])
    _bitwise(st, results["fl-b0"]["state"], "fl-b0")
    _bitwise(mets, results["fl-b0"]["metrics"], "fl-b0")
    for c in cases[3:]:
        want = simulate_aoi_regret(c.scheduler, env, 200, **CPU,
                                   uniforms=c.draw_uniforms(torch.device("cpu")))
        assert torch.equal(want["final_regret"], results[c.name]["final_regret"])
    sweep(cases[:2], **CPU)
    assert sweep_cache_stats() == {"hits": 1, "misses": 3}


def test_faulty_fl_cases_carry_their_fault_uniforms(setup):
    """A Byzantine bucket: given uniforms and fault uniforms ride the batch;
    a case without them draws both from its seed, uniforms first."""
    params, batches = setup
    fault = make_fault("burst", base=make_fault("sign_flip", rate=0.4), p_on=0.4, p_off=0.3)
    tr = _trainer(faults=fault, aggregator=make_aggregator("trimmed_mean", trim_frac=0.3))
    g = torch.Generator().manual_seed(2)
    u, fu = torch.rand((R, 2, NCH), generator=g), torch.rand((R, tr.n_fault_uniforms()),
                                                             generator=g)
    cases = [_case("given", tr, params, 0, batches, uniforms=u, fault_uniforms=fu),
             _case("drawn", tr, params, 3, batches)]
    results, report = sweep(cases, block=False, **CPU)
    assert [r.batch for r in report] == [2]
    c = cases[0]
    _hold(tr.run(tr.init(params), c.batches_x, c.batches_y, uniforms=u, fault_uniforms=fu),
          results["given"], "given")
    _hold(_serial(cases[1]), results["drawn"], "drawn")
    with pytest.raises(ValueError, match="fault_uniforms"):
        sweep([_case("half", tr, params, 0, batches, uniforms=u)], **CPU)


def test_fl_sweep_matches_jax_sweep(setup):
    """One bucket of three GLR-CUCB cases against JAX's ``sweep`` of the
    same cases: the port's cases carry the uniforms behind JAX's round
    keys.  n_success, AoI and ``has_update`` bit for bit, mean AoI at rtol
    1e-6, params at rtol 1e-5 / atol 1e-6."""
    params, batches = setup
    jtr = JaxTrainer(JaxConfig(n_clients=M, n_channels=NCH, local_epochs=1, client_lr=0.1,
                               server_lr=0.1), JaxGLRCUCB(NCH, M, history=32),
                     jax_stationary(jnp.linspace(0.9, 0.2, NCH)), _jax_loss)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    keys = {s: jnp.stack([jax.random.fold_in(KEY, 100 * s + t) for t in range(R)])
            for s in (0, 1, 2)}
    jcases = [JaxFLSweepCase(f"j{s}", jtr, jparams, jax.random.fold_in(KEY, s),
                             jnp.asarray(batches(s)[0].numpy()),
                             jnp.asarray(batches(s)[1].numpy()), keys[s]) for s in keys]
    jres, _ = jax_sweep(jcases, block=False)

    def u_of(ks):
        return torch.from_numpy(np.array(jax.vmap(lambda k: jnp.stack([
            jax.random.uniform(jax.random.split(k)[0], (NCH,)),
            jax.random.uniform(jax.random.split(k)[1], (NCH,))]))(ks)))

    tr = _trainer()
    cases = [_case(f"j{s}", tr, params, s, batches, uniforms=u_of(keys[s])) for s in keys]
    results, _ = sweep(cases, block=False, **CPU)
    for c in cases:
        got, want = results[c.name], jres[c.name]
        np.testing.assert_array_equal(got["metrics"]["n_success"].numpy(),
                                      np.array(want["metrics"]["n_success"]))
        np.testing.assert_allclose(got["metrics"]["mean_aoi"].numpy(),
                                   np.array(want["metrics"]["mean_aoi"]), rtol=1e-6)
        for f in ("aoi", "has_update"):
            np.testing.assert_array_equal(getattr(got["state"], f).numpy(),
                                          np.array(getattr(want["state"], f)))
        for k in got["state"].params:
            np.testing.assert_allclose(got["state"].params[k].numpy(),
                                       np.array(want["state"].params[k]), rtol=1e-5, atol=1e-6)


def test_fl_case_on_another_device_raises(setup):
    params, batches = setup
    with pytest.raises(ValueError, match="trainer is on cpu"):
        sweep([_case("x", _trainer(), params, 0, batches)], device="meta")
