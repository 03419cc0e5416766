"""The scenario subsystem across the port's engines, with every family.

The cases of the JAX package's ``tests/test_scenarios.py`` on the port: a
mixed-family grid of the four table families (Gilbert-Elliott, mobility,
shadowing, jamming over a piecewise base) buckets into one sweep bucket,
as JAX's ``group_cases`` buckets the same scenarios; segment and table
scenarios split by form; scenarios differing only in traced knobs share a
bucket; sweep results over process cases equal the serial
``simulate_aoi_regret`` runs realized from
``scenario_realize_generator(seed)`` bit for bit (grid-of-many and
grid-of-1), and so does a sharded bucket; the ``random_*_env`` shims are
their families' realizations; two knob values realize apart from one
generator; the batch engine refuses an unrealized process and the serial
harness realizes one; the Sec.-V matcher's score source follows the env's
hint.

The FL trainer: it accepts an unrealized ``ChannelProcess`` and realizes it
from ``realize_generator`` (or, with a warning, from a generator seeded 0),
keeping the process as ``scenario``; and three rounds on JAX's realized
reactive env, carried across, equal JAX's trainer on the same uniforms at
the tolerances ``chip_smoke.py`` phase 4 holds the card to: ``n_success``,
the per-client AoI and the detector's counts bit for bit, the mean AoI and
the interaction carry at rtol 1e-6 (XLA's ``mean``, and its fused
multiply-add in the load update), the rest at rtol 1e-4 / atol 1e-5.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro.core import channels as jc  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro.sim import SweepCase as JaxSweepCase  # noqa: E402
from repro.sim import group_cases as jax_group_cases  # noqa: E402
from repro.utils.tree import tree_unflatten_concat as jax_unflatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core import channels as tc  # noqa: E402
from repro_torch.core.matching import matcher_scores  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.data import FederatedLoader, make_federated_classification  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402
from repro_torch.sim import SweepCase, group_cases, simulate_aoi_regret_batch, sweep  # noqa: E402
from repro_torch.utils.tree import tree_unflatten_concat  # noqa: E402
from test_torch_fl_round import _jax_loss, _torch_loss  # noqa: E402
from test_torch_sim_engine import _bitwise  # noqa: E402

N, M, T = 5, 2, 120
CPU = dict(device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _table_scenarios(p):
    """One scenario per table family, one (T, N): a mixed-family grid (``p``
    the channels package, the port's or JAX's)."""
    return [p.GilbertElliottProcess(N, T, p_gb=0.03), p.MobilityDriftProcess(N, T, amplitude=0.25),
            p.ShadowingProcess(N, T, rho=0.9),
            p.JammingOverlay(base=p.PiecewiseProcess(N, T, 2), strength=0.8)]


def _names(buckets):
    return [[c.name for c in b] for b in buckets]


# ---------------------------------------------------------------------------
# bucketing: families merge per canonical form, as JAX's sweep merges them
# ---------------------------------------------------------------------------

def test_mixed_family_scenarios_share_one_bucket():
    s = tb.GLRCUCB(N, M, history=32, detector_stride=4)
    cases = [SweepCase(f"c{i}", s, p, i, T) for i, p in enumerate(_table_scenarios(tc))]
    assert _names(group_cases(cases)) == [["c0", "c1", "c2", "c3"]]


def test_buckets_follow_jax_across_forms():
    """Table, segment and reactive scenarios split by form exactly as the
    JAX sweep's grouping splits the same scenarios."""
    def scenarios(p):
        return _table_scenarios(p) + [
            p.PiecewiseProcess(N, T, 2), p.StationaryProcess(N),
            p.LoadCongestionProcess(N, T), p.GilbertElliottProcess(N, T, p_gb=0.2),
            p.ReactiveJammerProcess(base=p.PiecewiseProcess(N, T, 2)),
            p.AdversarialProcess(N, T), p.PiecewiseProcess(N, T, 2, min_gap=0.1)]

    s, js = tb.GLRCUCB(N, M, history=32), jb.GLRCUCB(N, M, history=32)
    tcases = [SweepCase(f"c{i}", s, p, i, T) for i, p in enumerate(scenarios(tc))]
    jcases = [JaxSweepCase(f"c{i}", js, p, jax.random.PRNGKey(i), T)
              for i, p in enumerate(scenarios(jc))]
    assert _names(group_cases(tcases)) == _names(jax_group_cases(jcases))
    assert _names(group_cases(tcases)) == [["c0", "c1", "c2", "c3", "c7"], ["c4", "c10"],
                                           ["c5"], ["c6", "c8"], ["c9"]]


def test_traced_scenario_params_share_a_bucket():
    s, base = tb.MExp3(N, M), tc.GilbertElliottProcess(N, T)
    cases = [SweepCase(f"p{v}", s, base.replace_traced(p_gb=v), i, T)
             for i, v in enumerate((0.01, 0.05, 0.2))]
    assert len(group_cases(cases)) == 1


# ---------------------------------------------------------------------------
# sweep parity with the serial harness
# ---------------------------------------------------------------------------

def _serial(s, case):
    return simulate_aoi_regret(s, case.env, case.horizon, uniforms=case.draw_uniforms("cpu"),
                               generator=tc.scenario_realize_generator(case.seed, "cpu"), **CPU)


def test_sweep_scenario_results_match_serial_bitwise():
    s = tb.GLRCUCB(N, M, history=32, detector_stride=4)
    cases = [SweepCase(f"c{i}", s, p, 10 + i, T) for i, p in enumerate(_table_scenarios(tc))]
    results, report = sweep(cases, **CPU)
    assert len(report) == 1 and report[0].batch == 4
    for c in cases:
        _bitwise(_serial(s, c), results[c.name], c.name)


def test_sweep_scenario_grid_of_1_bitwise():
    s, proc = tb.MExp3(N, M), tc.MobilityDriftProcess(N, T)
    case = SweepCase("one", s, proc, 3, T)
    results, _ = sweep([case], **CPU)
    _bitwise(_serial(s, case), results["one"])


def test_sharded_scenario_bucket_matches_unsharded():
    s = tb.MExp3(N, M)
    cases = [SweepCase(f"c{i}", s, p, i, T) for i, p in enumerate(_table_scenarios(tc)[:3])]
    r1, _ = sweep(cases, **CPU)
    r2, rep2 = sweep(cases, shard=True, **CPU)
    assert rep2[0].sharded
    for c in cases:
        _bitwise(r1[c.name], r2[c.name], c.name)


# ---------------------------------------------------------------------------
# legacy shims, realization, engine guards
# ---------------------------------------------------------------------------

def test_legacy_generators_are_registry_shims():
    a = tc.random_piecewise_env(_gen(7), N, 1000, 3, min_gap=0.1, **CPU)
    b = tc.PiecewiseProcess(N, 1000, 3, min_gap=0.1).realize(_gen(7), **CPU)
    c = tc.random_adversarial_env(_gen(7), N, 500, flip_prob=0.02, **CPU)
    d = tc.AdversarialProcess(N, 500, flip_prob=0.02).realize(_gen(7), **CPU)
    for x, y in ((a, b), (c, d)):
        for f in ("means", "breaks", "table", "react"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_knob_values_realize_apart_from_one_generator():
    """The twin of JAX's empty-params regression: each instance realizes
    with its own knob values."""
    a = tc.GilbertElliottProcess(N, 64, p_gb=0.5).realize(_gen(0), **CPU)
    b = tc.GilbertElliottProcess(N, 64, p_gb=0.01).realize(_gen(0), **CPU)
    assert not torch.equal(a.table, b.table)
    assert torch.equal(b.table, tc.GilbertElliottProcess(N, 64, p_gb=0.01)
                       .realize(_gen(0), **CPU).table)


def test_batch_engine_rejects_unrealized_process():
    with pytest.raises(TypeError, match="unrealized ChannelProcess"):
        simulate_aoi_regret_batch(tb.MExp3(N, M), tc.GilbertElliottProcess(N, T), T,
                                  uniforms=torch.rand((1, T, 2, N)), **CPU)


@pytest.mark.parametrize("family", ["gilbert_elliott", "congestion"])
def test_serial_harness_auto_realizes_process(family):
    proc = tc.example_scenario(family, N, T)
    out = simulate_aoi_regret(tb.MExp3(N, M), proc, T, generator=_gen(0), **CPU)
    assert out["regret"].shape == (T,) and bool(torch.isfinite(out["final_regret"]))


def test_matcher_scores_route_by_score_kind():
    s = tb.GLRCUCB(N, M, history=16)
    st = s.init("cpu")._replace(mu_tilde=torch.linspace(0.9, 0.1, N), counts=torch.ones(N))
    ucb_env = tc.GilbertElliottProcess(N, 32).realize(_gen(0), **CPU)
    mean_env = tc.AdversarialProcess(N, 32).realize(_gen(0), **CPU)
    react_env = tc.LoadCongestionProcess(N, 32).realize(_gen(0), **CPU)
    assert torch.equal(matcher_scores(s, st, 10, ucb_env), s.channel_scores(st, 10))
    assert torch.equal(matcher_scores(s, st, 10, react_env), s.channel_scores(st, 10))
    assert torch.equal(matcher_scores(s, st, 10, mean_env), st.mu_tilde)
    r = tb.RandomScheduler(N, M)
    assert torch.equal(matcher_scores(r, r.init("cpu"), 10, mean_env),
                       r.channel_scores(r.init("cpu"), 10))


def test_new_families_keep_the_ucb_hint():
    for family in tc.registered_scenarios():
        want = "mean" if family == "adversarial" else "ucb"
        assert tc.example_scenario(family, N, T).realize(_gen(0), **CPU).score_kind == want
    assert tc.make_stationary(torch.linspace(0.9, 0.1, N), **CPU).score_kind == "ucb"


# ---------------------------------------------------------------------------
# the FL trainer on scenarios
# ---------------------------------------------------------------------------

def _loss(p, x, y):
    return ((x @ p["w"] - y) ** 2).mean()


def test_fl_trainer_accepts_process_env():
    cfg = AsyncFLConfig(n_clients=M, n_channels=N, local_epochs=1)
    proc = tc.GilbertElliottProcess(N, 64)
    tr = AsyncFLTrainer(cfg, tb.GLRCUCB(N, M, history=16), proc, _loss, device="cpu",
                        realize_generator=tc.scenario_realize_generator(5, "cpu"))
    assert tr.env.form == "table" and tr.scenario is proc
    assert torch.equal(tr.env.table, proc.realize(tc.scenario_realize_generator(5, "cpu"),
                                                  **CPU).table)
    st = tr.init({"w": torch.zeros(3)})
    st, mets = tr.round(st, torch.zeros((M, 1, 4, 3)), torch.zeros((M, 1, 4)),
                        generator=_gen(0))
    assert bool(torch.isfinite(mets["local_loss"]))


def test_fl_trainer_falls_back_to_generator_zero_with_a_warning():
    cfg = AsyncFLConfig(n_clients=M, n_channels=N)
    proc = tc.LoadCongestionProcess(N, 64)
    with pytest.warns(UserWarning, match="seeded 0"):
        tr = AsyncFLTrainer(cfg, tb.GLRCUCB(N, M, history=16), proc, _loss, device="cpu")
    assert tr.env.form == "reactive"
    assert torch.equal(tr.env.table, proc.realize(_gen(0), **CPU).table)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr2 = AsyncFLTrainer(cfg, tb.GLRCUCB(N, M, history=16), tr.env, _loss, device="cpu")
    assert tr2.scenario is None
    with pytest.raises(TypeError, match="ChannelEnv or a ChannelProcess"):
        AsyncFLTrainer(cfg, tb.GLRCUCB(N, M, history=16), np.zeros((64, N)), _loss, device="cpu")


FN, FM, DIM, HID, C, E, B = 6, 4, 8, 16, 3, 2, 4
ROUNDS = 3
FL_CFG = dict(n_clients=FM, n_channels=FN, local_epochs=E, client_lr=0.1, server_lr=0.1)
FL_SCHED = dict(history=16, min_samples=4, delta=0.05)


@pytest.mark.parametrize("family", ["reactive_jammer", "congestion"])
def test_trainer_rounds_on_a_reactive_env_match_jax(family):
    cx, cy, _, _, px, py = make_federated_classification(
        FM, samples_per_client=64, n_classes=C, dim=DIM, alpha=0.5, seed=1)
    rng = np.random.default_rng(2)
    params = {"w1": (rng.standard_normal((DIM, HID)) * 0.3).astype(np.float32),
              "b1": np.zeros(HID, np.float32),
              "w2": (rng.standard_normal((HID, C)) * 0.3).astype(np.float32),
              "b2": np.zeros(C, np.float32)}
    bx, by = FederatedLoader(cx, cy, batch_size=B, local_epochs=E, seed=4).next_rounds(ROUNDS)
    proc = (jc.ReactiveJammerProcess(base=jc.PiecewiseProcess(FN, 64, 2), memory=0.5,
                                     lock_thresh=0.2)
            if family == "reactive_jammer"
            else jc.LoadCongestionProcess(FN, 64, memory=0.5, knee=0.3, severity=0.9))
    jenv = proc.realize(jax.random.PRNGKey(8))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jpx, jpy, tpx, tpy = jnp.asarray(px), jnp.asarray(py), torch.from_numpy(px), torch.from_numpy(py)
    tparams = convert.params(params, "cpu")
    jtr = JaxTrainer(JaxConfig(**FL_CFG), jb.GLRCUCB(FN, FM, **FL_SCHED), jenv, _jax_loss,
                     lambda flat: _jax_loss(jax_unflatten(flat, jparams), jpx, jpy))
    ttr = AsyncFLTrainer(AsyncFLConfig(**FL_CFG), tb.GLRCUCB(FN, FM, **FL_SCHED),
                         convert.env(jenv, "cpu"), _torch_loss,
                         lambda flat: _torch_loss(tree_unflatten_concat(flat, tparams), tpx, tpy),
                         device="cpu")
    key = jax.random.PRNGKey(3)
    jstate, tstate = jtr.init(jparams, key), ttr.init(tparams)
    for r in range(ROUNDS):
        k = jax.random.fold_in(key, r)
        k_env, k_sel = jax.random.split(k)
        u_env = torch.from_numpy(np.array(jax.random.uniform(k_env, (FN,))))
        u_sel = torch.from_numpy(np.array(jax.random.uniform(k_sel, (FN,))))
        jstate, jm = jtr.round(jstate, jnp.asarray(bx[r]), jnp.asarray(by[r]), k)
        tstate, tm = ttr.round(tstate, torch.from_numpy(bx[r]), torch.from_numpy(by[r]),
                               u_env=u_env, u_sel=u_sel)
        where = f"{family} round {r}"
        np.testing.assert_array_equal(tm["n_success"].numpy(), np.array(jm["n_success"]), where)
        for f in ("aoi", "has_update", "last_success"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.array(getattr(jstate, f)), f"{where} {f}")
        for f in ("counts", "cum", "restarts"):
            np.testing.assert_array_equal(getattr(tstate.sched_state, f).numpy(),
                                          np.array(getattr(jstate.sched_state, f)), f"{where} {f}")
        np.testing.assert_allclose(tstate.env_state.numpy(), np.array(jstate.env_state),
                                   rtol=1e-6, atol=0, err_msg=f"{where} env_state")
        np.testing.assert_allclose(tm["mean_aoi"].numpy(), np.array(jm["mean_aoi"]), rtol=1e-6,
                                   atol=0, err_msg=f"{where} mean_aoi")
        for k2 in ("local_loss", "aoi_var", "zeta_max"):
            np.testing.assert_allclose(tm[k2].numpy(), np.array(jm[k2]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{where} {k2}")
        for k2 in params:
            np.testing.assert_allclose(tstate.params[k2].numpy(), np.array(jstate.params[k2]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{where} {k2}")
    assert float(tstate.env_state.sum()) > 0       # the env saw the schedule
