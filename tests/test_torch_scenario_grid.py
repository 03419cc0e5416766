"""The port's scenario registry helpers and their sweep integration, on
the paper's three regimes.

The canonical-form contract of the JAX package's
``tests/test_scenario_properties.py`` and the sweep cases of
``tests/test_scenarios.py``, for the three families of the paper's
regimes (stationary, piecewise, adversarial): ``registered_scenarios`` /
``example_scenario`` / ``env_signature``, the realized shapes, stacking
round trips (``stack_envs``, ``env_batch_size``, rows bit for bit),
``dense_means`` against ``means_at``, ``scenario_grid`` and
``realize_processes`` rows equal to each process's own ``realize`` from
its generator, and the sweep: scenario cases bucket by their realized
env's signature (families merge), traced scenario parameters share a
bucket, and each case equals its serial run realized from
``scenario_realize_generator(seed)``.  JAX's own ``env_signature`` and
its ``group_cases`` over the same scenarios give the same buckets.
Realizations equal JAX's in distribution only (torch's generator is not
threefry), so no realized value is compared across the packages here.
The registry's six other families (the fading, mobility, shadowing and
jamming tables, the reactive jammer and congestion) are held to the same
contract, and their realizers to JAX's on JAX's own draws, in
``tests/test_torch_channel_families.py``; their sweep, engine and trainer
cases are in ``tests/test_torch_scenarios.py`` and
``tests/test_torch_reactive.py``.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro.core import channels as jc  # noqa: E402
from repro.sim import SweepCase as JaxSweepCase  # noqa: E402
from repro.sim import group_cases as jax_group_cases  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core import channels as tc  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.sim import SweepCase, group_cases, sweep  # noqa: E402
from test_torch_sim_engine import _bitwise  # noqa: E402

N, T = 5, 48
FAMILIES = ("stationary", "piecewise", "adversarial")
CPU = dict(device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_registry_has_the_papers_three_regimes():
    assert set(FAMILIES) <= set(tc.registered_scenarios())
    assert set(tc.registered_scenarios()) <= set(jc.registered_scenarios())
    with pytest.raises(ValueError, match="unknown family"):
        tc.example_scenario("no-such-family", N, T)


@pytest.mark.parametrize("family", FAMILIES)
def test_env_signature_matches_jax(family):
    tp, jp = tc.example_scenario(family, N, T), jc.example_scenario(family, N, T)
    assert tp.env_signature() == jp.env_signature()
    assert tp.traced_fields() == jp.traced_fields()
    assert [f for f, _ in tp.hp_signature()[1]] == [f for f, _ in jp.hp_signature()[1]]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("family", FAMILIES)
def test_canonical_form_shapes_dtypes_and_stacking(family, seed):
    proc = tc.example_scenario(family, N, T)
    env = proc.realize(_gen(seed), **CPU)
    table = env.form == tc.FORM_TABLE
    assert (env.form, T if table else env.means.shape[0], env.n_channels,
            env.score_kind) == proc.env_signature()
    for x in (env.means, env.table):
        assert x.dtype == torch.float32 and bool(((x >= 0) & (x <= 1)).all())
    if table:
        assert env.table.shape == (T, N) and env.means.shape == (1, N)
    else:
        assert env.table.shape == (0, N) and env.breaks.shape == (env.means.shape[0] - 1,)
        brk = env.breaks
        if brk.numel():
            assert bool((brk[1:] > brk[:-1]).all()) and 1 <= int(brk.min()) <= int(brk.max()) < T
    dense = tc.dense_means(env, T)
    assert dense.shape == (T, N)
    assert all(torch.equal(dense[t], env.means_at(t)) for t in range(T))
    envs = [env, proc.realize(_gen(seed + 100), **CPU)]
    stacked = tc.stack_envs(envs)
    assert tc.env_batch_size(stacked) == 2 and tc.env_batch_size(env) == 1
    assert torch.equal(tc.dense_means(stacked, T)[1], tc.dense_means(envs[1], T))
    for i, e in enumerate(envs):
        for x, y in ((stacked.means[i], e.means), (stacked.breaks[i], e.breaks),
                     (stacked.table[i], e.table)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("family", FAMILIES)
def test_scenario_grid_rows_match_serial_realize(family):
    proc = tc.example_scenario(family, N, T)
    grid = [proc, proc.replace_traced(**{proc.traced_fields()[0]: 0.2})]
    stacked = tc.scenario_grid(grid, [_gen(1), _gen(2)], **CPU)
    for i, (p, seed) in enumerate(zip(grid, (1, 2))):
        row = p.realize(_gen(seed), **CPU)
        assert torch.equal(stacked.means[i], row.means)
        assert torch.equal(stacked.table[i], row.table)
    with pytest.raises(ValueError, match="family/structure"):
        tc.scenario_grid([proc, tc.example_scenario(
            "adversarial" if family != "adversarial" else "stationary", N, T)],
            [_gen(0), _gen(1)], **CPU)
    with pytest.raises(ValueError, match="2 processes but 1 generators"):
        tc.scenario_grid(grid, [_gen(0)], **CPU)


def test_realize_processes_merges_families_of_one_form():
    pw = tc.PiecewiseProcess(N, T, 0)           # one segment, as a stationary env
    st = tc.StationaryProcess(N)
    assert pw.env_signature() == st.env_signature()
    stacked = tc.realize_processes([pw, st, pw], [_gen(i) for i in range(3)], **CPU)
    assert stacked.means.shape == (3, 1, N)
    assert torch.equal(stacked.means[1], st.realize(_gen(1), **CPU).means)
    with pytest.raises(ValueError, match="canonical form/shape"):
        tc.realize_processes([pw, tc.AdversarialProcess(N, T)], [_gen(0), _gen(1)], **CPU)
    with pytest.raises(ValueError, match="empty"):
        tc.realize_processes([], [], **CPU)


def test_scenario_realize_generator_is_a_documented_derivation():
    a = torch.rand(4, generator=tc.scenario_realize_generator(7, "cpu"))
    b = torch.rand(4, generator=torch.Generator().manual_seed(((7 ^ 0x5EED) * 0x9E3779B1) % 2**32))
    c = torch.rand(4, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _scenarios():
    return [tc.PiecewiseProcess(N, T, 2), tc.PiecewiseProcess(N, T, 2, min_gap=0.1),
            tc.AdversarialProcess(N, T), tc.AdversarialProcess(N, T, flip_prob=0.2),
            tc.StationaryProcess(N), tc.PiecewiseProcess(N, T, 0)]


def test_scenario_cases_bucket_by_realized_form_as_jax_does():
    s, js = tb.MExp3(N, 2), jb.MExp3(N, 2)
    key = jax.random.PRNGKey(0)
    jprocs = [jc.PiecewiseProcess(N, T, 2), jc.PiecewiseProcess(N, T, 2, min_gap=0.1),
              jc.AdversarialProcess(N, T), jc.AdversarialProcess(N, T, flip_prob=0.2),
              jc.StationaryProcess(N), jc.PiecewiseProcess(N, T, 0)]
    tcases = [SweepCase(f"c{i}", s, p, i, T) for i, p in enumerate(_scenarios())]
    jcases = [JaxSweepCase(f"c{i}", js, p, key, T) for i, p in enumerate(jprocs)]
    names = lambda buckets: [[c.name for c in b] for b in buckets]
    assert names(group_cases(tcases)) == names(jax_group_cases(jcases))
    assert names(group_cases(tcases)) == [["c0", "c1"], ["c2", "c3"], ["c4", "c5"]]


@pytest.mark.parametrize("sched", [tb.GLRCUCB(N, 2, history=16, detector_stride=4),
                                   tb.MExp3(N, 2)], ids=["glr-cucb", "m-exp3"])
def test_sweep_scenario_results_match_serial_bitwise(sched):
    cases = [SweepCase(f"c{i}", sched, p, 10 + i, T) for i, p in enumerate(_scenarios())]
    results, report = sweep(cases, **CPU)
    assert [r.batch for r in report] == [2, 2, 2]
    for c in cases:
        serial = simulate_aoi_regret(sched, c.env, T, uniforms=c.draw_uniforms("cpu"),
                                     generator=tc.scenario_realize_generator(c.seed, "cpu"),
                                     **CPU)
        _bitwise(serial, results[c.name], c.name)


def test_sweep_scenario_grid_of_1_bitwise():
    s, proc = tb.MExp3(N, 2), tc.AdversarialProcess(N, T)
    results, _ = sweep([SweepCase("one", s, proc, 3, T)], **CPU)
    serial = simulate_aoi_regret(s, proc, T, generator=tc.scenario_realize_generator(3, "cpu"),
                                 uniforms=SweepCase("one", s, proc, 3, T).draw_uniforms("cpu"),
                                 **CPU)
    _bitwise(serial, results["one"])


def test_sharded_scenario_bucket_matches_unsharded():
    s = tb.MExp3(N, 2)
    cases = [SweepCase(f"c{i}", s, p, i, T) for i, p in enumerate(_scenarios()[:3])]
    r1, _ = sweep(cases, **CPU)
    r2, rep2 = sweep(cases, shard=True, **CPU)
    assert rep2[0].sharded
    for c in cases:
        _bitwise(r1[c.name], r2[c.name], c.name)
