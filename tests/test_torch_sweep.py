"""The port's sweep driver and hyper-parameter grids (``repro_torch.sim``).

The regret cases of the JAX package's ``tests/test_hp_grid.py`` and the
sweep cases of ``tests/test_sim_engine.py``, held on the port: traced
scalars stay out of the bucket signature, a grid row equals the per-value
serial run (bit for bit: the port's batched rounds keep every row's bits,
where the JAX test allows rtol 1e-6), cases that differ only in traced
scalars share one bucket, a scheduler without the hyper-parameter
convention still sweeps, and ``sweep_cache_stats`` counts bucket-signature
reuse (the port compiles nothing per bucket, so ``compile_s`` is 0 on the
CPU).  ``group_cases`` on Fig. 2a's fifteen cases
(``benchmarks/run.py:182-213``) makes JAX's buckets, by name.  A case that
is not a regret case raises: the batched FL engine is not ported.
"""
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro.core.channels import random_adversarial_env as jax_adversarial  # noqa: E402
from repro.core.channels import random_piecewise_env as jax_piecewise  # noqa: E402
from repro.sim import SweepCase as JaxSweepCase  # noqa: E402
from repro.sim import group_cases as jax_group_cases  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.bandits.base import init_with_hp, stack_params  # noqa: E402
from repro_torch.core.channels import (  # noqa: E402
    make_stationary,
    random_adversarial_env,
    random_piecewise_env,
    stack_envs,
)
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    SweepCase,
    clear_sweep_cache,
    group_cases,
    simulate_aoi_regret_batch,
    sweep,
    sweep_cache_stats,
)
from test_torch_sim_engine import _bitwise, _leaves, _random_traced, _row  # noqa: E402

T = 300
CPU = dict(device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _pw(seed, k=2, n=5):
    return random_piecewise_env(_gen(seed), n, T, k, **CPU)


def _serial(case):
    """The serial run a sweep case stands for (``SweepCase``'s docstring)."""
    return simulate_aoi_regret(case.scheduler, case.env, case.horizon,
                               uniforms=case.draw_uniforms("cpu"), **CPU)


# ---------------------------------------------------------------------------
# traced-field conventions
# ---------------------------------------------------------------------------

def test_replace_traced_rejects_structural_fields():
    s = tb.GLRCUCB(5, 2)
    with pytest.raises(ValueError, match="not traced"):
        s.replace_traced(history=512)
    tuned = s.replace_traced(gamma=0.7, delta=1e-2)
    assert (tuned.gamma, tuned.delta) == (0.7, 1e-2)
    assert tuned.history == s.history


def test_hp_signature_merges_traced_and_splits_structural():
    base = tb.GLRCUCB(5, 2, history=64)
    assert base.hp_signature() == base.replace_traced(delta=1e-5).hp_signature()
    assert base.hp_signature() != tb.GLRCUCB(5, 2, history=128).hp_signature()
    assert (tb.AoIAware(tb.GLRCUCB(5, 2, delta=1e-2)).hp_signature()
            == tb.AoIAware(tb.GLRCUCB(5, 2, delta=1e-4)).hp_signature())
    assert (tb.MExp3(5, 2, share_alpha=0.0).hp_signature()
            != tb.MExp3(5, 2, share_alpha=1e-3).hp_signature())
    assert (tb.MExp3(5, 2, share_alpha=1e-3).hp_signature()
            == tb.MExp3(5, 2, share_alpha=5e-3).hp_signature())
    assert (tb.LyapunovSched(5, 2, min_rate=0.3).hp_signature()
            != tb.LyapunovSched(5, 2).hp_signature())
    assert (tb.LyapunovSched(5, 2, min_rate=0.3).hp_signature()
            == tb.LyapunovSched(5, 2, min_rate=0.4).hp_signature())


def test_params_roundtrip_defaults_bitwise():
    """init(hp=params()) equals init(): the identity every serial entry
    point relies on."""
    for s in [tb.GLRCUCB(5, 2, history=32), tb.MExp3(5, 2, share_alpha=1e-3),
              tb.AoIAware(tb.ChannelAwareAsync(5, 2)), tb.LyapunovSched(5, 2)]:
        for a, b in zip(_leaves(s.init("cpu")), _leaves(s.init("cpu", hp=s.params("cpu")))):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# grid rows against the per-value serial runs
# ---------------------------------------------------------------------------

def test_grid1_bitwise_matches_per_value_serial():
    """A grid row equals the per-value serial run with the representative
    scheduler's own traced values differing from the row's: the batch reads
    the hyper-parameters from the grid, not from the config."""
    env = random_piecewise_env(_gen(0), 5, T, 3, **CPU)
    rep = tb.GLRCUCB(5, 2, history=128, detector_stride=4)
    tuned = rep.replace_traced(gamma=0.65, delta=3e-2, min_samples=12)
    u = torch.rand((1, T, 2, 5), generator=_gen(1))
    serial = simulate_aoi_regret(tuned, env, T, uniforms=u[0], **CPU)
    grid1 = simulate_aoi_regret_batch(rep, stack_envs([env]), T, uniforms=u,
                                      hparams=stack_params([tuned], "cpu"), hp_axis=0, **CPU)
    _bitwise(serial, _row(grid1, 0))


POLICIES = [
    ("glr-cucb", tb.GLRCUCB(5, 2, history=64, detector_stride=4), "piecewise"),
    ("m-exp3", tb.MExp3(5, 2), "adversarial"),
    ("m-exp3-s", tb.MExp3(5, 2, share_alpha=1e-3), "adversarial"),
    ("aa-glr-cucb", tb.AoIAware(tb.GLRCUCB(5, 2, history=64, detector_stride=4)), "piecewise"),
    ("channel-aware", tb.ChannelAwareAsync(5, 2), "piecewise"),
    ("lyapunov", tb.LyapunovSched(5, 2), "piecewise"),
    ("lyapunov-rate", tb.LyapunovSched(5, 2, min_rate=0.3), "piecewise"),
]


@pytest.mark.parametrize("name,rep,env_kind", POLICIES, ids=[p[0] for p in POLICIES])
def test_randomized_grid_matches_per_value_loop(name, rep, env_kind):
    env = (random_piecewise_env(_gen(0), 5, T, 3, **CPU) if env_kind == "piecewise"
           else random_adversarial_env(_gen(0), 5, T, flip_prob=0.01, **CPU))
    rng = np.random.default_rng(sum(map(ord, name)))
    grid = [_random_traced(rep, rng) for _ in range(3)]
    u = torch.rand((T, 2, 5), generator=_gen(2))
    out = simulate_aoi_regret_batch(rep, env, T, uniforms=u, env_axis=None, uniforms_axis=None,
                                    hparams=stack_params(grid, "cpu"), hp_axis=0, **CPU)
    for i, cfg in enumerate(grid):
        _bitwise(simulate_aoi_regret(cfg, env, T, uniforms=u, **CPU), _row(out, i),
                 f"{name}[{i}]")


# ---------------------------------------------------------------------------
# sweep: bucketing, merging, results
# ---------------------------------------------------------------------------

def test_sweep_buckets_by_scheduler_and_env_shape():
    s1, s2 = tb.GLRCUCB(5, 2, history=64, detector_stride=4), tb.MExp3(5, 2)
    env_a, env_b, env_c = _pw(0), _pw(1), _pw(0, k=4)     # env_c: another means shape
    cases = [SweepCase("a", s1, env_a, 0, T), SweepCase("b", s1, env_b, 9, T),
             SweepCase("c", s1, env_c, 0, T), SweepCase("d", s2, env_a, 0, T)]
    assert sorted(len(b) for b in group_cases(cases)) == [1, 1, 2]


def test_sweep_results_match_serial_per_case():
    s1, s2 = tb.GLRCUCB(5, 2, history=64, detector_stride=4), tb.MExp3(5, 2)
    cases = [SweepCase("a", s1, _pw(0), 0, T), SweepCase("b", s1, _pw(1), 9, T),
             SweepCase("d", s2, _pw(0), 0, T,
                       uniforms=torch.rand((T, 2, 5), generator=_gen(4)))]
    results, report = sweep(cases, **CPU)
    assert set(results) == {"a", "b", "d"}
    assert sum(b.batch for b in report) == 3
    assert all(r.route == "rounds" and r.compile_s == 0.0 and not r.sharded for r in report)
    for c in cases:
        _bitwise(_serial(c), results[c.name], c.name)
        assert results[c.name]["route"] == "rounds"


def test_sweep_rejects_duplicate_names():
    env = make_stationary(np.linspace(0.9, 0.1, 5), **CPU)
    s = tb.RandomScheduler(5, 2)
    with pytest.raises(ValueError, match="duplicate"):
        sweep([SweepCase("x", s, env, 0, 50), SweepCase("x", s, env, 0, 50)], **CPU)


def test_sweep_rejects_a_case_that_is_not_a_regret_case():
    @dataclasses.dataclass(frozen=True)
    class FLSweepCase:
        name: str

    with pytest.raises(TypeError, match="FLSweepCase.*batched FL engine.*not ported"):
        sweep([FLSweepCase("fl")], **CPU)


def test_identical_scheduler_configs_share_bucket():
    cases = [SweepCase("a", tb.GLRCUCB(5, 2, history=64), _pw(0), 0, T),
             SweepCase("b", tb.GLRCUCB(5, 2, history=64), _pw(3), 4, T)]
    assert [len(b) for b in group_cases(cases)] == [2]


def test_sweep_merges_traced_scalar_cases_into_one_bucket():
    env = _pw(0)
    base = tb.GLRCUCB(5, 2, history=64, detector_stride=4)
    grid = [base.replace_traced(gamma=g, delta=d) for g in (0.6, 1.0, 1.4) for d in (1e-2, 1e-3)]
    cases = [SweepCase(f"p{i}", s, env, 0, T) for i, s in enumerate(grid)]
    cases.append(SweepCase("rand", tb.RandomScheduler(5, 2), env, 0, T))
    assert sorted(len(b) for b in group_cases(cases)) == [1, 6]
    results, report = sweep(cases, **CPU)
    assert [r.batch for r in report] == [6, 1]
    for c in cases:
        _bitwise(_serial(c), results[c.name], c.name)


class _LegacyState(NamedTuple):
    pulls: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LegacySched:
    """A scheduler without the hyper-parameter convention: ``init(device)``
    only, no ``params``/``hp_signature``; its rounds take a leading run
    axis, as the port's scheduler protocol asks (``bandits/base.py``)."""

    n_channels: int
    n_clients: int
    name: str = "legacy"

    def init(self, device):
        return _LegacyState(torch.zeros((self.n_channels,), device=device))

    def select(self, state, t, u, aoi):
        return torch.argsort(u, dim=-1, stable=True)[..., : self.n_clients], None

    def update(self, state, t, channels, rewards, aux):
        return _LegacyState(state.pulls.scatter_add(-1, channels, torch.ones_like(rewards)))

    def channel_scores(self, state, t):
        return state.pulls


def test_sweep_accepts_legacy_scheduler_without_hp_convention():
    env = make_stationary(np.linspace(0.9, 0.1, 5), **CPU)
    cases = [SweepCase(f"l{i}", LegacySched(5, 2), env, i, 200) for i in range(3)]
    assert stack_params([c.scheduler for c in cases]) is None
    results, report = sweep(cases, **CPU)
    assert report[0].batch == 3      # value-equal legacy configs still bucket
    for c in cases:
        _bitwise(_serial(c), results[c.name], c.name)


def test_sweep_cache_stats_count_bucket_signature_reuse():
    """A second sweep of the same structure with other traced values and
    seeds reuses the bucket signature (a hit); nothing is compiled."""
    clear_sweep_cache()
    env = _pw(0)
    base = tb.ChannelAwareAsync(5, 2)

    def run(tag, emas, seed0):
        cases = [SweepCase(f"{tag}{i}", base.replace_traced(ema=e), env, seed0 + i, T)
                 for i, e in enumerate(emas)]
        return cases, sweep(cases, **CPU)

    _, (_, report1) = run("a", [0.02, 0.1, 0.3], 10)
    stats1 = sweep_cache_stats()
    cases2, (results2, report2) = run("b", [0.05, 0.15, 0.25], 20)
    stats2 = sweep_cache_stats()
    assert stats1 == {"misses": 1, "hits": 0}
    assert stats2 == {"misses": 1, "hits": 1}
    assert [r.cache_hit for r in report1] == [False]
    assert [r.cache_hit for r in report2] == [True]
    assert [r.compile_s for r in report1 + report2] == [0.0, 0.0]
    for c in cases2:
        _bitwise(_serial(c), results2[c.name], c.name)
    clear_sweep_cache()
    assert sweep_cache_stats() == {"hits": 0, "misses": 0}


# ---------------------------------------------------------------------------
# Fig. 2a's cases bucket as JAX's do
# ---------------------------------------------------------------------------

def _fig2a(p, piecewise, adversarial, key, n=5, m=2, horizon=T):
    glr = lambda stride=5: p.GLRCUCB(n, m, history=1024, detector_stride=stride)
    scheds = [("random", p.RandomScheduler(n, m)), ("round-robin", p.RoundRobinScheduler(n, m)),
              ("channel-aware", p.ChannelAwareAsync(n, m)), ("lyapunov", p.LyapunovSched(n, m)),
              ("glr-cucb", glr()), ("cucb-static", glr(10**9)), ("aa-glr-cucb", p.AoIAware(glr())),
              ("m-exp3", p.MExp3(n, m, gamma=0.5)),
              ("aa-m-exp3", p.AoIAware(p.MExp3(n, m, gamma=0.5)))]
    adv = [("random", p.RandomScheduler(n, m)), ("channel-aware", p.ChannelAwareAsync(n, m)),
           ("lyapunov", p.LyapunovSched(n, m)),
           ("m-exp3", p.MExp3(n, m, gamma=0.5, share_alpha=1e-3)),
           ("aa-m-exp3", p.AoIAware(p.MExp3(n, m, gamma=0.5, share_alpha=1e-3))),
           ("glr-cucb", glr())]
    return ([(f"piecewise/{k}", s, piecewise) for k, s in scheds]
            + [(f"adversarial/{k}", s, adversarial) for k, s in adv])


def test_fig2a_cases_bucket_as_jax_does():
    key = jax.random.PRNGKey(0)
    jcases = [JaxSweepCase(name, s, env, key, T) for name, s, env in _fig2a(
        jb, jax_piecewise(key, 5, T, 5), jax_adversarial(key, 5, T, flip_prob=0.002), key)]
    tcases = [SweepCase(name, s, env, 0, T) for name, s, env in _fig2a(
        tb, random_piecewise_env(_gen(0), 5, T, 5, **CPU),
        random_adversarial_env(_gen(0), 5, T, flip_prob=0.002, **CPU), 0)]
    names = lambda buckets: [[c.name for c in b] for b in buckets]
    assert len(tcases) == 15
    assert names(group_cases(tcases)) == names(jax_group_cases(jcases))
    # ... and its hp grid (benchmarks/run.py:440-444) is one bucket in both
    grid = [(g, d) for g in (0.5, 0.75, 1.0, 1.25) for d in (1e-4, 1e-3, 1e-2, 1e-1)]
    jgrid = [JaxSweepCase(f"g{g}_d{d}", jb.GLRCUCB(5, 2, history=1024, detector_stride=5,
                                                   gamma=g, delta=d),
                          jcases[0].env, key, T) for g, d in grid]
    tgrid = [SweepCase(f"g{g}_d{d}", tb.GLRCUCB(5, 2, history=1024, detector_stride=5,
                                                gamma=g, delta=d),
                       tcases[0].env, 0, T) for g, d in grid]
    assert names(group_cases(tgrid)) == names(jax_group_cases(jgrid)) == [[c.name for c in tgrid]]
    assert init_with_hp(tgrid[0].scheduler, "cpu", None).hp["gamma"] == 0.5
