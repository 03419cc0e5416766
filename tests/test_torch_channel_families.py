"""The port's six non-stationary channel families against the JAX package.

Gilbert-Elliott fading, mobility drift, SNR shadowing, the jamming overlay,
the reactive jammer and load congestion realize in two steps in the port,
``_draws`` (every random draw) and ``_from_draws`` (the rest).  Fed the
draws behind JAX's own realization (the uniforms, normals and permutation
on the keys JAX splits), ``_from_draws`` must give JAX's env: the
Gilbert-Elliott and jamming tables bit for bit (thresholds on the same
uniforms, products of exact factors), the reactive jammer's base table and
``react`` leaf bit for bit (the base is JAX's realized piecewise env,
carried across), congestion's ``react`` bit for bit; mobility's and
congestion's tables at rtol 1e-6 (XLA contracts ``jax.random.uniform``'s
move to [low, high) into a fused multiply-add; mobility's ``sin``),
shadowing's at rtol 1e-5 (XLA contracts the AR(1) step ``rho * x + innov *
e`` too, and XLA's ``erf``/``erfc`` are not torch's).  The chains run
without a loop over the rounds (``_markov_chain``), equal to the
sequential chain bit for bit.

Then the canonical-form contract of ``tests/test_scenario_properties.py``
over every family the port registers: the registry lists JAX's nine
families with JAX's knobs, defaults and traced tuples; realized means lie
in [0, 1]; shapes, dtypes and the ``react`` leaf match ``env_signature()``;
stacking round-trips; the jamming overlay never raises a mean above its
open-loop base's; ``scenario_grid`` rows equal the serial realizations;
``dense_means`` equals ``means_at`` on open-loop envs; and the open-loop
helpers raise on reactive envs with closed-loop guidance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import channels as jc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import channels as tc  # noqa: E402
from repro_torch.core.channels.families import _markov_chain  # noqa: E402

N, T = 5, 48
FAMILIES = sorted(tc.registered_scenarios())
OPEN_LOOP = sorted(f for f, c in tc.registered_scenarios().items() if c.FORM != tc.FORM_REACTIVE)
REACTIVE = sorted(set(FAMILIES) - set(OPEN_LOOP))
CPU = dict(device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _split(key, n=2):
    return jax.random.split(key, n)


# ---------------------------------------------------------------------------
# the transforms on JAX's own draws
# ---------------------------------------------------------------------------

def _base_draw(jbase, key):
    """JAX's realized base env, carried across (the overlays' ``base`` draw)."""
    return convert.env(jbase._realize(key, jbase.params()), "cpu")


# family -> (JAX process, port process, JAX draws as the port's ``_from_draws`` takes them)
def _case(family, key, knobs):
    k0, k1 = _split(key)
    if family == "gilbert_elliott":
        return (jc.GilbertElliottProcess(N, T, **knobs), tc.GilbertElliottProcess(N, T, **knobs),
                dict(u0=_t(jax.random.uniform(k0, (N,))), u=_t(jax.random.uniform(k1, (T, N)))))
    if family == "mobility":
        return (jc.MobilityDriftProcess(N, T, **knobs), tc.MobilityDriftProcess(N, T, **knobs),
                dict(center=_t(jax.random.uniform(k0, (N,))),
                     phase=_t(jax.random.uniform(k1, (N,)))))
    if family == "shadowing":
        return (jc.ShadowingProcess(N, T, **knobs), tc.ShadowingProcess(N, T, **knobs),
                dict(margin=_t(jax.random.uniform(k0, (N,))),
                     eps=_t(jax.random.normal(k1, (T, N)))))
    if family == "congestion":
        return (jc.LoadCongestionProcess(N, T, **knobs), tc.LoadCongestionProcess(N, T, **knobs),
                dict(u=_t(jax.random.uniform(key, (N,)))))
    if family == "jamming":
        jbase = jc.PiecewiseProcess(N, T, 3)
        kb, kj, kt = _split(key, 3)
        return (jc.JammingOverlay(base=jbase, **knobs),
                tc.JammingOverlay(base=tc.PiecewiseProcess(N, T, 3), **knobs),
                dict(base=_base_draw(jbase, kb), u=_t(jax.random.uniform(kj, (T,))),
                     perm=_t(jax.random.permutation(kt, N))))
    if family == "reactive_jammer":
        jbase = jc.PiecewiseProcess(N, T, 3)
        return (jc.ReactiveJammerProcess(base=jbase, **knobs),
                tc.ReactiveJammerProcess(base=tc.PiecewiseProcess(N, T, 3), **knobs),
                dict(base=_base_draw(jbase, key)))
    raise KeyError(family)


# family -> (table tolerance: None for bitwise, or rtol), knob points
TRANSFORMS = {
    "gilbert_elliott": (None, [{}, dict(p_gb=0.3, p_bg=0.01), dict(p_gb=0.0, p_bg=1.0),
                               dict(mu_good=1.5, mu_bad=-0.2)]),
    "jamming": (None, [{}, dict(strength=0.5, jam_on=0.3, jam_off=0.05), dict(n_jammed=4),
                       dict(strength=2.0)]),
    "reactive_jammer": (None, [{}, dict(memory=0.5, strength=1.0, lock_thresh=0.1,
                                        sharpness=4.0)]),
    "mobility": (1e-6, [{}, dict(period=37.0, amplitude=0.45)]),
    "congestion": (1e-6, [{}, dict(mean_low=0.1, mean_high=0.3, severity=0.9)]),
    "shadowing": (1e-5, [{}, dict(rho=0.85), dict(rho=0.97, sigma_db=6.0)]),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family,point", [(f, i) for f, (_, pts) in TRANSFORMS.items()
                                          for i in range(len(pts))])
def test_transform_of_jax_draws_is_jax_realize(family, point, seed):
    rtol, points = TRANSFORMS[family]
    key = jax.random.PRNGKey(100 * seed + point)
    jproc, tproc, draws = _case(family, key, points[point])
    want = jproc.realize(key)
    got = tproc._from_draws(draws, torch.device("cpu"))
    assert got.form == want.form and got.score_kind == want.score_kind
    if rtol is None:
        np.testing.assert_array_equal(got.table.numpy(), np.array(want.table))
    else:
        np.testing.assert_allclose(got.table.numpy(), np.array(want.table), rtol=rtol, atol=0)
    np.testing.assert_array_equal(got.react.numpy(), np.array(want.react))
    np.testing.assert_array_equal(got.means.numpy(), np.array(want.means))
    np.testing.assert_array_equal(got.breaks.numpy(), np.array(want.breaks))


@pytest.mark.parametrize("seed", range(4))
def test_markov_chain_is_the_sequential_chain(seed):
    """Both start values, thresholds at 0 and 1, draws landing on them."""
    rng = np.random.default_rng(seed)
    u = rng.random((200, 7)).astype(np.float32)
    u[rng.random(u.shape) < 0.05] = 0.25
    start = rng.random(7) < 0.5
    for p_leave, p_enter in ((0.25, 0.25), (0.0, 1.0), (1.0, 0.0), (0.3, 0.6), (0.9, 0.05)):
        s, want = start.copy(), []
        for t in range(u.shape[0]):
            s = np.where(s, u[t] >= p_leave, u[t] < p_enter)
            want.append(s)
        got = _markov_chain(torch.from_numpy(start), torch.from_numpy(u),
                            torch.tensor(p_leave), torch.tensor(p_enter))
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
        got1 = _markov_chain(torch.tensor(bool(start[0])), torch.from_numpy(u[:, 0]),
                             torch.tensor(p_leave), torch.tensor(p_enter))
        np.testing.assert_array_equal(got1.numpy(), np.stack(want)[:, 0])


# ---------------------------------------------------------------------------
# the registry: JAX's nine families, knobs and defaults
# ---------------------------------------------------------------------------

def test_registry_lists_the_nine_jax_families():
    assert set(FAMILIES) == set(jc.registered_scenarios())
    assert len(FAMILIES) == 9
    assert set(REACTIVE) == {"reactive_jammer", "congestion"}


@pytest.mark.parametrize("family", FAMILIES)
def test_knobs_defaults_and_signature_match_jax(family):
    tcls, jcls = tc.registered_scenarios()[family], jc.registered_scenarios()[family]
    knobs = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls) if f.init]
    assert knobs(tcls) == knobs(jcls)
    assert (tcls.FORM, tcls.SCORE_KIND, tcls.TRACED) == (jcls.FORM, jcls.SCORE_KIND, jcls.TRACED)
    tp, jp = tc.example_scenario(family, N, T), jc.example_scenario(family, N, T)
    assert tp.env_signature() == jp.env_signature()
    assert set(tp.params("cpu")) == set(jp.params())
    names = lambda sig: [p[0] for p in sig[1]]
    assert names(tp.hp_signature()) == names(jp.hp_signature())


def test_overlays_nest_the_base_params():
    jam = tc.JammingOverlay(base=tc.GilbertElliottProcess(N, T, p_gb=0.2))
    sp = jam.params("cpu")
    assert set(sp) == {"jam_on", "jam_off", "strength", "base"}
    assert float(sp["base"]["p_gb"]) == pytest.approx(0.2)
    # the base's structure is part of the overlay's
    other = tc.JammingOverlay(base=tc.GilbertElliottProcess(N, 2 * T))
    assert jam.hp_signature() != other.hp_signature()
    assert jam.hp_signature() == jam.replace_traced(strength=0.1).hp_signature()


def test_overlays_reject_a_reactive_base_and_a_missing_horizon():
    cong = tc.LoadCongestionProcess(N, T)
    with pytest.raises(ValueError, match="reactive_jammer"):
        tc.JammingOverlay(base=cong)
    with pytest.raises(ValueError, match="reactive"):
        tc.ReactiveJammerProcess(base=cong)
    for cls in (tc.JammingOverlay, tc.ReactiveJammerProcess):
        with pytest.raises(ValueError, match="horizon"):
            cls(base=tc.StationaryProcess(N))
        env = cls(base=tc.StationaryProcess(N), horizon=T).realize(_gen(0), **CPU)
        assert env.horizon == T


# ---------------------------------------------------------------------------
# the canonical-form contract over every registered family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("family", FAMILIES)
def test_realized_means_in_unit_interval(family, seed):
    env = tc.example_scenario(family, N, T).realize(_gen(seed), **CPU)
    for x in (env.means, env.table):
        assert bool(((x >= 0.0) & (x <= 1.0)).all())


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("family", FAMILIES)
def test_canonical_form_shapes_and_dtypes(family, seed):
    proc = tc.example_scenario(family, N, T)
    env = proc.realize(_gen(seed), **CPU)
    table_lead = env.form in (tc.FORM_TABLE, tc.FORM_REACTIVE)
    assert (env.form, env.horizon if table_lead else env.means.shape[0], env.n_channels,
            env.score_kind) == proc.env_signature()
    assert env.react.dtype == torch.float32
    assert env.react.shape == ((4,) if env.form == tc.FORM_REACTIVE else (0,))
    if table_lead:
        assert env.table.shape == (T, N) and env.table.dtype == torch.float32
        assert env.means.shape == (1, N)
    else:
        assert env.table.shape == (0, N) and env.means.dtype == torch.float32
        brk = env.breaks
        assert brk.shape == (env.means.shape[0] - 1,)
        if brk.numel():
            assert bool((brk[1:] > brk[:-1]).all()) and 1 <= int(brk.min()) <= int(brk.max()) < T


@pytest.mark.parametrize("family", FAMILIES)
def test_stack_envs_round_trip(family):
    proc = tc.example_scenario(family, N, T)
    envs = [proc.realize(_gen(s), **CPU) for s in (3, 4)]
    stacked = tc.stack_envs(envs)
    assert tc.env_batch_size(stacked) == 2 and tc.env_batch_size(envs[0]) == 1
    assert stacked.react.shape == (2, envs[0].react.shape[0])
    for i, e in enumerate(envs):
        for f in ("means", "breaks", "table", "react"):
            assert torch.equal(getattr(stacked, f)[i], getattr(e, f)), f


@pytest.mark.parametrize("strength", [0.3, 0.9, 1.7])
@pytest.mark.parametrize("family", OPEN_LOOP)
def test_jamming_overlay_never_raises_means(family, strength):
    base = tc.example_scenario(family, N, T)
    jam = tc.JammingOverlay(base=base, horizon=T, strength=strength)
    off = tc.JammingOverlay(base=base, horizon=T, strength=0.0)
    jammed, unjammed = jam.realize(_gen(5), **CPU).table, off.realize(_gen(5), **CPU).table
    assert jammed.shape == unjammed.shape == (T, N)
    assert torch.equal(unjammed, tc.dense_means(base.realize(_gen(5), **CPU), T))
    assert bool((jammed <= unjammed).all()) and bool(((jammed >= 0) & (jammed <= 1)).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_scenario_grid_rows_match_serial_realize(family):
    proc = tc.example_scenario(family, N, T)
    grid = [proc, proc.replace_traced(**{proc.traced_fields()[0]: 0.2})]
    stacked = tc.scenario_grid(grid, [_gen(1), _gen(2)], **CPU)
    assert tc.env_batch_size(stacked) == 2
    for i, (p, seed) in enumerate(zip(grid, (1, 2))):
        row = p.realize(_gen(seed), **CPU)
        for f in ("means", "breaks", "table", "react"):
            assert torch.equal(getattr(stacked, f)[i], getattr(row, f)), f


@pytest.mark.parametrize("family", OPEN_LOOP)
def test_dense_means_matches_means_at(family):
    env = tc.example_scenario(family, N, T).realize(_gen(7), **CPU)
    dense = tc.dense_means(env, T)
    assert dense.shape == (T, N)
    for t in (0, T // 2, T - 1):
        assert torch.equal(dense[t], env.means_at(t))


@pytest.mark.parametrize("family", REACTIVE)
def test_open_loop_helpers_raise_on_reactive(family):
    env = tc.example_scenario(family, N, T).realize(_gen(8), **CPU)
    with pytest.raises(ValueError, match="interaction"):
        tc.dense_means(env, T)
    with pytest.raises(ValueError, match="closed-loop"):
        env.means_at(0)
    with pytest.raises(ValueError, match="closed-loop"):
        env.sample(0, torch.rand(N))
    with pytest.raises(ValueError, match="reactive_jammer"):
        tc.JammingOverlay(base=tc.example_scenario(family, N, T), horizon=T)
