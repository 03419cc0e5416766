"""The closed-loop ("reactive") canonical form in the port, against the JAX
package.

The nine behaviours of ``tests/test_reactive.py``: the reaction law
suppresses scheduled channels; ``interact_step`` is a leaky integrator of
the schedule; open-loop envs degenerate exactly (``sample_dyn`` is
``sample``, ``interact_step`` the identity); reactive envs stack; knob
typos raise; reactive cases of one (T, N) share one ``sweep`` bucket and
equal their serial runs, sharded or not; the follower jammer shifts GLR-CUCB's restarts
and regret against the matched open-loop ``JammingOverlay``; congestion
drags a greedy policy below the idle means; a reactive base is refused.

Parity: JAX's realized reactive env, carried across with ``convert.env``,
and the uniforms behind JAX's own per-round keys (``k_env``'s channel draw,
``k_sel``'s selection draw through ``selection_uniform``) give the port's
per-round route the JAX harness's schedules, AoIs, regret curve, restarts
and ``exploit_rounds`` bit for bit, at T = 300 for GLR-CUCB, M-Exp3,
AoI-Aware over GLR-CUCB and random on both reactive families.  The means
may differ in the last ulp (XLA's ``logistic`` against ``1 / (1 +
exp(-x))``, and XLA contracts the load update into a fused multiply-add),
so a schedule could fork there only where a draw lands within 1e-6 of its
mean: the test asserts that no draw on the seeds used is that close.  The
one other fork it admits is the policies' own, held by
``tests/test_torch_regret_baselines.py`` the same way: XLA contracts
AoI-Aware's discounted sums ``rho * x + y`` into a fused multiply-add in
the compiled round, so two of its discounted means that tie in one package
can sit an ulp apart in the other; a fork must then sit on such a near-tie
(1e-5 relative) of the ranking that decided the round, everything before
it bit for bit.  JAX's policy state, AoI and load after the forked round
are then carried into the port and every later round is held bit for bit
again; ``ALLOWED_FORKS`` caps each case's forks (one, AoI-Aware on
congestion at round 6; none for the seven others).  A stacked reactive batch equals its serial runs bit for
bit.  ``means_dyn``/``interact_step`` against JAX's op by op: the load step
bitwise, the means at rtol 1e-6.  At ``chaos_suite``'s size (N = 8, M = 3,
H = 256, T = 4000) GLR-CUCB on JAX's follower jammer gives JAX's regret
curve and restarts bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro.core import channels as jc  # noqa: E402
from repro.core.aoi import init_aoi as jax_init_aoi, update_aoi as jax_update_aoi  # noqa: E402
from repro.core.bandits.oracle import oracle_assign as jax_oracle  # noqa: E402
from repro.core.regret import policy_round as jax_policy_round  # noqa: E402
from repro.core.regret import simulate_aoi_regret as jax_simulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core import channels as tc  # noqa: E402
from repro_torch.core.aoi import update_aoi  # noqa: E402
from repro_torch.core.bandits.oracle import oracle_assign  # noqa: E402
from repro_torch.core.regret import offline_round_stream, policy_round, state_counters  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.sim import SweepCase, group_cases, simulate_aoi_regret_batch, sweep  # noqa: E402
from test_torch_baselines import _close_rel, _sorted_gap_tie, near_tie  # noqa: E402
from test_torch_baselines import selection_uniform  # noqa: E402
from test_torch_sim_engine import _bitwise  # noqa: E402

N, M, T = 8, 3, 600
CPU = dict(device="cpu")
NO_FORK_GAP = 1e-6          # |u - mu| below this could fork on an ulp of the mean


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _env(decay=0.5, gain=0.8, thresh=0.3, sharp=16.0, mu=0.7):
    return tc.reactive_env(torch.full((T, N), mu), decay=decay, gain=gain, thresh=thresh,
                           sharp=sharp, **CPU)


# ---------------------------------------------------------------------------
# unit laws of the reaction dynamics
# ---------------------------------------------------------------------------

def test_reaction_law_suppresses_scheduled_channels():
    env = _env()
    assert env.form == tc.FORM_REACTIVE and env.kind == "reactive" and env.horizon == T
    idle = env.means_dyn(0, torch.zeros(N))
    busy = env.means_dyn(0, torch.ones(N))
    assert bool((busy < idle).all()) and bool((busy >= 0.0).all())
    assert bool((idle <= 0.7 + 1e-7).all())
    with pytest.raises(ValueError, match="horizon"):
        env.means_dyn(T, torch.zeros(N))


def test_interact_step_is_a_leaky_schedule_integrator():
    env = _env(decay=0.5)
    sched = torch.zeros(N)
    sched[0] = 1.0
    s = env.interact_init()
    assert s.shape == (N,) and float(s.sum()) == 0.0
    s1 = env.interact_step(s, 0, sched)
    s2 = env.interact_step(s1, 1, sched)
    assert torch.equal(s1, 0.5 * sched) and torch.equal(s2, 0.75 * sched)
    s3 = env.interact_step(s2, 2, torch.zeros(N))
    assert float(s3[0]) == pytest.approx(0.375)


def test_open_loop_envs_degenerate_exactly():
    env = tc.make_stationary(torch.linspace(0.1, 0.9, N), **CPU)
    s, u = env.interact_init(), torch.rand(N, generator=_gen(3))
    assert torch.equal(env.sample_dyn(5, u, s), env.sample(5, u))
    assert torch.equal(env.interact_step(s, 5, torch.ones(N)), s)


def test_reactive_envs_stack():
    envs = [tc.make_scenario("congestion", n_channels=N, horizon=T).realize(_gen(i), **CPU)
            for i in range(2)]
    stacked = tc.stack_envs(envs)
    assert stacked.table.shape == (2, T, N) and stacked.react.shape == (2, 4)
    with pytest.raises(ValueError, match="share kind"):
        tc.stack_envs([envs[0], tc.make_scenario("gilbert_elliott", n_channels=N, horizon=T)
                       .realize(_gen(0), **CPU)])


def test_make_scenario_rejects_unknown_and_missing_knobs():
    with pytest.raises(ValueError, match="unknown knob"):
        tc.make_scenario("congestion", n_channels=N, horizon=T, sevrity=0.5)
    with pytest.raises(ValueError, match="missing required knob"):
        tc.make_scenario("congestion", n_channels=N)
    with pytest.raises(ValueError, match="unknown knob"):
        tc.make_scenario("reactive_jammer", base=tc.PiecewiseProcess.example(N, T), strenght=0.9)


def test_reactive_cases_share_one_sweep_bucket():
    """Two congestion cases and a reactive jammer of one (T, N): one bucket,
    each case equal to its serial run from the same seed."""
    sched, t = tb.GLRCUCB(N, M, history=64), T // 2
    procs = {
        "cong-a": tc.make_scenario("congestion", n_channels=N, horizon=t),
        "cong-b": tc.make_scenario("congestion", n_channels=N, horizon=t, severity=0.9),
        "jam-r": tc.make_scenario("reactive_jammer", base=tc.PiecewiseProcess.example(N, t)),
    }
    cases = [SweepCase(k, sched, p, i, t) for i, (k, p) in enumerate(sorted(procs.items()))]
    assert len(group_cases(cases)) == 1
    results, report = sweep(cases, collect_curve=False, **CPU)
    assert report[0].batch == 3 and report[0].route == "rounds"
    sharded, rep = sweep(cases, collect_curve=False, shard=True, **CPU)
    assert rep[0].sharded
    for c in cases:
        serial = simulate_aoi_regret(sched, c.env, t, uniforms=c.draw_uniforms("cpu"),
                                     generator=tc.scenario_realize_generator(c.seed, "cpu"),
                                     collect_curve=False, **CPU)
        _bitwise(serial, results[c.name], c.name)
        _bitwise(serial, sharded[c.name], f"sharded {c.name}")


def test_reactive_jammer_shifts_scheduling_vs_matched_open_loop():
    """Against the same base scenario and uniforms, the follower jammer
    changes what GLR-CUCB experiences relative to the matched open-loop
    overlay: a different restart count and a larger AoI regret."""
    base = tc.PiecewiseProcess.example(N, T)
    sched = tb.GLRCUCB(N, M, history=256)
    u = torch.rand((T, 2, N), generator=_gen(1))
    react = tc.make_scenario("reactive_jammer", base=base)
    openl = tc.JammingOverlay(base=base, horizon=T, strength=0.9)
    rr = simulate_aoi_regret(sched, react, T, generator=_gen(0), uniforms=u,
                             collect_curve=False, **CPU)
    ro = simulate_aoi_regret(sched, openl, T, generator=_gen(0), uniforms=u,
                             collect_curve=False, **CPU)
    # one base realization under both (each overlay draws its base first)
    assert torch.equal(react.realize(_gen(0), **CPU).table[:, :1],
                       tc.dense_means(base.realize(_gen(0), **CPU), T)[:, :1])
    assert int(rr["restarts"]) != int(ro["restarts"])
    assert float(rr["final_regret"]) > float(ro["final_regret"])


def test_congestion_drags_down_a_greedy_policy():
    proc = tc.LoadCongestionProcess(N, T, severity=0.9, memory=0.95, knee=0.2)
    sched = tb.GLRCUCB(N, M, history=256)
    out = simulate_aoi_regret(sched, proc, T, generator=_gen(7), collect_curve=False, **CPU)
    env = proc.realize(_gen(7), **CPU)
    idle_best = float(torch.sort(env.table[0]).values[-M:].mean())
    assert float(out["success_rate"]) < idle_best - 0.05


def test_reactive_jammer_rejects_reactive_base():
    with pytest.raises(ValueError, match="reactive"):
        tc.ReactiveJammerProcess(base=tc.make_scenario("congestion", n_channels=N, horizon=T))


def test_reactive_env_has_no_offline_stream():
    with pytest.raises(ValueError, match="no offline round stream"):
        offline_round_stream(_env(), torch.rand((T, 2, N)), T)


# ---------------------------------------------------------------------------
# the reaction law against JAX's, op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("react", [(0.8, 0.9, 0.3, 16.0), (0.9, 0.6, 0.5, 4.0),
                                   (0.0, 1.0, 0.3, 16.0), (1.0, 1.0, 0.3, 16.0),
                                   (-0.5, 1.7, 0.0, 40.0)])
def test_reaction_law_matches_jax(react):
    rng = np.random.default_rng(0)
    table = rng.random((4, N)).astype(np.float32)
    jenv = jc.reactive_env(jnp.asarray(table), *react)
    tenv = convert.env(jenv, "cpu")
    assert torch.equal(tenv.react, torch.tensor(react, dtype=torch.float32))
    for t in range(4):
        load = rng.random(N).astype(np.float32)
        mask = (rng.random(N) < 0.4).astype(np.float32)
        np.testing.assert_allclose(
            tenv.means_dyn(t, torch.from_numpy(load)).numpy(),
            np.array(jenv.means_dyn(jnp.int32(t), jnp.asarray(load))), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(
            tenv.interact_step(torch.from_numpy(load), t, torch.from_numpy(mask)).numpy(),
            np.array(jenv.interact_step(jnp.asarray(load), jnp.int32(t), jnp.asarray(mask))))


# ---------------------------------------------------------------------------
# trajectory parity with the JAX harness on JAX's realized reactive envs
# ---------------------------------------------------------------------------

PN, PM, PT, PH, PSTRIDE = 5, 2, 300, 64, 5
KEY = jax.random.PRNGKey(21)


def _policy(name):
    mk = {
        "glr-cucb": lambda p: p.GLRCUCB(PN, PM, history=PH, detector_stride=PSTRIDE),
        "m-exp3": lambda p: p.MExp3(PN, PM, gamma=0.5),
        "aa-glr-cucb": lambda p: p.AoIAware(p.GLRCUCB(PN, PM, history=PH,
                                                      detector_stride=PSTRIDE)),
        "random": lambda p: p.RandomScheduler(PN, PM),
    }[name]
    return mk(jb), mk(tb)


def _jax_envs():
    base = jc.PiecewiseProcess(PN, PT, 3)
    return {"reactive_jammer": jc.ReactiveJammerProcess(base=base, strength=0.9)
            .realize(jax.random.PRNGKey(31)),
            "congestion": jc.LoadCongestionProcess(PN, PT, severity=0.8, knee=0.3)
            .realize(jax.random.PRNGKey(32))}


def _jax_replay(sched, env, key, horizon):
    """The JAX harness's scan body with its interaction carry, one round at
    a time: schedule, regret curve, the round's means and channel draw, the
    final AoIs and state, and after each round its policy state, AoI and
    load (``after``)."""
    @jax.jit
    def step(state, aoi_pi, aoi_star, istate, t, k):
        k_env, k_sel = jax.random.split(k)
        mu = env.means_dyn(t, istate)
        states = env.sample_dyn(t, k_env, istate)
        state, aoi_pi, channels, _ = jax_policy_round(sched, state, aoi_pi, t, k_sel, states)
        istate = env.interact_step(istate, t, jnp.zeros((PN,)).at[channels].set(1.0))
        _, star = jax_oracle(states, aoi_star, sched.n_clients)
        return (state, aoi_pi, jax_update_aoi(aoi_star, star), istate, channels, mu,
                jax.random.uniform(k_env, (PN,)))

    state, istate = sched.init(key), env.interact_init()
    aoi_pi = aoi_star = jax_init_aoi(sched.n_clients)
    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    channels, regret, gaps, after, cum = [], [], [], [], np.float32(0.0)
    for t in range(horizon):
        state, aoi_pi, aoi_star, istate, ch, mu, u = step(state, aoi_pi, aoi_star, istate,
                                                          jnp.int32(t), keys[t])
        cum = np.float32(cum + np.float32(np.array(jnp.sum(aoi_pi - aoi_star))))
        channels.append(np.array(ch))
        regret.append(cum)
        gaps.append(float(np.abs(np.array(u) - np.array(mu)).min()))
        after.append((state, np.array(aoi_pi), np.array(istate)))
    return dict(channels=np.stack(channels), regret=np.array(regret, np.float32),
                state=state, aoi_pi=np.array(aoi_pi), aoi_star=np.array(aoi_star),
                min_gap=min(gaps), after=after)


def _uniforms(jsched, key, horizon):
    def draws(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (PN,)), selection_uniform(jsched, k_sel, PN)])

    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    return torch.from_numpy(np.array(jax.vmap(draws)(keys)))


def _jax_counter(state, name):
    while not hasattr(state, name):
        state = getattr(state, "base", None)
        if not isinstance(state, tuple):
            return None
    return int(getattr(state, name))


def _port_replay(tsched, tenv, uniforms, want, label):
    """The port's per-round route, one round at a time, held to the JAX
    replay ``want`` round by round.  A round whose schedule differs must sit
    on a near-tie of the ranking that decided it; JAX's policy state, AoI
    and load after that round are then carried into the port and the replay
    goes on from them.  Returns the schedule, regret curve, final AoIs and
    state, and the rounds that forked."""
    state, aoi_pi, aoi_star, load = tsched.init("cpu"), torch.ones(PM), torch.ones(PM), \
        tenv.interact_init()
    channels, regret, forks, cum = [], [], [], np.float32(0.0)
    for t in range(PT):
        states = tenv.sample_dyn(t, uniforms[t, 0], load)
        new_state, new_aoi, ch, _ = policy_round(tsched, state, aoi_pi, t, uniforms[t, 1], states)
        if np.array_equal(ch.numpy(), want["channels"][t]):
            load = tenv.interact_step(load, t, torch.zeros(PN).scatter(0, ch, 1.0))
        else:
            assert _policy_near_tie(tsched, state, t, uniforms[t, 1], aoi_pi), (
                f"{label}: trajectories fork at round {t} without a near-tie: jax "
                f"{want['channels'][t]}, port {ch.tolist()}")
            forks.append(t)
            j_state, j_aoi, j_load = want["after"][t]
            new_state = convert.sched_state(tsched, j_state, "cpu")
            new_aoi, load = torch.from_numpy(j_aoi), torch.from_numpy(j_load)
            ch = torch.from_numpy(want["channels"][t])
        state, aoi_pi = new_state, new_aoi
        _, star = oracle_assign(states, aoi_star, PM)
        aoi_star = update_aoi(aoi_star, star)
        cum = np.float32(cum + np.float32((aoi_pi - aoi_star).sum().item()))
        channels.append(ch.numpy())
        regret.append(cum)
    return dict(channels=np.stack(channels), regret=np.array(regret, np.float32),
                aoi_pi=aoi_pi.numpy(), aoi_star=aoi_star.numpy(),
                **state_counters(state)), forks


def _policy_near_tie(tsched, state, t, u_sel, aoi):
    """Whether the ranking that decided round ``t`` sits on a 1e-5 near-tie:
    AoI-Aware's threshold or, when it exploits, its discounted means; else
    the base policy's own (``near_tie``)."""
    if isinstance(tsched, tb.AoIAware):
        mu_hat = state.mu_sum / state.pulls.clamp_min(1.0)
        h_t = state.hp["threshold_scale"] / mu_hat.max().clamp_min(1e-6)
        if _close_rel(aoi.max(), h_t):
            return True
        if bool(aoi.max() > h_t):
            return _sorted_gap_tie(mu_hat, PM)
        return near_tie(tsched.base, state.base, t, u_sel, aoi)
    return near_tie(tsched, state, t, u_sel, aoi)


@pytest.fixture(scope="module")
def jax_envs():
    return _jax_envs()


def _same_as_jax(got, want, label, rounds=PT):
    np.testing.assert_array_equal(np.asarray(got["channels"])[:rounds], want["channels"][:rounds],
                                  err_msg=label)
    np.testing.assert_array_equal(np.asarray(got["regret"])[:rounds], want["regret"][:rounds],
                                  err_msg=label)
    if rounds < PT:
        return
    np.testing.assert_array_equal(np.asarray(got["aoi_pi"]), want["aoi_pi"], err_msg=label)
    np.testing.assert_array_equal(np.asarray(got["aoi_star"]), want["aoi_star"], err_msg=label)
    for counter in ("restarts", "exploit_rounds"):
        expected = _jax_counter(want["state"], counter)
        assert (counter in got) == (expected is not None), (label, counter)
        if expected is not None:
            assert int(got[counter]) == expected, (label, counter)


# the schedule forks each case may show on these seeds: AoI-Aware over GLR-CUCB
# on congestion forks once, at round 6, on two discounted means an FMA apart
ALLOWED_FORKS = {("congestion", "aa-glr-cucb"): 1}


@pytest.mark.parametrize("family", ["reactive_jammer", "congestion"])
@pytest.mark.parametrize("name", ["glr-cucb", "m-exp3", "aa-glr-cucb", "random"])
def test_trajectory_matches_jax_on_a_reactive_env(jax_envs, family, name):
    jenv = jax_envs[family]
    jsched, tsched = _policy(name)
    tenv = convert.env(jenv, "cpu")
    assert tenv.form == "reactive" and torch.equal(tenv.react, torch.from_numpy(np.array(jenv.react)))
    want = _jax_replay(jsched, jenv, KEY, PT)
    assert want["min_gap"] > NO_FORK_GAP, (
        f"{family}/{name}: a draw lands within {want['min_gap']:.2e} of its mean; this seed "
        "cannot hold the trajectories bitwise")
    uniforms = _uniforms(jsched, KEY, PT)
    label = f"{family}/{name}"
    replay, forks = _port_replay(tsched, tenv, uniforms, want, label)
    assert len(forks) <= ALLOWED_FORKS.get((family, name), 0), (label, forks)
    _same_as_jax(replay, want, f"{label} replay")
    got = simulate_aoi_regret(tsched, tenv, PT, uniforms=uniforms, return_state=True, **CPU)
    _same_as_jax(got, want, f"{label} harness", rounds=forks[0] if forks else PT)


def test_replay_is_the_jax_harness_on_a_reactive_env(jax_envs):
    """The replay above is the JAX harness (same key layout, same carry)."""
    jsched, _ = _policy("glr-cucb")
    want = _jax_replay(jsched, jax_envs["reactive_jammer"], KEY, PT)
    jout = jax_simulate(jsched, jax_envs["reactive_jammer"], KEY, PT)
    np.testing.assert_array_equal(np.array(jout["regret"]), want["regret"])
    assert int(jout["restarts"]) == _jax_counter(want["state"], "restarts")


def test_chaos_size_reactive_jammer_matches_jax():
    """At ``chaos_suite``'s regret size (N = 8, M = 3, H = 256, stride 5,
    T = 4000, base ``PiecewiseProcess(8, 4000, 4)``, strength 0.9), JAX's
    realized follower jammer through ``convert.env`` and JAX's uniforms give
    the port's per-round route JAX's regret curve and restarts bit for bit."""
    n, m, horizon = 8, 3, 4000
    jsched = jb.GLRCUCB(n, m, history=256, detector_stride=5)
    tsched = tb.GLRCUCB(n, m, history=256, detector_stride=5)
    jenv = jc.ReactiveJammerProcess(base=jc.PiecewiseProcess(n, horizon, 4), strength=0.9) \
        .realize(jax.random.PRNGKey(33))
    key = jax.random.PRNGKey(0)
    want = jax_simulate(jsched, jenv, key, horizon)

    def draws(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (n,)), selection_uniform(jsched, k_sel, n)])

    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    uniforms = torch.from_numpy(np.array(jax.vmap(draws)(keys)))
    got = simulate_aoi_regret(tsched, convert.env(jenv, "cpu"), horizon, uniforms=uniforms, **CPU)
    np.testing.assert_array_equal(got["regret"].numpy(), np.array(want["regret"]))
    assert float(got["final_regret"]) == float(want["final_regret"])
    assert int(got["restarts"]) == int(want["restarts"])


# ---------------------------------------------------------------------------
# a stacked reactive batch equals its serial runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["glr-cucb", "m-exp3"])
@pytest.mark.parametrize("shared", [False, True], ids=["stacked", "shared"])
def test_reactive_batch_equals_serial_runs(name, shared):
    _, sched = _policy(name)
    procs = [tc.make_scenario("congestion", n_channels=PN, horizon=PT, knee=0.3),
             tc.make_scenario("reactive_jammer", base=tc.PiecewiseProcess(PN, PT, 3)),
             tc.make_scenario("congestion", n_channels=PN, horizon=PT, severity=0.95)]
    gens = [_gen(40 + i) for i in range(len(procs))]
    envs = tc.realize_processes(procs, gens, **CPU)
    u = torch.rand((len(procs), PT, 2, PN), generator=_gen(9))
    if shared:
        env0 = procs[1].realize(_gen(41), **CPU)
        out = simulate_aoi_regret_batch(sched, env0, PT, uniforms=u, env_axis=None,
                                        return_state=True, **CPU)
        rows = [env0] * len(procs)
    else:
        out = simulate_aoi_regret_batch(sched, envs, PT, uniforms=u, return_state=True, **CPU)
        rows = [p.realize(_gen(40 + i), **CPU) for i, p in enumerate(procs)]
    assert out["route"] == "rounds"
    for i, env in enumerate(rows):
        want = simulate_aoi_regret(sched, env, PT, uniforms=u[i], return_state=True, **CPU)
        _bitwise(want, {k: v[i] if isinstance(v, torch.Tensor) else v for k, v in out.items()
                        if k != "final_sched_state"}, f"run {i}")
