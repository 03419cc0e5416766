"""Trajectory parity of the AoI-regret harness (Fig. 2 path).

The port's ``simulate_aoi_regret`` runs from JAX's own randomness: the
round keys ``split(fold_in(key, 1), T)``, each split into ``k_env, k_sel``
and drawn as (N,) uniforms — ``jax.random.bernoulli(k, p)`` is
``uniform(k, p.shape) < p``, so the channel states agree bitwise.  The
JAX side is replayed round by round (checked against its own
``simulate_aoi_regret``) to expose the per-round schedule and restarts.

Channel sequences, restart rounds and AoI must be equal.  ``log`` and
``sqrt`` differ by an ulp between XLA and torch on the CPU, so a
trajectory may fork at an ulp-level near-tie; a fork passes only if, at
the first differing round, the UCB ranking gap or a GLR statistic's
distance to its threshold is within 1e-5 relative.  Any other fork fails.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.aoi import init_aoi as jax_init_aoi, update_aoi as jax_update_aoi  # noqa: E402
from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.bandits.oracle import oracle_assign as jax_oracle  # noqa: E402
from repro.core.channels import random_piecewise_env  # noqa: E402
from repro.core.regret import policy_round as jax_policy_round  # noqa: E402
from repro.core.regret import simulate_aoi_regret as jax_simulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.bandits import GLRCUCB, glr_threshold  # noqa: E402
from repro_torch.core.bandits.oracle import oracle_assign  # noqa: E402
from repro_torch.core.channels import make_scenario  # noqa: E402
from repro_torch.core.regret import (  # noqa: E402
    regret_growth_exponent,
    simulate_aoi_regret,
    sublinearity_index,
)
from repro.core.regret import regret_growth_exponent as jax_growth  # noqa: E402
from repro.core.regret import sublinearity_index as jax_sublinearity  # noqa: E402

N, M, H, STRIDE, T = 5, 2, 64, 5, 400
KEY = jax.random.PRNGKey(7)
REL_TIE = 1e-5


def jax_uniforms(key, horizon, n):
    """(T, 2, N): the uniforms behind each round's ``k_env``/``k_sel``."""
    def draws(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (n,)), jax.random.uniform(k_sel, (n,))])

    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    return np.array(jax.vmap(draws)(keys))


def _jax_replay(sched, env, key, horizon):
    """The JAX harness's scan body, one round at a time."""
    @jax.jit
    def step(state, aoi_pi, aoi_star, t, k):
        k_env, k_sel = jax.random.split(k)
        states = env.sample(t, k_env)
        state, aoi_pi, channels, _ = jax_policy_round(sched, state, aoi_pi, t, k_sel, states)
        _, star = jax_oracle(states, aoi_star, sched.n_clients)
        return state, aoi_pi, jax_update_aoi(aoi_star, star), channels

    state = sched.init(key)
    aoi_pi = aoi_star = jax_init_aoi(sched.n_clients)
    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    trace = []
    for t in range(horizon):
        prev = state
        state, aoi_pi, aoi_star, channels = step(state, aoi_pi, aoi_star, jnp.int32(t), keys[t])
        trace.append((prev, np.array(channels), int(state.restarts), np.array(aoi_pi)))
    return trace, state, aoi_pi, aoi_star


def _port_replay(sched, env, uniforms, horizon):
    """The port's harness loop, one round at a time (same calls as
    ``simulate_aoi_regret``)."""
    state = sched.init("cpu")
    aoi_pi = torch.ones(M)
    trace = []
    for t in range(horizon):
        prev = state
        states = env.sample(t, uniforms[t, 0])
        channels, aux = sched.select(state, t, uniforms[t, 1], aoi_pi)
        rewards = states[channels]
        state = sched.update(state, t, channels, rewards, aux)
        aoi_pi = torch.where(rewards > 0.5, 1.0, aoi_pi + 1.0)
        trace.append((prev, channels.numpy(), int(state.restarts), aoi_pi.numpy()))
    return trace


def _near_tie(sched, state, t, u_sel, channels, rewards):
    """Whether round ``t`` from ``state`` sits on an ulp-level near-tie:
    the M-th and (M+1)-th UCB keys, or a scheduled channel's GLR statistic
    and its threshold, within ``REL_TIE`` relative."""
    ucb = sched.ucb(state, t)
    key = torch.where(torch.isinf(ucb), 1e9, ucb) + torch.where(state.counts == 0, u_sel * 1e6, 0.0)
    top = torch.sort(key, descending=True).values
    if abs(float(top[M - 1] - top[M])) <= REL_TIE * abs(float(top[M - 1])):
        return True
    if t % sched.detector_stride:
        return False
    sched_mask = torch.zeros(N, dtype=torch.bool).index_fill(0, channels, True)
    r_vec = torch.zeros(N).index_put((channels,), rewards)
    counts = state.counts + sched_mask.float()
    from repro_torch.kernels import ref
    *_, stats = ref.glr_step(state.cum, state.total, state.base, state.counts, r_vec, sched_mask)
    thresh = glr_threshold(counts.clamp_max(float(H)).to(torch.int32), state.hp["delta"])
    gap = (stats - thresh).abs() <= REL_TIE * thresh.abs()
    return bool((gap & sched_mask & torch.isfinite(stats)).any())


def test_trajectory_matches_jax():
    env = random_piecewise_env(jax.random.PRNGKey(11), N, T, 5)
    jsched = JaxGLRCUCB(N, M, history=H, detector_stride=STRIDE)
    tsched = GLRCUCB(N, M, history=H, detector_stride=STRIDE)
    tenv = convert.channel_env(env.form, env.means, env.breaks, env.table, device="cpu")
    uniforms = torch.from_numpy(jax_uniforms(KEY, T, N))

    jtrace, jstate, jaoi_pi, jaoi_star = _jax_replay(jsched, env, KEY, T)
    jout = jax_simulate(jsched, env, KEY, T, return_state=True)
    assert np.array_equal(np.array(jout["aoi_pi"]), np.array(jaoi_pi))
    assert int(jout["restarts"]) == int(jstate.restarts)

    ttrace = _port_replay(tsched, tenv, uniforms, T)
    for t, (j, p) in enumerate(zip(jtrace, ttrace)):
        same = (np.array_equal(j[1], p[1]) and j[2] == p[2] and np.array_equal(j[3], p[3]))
        if not same:
            state = p[0]
            channels = torch.from_numpy(p[1])
            rewards = tenv.sample(t, uniforms[t, 0])[channels]
            assert _near_tie(tsched, state, t, uniforms[t, 1], channels, rewards), (
                f"trajectories fork at round {t} without a near-tie: "
                f"jax {j[1]} restarts {j[2]}, port {p[1]} restarts {p[2]}")
            return

    # no fork: the harness itself agrees end to end
    tout = simulate_aoi_regret(tsched, tenv, T, uniforms=uniforms, return_state=True,
                               device="cpu")
    np.testing.assert_array_equal(tout["regret"].numpy(), np.array(jout["regret"]))
    np.testing.assert_array_equal(tout["aoi_pi"].numpy(), np.array(jout["aoi_pi"]))
    np.testing.assert_array_equal(tout["aoi_star"].numpy(), np.array(jout["aoi_star"]))
    assert int(tout["restarts"]) == int(jout["restarts"])
    np.testing.assert_array_equal(tout["channels"].numpy(), np.stack([p[1] for p in ttrace]))
    np.testing.assert_allclose(tout["cum_aoi_var"].numpy(), np.array(jout["cum_aoi_var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tout["success_rate"]), float(jout["success_rate"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(sublinearity_index(tout["regret"])),
                               float(jax_sublinearity(jout["regret"])), rtol=1e-6)
    np.testing.assert_allclose(regret_growth_exponent(tout["regret"]),
                               jax_growth(jout["regret"]), rtol=1e-5)


def test_oracle_matches_jax_on_ties():
    """Ties are the common case for the oracle (equal AoI, equal states);
    both sorts must be stable."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        states = (rng.random(7) < 0.4).astype(np.float32)
        aoi = rng.integers(1, 4, 5).astype(np.float32)
        jc, js = jax_oracle(jnp.asarray(states), jnp.asarray(aoi), 5)
        tc, ts = oracle_assign(torch.from_numpy(states), torch.from_numpy(aoi), 5)
        np.testing.assert_array_equal(tc.numpy(), np.array(jc))
        np.testing.assert_array_equal(ts.numpy(), np.array(js))


def test_simulate_draws_from_generator_on_cpu():
    """Without ``uniforms`` the loop draws from the generator: the same
    seed gives the same run."""
    env = make_scenario("piecewise", n_channels=N, horizon=300, n_breakpoints=2).realize(
        torch.Generator().manual_seed(1), device="cpu")
    runs = [simulate_aoi_regret(GLRCUCB(N, M, history=H), env, 300,
                                generator=torch.Generator().manual_seed(5), device="cpu")
            for _ in range(2)]
    assert torch.equal(runs[0]["regret"], runs[1]["regret"])
    assert torch.isfinite(runs[0]["regret"]).all()
    assert runs[0]["channels"].shape == (300, M)


def test_channel_env_forms_and_aoi_match_jax():
    """The randomness seam: ``sample(t, u)`` with ``u = uniform(k, (N,))``
    equals ``jax.random.bernoulli(k, mu(t))`` bitwise, for the segments and
    table forms; the AoI helpers agree."""
    from repro.core import aoi as jaoi
    from repro.core.channels import make_piecewise as jax_piecewise, table_env as jax_table
    from repro_torch.core import aoi as taoi
    from repro_torch.core.channels import make_piecewise, table_env

    rng = np.random.default_rng(3)
    means = rng.random((3, N)).astype(np.float32)
    breaks = np.array([5, 9], np.int32)
    table = rng.random((12, N)).astype(np.float32)
    pairs = [(jax_piecewise(means, breaks), make_piecewise(means, breaks, device="cpu")),
             (jax_table(table), table_env(table, device="cpu"))]
    for jenv, tenv in pairs:
        for t in range(12):
            k = jax.random.fold_in(KEY, t)
            u = torch.from_numpy(np.array(jax.random.uniform(k, (N,))))
            np.testing.assert_array_equal(tenv.means_at(t).numpy(), np.array(jenv.means_at(t)))
            np.testing.assert_array_equal(
                tenv.sample(t, u).numpy(), np.array(jenv.sample(t, k)))
    with pytest.raises(ValueError, match="horizon"):
        pairs[1][1].means_at(12)

    aoi = rng.integers(1, 9, 6).astype(np.float32)
    mu_seq = rng.random(16).astype(np.float32)
    ok = rng.random(6) < 0.5
    np.testing.assert_array_equal(taoi.update_aoi(torch.from_numpy(aoi), torch.from_numpy(ok)),
                                  np.array(jaoi.update_aoi(jnp.asarray(aoi), jnp.asarray(ok))))
    for name, arg in (("mean_aoi", aoi), ("aoi_variance", aoi),
                      ("expected_aoi_from_means", mu_seq), ("oracle_stationary_aoi", mu_seq)):
        np.testing.assert_allclose(getattr(taoi, name)(torch.from_numpy(arg)).numpy(),
                                   np.array(getattr(jaoi, name)(jnp.asarray(arg))),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(taoi.init_aoi(4, "cpu").numpy(), np.array(jaoi.init_aoi(4)))


def test_scenarios_match_jax_in_distribution():
    """``make_scenario(...).realize(generator)`` draws from the JAX families'
    distributions (not their bits): per-channel mean of the segment means
    and the mean breakpoints agree over 200 draws each, and every draw has
    strictly ascending breakpoints inside (0, T) and means in the band."""
    from repro.core.channels import make_scenario as jax_make_scenario

    T_, nb, draws = 1000, 4, 200
    kw = dict(n_channels=N, horizon=T_, n_breakpoints=nb)
    jproc = jax_make_scenario("piecewise", **kw)
    tproc = make_scenario("piecewise", **kw)
    jenvs = [jproc.realize(jax.random.PRNGKey(i)) for i in range(draws)]
    gen = torch.Generator().manual_seed(0)
    tenvs = [tproc.realize(gen, device="cpu") for _ in range(draws)]
    for env in tenvs:
        b = env.breaks.numpy()
        assert (np.diff(b) > 0).all() and b[0] >= 1 and b[-1] <= T_ - 1
        m = env.means.numpy()
        assert m.shape == (nb + 1, N) and m.min() >= 0.1 - 1e-6 and m.max() <= 0.9 + 1e-6
    jm = np.mean([np.array(e.means) for e in jenvs], axis=(0, 1))
    tm = np.mean([e.means.numpy() for e in tenvs], axis=(0, 1))
    np.testing.assert_allclose(tm, jm, atol=0.04)
    jb = np.mean([np.array(e.breaks) for e in jenvs], axis=0)
    tb = np.mean([e.breaks.numpy() for e in tenvs], axis=0)
    np.testing.assert_allclose(tb, jb, atol=0.02 * T_)
    st = make_scenario("stationary", n_channels=N).realize(gen, device="cpu")
    assert st.means.shape == (1, N) and st.breaks.numel() == 0
