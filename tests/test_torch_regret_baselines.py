"""Trajectory parity of the AoI-regret harness (Fig. 2a) for the baselines.

Each Fig. 2a row but the GLR-CUCB ones on the piecewise env (held by
``tests/test_torch_regret.py``) runs T rounds at N = 5, M = 2 through the
port's ``simulate_aoi_regret`` on the CPU and through the JAX harness's
scan body replayed round by round, on a piecewise env and on the JAX
adversarial table carried across with ``convert.channel_env``.  The port
gets the uniforms behind each round key's ``k_env, k_sel`` split, the
selection uniform through ``selection_uniform`` (the seam of each policy,
``tests/test_torch_baselines.py``).

Schedules, AoI, the regret curve, restarts and ``exploit_rounds`` must be
equal.  A trajectory may fork only at a near-tie within 1e-5 relative
(``near_tie``: channel-aware's perturbed scores, M-Exp3's draw against a
CDF boundary, AoI-Aware's threshold, GLR-CUCB's UCB ranking); up to the
fork everything must still be equal.  Any other fork fails.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro.core.aoi import init_aoi as jax_init_aoi, update_aoi as jax_update_aoi  # noqa: E402
from repro.core.bandits.oracle import oracle_assign as jax_oracle  # noqa: E402
from repro.core.channels import random_adversarial_env as jax_adversarial  # noqa: E402
from repro.core.channels import random_piecewise_env as jax_piecewise  # noqa: E402
from repro.core.regret import policy_round as jax_policy_round  # noqa: E402
from repro.core.regret import simulate_aoi_regret as jax_simulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.regret import policy_round, simulate_aoi_regret  # noqa: E402
from test_torch_baselines import near_tie, selection_uniform  # noqa: E402

N, M, H, STRIDE, T = 5, 2, 64, 5, 300
KEY = jax.random.PRNGKey(7)


def _policy(name, share):
    """(JAX policy, port policy) of a Fig. 2a row; ``share`` is M-Exp3's
    Exp3.S rate (the adversarial rows use 1e-3)."""
    mk = {
        "random": lambda p: p.RandomScheduler(N, M),
        "round-robin": lambda p: p.RoundRobinScheduler(N, M),
        "channel-aware": lambda p: p.ChannelAwareAsync(N, M),
        "lyapunov": lambda p: p.LyapunovSched(N, M),
        "glr-cucb": lambda p: p.GLRCUCB(N, M, history=H, detector_stride=STRIDE),
        "aa-glr-cucb": lambda p: p.AoIAware(p.GLRCUCB(N, M, history=H, detector_stride=STRIDE)),
        "m-exp3": lambda p: p.MExp3(N, M, gamma=0.5, share_alpha=share),
        "aa-m-exp3": lambda p: p.AoIAware(p.MExp3(N, M, gamma=0.5, share_alpha=share)),
    }[name]
    return mk(jb), mk(tb)


ENVS = {
    "piecewise": lambda: jax_piecewise(jax.random.PRNGKey(11), N, T, 5),
    "adversarial": lambda: jax_adversarial(jax.random.PRNGKey(12), N, T, flip_prob=0.02),
}
CASES = ([("piecewise", p) for p in ("random", "round-robin", "channel-aware", "lyapunov",
                                     "aa-glr-cucb", "m-exp3", "aa-m-exp3")]
         + [("adversarial", p) for p in ("random", "round-robin", "channel-aware", "lyapunov",
                                         "m-exp3", "aa-m-exp3", "glr-cucb", "aa-glr-cucb")])


def _jax_replay(sched, env, key, horizon):
    """The JAX harness's scan body, one round at a time: the schedule, the
    regret curve, the final AoIs and state."""
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
    channels, regret, cum = [], [], np.float32(0.0)
    for t in range(horizon):
        state, aoi_pi, aoi_star, ch = step(state, aoi_pi, aoi_star, jnp.int32(t), keys[t])
        cum = np.float32(cum + np.float32(np.array(jnp.sum(aoi_pi - aoi_star))))
        channels.append(np.array(ch))
        regret.append(cum)
    return np.stack(channels), np.array(regret, np.float32), state, aoi_pi, aoi_star


def _uniforms(jsched, key, horizon):
    """(T, 2, N): per round the env's uniform on ``k_env`` and the policy's
    selection uniform on ``k_sel``."""
    def draws(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (N,)), selection_uniform(jsched, k_sel, N)])

    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    return torch.from_numpy(np.array(jax.vmap(draws)(keys)))


def _port_state_at(tsched, tenv, uniforms, t_fork):
    """The port's policy state and AoI before round ``t_fork``."""
    state, aoi = tsched.init("cpu"), torch.ones(M)
    for t in range(t_fork):
        states = tenv.sample(t, uniforms[t, 0])
        state, aoi, _, _ = policy_round(tsched, state, aoi, t, uniforms[t, 1], states)
    return state, aoi


def _jax_counter(state, name):
    while not hasattr(state, name):
        state = getattr(state, "base", None)
        if not isinstance(state, tuple):
            return None
    return int(getattr(state, name))


@pytest.fixture(scope="module")
def envs():
    return {k: mk() for k, mk in ENVS.items()}


@pytest.mark.parametrize("env_name, name", CASES)
def test_trajectory_matches_jax(envs, env_name, name):
    jenv = envs[env_name]
    jsched, tsched = _policy(name, 1e-3 if env_name == "adversarial" else 0.0)
    tenv = convert.channel_env(jenv.form, jenv.means, jenv.breaks, jenv.table,
                               jenv.score_kind, device="cpu")
    assert tenv.score_kind == ("mean" if env_name == "adversarial" else "ucb")
    uniforms = _uniforms(jsched, KEY, T)
    jch, jregret, jstate, jaoi_pi, jaoi_star = _jax_replay(jsched, jenv, KEY, T)
    out = simulate_aoi_regret(tsched, tenv, T, uniforms=uniforms, return_state=True,
                              device="cpu")
    tch = out["channels"].numpy()
    differ = np.nonzero((tch != jch).any(axis=1))[0]
    if differ.size:
        t0 = int(differ[0])
        np.testing.assert_array_equal(out["regret"][:t0].numpy(), jregret[:t0])
        state, aoi = _port_state_at(tsched, tenv, uniforms, t0)
        assert near_tie(tsched, state, t0, uniforms[t0, 1], aoi), (
            f"{env_name}/{name}: trajectories fork at round {t0} without a near-tie: "
            f"jax {jch[t0]}, port {tch[t0]}")
        return
    np.testing.assert_array_equal(out["regret"].numpy(), jregret)
    np.testing.assert_array_equal(out["aoi_pi"].numpy(), np.array(jaoi_pi))
    np.testing.assert_array_equal(out["aoi_star"].numpy(), np.array(jaoi_star))
    for counter in ("restarts", "exploit_rounds"):
        expected = _jax_counter(jstate, counter)
        if expected is None:
            assert counter not in out, (name, counter)
        else:
            assert int(out[counter]) == expected, (name, counter)
            assert out[counter].dtype == torch.int32


def test_replay_is_the_jax_harness(envs):
    """The replay above equals the JAX harness itself (same key layout),
    for a wrapped policy on the adversarial table."""
    jsched, _ = _policy("aa-m-exp3", 1e-3)
    jch, jregret, _, jaoi_pi, _ = _jax_replay(jsched, envs["adversarial"], KEY, T)
    jout = jax_simulate(jsched, envs["adversarial"], KEY, T)
    np.testing.assert_array_equal(np.array(jout["regret"]), jregret)
    np.testing.assert_array_equal(np.array(jout["aoi_pi"]), np.array(jaoi_pi))


def test_counters_read_through_the_wrapper():
    """``restarts`` of a wrapped GLR-CUCB and AoI-Aware's ``exploit_rounds``
    come out of the harness; a policy without counters gives neither."""
    from repro_torch.core.channels import make_piecewise

    env = make_piecewise(np.array([[0.9, 0.8, 0.1, 0.1, 0.1], [0.1, 0.1, 0.1, 0.9, 0.8]],
                                  np.float32), np.array([150]), device="cpu")
    u = torch.rand((T, 2, N), generator=torch.Generator().manual_seed(0))
    aa = simulate_aoi_regret(tb.AoIAware(tb.GLRCUCB(N, M, history=H)), env, T, uniforms=u,
                             device="cpu", return_state=True)
    assert int(aa["restarts"]) == int(aa["final_sched_state"].base.restarts) >= 1
    assert int(aa["exploit_rounds"]) == int(aa["final_sched_state"].exploit_rounds) >= 1
    plain = simulate_aoi_regret(tb.RandomScheduler(N, M), env, T, uniforms=u, device="cpu")
    assert "restarts" not in plain and "exploit_rounds" not in plain
