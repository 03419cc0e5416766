"""The port's batched AoI-regret engine (``repro_torch.sim``) on the CPU.

* The JAX engine's own regret contract (``tests/test_sim_engine.py``): a
  batch of 1 is the serial run bit for bit, a multi-seed batch equals the
  per-seed serial runs, env broadcast, the axis rule, env stacking.
* Every policy's batched round (``select``/``update`` over a leading run
  axis) equals its unbatched round on each row, bit for bit.
* The whole batch equals the port's serial runs bit for bit, for all seven
  policies (both GLR detectors) on stacked piecewise and adversarial envs;
  the variance sums at rtol 1e-6 where M > 2 (ROADMAP Queue 3: a sum of M
  squares may add in another order).
* JAX against the port on the same inputs: ``simulate_aoi_regret_batch``
  with B = 3 keys against the port on those keys' uniforms (the seam of
  ``tests/test_torch_baselines.py``), stacked envs, a shared env, a shared
  key and an hp grid carried across by ``convert``.  The schedule, the
  regret curve, the AoI, the variance sums (M = 2), the counts and
  ``restarts`` are bitwise; the GLR-CUCB means at rtol 1e-6 and M-Exp3's
  log-weights at rtol 1e-5 (``log``/``exp`` differ by an ulp between XLA
  and torch, ROADMAP Queue 3), the discounted sums of AoI-Aware, Lyapunov
  and channel-aware at rtol 1e-5 (XLA contracts ``rho * x + y`` into a
  fused multiply-add inside its compiled scan, Queue 3); the success rate
  at rtol 1e-6 (XLA multiplies the count by 1 / (T * M), the port
  divides).  A run may fork only at a near-tie within 1e-5
  relative, everything equal before it, as in
  ``tests/test_torch_regret_baselines.py``.
"""
import dataclasses

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
from repro.core.channels import stack_envs as jax_stack_envs  # noqa: E402
from repro.core.regret import policy_round as jax_policy_round  # noqa: E402
from repro.sim import simulate_aoi_regret_batch as jax_batch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.bandits.base import init_batch, stack_params  # noqa: E402
from repro_torch.core.channels import (  # noqa: E402
    AdversarialProcess,
    dense_means,
    env_batch_size,
    make_stationary,
    random_adversarial_env,
    random_piecewise_env,
    stack_envs,
)
from repro_torch.core.regret import policy_round, simulate_aoi_regret  # noqa: E402
from repro_torch.sim import simulate_aoi_regret_batch  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402
from test_torch_baselines import LEAF_RTOL, near_tie, selection_uniform  # noqa: E402

T = 300
N, M, H, STRIDE = 5, 2, 64, 5
CPU = dict(device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _u(seed, b, horizon=T, n=N):
    return torch.rand((b, horizon, 2, n), generator=_gen(seed))


def _bitwise(want, got, label=""):
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, got[k]), f"{label}.{k}"


def _row(tree, i):
    """Run ``i`` of a batched result or state (0-d and non-tensor leaves, the
    shared ones, as they are)."""
    return tree_map(lambda x: x[i] if isinstance(x, torch.Tensor) and x.dim() else x, tree)


# ---------------------------------------------------------------------------
# the JAX engine's contract (tests/test_sim_engine.py), on the port
# ---------------------------------------------------------------------------

def _pw(seed, n=N, horizon=T, k=3):
    return random_piecewise_env(_gen(seed), n, horizon, k, **CPU)


@pytest.mark.parametrize("sched,env_fn", [
    (tb.GLRCUCB(5, 2, history=128, detector_stride=4), lambda: _pw(0)),
    (tb.MExp3(5, 2, share_alpha=1e-3),
     lambda: random_adversarial_env(_gen(0), 5, T, flip_prob=0.01, **CPU)),
    (tb.RandomScheduler(5, 2), lambda: make_stationary(np.linspace(0.9, 0.1, 5), **CPU)),
    (tb.ChannelAwareAsync(5, 2), lambda: _pw(0)),
    (tb.LyapunovSched(5, 2), lambda: _pw(0)),
], ids=["glr-cucb", "m-exp3", "random", "channel-aware", "lyapunov"])
def test_batch1_bitwise_matches_serial(sched, env_fn):
    env = env_fn()
    u = _u(1, 1)
    serial = simulate_aoi_regret(sched, env, T, uniforms=u[0], return_state=True, **CPU)
    batched = simulate_aoi_regret_batch(sched, stack_envs([env]), T, uniforms=u,
                                        return_state=True, **CPU)
    assert batched["route"] == "rounds"
    _bitwise(serial, _row({k: v for k, v in batched.items() if k != "final_sched_state"}, 0))
    for a, b in zip(_leaves(serial["final_sched_state"]),
                    _leaves(_row(batched["final_sched_state"], 0))):
        assert torch.equal(a, b)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def test_multi_seed_batch_matches_per_seed_serial():
    sched = tb.GLRCUCB(4, 2, history=64, detector_stride=4)
    envs = [_pw(i, n=4, k=2) for i in range(4)]
    u = _u(100, 4, n=4)
    out = simulate_aoi_regret_batch(sched, stack_envs(envs), T, uniforms=u, **CPU)
    for i, env in enumerate(envs):
        _bitwise(simulate_aoi_regret(sched, env, T, uniforms=u[i], **CPU), _row(out, i), str(i))


def test_env_broadcast_over_seed_batch():
    """One env, many seeds: env_axis=None shares the unbatched env."""
    sched = tb.RandomScheduler(5, 2)
    env = make_stationary(np.linspace(0.9, 0.1, 5), **CPU)
    out = simulate_aoi_regret_batch(sched, env, T, generator=_gen(3), env_axis=None,
                                    uniforms=_u(3, 3), **CPU)
    assert out["final_regret"].shape == (3,)
    assert len(set(out["final_regret"].tolist())) > 1      # different seeds, trajectories


def test_batch_requires_some_axis():
    env = make_stationary(np.linspace(0.9, 0.1, 5), **CPU)
    with pytest.raises(ValueError, match="nothing to batch"):
        simulate_aoi_regret_batch(tb.RandomScheduler(5, 2), env, T, env_axis=None,
                                  uniforms_axis=None, **CPU)


def test_batch_rejects_an_unrealized_process():
    with pytest.raises(TypeError, match="unrealized ChannelProcess.*realize"):
        simulate_aoi_regret_batch(tb.MExp3(N, M), AdversarialProcess(N, T), T, **CPU)


def test_batch_checks_its_axes_and_sizes():
    env = _pw(0)
    with pytest.raises(ValueError, match="stacked env"):
        simulate_aoi_regret_batch(tb.RandomScheduler(N, M), env, T, uniforms=_u(0, 2), **CPU)
    with pytest.raises(ValueError, match="sizes differ"):
        simulate_aoi_regret_batch(tb.RandomScheduler(N, M), stack_envs([env] * 3), T,
                                  uniforms=_u(0, 2), **CPU)
    with pytest.raises(ValueError, match="comes from"):
        simulate_aoi_regret_batch(tb.RandomScheduler(N, M), env, T, env_axis=None, **CPU)
    with pytest.raises(ValueError, match="impl='scan' does not apply.*cpu"):
        simulate_aoi_regret_batch(tb.GLRCUCB(N, M, history=16), stack_envs([env]), T,
                                  impl="scan", uniforms=_u(0, 1), **CPU)


def test_stack_envs_shapes_and_batch_size():
    envs = [_pw(i, n=6, k=2) for i in range(3)]
    stacked = stack_envs(envs)
    assert stacked.means.shape == (3,) + envs[0].means.shape
    assert stacked.breaks.shape == (3,) + envs[0].breaks.shape
    assert stacked.kind == "piecewise"
    assert env_batch_size(stacked) == 3
    assert env_batch_size(envs[0]) == 1


@pytest.mark.parametrize("pair", ["kind", "shape", "empty"])
def test_stack_envs_rejects_mismatch(pair):
    if pair == "empty":
        with pytest.raises(ValueError, match="empty env list"):
            stack_envs([])
        return
    a = make_stationary(np.linspace(0.9, 0.1, 5), **CPU) if pair == "kind" else _pw(0, k=2)
    b = random_adversarial_env(_gen(0), 5, T, **CPU) if pair == "kind" else _pw(0, k=4)
    with pytest.raises(ValueError, match="share kind"):
        stack_envs([a, b])


# ---------------------------------------------------------------------------
# every policy's batched round against its unbatched round, row by row
# ---------------------------------------------------------------------------

def _policies(n=N, m=M, h=H):
    glr = lambda **kw: tb.GLRCUCB(n, m, history=h, detector_stride=STRIDE, **kw)
    return {
        "glr-cucb": glr(),
        "glr-cucb-recompute": glr(detector_impl="recompute"),
        "glr-cucb-fused": glr(detector_backend="kernel"),
        "glr-cucb-alpha": glr(alpha=0.3),
        "m-exp3": tb.MExp3(n, m),
        "m-exp3-s": tb.MExp3(n, m, share_alpha=1e-3),
        "aa-glr-cucb": tb.AoIAware(glr()),
        "aa-m-exp3": tb.AoIAware(tb.MExp3(n, m, share_alpha=1e-3)),
        "random": tb.RandomScheduler(n, m),
        "round-robin": tb.RoundRobinScheduler(n, m),
        "channel-aware": tb.ChannelAwareAsync(n, m),
        "lyapunov": tb.LyapunovSched(n, m),
        "lyapunov-rate": tb.LyapunovSched(n, m, min_rate=0.3),
    }


POLICY_NAMES = list(_policies())


@pytest.mark.parametrize("name", POLICY_NAMES)
def test_batched_round_equals_unbatched_rows(name):
    """100 rounds of ``select``/``update`` on 4 rows at once (each row its
    own hyper-parameters, env and uniforms), every round's channels, aux
    and state held bit for bit against the unbatched calls on each row."""
    rep = _policies()[name]
    b, rounds = 4, 100
    rng = np.random.default_rng(5)
    grid = [_random_traced(rep, rng) for _ in range(b)]
    hp = stack_params(grid, "cpu")
    state = init_batch(rep, b, "cpu", hp)
    rows = [tb.init_with_hp(g, "cpu", None) for g in grid]
    aoi, aois = torch.ones((b, M)), [torch.ones(M) for _ in range(b)]
    gen = _gen(7)
    for t in range(rounds):
        u = torch.rand((b, N), generator=gen)
        ch_states = (torch.rand((b, N), generator=gen) < 0.5).float()
        channels, aux = rep.select(state, t, u, aoi)
        rewards = ch_states.gather(-1, channels)
        new = rep.update(state, t, channels, rewards, aux)
        for i, g in enumerate(grid):
            c_i, aux_i = g.select(rows[i], t, u[i], aois[i])
            assert torch.equal(c_i, channels[i]), (name, t, i)
            for x, y in zip(_leaves(aux_i), _leaves(_row(aux, i))):
                assert torch.equal(x, y), (name, t, i)
            rows[i] = g.update(rows[i], t, c_i, ch_states[i].gather(-1, c_i), aux_i)
            for f, (x, y) in enumerate(zip(_leaves(rows[i]), _leaves(_row(new, i)))):
                assert torch.equal(x, y), (name, t, i, f)
        state = new
        aoi = torch.where(rewards > 0.5, 1.0, aoi + 1.0)
        aois = [torch.where(rewards[i] > 0.5, 1.0, aois[i] + 1.0) for i in range(b)]


def _random_traced(cfg, rng):
    """A random traced-field override in each knob's valid domain."""
    ranges = {"gamma": (0.2, 0.9) if isinstance(cfg, tb.MExp3) else (0.3, 1.5),
              "delta": (1e-4, 1e-1), "min_samples": (4, 16), "share_alpha": (1e-4, 1e-2),
              "threshold_scale": (0.5, 2.0), "discount": (0.8, 0.99), "ema": (0.01, 0.3),
              "explore_eps": (0.05, 0.4), "v": (0.5, 8.0), "rate_slack": (0.2, 0.8),
              "min_rate": (0.1, 0.5)}
    vals = {}
    for f in cfg.traced_fields():
        v = float(rng.uniform(*ranges[f]))
        vals[f] = int(round(v)) if f == "min_samples" else v
    new = cfg.replace_traced(**vals)
    if isinstance(cfg, tb.AoIAware):
        new = dataclasses.replace(new, base=_random_traced(cfg.base, rng))
    return new


@pytest.mark.parametrize("env_kind", ["piecewise", "adversarial"])
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_batch_equals_serial_runs(name, env_kind):
    sched = _policies()[name]
    mk = (lambda s: _pw(s, k=5)) if env_kind == "piecewise" else \
        (lambda s: random_adversarial_env(_gen(s), N, T, flip_prob=0.02, **CPU))
    envs = [mk(10 + i) for i in range(3)]
    u = _u(20, 3)
    out = simulate_aoi_regret_batch(sched, stack_envs(envs), T, uniforms=u, **CPU)
    for i, env in enumerate(envs):
        _bitwise(simulate_aoi_regret(sched, env, T, uniforms=u[i], **CPU), _row(out, i),
                 f"{name}[{i}]")


@pytest.mark.parametrize("name", ["glr-cucb", "m-exp3", "aa-glr-cucb", "lyapunov"])
def test_batch_at_m_above_two_holds_the_variance_sums_at_rtol(name):
    """N = 8, M = 5: the schedule, regret, AoI and counters bitwise; the
    variance sums (sums of M squared deviations) at rtol 1e-6."""
    sched = _policies(8, 5, 32)[name]
    envs = [_pw(30 + i, n=8) for i in range(3)]
    u = _u(31, 3, n=8)
    out = simulate_aoi_regret_batch(sched, stack_envs(envs), T, uniforms=u, **CPU)
    for i, env in enumerate(envs):
        want = simulate_aoi_regret(sched, env, T, uniforms=u[i], **CPU)
        for k, v in want.items():
            if "var" in k:
                torch.testing.assert_close(out[k][i], v, rtol=1e-6, atol=0)
            else:
                assert torch.equal(out[k][i], v), k


def test_shared_env_uniforms_and_hp_axes():
    """Each axis on its own: one env and one stream shared, the hp grid
    mapped; one env shared, the streams mapped; every run the same."""
    env, u = _pw(40), _u(41, 3)
    rep = tb.GLRCUCB(N, M, history=H, detector_stride=STRIDE)
    grid = [rep.replace_traced(gamma=g) for g in (0.5, 1.0, 1.5)]
    out = simulate_aoi_regret_batch(rep, env, T, uniforms=u[0], env_axis=None,
                                    uniforms_axis=None, hparams=stack_params(grid, "cpu"),
                                    hp_axis=0, **CPU)
    for i, g in enumerate(grid):
        _bitwise(simulate_aoi_regret(g, env, T, uniforms=u[0], **CPU), _row(out, i))
    shared_hp = rep.replace_traced(delta=0.05)
    out = simulate_aoi_regret_batch(rep, env, T, uniforms=u, env_axis=None,
                                    hparams=shared_hp.params("cpu"), **CPU)
    for i in range(3):
        _bitwise(simulate_aoi_regret(shared_hp, env, T, uniforms=u[i], **CPU), _row(out, i))


def test_uniforms_drawn_from_the_generator():
    envs = stack_envs([_pw(50), _pw(51)])
    sched = tb.LyapunovSched(N, M)
    a = simulate_aoi_regret_batch(sched, envs, T, generator=_gen(52), **CPU)
    b = simulate_aoi_regret_batch(sched, envs, T, uniforms=_u(52, 2), **CPU)
    _bitwise(a, b)


def test_init_batch_hp_forms():
    sched = tb.AoIAware(tb.GLRCUCB(N, M, history=8))
    grid = [sched.replace_traced(discount=d) for d in (0.8, 0.9)]
    st = init_batch(sched, 2, "cpu", stack_params(grid, "cpu"))
    assert st.mu_sum.shape == (2, N) and st.base.cum.shape == (2, N, 8)
    assert st.hp["discount"].tolist() == pytest.approx([0.8, 0.9])
    assert st.base.hp["gamma"].shape == (2,)
    own = init_batch(sched, 3, "cpu")
    assert own.hp["discount"].dim() == 0 and own.base.tau.shape == (3,)
    with pytest.raises(ValueError, match="0-d or \\(3,\\)"):
        init_batch(sched, 3, "cpu", stack_params(grid, "cpu"))


# ---------------------------------------------------------------------------
# JAX's engine against the port's, on the same keys' uniforms
# ---------------------------------------------------------------------------

KEYS = jnp.stack([jax.random.PRNGKey(100 + i) for i in range(3)])


def _jax_policy(name, n=N, m=M, h=H):
    glr = lambda **kw: jb.GLRCUCB(n, m, history=h, detector_stride=STRIDE, **kw)
    return {
        "glr-cucb": glr(), "glr-cucb-recompute": glr(detector_impl="recompute"),
        "m-exp3": jb.MExp3(n, m), "m-exp3-s": jb.MExp3(n, m, share_alpha=1e-3),
        "aa-glr-cucb": jb.AoIAware(glr()),
        "aa-m-exp3": jb.AoIAware(jb.MExp3(n, m, share_alpha=1e-3)),
        "random": jb.RandomScheduler(n, m), "round-robin": jb.RoundRobinScheduler(n, m),
        "channel-aware": jb.ChannelAwareAsync(n, m), "lyapunov": jb.LyapunovSched(n, m),
    }[name]


JAX_POLICIES = ["glr-cucb", "glr-cucb-recompute", "m-exp3", "m-exp3-s", "aa-glr-cucb",
                "aa-m-exp3", "random", "round-robin", "channel-aware", "lyapunov"]


def _jax_uniforms(jsched, key, horizon=T):
    """(T, 2, N): each round's env uniform on ``k_env`` and the policy's
    selection uniform on ``k_sel`` (the seam of each policy)."""
    def draws(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (N,)), selection_uniform(jsched, k_sel, N)])

    keys = jax.random.split(jax.random.fold_in(key, 1), horizon)
    return np.array(jax.vmap(draws)(keys))


def _jax_trajectories(jsched, envs, keys, hp, env_axis, key_axis, hp_axis):
    """The JAX harness's scan body over the batch, keeping what the engine
    does not return: each round's channels and the final policy state."""
    def one(env, key, hp_):
        def step(carry, inp):
            state, aoi_pi, aoi_star = carry
            t, k = inp
            k_env, k_sel = jax.random.split(k)
            states = env.sample(t, k_env)
            state, aoi_pi, ch, _ = jax_policy_round(jsched, state, aoi_pi, t, k_sel, states)
            _, star = jax_oracle(states, aoi_star, jsched.n_clients)
            return (state, aoi_pi, jax_update_aoi(aoi_star, star)), ch

        state = jsched.init(key) if hp_ is None else jsched.init(key, hp=hp_)
        aoi = jax_init_aoi(jsched.n_clients)
        ks = jax.random.split(jax.random.fold_in(key, 1), T)
        (state, _, _), ch = jax.lax.scan(step, (state, aoi, aoi), (jnp.arange(T), ks))
        return ch, state

    return jax.jit(jax.vmap(one, in_axes=(env_axis, key_axis, hp_axis)))(envs, keys, hp)


# the discounted sums ``rho * x + y``, which XLA contracts into a fused
# multiply-add inside the compiled scan (ROADMAP Queue 3)
FMA_LEAVES = {("LyapunovState", "mu_sum"), ("LyapunovState", "pulls"),
              ("AoIAwareState", "mu_sum"), ("AoIAwareState", "pulls"),
              ("ChannelAwareState", "p_hat")}


def _state_leaves_close(tstate, jstate, label):
    for f in tstate._fields:
        tv, jv = getattr(tstate, f), getattr(jstate, f)
        if f == "hp":
            continue
        rtol = 1e-5 if (type(tstate).__name__, f) in FMA_LEAVES else LEAF_RTOL.get(f)
        if isinstance(tv, tuple):
            _state_leaves_close(tv, jv, f"{label}.{f}")
        elif rtol is not None:
            np.testing.assert_allclose(tv.numpy(), np.array(jv), rtol=rtol,
                                       atol=1e-6, err_msg=f"{label}.{f}")
        else:
            np.testing.assert_array_equal(tv.numpy(), np.array(jv), err_msg=f"{label}.{f}")


def _hold_against_jax(tscheds, tenvs, out, jout, jch, jstate, u, env_axis, label):
    """The port's batch against JAX's, run by run (``tscheds[i]`` the port
    policy of run i); a run may fork only at a near-tie, everything equal
    before it."""
    for i, tsched in enumerate(tscheds):
        tch = out["channels"][i].numpy()
        differ = np.nonzero((tch != np.array(jch[i])).any(axis=1))[0]
        if differ.size:
            t0 = int(differ[0])
            np.testing.assert_array_equal(out["regret"][i, :t0].numpy(),
                                          np.array(jout["regret"][i, :t0]))
            env = tenvs if env_axis is None else dataclasses.replace(
                tenvs, means=tenvs.means[i], breaks=tenvs.breaks[i], table=tenvs.table[i])
            ui = u[i] if u.dim() == 4 else u
            state, aoi = _port_state_at(tsched, env, ui, t0)
            assert near_tie(tsched, state, t0, ui[t0, 1], aoi), (
                f"{label}[{i}]: forks at round {t0} without a near-tie")
            continue
        for k in ("regret", "final_regret", "aoi_pi", "aoi_star", "cum_aoi_var",
                  "oracle_cum_aoi_var", "restarts"):
            if k in jout:
                np.testing.assert_array_equal(out[k][i].numpy(), np.array(jout[k][i]),
                                              err_msg=f"{label}[{i}].{k}")
        # XLA multiplies the success count by 1 / (T * M); the port divides
        np.testing.assert_allclose(out["success_rate"][i].numpy(),
                                   np.array(jout["success_rate"][i]), rtol=1e-6, atol=0)
        _state_leaves_close(_row(out["final_sched_state"], i), _row_jax(jstate, i),
                            f"{label}[{i}]")


def _row_jax(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _port_state_at(tsched, tenv, uniforms, t_fork):
    """The port's serial policy state and AoI before round ``t_fork``."""
    state, aoi = tsched.init("cpu"), torch.ones(M)
    mu = dense_means(tenv, T)
    for t in range(t_fork):
        states = (uniforms[t, 0] < mu[t]).float()
        state, aoi, _, _ = policy_round(tsched, state, aoi, t, uniforms[t, 1], states)
    return state, aoi


@pytest.fixture(scope="module")
def jax_envs():
    return {
        "piecewise": [jax_piecewise(jax.random.PRNGKey(11 + i), N, T, 5) for i in range(3)],
        "adversarial": [jax_adversarial(jax.random.PRNGKey(21 + i), N, T, flip_prob=0.02)
                        for i in range(3)],
    }


@pytest.mark.parametrize("env_kind", ["piecewise", "adversarial"])
@pytest.mark.parametrize("name", JAX_POLICIES)
def test_batch_matches_jax_on_stacked_envs(jax_envs, name, env_kind):
    jsched, tsched = _jax_policy(name), _policies()[name]
    jenvs = jax_stack_envs(jax_envs[env_kind])
    jout = jax_batch(jsched, jenvs, KEYS, T)
    jch, jstate = _jax_trajectories(jsched, jenvs, KEYS, None, 0, 0, None)
    tenvs = convert.env(jenvs, **CPU)
    u = torch.from_numpy(np.stack([_jax_uniforms(jsched, KEYS[i]) for i in range(3)]))
    out = simulate_aoi_regret_batch(tsched, tenvs, T, uniforms=u, return_state=True, **CPU)
    _hold_against_jax([tsched] * 3, tenvs, out, jout, jch, jstate, u, 0, f"{name}/{env_kind}")


@pytest.mark.parametrize("name", ["glr-cucb", "m-exp3-s", "channel-aware"])
def test_batch_matches_jax_with_a_shared_env(jax_envs, name):
    jsched, tsched = _jax_policy(name), _policies()[name]
    jenv = jax_envs["piecewise"][0]
    jout = jax_batch(jsched, jenv, KEYS, T, env_axis=None)
    jch, jstate = _jax_trajectories(jsched, jenv, KEYS, None, None, 0, None)
    tenv = convert.env(jenv, **CPU)
    u = torch.from_numpy(np.stack([_jax_uniforms(jsched, KEYS[i]) for i in range(3)]))
    out = simulate_aoi_regret_batch(tsched, tenv, T, uniforms=u, env_axis=None,
                                    return_state=True, **CPU)
    _hold_against_jax([tsched] * 3, tenv, out, jout, jch, jstate, u, None,
                      f"{name}/shared env")


@pytest.mark.parametrize("name", ["glr-cucb", "lyapunov"])
def test_batch_matches_jax_with_a_shared_key(jax_envs, name):
    jsched, tsched = _jax_policy(name), _policies()[name]
    jenvs = jax_stack_envs(jax_envs["adversarial"])
    jout = jax_batch(jsched, jenvs, KEYS[0], T, key_axis=None)
    jch, jstate = _jax_trajectories(jsched, jenvs, KEYS[0], None, 0, None, None)
    u = torch.from_numpy(_jax_uniforms(jsched, KEYS[0]))
    out = simulate_aoi_regret_batch(tsched, convert.env(jenvs, **CPU), T, uniforms=u,
                                    uniforms_axis=None, return_state=True, **CPU)
    _hold_against_jax([tsched] * 3, convert.env(jenvs, **CPU), out, jout, jch, jstate, u, 0,
                      f"{name}/shared key")


@pytest.mark.parametrize("name", ["glr-cucb", "aa-m-exp3"])
def test_batch_matches_jax_on_an_hp_grid(jax_envs, name):
    """A JAX ``stack_params`` grid carried across by ``convert.hparams``,
    over one shared env and key."""
    jrep, trep = _jax_policy(name), _policies()[name]
    if name == "glr-cucb":
        point = lambda p, a, b: p.replace_traced(gamma=a, delta=b)
        values = [(g, d) for g in (0.5, 1.5) for d in (1e-3, 0.1)]
    else:
        point = lambda p, a, b: dataclasses.replace(p.replace_traced(discount=a),
                                                    base=p.base.replace_traced(gamma=b))
        values = [(d, g) for d in (0.8, 0.95) for g in (0.3, 0.7)]
    jgrid = [point(jrep, *v) for v in values]
    jhp = jb.stack_params(jgrid)
    jenv = jax_envs["piecewise"][1]
    jout = jax_batch(jrep, jenv, KEYS[1], T, env_axis=None, key_axis=None, hparams=jhp,
                     hp_axis=0)
    jch, jstate = _jax_trajectories(jrep, jenv, KEYS[1], jhp, None, None, 0)
    u = torch.from_numpy(_jax_uniforms(jrep, KEYS[1]))
    tenv = convert.env(jenv, **CPU)
    out = simulate_aoi_regret_batch(trep, tenv, T, uniforms=u, env_axis=None,
                                    uniforms_axis=None, hparams=convert.hparams(jhp, **CPU),
                                    hp_axis=0, return_state=True, **CPU)
    assert out["channels"].shape == (4, T, M)
    _hold_against_jax([point(trep, *v) for v in values], tenv, out, jout, jch, jstate, u,
                      None, f"{name}/hp grid")
