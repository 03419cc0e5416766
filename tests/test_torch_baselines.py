"""Parity of the port's baseline policies with the JAX package's.

Policies: random, round-robin, Lyapunov, channel-aware, M-Exp3 (with and
without Exp3.S sharing) and the AoI-Aware wrapper over GLR-CUCB and over
M-Exp3.  A JAX run of each is carried across at several rounds through
``convert.sched_state``; the port then runs one ``select`` on the uniform
that stands for the JAX draw on ``k_sel`` (``selection_uniform`` below:
the seam each policy's docstring names) and one ``update`` with the JAX
round's channels, rewards and aux.

Tolerances: schedules, counts, AoI-Aware's ``exploit_rounds`` and every
leaf of random, round-robin, Lyapunov and channel-aware bitwise, and
AoI-Aware's own ``mu_sum``/``pulls``; GLR-CUCB's running mean
``mu_tilde`` at rtol 1e-6 (as ``tests/test_torch_glr_cucb.py``); M-Exp3's
log-weights and probabilities at rtol 1e-5 (``logsumexp``, ``logaddexp``
and ``exp`` are not bitwise between XLA and torch).  A schedule may differ
only at a near-tie within 1e-5 relative (``near_tie``): of the perturbed
scores of channel-aware (its Gumbel noise goes through ``log``), of
M-Exp3's draw and a CDF boundary, of AoI-Aware's threshold, of GLR-CUCB's
UCB ranking.  The file also holds the hyper-parameter helpers, the
super-arm table and ports of ``tests/test_bandits.py``'s M-Exp3 and
AoI-Aware behaviour tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.channels import random_adversarial_env  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402

N, M = 5, 2
KEY = jax.random.PRNGKey(5)
REL_TIE = 1e-5
ROUNDS = 40
CHECK_ROUNDS = (0, 1, 7, 39)
MEANS = np.array([0.8, 0.3, 0.6, 0.1, 0.5], np.float32)


def pairs(n=N, m=M, history=64):
    """(id, JAX policy, port policy) for every policy form."""
    return [
        ("random", jb.RandomScheduler(n, m), tb.RandomScheduler(n, m)),
        ("round-robin", jb.RoundRobinScheduler(n, m), tb.RoundRobinScheduler(n, m)),
        ("lyapunov", jb.LyapunovSched(n, m), tb.LyapunovSched(n, m)),
        ("lyapunov-min-rate", jb.LyapunovSched(n, m, min_rate=0.3),
         tb.LyapunovSched(n, m, min_rate=0.3)),
        ("channel-aware", jb.ChannelAwareAsync(n, m), tb.ChannelAwareAsync(n, m)),
        ("m-exp3", jb.MExp3(n, m, gamma=0.5), tb.MExp3(n, m, gamma=0.5)),
        ("m-exp3-share", jb.MExp3(n, m, gamma=0.5, share_alpha=1e-3),
         tb.MExp3(n, m, gamma=0.5, share_alpha=1e-3)),
        ("aa-glr-cucb",
         jb.AoIAware(jb.GLRCUCB(n, m, history=history, detector_stride=5)),
         tb.AoIAware(tb.GLRCUCB(n, m, history=history, detector_stride=5))),
        ("aa-m-exp3", jb.AoIAware(jb.MExp3(n, m, gamma=0.5)),
         tb.AoIAware(tb.MExp3(n, m, gamma=0.5))),
    ]


PAIRS = {name: (j, t) for name, j, t in pairs()}


# ---------------------------------------------------------------------------
# the randomness seam and the near-tie rule, shared with the other
# baseline parity files
# ---------------------------------------------------------------------------

def selection_uniform(jsched, k_sel, n):
    """The port's (N,) f32 selection uniform for the JAX policy's draw on
    ``k_sel``: ``permutation`` is the stable argsort of
    ``uniform(split(k_sel)[1])``; M-Exp3's ``choice`` reads
    ``uniform(k_sel, ())`` (as ``u[0]``); AoI-Aware hands ``k_sel`` to its
    base; the rest draw ``uniform(k_sel, (N,))``."""
    if isinstance(jsched, jb.AoIAware):
        return selection_uniform(jsched.base, k_sel, n)
    if isinstance(jsched, jb.RandomScheduler):
        return jax.random.uniform(jax.random.split(k_sel)[1], (n,))
    u = jax.random.uniform(k_sel, (n,))
    if isinstance(jsched, jb.MExp3):
        u = u.at[0].set(jax.random.uniform(k_sel, ()))
    return u


def _close_rel(a, b):
    return abs(float(a) - float(b)) <= REL_TIE * max(abs(float(a)), abs(float(b)))


def _sorted_gap_tie(keys, m):
    """Two of the first m + 1 descending keys within REL_TIE of each other."""
    top = torch.sort(keys, descending=True).values[: m + 1]
    return any(_close_rel(top[i], top[i + 1]) for i in range(len(top) - 1))


def near_tie(sched, state, t, u, aoi):
    """Whether round ``t``'s selection from ``state`` sits on an ulp-level
    near-tie where XLA's and torch's ``log``/``exp`` may decide apart."""
    m = sched.n_clients
    if isinstance(sched, tb.AoIAware):
        mu_hat = state.mu_sum / state.pulls.clamp_min(1.0)
        h_t = state.hp["threshold_scale"] / mu_hat.max().clamp_min(1e-6)
        return _close_rel(aoi.max(), h_t) or near_tie(sched.base, state.base, t, u, aoi)
    if isinstance(sched, tb.ChannelAwareAsync):
        g = -torch.log(-torch.log((u * (1.0 - 1e-12) + 1e-12).clamp_min(1e-12)))
        return _sorted_gap_tie(torch.log(sched._weights(state)) + g, m)
    if isinstance(sched, tb.MExp3):
        cdf = torch.cumsum(sched._probs(state), 0)
        r = cdf[-1] * (1.0 - u[0])
        return bool(((cdf - r).abs() <= REL_TIE * r.abs()).any())
    if isinstance(sched, tb.GLRCUCB):
        ucb = sched.ucb(state, t)
        key = torch.where(torch.isinf(ucb), 1e9, ucb) + torch.where(
            state.counts == 0, u * 1e6, 0.0)
        return _sorted_gap_tie(key, m)
    return False


def port_aux(tsched, jaux):
    """The port's ``select`` aux for a JAX one."""
    if isinstance(tsched, tb.AoIAware):
        return (port_aux(tsched.base, jaux[0]), torch.tensor(bool(jaux[1])))
    if isinstance(tsched, tb.MExp3):
        return torch.tensor(int(jaux))
    return None


def _same_aux(a, b):
    """Two ``select`` auxes: None, an index or flag, or a tuple of them."""
    if isinstance(a, tuple):
        return isinstance(b, tuple) and all(_same_aux(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or (a is not None and b is not None and int(a) == int(b))


# the leaves not held bitwise, by state field name
LEAF_RTOL = {"log_w": 1e-5, "mu_tilde": 1e-6}


def assert_state_matches(tstate, jstate, where):
    """Every leaf of the port's state against the JAX state's."""
    for f in tstate._fields:
        tv, jv = getattr(tstate, f), getattr(jstate, f)
        if isinstance(tv, tuple):
            assert_state_matches(tv, jv, f"{where}.{f}")
        elif isinstance(tv, dict):
            for k in tv:
                if isinstance(tv[k], dict):
                    for kk in tv[k]:
                        np.testing.assert_array_equal(tv[k][kk].numpy(), np.array(jv[k][kk]))
                else:
                    np.testing.assert_array_equal(tv[k].numpy(), np.array(jv[k]),
                                                  err_msg=f"{where}.{f}[{k}]")
        elif f in LEAF_RTOL:
            np.testing.assert_allclose(tv.numpy(), np.array(jv), rtol=LEAF_RTOL[f],
                                       atol=1e-6, err_msg=f"{where}.{f}")
        else:
            assert tv.numpy().dtype == np.array(jv).dtype, (where, f)
            np.testing.assert_array_equal(tv.numpy(), np.array(jv), err_msg=f"{where}.{f}")


def _jax_run(jsched, rounds):
    """A JAX run against fixed channel means: per round (state before,
    aoi, k_sel, channels, aux, rewards)."""
    select = jax.jit(jsched.select)
    update = jax.jit(jsched.update)
    rng = np.random.default_rng(0)
    state, aoi, trace = jsched.init(KEY), jnp.ones((M,)), []
    for t in range(rounds):
        k_sel = jax.random.fold_in(KEY, t)
        ch, aux = select(state, jnp.int32(t), k_sel, aoi)
        rewards = jnp.asarray((rng.random(N) < MEANS)[np.array(ch)].astype(np.float32))
        trace.append((state, aoi, k_sel, ch, aux, rewards))
        state = update(state, jnp.int32(t), ch, rewards, aux)
        aoi = jnp.where(rewards > 0.5, 1.0, aoi + 1.0)
    trace.append((state,))
    return trace


@pytest.mark.parametrize("name", list(PAIRS))
def test_select_and_update_match_jax(name):
    jsched, tsched = PAIRS[name]
    trace = _jax_run(jsched, ROUNDS)
    for r in CHECK_ROUNDS:
        jstate, jaoi, k_sel, jch, jaux, jrew = trace[r]
        tstate = convert.sched_state(tsched, jstate, "cpu")
        assert_state_matches(tstate, jstate, f"{name} round {r} (carried across)")
        u = torch.from_numpy(np.array(selection_uniform(jsched, k_sel, N)))
        aoi = torch.from_numpy(np.array(jaoi))
        tch, taux = tsched.select(tstate, r, u, aoi)
        if not np.array_equal(tch.numpy(), np.array(jch)):
            assert near_tie(tsched, tstate, r, u, aoi), (
                f"{name} round {r}: schedules differ without a near-tie: jax {np.array(jch)}, "
                f"port {tch.numpy()}")
        else:
            assert _same_aux(taux, port_aux(tsched, jaux)), (name, r, taux, jaux)
        tnext = tsched.update(tstate, r, torch.from_numpy(np.array(jch)).to(torch.int64),
                              torch.from_numpy(np.array(jrew)), port_aux(tsched, jaux))
        assert_state_matches(tnext, trace[r + 1][0], f"{name} round {r} update")
        np.testing.assert_array_equal(tsched.channel_scores(tnext, r + 1).numpy(),
                                      np.array(jsched.channel_scores(trace[r + 1][0], r + 1)))


@pytest.mark.parametrize("name", ["m-exp3", "m-exp3-share"])
def test_mexp3_probabilities_match_jax(name):
    jsched, tsched = PAIRS[name]
    trace = _jax_run(jsched, ROUNDS)
    for r in CHECK_ROUNDS:
        jstate = trace[r + 1][0]
        tstate = convert.sched_state(tsched, jstate, "cpu")
        np.testing.assert_allclose(tsched._probs(tstate).numpy(), np.array(jsched._probs(jstate)),
                                   rtol=1e-5)
    assert tsched.n_super_arms == jsched.n_super_arms == 10
    np.testing.assert_array_equal(tsched.combos("cpu").numpy(), np.array(jsched._combos))


# ---------------------------------------------------------------------------
# hyper-parameters, grids and the super-arm table
# ---------------------------------------------------------------------------

def _assert_params_equal(tp, jp):
    assert set(tp) == set(jp)
    for k in tp:
        if isinstance(tp[k], dict):
            _assert_params_equal(tp[k], jp[k])
        else:
            assert tp[k].dtype == torch.float32
            np.testing.assert_array_equal(tp[k].numpy(), np.array(jp[k]))


@pytest.mark.parametrize("name", list(PAIRS))
def test_params_and_traced_fields_match_jax(name):
    jsched, tsched = PAIRS[name]
    assert tsched.traced_fields() == jsched.traced_fields()
    _assert_params_equal(tsched.params("cpu"), jsched.params())
    assert tsched.name == jsched.name
    if not isinstance(tsched, tb.AoIAware) or isinstance(tsched.base, tb.MExp3):
        # GLR-CUCB's structural fields differ between the packages (the
        # port's detector backends); every baseline's are the same
        assert tsched.hp_signature() == jsched.hp_signature()


@pytest.mark.parametrize("name, override", [
    ("lyapunov", {"v": 2.0, "discount": 0.5, "rate_slack": 0.25}),
    ("channel-aware", {"ema": 0.2, "explore_eps": 0.3}),
    ("m-exp3-share", {"gamma": 0.1, "share_alpha": 0.01}),
    ("aa-m-exp3", {"threshold_scale": 2.0, "discount": 0.5, "base": {"gamma": 0.25}}),
])
def test_hp_override_matches_jax(name, override):
    jsched, tsched = PAIRS[name]
    jstate = jsched.init(KEY, hp=jax.tree_util.tree_map(jnp.float32, override))
    tstate = tsched.init("cpu", hp=override)
    assert_state_matches(tstate, jstate, f"{name} init(hp=...)")
    state = tsched.init("cpu")
    for t in range(3):        # the override, not the config, drives the numbers
        u = torch.rand(N, generator=torch.Generator().manual_seed(t))
        ch, aux = tsched.select(tstate, t, u, torch.ones(M))
        tstate = tsched.update(tstate, t, ch, torch.ones(M), aux)
        ch, aux = tsched.select(state, t, u, torch.ones(M))
        state = tsched.update(state, t, ch, torch.ones(M), aux)
    assert any(not torch.equal(a, b) for a, b in zip(
        [x for x in tstate if isinstance(x, torch.Tensor)],
        [x for x in state if isinstance(x, torch.Tensor)]))


def test_replace_traced_and_signature():
    s = tb.MExp3(N, M, gamma=0.5, share_alpha=1e-3)
    g = s.replace_traced(gamma=0.2, share_alpha=0.01)
    assert g.gamma == 0.2 and g.hp_signature() == s.hp_signature()
    with pytest.raises(ValueError, match="not traced"):
        s.replace_traced(n_channels=6)
    # turning sharing on is structural: a different signature
    assert tb.MExp3(N, M).hp_signature() != s.hp_signature()
    lyap = tb.LyapunovSched(N, M)
    with pytest.raises(ValueError, match="not traced"):
        lyap.replace_traced(min_rate=0.3)
    aa = tb.AoIAware(tb.MExp3(N, M))
    assert aa.replace_traced(discount=0.5).hp_signature() == aa.hp_signature()
    assert aa.hp_signature() != tb.AoIAware(tb.MExp3(N, M, share_alpha=0.1)).hp_signature()


@pytest.mark.parametrize("name", ["lyapunov", "m-exp3-share", "aa-m-exp3", "random"])
def test_stack_params_matches_jax(name):
    jsched, tsched = PAIRS[name]
    grid = [tsched.replace_traced(**{f: 0.1 * (i + 1) for f in tsched.traced_fields()})
            for i in range(3)]
    jgrid = [jsched.replace_traced(**{f: 0.1 * (i + 1) for f in jsched.traced_fields()})
             for i in range(3)]
    tp, jp = tb.stack_params(grid, "cpu"), jb.stack_params(jgrid)
    if jp is None:
        assert tp is None
        return
    _assert_params_equal(tp, jp)
    leaf = next(v for v in tp.values() if isinstance(v, torch.Tensor))
    assert leaf.shape == (3,)


@pytest.mark.parametrize("n, m", [(5, 2), (6, 4), (8, 3), (30, 3)])
def test_combinations_array_matches_jax(n, m):
    t, j = tb.combinations_array(n, m), jb.combinations_array(n, m)
    assert t.dtype == j.dtype == np.int32
    np.testing.assert_array_equal(t, j)


def test_combinations_array_guard():
    assert tb.combinations_array(5, 2).shape == (10, 2)
    with pytest.raises(ValueError, match="exceeds the M-Exp3 enumeration limit"):
        tb.combinations_array(30, 15)
    # the Fig. 3 piecewise scale: C(30, 20) > 200,000, as in JAX
    with pytest.raises(ValueError, match="use GLR-CUCB"):
        tb.MExp3(30, 20)
    with pytest.raises(ValueError, match="use GLR-CUCB"):
        jb.MExp3(30, 20)


# ---------------------------------------------------------------------------
# stable sorts: -0.0 ties
# ---------------------------------------------------------------------------

def test_negative_zero_ties_sort_as_jax():
    keys = np.array([0.0, -0.0, 0.5, -0.0, 0.0, 0.5, -0.5], np.float32)
    for k in (keys, -keys):
        np.testing.assert_array_equal(torch.argsort(torch.from_numpy(k), stable=True).numpy(),
                                      np.array(jnp.argsort(jnp.asarray(k))))
    # AoI-Aware at round 0: -mu_hat is -0.0 everywhere; a starving client
    # fires the exploitation branch, whose order comes from those ties
    jsched, tsched = PAIRS["aa-m-exp3"]
    aoi = np.array([2e6, 3e6], np.float32)      # above h(0) = 1 / 1e-6
    jch, (_, jexp) = jsched.select(jsched.init(KEY), jnp.int32(0), KEY, jnp.asarray(aoi))
    u = torch.from_numpy(np.array(selection_uniform(jsched, KEY, N)))
    tch, (_, texp) = tsched.select(tsched.init("cpu"), 0, u, torch.from_numpy(aoi))
    assert bool(jexp) and bool(texp)
    np.testing.assert_array_equal(tch.numpy(), np.array(jch))


# ---------------------------------------------------------------------------
# behaviour (ports of tests/test_bandits.py)
# ---------------------------------------------------------------------------

def test_mexp3_probs_form_simplex():
    s = tb.MExp3(5, 2, gamma=0.4)
    p = s._probs(s.init("cpu"))
    np.testing.assert_allclose(float(p.sum()), 1.0, atol=1e-5)
    assert float(p.min()) >= 0.4 / s.n_super_arms - 1e-9   # gamma floor


def test_mexp3_weights_concentrate_on_good_superarm():
    s = tb.MExp3(4, 2, gamma=0.3)
    best = {0, 1}
    state, gen = s.init("cpu"), torch.Generator().manual_seed(0)
    for t in range(400):
        ch, aux = s.select(state, t, torch.rand(4, generator=gen), torch.ones(2))
        rewards = torch.tensor([1.0 if int(c) in best else 0.0 for c in ch])
        state = s.update(state, t, ch, rewards, aux)
    probs = s._probs(state)
    best_idx = next(i for i, c in enumerate(s.combos("cpu").tolist()) if set(c) == best)
    assert float(probs[best_idx]) == float(probs.max())


def test_mexp3_beats_random_adversarial():
    gen = torch.Generator().manual_seed(0)
    env = random_adversarial_env(gen, 5, 4000, flip_prob=0.003, device="cpu")
    u = torch.rand((4000, 2, 5), generator=gen)
    r_rand = simulate_aoi_regret(tb.RandomScheduler(5, 2), env, 4000, uniforms=u,
                                 collect_curve=False, device="cpu")
    r_exp3 = simulate_aoi_regret(tb.MExp3(5, 2, share_alpha=1e-3), env, 4000, uniforms=u,
                                 collect_curve=False, device="cpu")
    assert float(r_exp3["final_regret"]) < float(r_rand["final_regret"])


def test_aoi_aware_exploits_under_high_aoi():
    aa = tb.AoIAware(tb.GLRCUCB(4, 2, history=64))
    state, gen = aa.init("cpu"), torch.Generator().manual_seed(0)
    # seed the discounted stats so channels 0/1 look best
    for t in range(30):
        ch, aux = aa.select(state, t, torch.rand(4, generator=gen), torch.ones(2))
        rewards = torch.tensor([1.0 if int(c) < 2 else 0.0 for c in ch])
        state = aa.update(state, t, ch, rewards, aux)
    ch, (_, exploited) = aa.select(state, 31, torch.rand(4, generator=gen),
                                   torch.tensor([50.0, 60.0]))
    assert bool(exploited)
    assert set(ch.tolist()) == {0, 1}       # the historical best channels
    state = aa.update(state, 31, ch, torch.ones(2), (None, exploited))
    assert state.exploit_rounds.dtype == torch.int32 and int(state.exploit_rounds) >= 1
