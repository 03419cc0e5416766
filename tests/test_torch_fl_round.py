"""FL round parity (Fig. 3/4 path): the port's ``AsyncFLTrainer`` against
the JAX package's on the same data, weights and randomness.

A JAX run (N=6 channels, M=4 clients, an MLP 8->16->3, E=2, B=4) is
carried across at rounds 0, 1, 5 and 20 through ``repro_torch.convert``;
the port then runs one round with the same batches and the uniforms
behind the round key's ``k_env, k_sel`` split.  The schedule, ``n_success``,
AoI and ``has_update`` must be bitwise.  Params, buffers, contributions and
zeta are held at rtol 1e-5 / atol 1e-6: local SGD runs torch autograd
against ``jax.grad``, sums run in another order, and ``log``/``sqrt`` differ
by an ulp between XLA and torch on the CPU.

A 10-round run from the same start must give allclose metrics; if the two
schedules fork, the fork must sit on an ulp-level near-tie (1e-5 relative)
of the UCB ranking, the channel scores or the matcher priorities.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.channels import make_piecewise as jax_make_piecewise  # noqa: E402
from repro.core.matching import AdaptiveMatcher as JaxMatcher  # noqa: E402
from repro.core.matching import matcher_scores as jax_matcher_scores  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro.utils.tree import tree_unflatten_concat as jax_unflatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.matching import AdaptiveMatcher, matcher_scores  # noqa: E402
from repro_torch.data import FederatedLoader, make_federated_classification  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402
from repro_torch.utils.tree import tree_flatten_concat, tree_unflatten_concat  # noqa: E402

N, M, DIM, HID, C, E, B = 6, 4, 8, 16, 3, 2, 4
KEY = jax.random.PRNGKey(3)
MEANS = np.array([[0.9, 0.1, 0.7, 0.3, 0.5, 0.2],
                  [0.2, 0.8, 0.3, 0.9, 0.1, 0.6]], np.float32)
BREAKS = np.array([12], np.int32)
CFG = dict(n_clients=M, n_channels=N, local_epochs=E, client_lr=0.1, server_lr=0.1)
SCHED = dict(history=16, min_samples=4, delta=0.05)
PARITY_ROUNDS = (0, 1, 5, 20)
REL_TIE = 1e-5


def _jax_loss(p, x, y):
    logits = jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    lg = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(lg, y[:, None].astype(jnp.int32), 1))


def _torch_loss(p, x, y):
    logits = torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    lg = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lg, 1, y[:, None].to(torch.int64)).mean()


@pytest.fixture(scope="module")
def problem():
    cx, cy, _, _, px, py = make_federated_classification(
        M, samples_per_client=64, n_classes=C, dim=DIM, alpha=0.5, seed=1)
    rng = np.random.default_rng(2)
    params = {"w1": (rng.standard_normal((DIM, HID)) * 0.3).astype(np.float32),
              "b1": np.zeros(HID, np.float32),
              "w2": (rng.standard_normal((HID, C)) * 0.3).astype(np.float32),
              "b2": np.zeros(C, np.float32)}
    bx, by = FederatedLoader(cx, cy, batch_size=B, local_epochs=E, seed=4).next_rounds(21)

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jpx, jpy = jnp.asarray(px), jnp.asarray(py)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    tparams = convert.params(params, "cpu")
    jtrainer = JaxTrainer(
        JaxConfig(**CFG), JaxGLRCUCB(N, M, **SCHED), jax_make_piecewise(MEANS, BREAKS),
        _jax_loss, lambda flat: _jax_loss(jax_unflatten(flat, jparams), jpx, jpy))
    ttrainer = AsyncFLTrainer(
        AsyncFLConfig(**CFG), GLRCUCB(N, M, **SCHED),
        convert.channel_env("segments", MEANS, BREAKS, np.zeros((0, N), np.float32),
                            device="cpu"),
        _torch_loss,
        lambda flat: _torch_loss(tree_unflatten_concat(flat, tparams), tpx, tpy),
        device="cpu")

    keys = [jax.random.fold_in(KEY, r) for r in range(21)]
    states, metrics = [jtrainer.init(jparams, KEY)], []
    for r in range(21):
        st, mets = jtrainer.round(states[-1], jnp.asarray(bx[r]), jnp.asarray(by[r]), keys[r])
        states.append(st)
        metrics.append(mets)
    return dict(jtrainer=jtrainer, ttrainer=ttrainer, params=params, bx=bx, by=by,
                keys=keys, states=states, metrics=metrics)


def _uniforms(key):
    k_env, k_sel = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(k_env, (N,)))),
            torch.from_numpy(np.array(jax.random.uniform(k_sel, (N,)))), k_sel)


def _jax_assignment(trainer, state, k_sel):
    ch, _ = trainer.scheduler.select(state.sched_state, state.t, k_sel, state.aoi)
    scores = jax_matcher_scores(trainer.scheduler, state.sched_state, state.t, trainer.env)
    a, _ = JaxMatcher(trainer.cfg.matcher_beta).match(
        state.matcher_state, ch, scores, state.contrib, state.aoi)
    return np.array(a)


def _torch_assignment(trainer, state, u_sel):
    ch, _ = trainer.scheduler.select(state.sched_state, state.t, u_sel, state.aoi)
    scores = matcher_scores(trainer.scheduler, state.sched_state, state.t, trainer.env)
    a, _ = AdaptiveMatcher(trainer.cfg.matcher_beta).match(
        state.matcher_state, ch, scores, state.contrib, state.aoi)
    return a.numpy()


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=what)


def _equal(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("r", PARITY_ROUNDS)
def test_one_round_matches_jax(problem, r):
    jstate, jnext = problem["states"][r], problem["states"][r + 1]
    tr = problem["ttrainer"]
    u_env, u_sel, k_sel = _uniforms(problem["keys"][r])
    tstate = convert.async_fl_state(jstate, "cpu")
    _equal(_torch_assignment(tr, tstate, u_sel),
           _jax_assignment(problem["jtrainer"], jstate, k_sel), "schedule")

    tnext, tmets = tr.round(tstate, torch.from_numpy(problem["bx"][r]),
                            torch.from_numpy(problem["by"][r]), u_env=u_env, u_sel=u_sel)
    jmets = problem["metrics"][r]
    assert tnext.t == int(jnext.t) == r + 1
    for f in ("aoi", "has_update", "last_success", "staleness"):
        _equal(getattr(tnext, f).numpy(), np.array(getattr(jnext, f)), f)
    _equal(tmets["n_success"].numpy(), np.array(jmets["n_success"]), "n_success")
    for f in ("counts", "cum", "total", "base", "tau", "restarts"):
        _equal(getattr(tnext.sched_state, f).numpy(),
               np.array(getattr(jnext.sched_state, f)), f)
    for k in problem["params"]:
        _close(tnext.params[k].numpy(), np.array(jnext.params[k]), k)
    _close(tnext.buffers.numpy(), np.array(jnext.buffers), "buffers")
    for f in ("grads", "params", "fresh"):
        _close(getattr(tnext.contrib_buf, f).numpy(), np.array(getattr(jnext.contrib_buf, f)), f)
    _close(tnext.contrib.numpy(), np.array(jnext.contrib), "contrib")
    _close(tnext.zeta.numpy(), np.array(jnext.zeta), "zeta")
    _close(tnext.sched_state.mu_tilde.numpy(), np.array(jnext.sched_state.mu_tilde), "mu")
    for f in tnext.matcher_state._fields:
        _close(getattr(tnext.matcher_state, f).numpy(),
               np.array(getattr(jnext.matcher_state, f)), f)
    for k in jmets:
        _close(tmets[k].numpy(), np.array(jmets[k]), k)


def test_parity_rounds_aggregate(problem):
    """The one-round checks include rounds that aggregate updates, not
    only all-Bad no-op rounds."""
    assert sum(float(problem["metrics"][r]["n_success"]) for r in PARITY_ROUNDS[1:]) > 0


def _near_tie(trainer, state, u_sel):
    """Whether the round from ``state`` sits on an ulp-level near-tie of the
    UCB ranking, the channel scores or the matcher priorities."""
    def tight(v):
        v = torch.sort(v.reshape(-1), descending=True).values
        gaps = (v[:-1] - v[1:]).abs() <= REL_TIE * v[:-1].abs().clamp_min(1e-30)
        return bool(gaps.any())

    sched, ss, t = trainer.scheduler, state.sched_state, state.t
    ucb = sched.ucb(ss, t)
    key = torch.where(torch.isinf(ucb), 1e9, ucb) + torch.where(ss.counts == 0, u_sel * 1e6, 0.0)
    lam, _ = AdaptiveMatcher(trainer.cfg.matcher_beta).priorities(
        state.matcher_state, state.contrib, state.aoi)
    return tight(key) or tight(sched.channel_scores(ss, t)) or tight(lam)


def test_ten_round_run_matches_jax(problem):
    tr = problem["ttrainer"]
    tstate = tr.init(convert.params(problem["params"], "cpu"))
    uniforms = torch.stack([torch.stack(_uniforms(k)[:2]) for k in problem["keys"][:10]])
    bx, by = torch.from_numpy(problem["bx"][:10]), torch.from_numpy(problem["by"][:10])
    run_state, run_mets = tr.run(tstate, bx, by, uniforms=uniforms)

    state = tstate
    for r in range(10):
        jstate = problem["states"][r]
        mine = _torch_assignment(tr, state, uniforms[r, 1])
        theirs = _jax_assignment(problem["jtrainer"], jstate, _uniforms(problem["keys"][r])[2])
        if not np.array_equal(mine, theirs):
            assert _near_tie(tr, state, uniforms[r, 1]), (
                f"schedules fork at round {r} without a near-tie: port {mine}, jax {theirs}")
            return
        state, mets = tr.round(state, bx[r], by[r], u_env=uniforms[r, 0], u_sel=uniforms[r, 1])
        for k, v in problem["metrics"][r].items():
            _close(mets[k].numpy(), np.array(v), f"round {r} {k}")
            _equal(run_mets[k][r].numpy(), mets[k].numpy(), f"run vs round {r} {k}")
    for k in problem["params"]:
        _equal(run_state.params[k].numpy(), state.params[k].numpy(), k)
    assert float(run_mets["n_success"].sum()) > 0


def test_flatten_order_is_jax_sorted_keys(problem):
    p = convert.params(problem["params"], "cpu")
    flat = tree_flatten_concat(p)
    want = np.concatenate([problem["params"][k].ravel() for k in ("b1", "b2", "w1", "w2")])
    _equal(flat.numpy(), want, "flatten order")
    back = tree_unflatten_concat(flat, p)
    for k in p:
        _equal(back[k].numpy(), problem["params"][k], k)


def test_all_bad_round_is_a_bitwise_noop_on_params(problem):
    """With every channel Bad (u_env = 1 > any mean) nothing aggregates and
    params are untouched bit for bit."""
    tr = problem["ttrainer"]
    state = tr.init(convert.params(problem["params"], "cpu"))
    state, _ = tr.round(state, torch.from_numpy(problem["bx"][0]),
                        torch.from_numpy(problem["by"][0]),
                        u_env=torch.ones(N), u_sel=torch.rand(N))
    nxt, mets = tr.round(state, torch.from_numpy(problem["bx"][1]),
                         torch.from_numpy(problem["by"][1]),
                         u_env=torch.ones(N), u_sel=torch.rand(N))
    assert float(mets["n_success"]) == 0.0
    for k in state.params:
        assert torch.equal(nxt.params[k], state.params[k])


def test_round_draws_from_generator(problem):
    """Without ``u_env``/``u_sel`` a round draws its two uniforms from the
    generator: the same seed gives the same round."""
    tr = problem["ttrainer"]
    bx, by = torch.from_numpy(problem["bx"][:2]), torch.from_numpy(problem["by"][:2])
    outs = []
    for _ in range(2):
        state = tr.init(convert.params(problem["params"], "cpu"))
        outs.append(tr.run(state, bx, by, generator=torch.Generator().manual_seed(9)))
    (s1, m1), (s2, m2) = outs
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k

