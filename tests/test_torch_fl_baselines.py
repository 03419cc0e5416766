"""FL round parity (Fig. 3/4 path) for the baseline policies.

The Fig. 3/4 rows' policies (random, channel-aware, Lyapunov, M-Exp3 with
and without adaptive matching) drive three rounds of the port's
``AsyncFLTrainer`` and of the JAX package's at N = 6 channels, M = 4
clients (an MLP 8->16->3, E = 2, B = 4), on the JAX adversarial table
carried across with ``convert.channel_env`` (its ``"mean"`` hint routes
the matcher to the historical means) and, for the piecewise rows'
policies, on a piecewise env.  Each port round gets the uniforms behind
the JAX round key's ``k_env, k_sel`` split, the selection uniform through
``selection_uniform`` (``tests/test_torch_baselines.py``).

Tolerances are those of ``tests/test_torch_fl_round.py``: the assignment,
``n_success``, AoI, ``has_update`` and the scheduler state's integer
leaves bitwise; params, buffers, contributions, zeta, the metrics and the
scheduler state's f32 leaves at rtol 1e-5 / atol 1e-6.  Inside the
trainer's compiled round XLA may contract a discounted sum ``rho * x + y``
into one fused multiply-add, which the port's two roundings differ from by
an ulp (seen on Lyapunov's discounted pull counts), so the f32 leaves that
``tests/test_torch_baselines.py`` holds bitwise against the policy's own
compiled ``update`` are held here at the file's tolerance.  An assignment
may differ only at a near-tie within 1e-5 relative of the policy's
selection, the channel scores or the matcher priorities.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro.core.channels import make_piecewise as jax_make_piecewise  # noqa: E402
from repro.core.channels import random_adversarial_env as jax_adversarial  # noqa: E402
from repro.core.matching import AdaptiveMatcher as JaxMatcher  # noqa: E402
from repro.core.matching import matcher_scores as jax_matcher_scores  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro.utils.tree import tree_unflatten_concat as jax_unflatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.matching import AdaptiveMatcher, matcher_scores  # noqa: E402
from repro_torch.data import FederatedLoader, make_federated_classification  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402
from repro_torch.utils.tree import tree_unflatten_concat  # noqa: E402
from test_torch_baselines import near_tie, selection_uniform  # noqa: E402

N, M, DIM, HID, C, E, B = 6, 4, 8, 16, 3, 2, 4
ROUNDS = 3
KEY = jax.random.PRNGKey(3)
REL_TIE = 1e-5
MEANS = np.array([[0.9, 0.1, 0.7, 0.3, 0.5, 0.2],
                  [0.2, 0.8, 0.3, 0.9, 0.1, 0.6]], np.float32)
BREAKS = np.array([2], np.int32)
CFG = dict(n_clients=M, n_channels=N, local_epochs=E, client_lr=0.1, server_lr=0.1)

POLICIES = {
    "random": lambda p: p.RandomScheduler(N, M),
    "channel-aware": lambda p: p.ChannelAwareAsync(N, M),
    "lyapunov": lambda p: p.LyapunovSched(N, M),
    "m-exp3": lambda p: p.MExp3(N, M, share_alpha=1e-3),
}
# (env, policy, matching): the Fig. 3/4 rows at this size
CASES = ([("adversarial", p, False) for p in POLICIES] + [("adversarial", "m-exp3", True)]
         + [("piecewise", p, False) for p in ("random", "channel-aware", "lyapunov")])


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
    bx, by = FederatedLoader(cx, cy, batch_size=B, local_epochs=E, seed=4).next_rounds(ROUNDS)
    envs = {"adversarial": jax_adversarial(jax.random.PRNGKey(10), N, ROUNDS, flip_prob=0.01),
            "piecewise": jax_make_piecewise(MEANS, BREAKS)}
    return dict(params=params, bx=bx, by=by, px=px, py=py, envs=envs)


def _trainers(problem, env_name, policy, matching):
    jparams = {k: jnp.asarray(v) for k, v in problem["params"].items()}
    jpx, jpy = jnp.asarray(problem["px"]), jnp.asarray(problem["py"])
    tpx, tpy = torch.from_numpy(problem["px"]), torch.from_numpy(problem["py"])
    tparams = convert.params(problem["params"], "cpu")
    jenv = problem["envs"][env_name]
    cfg = dict(CFG, use_matching=matching, use_zeta=matching)
    jtr = JaxTrainer(JaxConfig(**cfg), POLICIES[policy](jb), jenv, _jax_loss,
                     lambda flat: _jax_loss(jax_unflatten(flat, jparams), jpx, jpy))
    ttr = AsyncFLTrainer(
        AsyncFLConfig(**cfg), POLICIES[policy](tb),
        convert.channel_env(jenv.form, jenv.means, jenv.breaks, jenv.table, jenv.score_kind,
                            device="cpu"),
        _torch_loss, lambda flat: _torch_loss(tree_unflatten_concat(flat, tparams), tpx, tpy),
        device="cpu")
    return jtr, ttr, jparams, tparams


def _jax_assignment(trainer, state, k_sel):
    ch, _ = trainer.scheduler.select(state.sched_state, state.t, k_sel, state.aoi)
    if not trainer.cfg.use_matching:
        return np.array(ch)
    scores = jax_matcher_scores(trainer.scheduler, state.sched_state, state.t, trainer.env)
    a, _ = JaxMatcher(trainer.cfg.matcher_beta).match(
        state.matcher_state, ch, scores, state.contrib, state.aoi)
    return np.array(a)


def _torch_assignment(trainer, state, u_sel):
    ch, _ = trainer.scheduler.select(state.sched_state, state.t, u_sel, state.aoi)
    if not trainer.cfg.use_matching:
        return ch.numpy()
    scores = matcher_scores(trainer.scheduler, state.sched_state, state.t, trainer.env)
    a, _ = AdaptiveMatcher(trainer.cfg.matcher_beta).match(
        state.matcher_state, ch, scores, state.contrib, state.aoi)
    return a.numpy()


def _tight(v):
    v = torch.sort(v.reshape(-1), descending=True).values
    return bool(((v[:-1] - v[1:]).abs() <= REL_TIE * v[:-1].abs().clamp_min(1e-30)).any())


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=what)


def _equal(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _state_matches(tstate, jstate, where):
    """Scheduler state: integer leaves bitwise, f32 leaves at the file's
    tolerance; the ``hp`` dict bitwise."""
    for f in tstate._fields:
        tv, jv = getattr(tstate, f), getattr(jstate, f)
        if isinstance(tv, dict):
            for k in tv:
                _equal(tv[k].numpy(), np.array(jv[k]), f"{where}.{f}[{k}]")
        elif tv.dtype.is_floating_point:
            _close(tv.numpy(), np.array(jv), f"{where}.{f}")
        else:
            _equal(tv.numpy(), np.array(jv), f"{where}.{f}")


@pytest.mark.parametrize("env_name, policy, matching", CASES)
def test_three_rounds_match_jax(problem, env_name, policy, matching):
    jtr, ttr, jparams, tparams = _trainers(problem, env_name, policy, matching)
    jstate, tstate = jtr.init(jparams, KEY), ttr.init(tparams)
    aggregated = 0.0
    for r in range(ROUNDS):
        key = jax.random.fold_in(KEY, r)
        k_env, k_sel = jax.random.split(key)
        u_env = torch.from_numpy(np.array(jax.random.uniform(k_env, (N,))))
        u_sel = torch.from_numpy(np.array(selection_uniform(jtr.scheduler, k_sel, N)))
        bx, by = problem["bx"][r], problem["by"][r]
        mine, theirs = _torch_assignment(ttr, tstate, u_sel), _jax_assignment(jtr, jstate, k_sel)
        if not np.array_equal(mine, theirs):
            lam, _ = AdaptiveMatcher(ttr.cfg.matcher_beta).priorities(
                tstate.matcher_state, tstate.contrib, tstate.aoi)
            scores = matcher_scores(ttr.scheduler, tstate.sched_state, r, ttr.env)
            assert (near_tie(ttr.scheduler, tstate.sched_state, r, u_sel, tstate.aoi)
                    or (matching and (_tight(lam) or _tight(scores)))), (
                f"{env_name}/{policy}: round {r} forks without a near-tie: port {mine}, "
                f"jax {theirs}")
            return
        jnext, jmets = jtr.round(jstate, jnp.asarray(bx), jnp.asarray(by), key)
        tnext, tmets = ttr.round(tstate, torch.from_numpy(bx), torch.from_numpy(by),
                                 u_env=u_env, u_sel=u_sel)
        assert tnext.t == int(jnext.t) == r + 1
        for f in ("aoi", "has_update", "last_success", "staleness"):
            _equal(getattr(tnext, f).numpy(), np.array(getattr(jnext, f)), f"round {r} {f}")
        _equal(tmets["n_success"].numpy(), np.array(jmets["n_success"]), f"round {r} n_success")
        _equal(tmets["mean_aoi"].numpy(), np.array(jmets["mean_aoi"]), f"round {r} mean_aoi")
        _state_matches(tnext.sched_state, jnext.sched_state, f"{policy} round {r}")
        for k in problem["params"]:
            _close(tnext.params[k].numpy(), np.array(jnext.params[k]), f"round {r} {k}")
        _close(tnext.buffers.numpy(), np.array(jnext.buffers), f"round {r} buffers")
        _close(tnext.contrib.numpy(), np.array(jnext.contrib), f"round {r} contrib")
        _close(tnext.zeta.numpy(), np.array(jnext.zeta), f"round {r} zeta")
        for f in tnext.matcher_state._fields:
            _close(getattr(tnext.matcher_state, f).numpy(),
                   np.array(getattr(jnext.matcher_state, f)), f"round {r} {f}")
        for k in jmets:
            _close(tmets[k].numpy(), np.array(jmets[k]), f"round {r} {k}")
        aggregated += float(tmets["n_success"])
        # carry the JAX state across each round, as a mid-run restart would
        jstate = jnext
        tstate = convert.async_fl_state(jnext, "cpu", scheduler=ttr.scheduler)
    assert aggregated > 0, f"{env_name}/{policy}: no round aggregated"
