"""Recompute GLR detector parity: the port's plain ``glr_scan`` and
``GLRCUCB(detector_impl="recompute")`` against the JAX package's.

Tolerances.  The statistic goes through ``log``, which differs by an ulp
between XLA and torch on the CPU, so on {0, 1} histories (exact integer
prefixes) it is held at rtol 1e-5 with -inf at the same places.  On
real-valued histories the prefixes are also summed in another order (XLA's
``cumsum`` against torch's), and the split term amplifies a prefix's
rounding where the split mean is near the window mean: rtol 1e-4 / atol
1e-5 there.  The rolled history, counts, ``tau`` and ``restarts`` are
bitwise ({0, 1} rewards).  The T = 400 regret run uses the env, key and
detector of ``tests/test_torch_regret.py``, whose streaming trajectory
agrees with JAX bitwise; the recompute one must as well.  Within the port,
the recompute and the streaming detector see the same exact integer
prefixes and evaluate the same split term, so their runs are bitwise equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.channels import make_piecewise, random_piecewise_env  # noqa: E402
from repro.core.regret import simulate_aoi_regret as jax_simulate  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N, M, H, STRIDE, T = 5, 2, 64, 5, 400


def _hist_inputs(n, h, seed, binary=True):
    rng = np.random.default_rng(seed)
    hist = (rng.integers(0, 2, (n, h)) if binary else rng.random((n, h))).astype(np.float32)
    counts = rng.integers(0, h + 1, n).astype(np.int32)
    counts[:4] = [0, 1, 2, h][:n]
    return hist, counts


def _assert_stats_close(got, want, binary):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    tol = dict(rtol=1e-5, atol=0) if binary else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


@pytest.mark.parametrize("n,h", [(5, 96), (13, 200)])
@pytest.mark.parametrize("binary", [True, False], ids=["01", "real"])
def test_plain_glr_scan_matches_pallas_interpret(n, h, binary):
    hist, counts = _hist_inputs(n, h, seed=n * h, binary=binary)
    want = jops.glr_scan(jnp.asarray(hist), jnp.asarray(counts), backend="pallas_interpret")
    got = ops.glr_scan(torch.from_numpy(hist), torch.from_numpy(counts))
    assert got.dtype == torch.float32 and got.shape == (n,)
    _assert_stats_close(got.numpy(), want, binary)


@pytest.mark.parametrize("n,h", [(1, 8), (5, 1024), (30, 256), (7, 1000)])
@pytest.mark.parametrize("binary", [True, False], ids=["01", "real"])
def test_plain_glr_scan_matches_jax_ref(n, h, binary):
    hist, counts = _hist_inputs(n, h, seed=n + h, binary=binary)
    want = jax.jit(jops.glr_scan, static_argnames="backend")(
        jnp.asarray(hist), jnp.asarray(counts), backend="jnp")
    _assert_stats_close(ops.glr_scan(torch.from_numpy(hist), torch.from_numpy(counts)).numpy(),
                        want, binary)


def test_short_windows_give_minus_inf():
    hist, _ = _hist_inputs(4, 16, seed=1)
    got = ops.glr_scan(torch.from_numpy(hist), torch.tensor([0, 1, 2, 3], dtype=torch.int32))
    assert torch.isneginf(got[:2]).all() and torch.isfinite(got[2:]).all()


def test_recompute_rejects_sparse_split_grids():
    for grid in ("geometric", "auto"):
        with pytest.raises(ValueError, match="streaming"):
            GLRCUCB(N, M, detector_impl="recompute", split_grid=grid)
    with pytest.raises(ValueError, match="detector_impl"):
        GLRCUCB(N, M, detector_impl="rolling")


def test_recompute_state_layout():
    st = GLRCUCB(N, M, history=H, detector_impl="recompute").init("cpu")
    assert st.hist.shape == (N, H) and st.cum.shape == (N, 0)
    st = GLRCUCB(N, M, history=H).init("cpu")
    assert st.hist.shape == (N, 0) and st.cum.shape == (N, H)


MEANS = np.array([[0.9, 0.2, 0.6, 0.1, 0.8],
                  [0.1, 0.9, 0.2, 0.8, 0.3],
                  [0.7, 0.1, 0.9, 0.3, 0.2]], np.float32)
BREAKS = np.array([120, 240], np.int32)


@pytest.mark.parametrize("prefix", [7, 64, 130, 330])
def test_one_recompute_step_matches_jax(prefix):
    """The JAX recompute state after ``prefix`` rounds, carried into the
    port, gives the same next schedule, history and restart decision."""
    cfg = dict(history=H, detector_stride=1, min_samples=4, delta=0.05, detector_impl="recompute")
    jsched, tsched = JaxGLRCUCB(N, M, **cfg), GLRCUCB(N, M, **cfg)
    key = jax.random.PRNGKey(21)
    env = make_piecewise(MEANS, BREAKS)
    out = jax_simulate(jsched, env, key, prefix, collect_curve=False, return_state=True)
    jstate = out["final_sched_state"]
    tstate = convert.glr_cucb_state(jstate, device="cpu")
    k_env, k_sel = jax.random.split(jax.random.fold_in(key, 10_000 + prefix))
    ch_states = np.array(jax.random.bernoulli(k_env, env.means_at(prefix)), np.float32)
    aoi = np.array(out["aoi_pi"])
    jch, jaux = jsched.select(jstate, jnp.int32(prefix), k_sel, jnp.asarray(aoi))
    tch, taux = tsched.select(tstate, prefix,
                              torch.from_numpy(np.array(jax.random.uniform(k_sel, (N,)))),
                              torch.from_numpy(aoi))
    np.testing.assert_array_equal(tch.numpy(), np.array(jch))
    jnext = jsched.update(jstate, jnp.int32(prefix), jch, jnp.asarray(ch_states)[jch], jaux)
    tnext = tsched.update(tstate, prefix, tch, torch.from_numpy(ch_states)[tch], taux)
    for f in ("hist", "counts", "tau", "restarts"):
        np.testing.assert_array_equal(getattr(tnext, f).numpy(), np.array(getattr(jnext, f)), f)
    np.testing.assert_allclose(tnext.mu_tilde.numpy(), np.array(jnext.mu_tilde), rtol=1e-6)


def _jax_uniforms(key, horizon, n):
    """(T, 2, N): the uniforms behind each round's ``k_env``/``k_sel``."""
    def draws(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (n,)), jax.random.uniform(k_sel, (n,))])

    return np.array(jax.vmap(draws)(jax.random.split(jax.random.fold_in(key, 1), horizon)))


def test_recompute_regret_run_matches_jax():
    key = jax.random.PRNGKey(7)
    env = random_piecewise_env(jax.random.PRNGKey(11), N, T, 5)
    cfg = dict(history=H, detector_stride=STRIDE, detector_impl="recompute")
    jout = jax_simulate(JaxGLRCUCB(N, M, **cfg), env, key, T)
    tenv = convert.channel_env(env.form, env.means, env.breaks, env.table, device="cpu")
    uniforms = torch.from_numpy(_jax_uniforms(key, T, N))
    tout = simulate_aoi_regret(GLRCUCB(N, M, **cfg), tenv, T, uniforms=uniforms, device="cpu")
    streaming = simulate_aoi_regret(GLRCUCB(N, M, history=H, detector_stride=STRIDE), tenv, T,
                                    uniforms=uniforms, device="cpu")
    assert int(jout["restarts"]) > 0
    assert int(tout["restarts"]) == int(jout["restarts"])
    for k in ("regret", "aoi_pi", "aoi_star"):
        np.testing.assert_array_equal(tout[k].numpy(), np.array(jout[k]), err_msg=k)
    assert torch.equal(tout["channels"], streaming["channels"])


@pytest.mark.parametrize("history,stride", [(128, 4), (32, 5)])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_recompute_run_equals_streaming_run(history, stride, backend):
    """The port's two detectors give bitwise-equal runs on the same
    uniforms, as the JAX package asserts for its own two."""
    env = random_piecewise_env(jax.random.PRNGKey(3), N, 1200, 3)
    tenv = convert.channel_env(env.form, env.means, env.breaks, env.table, device="cpu")
    u = torch.rand((1200, 2, N), generator=torch.Generator().manual_seed(history))
    runs = [simulate_aoi_regret(GLRCUCB(N, M, history=history, detector_stride=stride,
                                        detector_backend=backend, detector_impl=impl),
                                tenv, 1200, uniforms=u, return_state=True, device="cpu")
            for impl in ("recompute", "streaming")]
    rec, stream = runs
    assert int(rec["restarts"]) > 0
    assert int(rec["restarts"]) == int(stream["restarts"])
    for k in ("channels", "regret", "aoi_pi", "cum_aoi_var"):
        assert torch.equal(rec[k], stream[k]), k
    for f in ("mu_tilde", "counts", "tau"):
        assert torch.equal(getattr(rec["final_sched_state"], f),
                           getattr(stream["final_sched_state"], f)), f
