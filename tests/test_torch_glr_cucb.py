"""One-step GLR-CUCB parity: the JAX state after a prefix of a run, carried
into the port, gives the same next schedule and the same next state.

JAX runs ``simulate_aoi_regret(..., return_state=True)`` for several
prefix lengths (before and after ring wraparound and restarts); the final
state crosses over through ``repro_torch.convert``.  Both sides then take
one ``select`` with the same (N,) uniform and one ``update`` with the same
rewards.  Channels, counts, the prefix ring, totals, bases, ``tau`` and
``restarts`` must be bitwise; ``mu_tilde`` is a running mean, one division
per round, held at rtol 1e-6.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.channels import make_piecewise  # noqa: E402
from repro.core.regret import simulate_aoi_regret as jax_simulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402

N, M, H = 5, 2, 64
MEANS = np.array([[0.9, 0.2, 0.6, 0.1, 0.8],
                  [0.1, 0.9, 0.2, 0.8, 0.3],
                  [0.7, 0.1, 0.9, 0.3, 0.2]], np.float32)
BREAKS = np.array([120, 240], np.int32)
KEY = jax.random.PRNGKey(21)


def _configs(**kw):
    cfg = dict(history=H, detector_stride=1, min_samples=4, delta=0.05, **kw)
    return JaxGLRCUCB(N, M, **cfg), cfg


@functools.lru_cache(maxsize=None)
def _jax_prefix_run(prefix, split_grid):
    """The JAX run up to ``prefix``, shared by both port backends."""
    jsched, cfg = _configs(split_grid=split_grid)
    out = jax_simulate(jsched, make_piecewise(MEANS, BREAKS), KEY, prefix,
                       collect_curve=False, return_state=True)
    return jsched, cfg, out


@pytest.mark.parametrize("prefix", [7, 64, 130, 245, 330, 400])
@pytest.mark.parametrize("split_grid", ["all", "geometric"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_one_step_matches_jax(prefix, split_grid, backend):
    jsched, cfg, out = _jax_prefix_run(prefix, split_grid)
    env = make_piecewise(MEANS, BREAKS)
    jstate = out["final_sched_state"]
    tsched = GLRCUCB(N, M, detector_backend=backend, **cfg)
    tstate = convert.glr_cucb_state(jstate, device="cpu")

    t = prefix
    k_env, k_sel = jax.random.split(jax.random.fold_in(KEY, 10_000 + prefix))
    u_sel = jax.random.uniform(k_sel, (N,))
    ch_states = np.array(jax.random.bernoulli(k_env, env.means_at(t)), np.float32)
    aoi = jnp.asarray(np.array(out["aoi_pi"]))

    jch, jaux = jsched.select(jstate, jnp.int32(t), k_sel, aoi)
    tch, taux = tsched.select(tstate, t, torch.from_numpy(np.array(u_sel)),
                              torch.from_numpy(np.array(aoi)))
    np.testing.assert_array_equal(tch.numpy(), np.array(jch))

    jnext = jsched.update(jstate, jnp.int32(t), jch, jnp.asarray(ch_states)[jch], jaux)
    tnext = tsched.update(tstate, t, tch, torch.from_numpy(ch_states)[tch], taux)
    for f in ("counts", "cum", "total", "base", "tau", "restarts"):
        np.testing.assert_array_equal(getattr(tnext, f).numpy(), np.array(getattr(jnext, f)), f)
    np.testing.assert_allclose(tnext.mu_tilde.numpy(), np.array(jnext.mu_tilde), rtol=1e-6)


def test_prefixes_cover_wraparound_and_restarts():
    """The parity prefixes above reach past the ring length and past at
    least one restart, so the one-step test covers both."""
    jsched, _ = _configs()
    out = jax_simulate(jsched, make_piecewise(MEANS, BREAKS), KEY, 400,
                       collect_curve=False, return_state=True)
    st = out["final_sched_state"]
    assert int(out["restarts"]) >= 2
    assert float(np.array(st.counts).max()) > H and float(np.array(st.base).max()) > 0
