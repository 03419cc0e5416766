"""FL trainers taking their schedule from the scheduler service
(``AsyncFLTrainer.run_served``).

On the CPU a trainer that posts its channel vector, selection uniform,
contributions and AoI to a ``SchedServer`` and finishes each round with
the returned assignment and matcher row reproduces its own ``run()`` bit
for bit: every state leaf (``sched_state`` excepted: the policy state
lives in the server's tenant row, which must equal ``run()``'s final
``sched_state``) and every metric; also under client faults, and with two
tenants sharing one server.  Splitting ``round`` into its pre- and
post-decision halves leaves ``round`` as it was (``run`` is the reference
above and ``tests/test_torch_fl_round.py`` holds it to JAX).

Against the JAX trainer's ``run_served`` on the same data, weights and
randomness, over 3 rounds: ``n_success``, AoI, ``has_update`` and the
server's channel counts bitwise;
params, buffers, contributions and zeta at rtol 1e-5 / atol 1e-6 (local
SGD is torch autograd against ``jax.grad``), as in
``tests/test_torch_fl_round.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.channels import make_piecewise as jax_make_piecewise  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro.sim import SchedServer as JaxServer  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.channels import make_piecewise  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402
from repro_torch.sim import SchedServer  # noqa: E402

D, B, E = 4, 3, 2
M, NCH, R = 5, 8, 12
MEANS = np.array([[0.9, 0.2, 0.7, 0.3, 0.6, 0.1, 0.8, 0.4],
                  [0.2, 0.8, 0.3, 0.9, 0.1, 0.7, 0.3, 0.6],
                  [0.5, 0.5, 0.9, 0.1, 0.8, 0.2, 0.4, 0.7]], np.float32)
BREAKS = np.array([4, 8], np.int64)
CFG = dict(n_clients=M, n_channels=NCH, local_epochs=E, staleness_cap=3, max_update_norm=50.0)


def _torch_loss(p, x, y):
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


def _jax_loss(p, x, y):
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def _data(seed):
    rng = np.random.default_rng(seed)
    bx = rng.normal(size=(R, M, E, B, D)).astype(np.float32)
    by = rng.normal(size=(R, M, E, B)).astype(np.float32)
    u = rng.random((R, 2, NCH)).astype(np.float32)
    return torch.from_numpy(bx), torch.from_numpy(by), torch.from_numpy(u)


def _params():
    return {"w": torch.zeros(D), "b": torch.zeros(())}


def _trainer(faults=None, **cfg):
    env = make_piecewise(torch.from_numpy(MEANS), torch.from_numpy(BREAKS), device="cpu")
    return AsyncFLTrainer(AsyncFLConfig(**{**CFG, **cfg}), GLRCUCB(NCH, M, history=32), env,
                          _torch_loss, device="cpu", faults=faults)


def _server(trainer, **kw):
    cfg = dict(capacity=4, slots=2, use_matching=True, matcher_beta=trainer.cfg.matcher_beta,
               device="cpu")
    cfg.update(kw)
    return SchedServer(trainer.scheduler, **cfg)


def _flat(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree for x in _flat(f)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _assert_bitwise(ref_state, state, ref_m, mets, server, tenant):
    for name in ref_state._fields:
        if name == "sched_state":
            continue
        for a, b in zip(_flat(getattr(ref_state, name)), _flat(getattr(state, name))):
            assert (a == b) if isinstance(a, int) else torch.equal(a, b), name
    row = server.tenant_state(tenant).sched_state
    for a, b in zip(_flat(ref_state.sched_state), _flat(row)):
        assert torch.equal(a, b), "server-side sched_state"
    for k in ref_m:
        assert torch.equal(ref_m[k], mets[k]), k


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "sign_flip"])
def test_run_served_matches_run_bitwise(faulty):
    bx, by, u = _data(1)
    faults = tfaults.make_fault("sign_flip", rate=0.5) if faulty else None
    tr = _trainer(faults=faults)
    fu = (torch.from_numpy(np.random.default_rng(2).random((R, tr.n_fault_uniforms()))
                           .astype(np.float32)) if faulty else None)
    ref_state, ref_m = tr.run(tr.init(_params()), bx, by, uniforms=u, fault_uniforms=fu)
    server = _server(tr)
    server.join("job")
    state, mets = tr.run_served(tr.init(_params()), bx, by, server, "job", uniforms=u,
                                fault_uniforms=fu)
    _assert_bitwise(ref_state, state, ref_m, mets, server, "job")
    assert float(ref_m["n_success"].sum()) > 0


def test_two_tenants_share_a_server_without_crosstalk():
    """Interleaved rounds of two jobs on one server: each reproduces its own
    ``run()``; tenant b joins with its own hyper-parameters."""
    tr_a, tr_b = _trainer(), _trainer(client_lr=0.2)
    hp_b = {"gamma": 0.5}
    (bx_a, by_a, u_a), (bx_b, by_b, u_b) = _data(3), _data(4)
    ref_a = tr_a.run(tr_a.init(_params()), bx_a, by_a, uniforms=u_a)
    full_b = {**{k: float(v) for k, v in tr_b.scheduler.params("cpu").items()}, **hp_b}
    ref_b = tr_b.run(tr_b.init(_params(), hp=full_b), bx_b, by_b, uniforms=u_b)
    server = _server(tr_a)
    server.join("a")
    server.join("b", hp=hp_b)
    st_a, st_b = tr_a.init(_params()), tr_b.init(_params(), hp=full_b)
    mets_a, mets_b = [], []
    for r in range(R):
        st_a, m_a = tr_a.run_served(st_a, bx_a[r:r + 1], by_a[r:r + 1], server, "a",
                                    uniforms=u_a[r:r + 1])
        st_b, m_b = tr_b.run_served(st_b, bx_b[r:r + 1], by_b[r:r + 1], server, "b",
                                    uniforms=u_b[r:r + 1])
        mets_a.append(m_a)
        mets_b.append(m_b)
    cat = lambda ms: {k: torch.cat([m[k] for m in ms]) for k in ms[0]}
    _assert_bitwise(*ref_a[:1], st_a, ref_a[1], cat(mets_a), server, "a")
    _assert_bitwise(*ref_b[:1], st_b, ref_b[1], cat(mets_b), server, "b")


def test_validate_server_guard_rails():
    tr = _trainer()
    bx, by, u = _data(0)
    with pytest.raises(ValueError, match="use_matching"):
        tr.run_served(tr.init(_params()), bx, by, _server(tr, use_matching=False), "x",
                      uniforms=u)
    with pytest.raises(ValueError, match="matcher_beta"):
        tr.run_served(tr.init(_params()), bx, by, _server(tr, matcher_beta=0.9), "x",
                      uniforms=u)
    with pytest.raises(ValueError, match="dims"):
        tr.run_served(tr.init(_params()), bx, by,
                      SchedServer(GLRCUCB(NCH, M + 1, history=32), use_matching=True,
                                  device="cpu"), "x", uniforms=u)
    with pytest.raises(ValueError, match="score_kind"):
        tr.run_served(tr.init(_params()), bx, by, _server(tr, score_kind="mean"), "x",
                      uniforms=u)
    with pytest.raises(ValueError, match="uniforms must be"):
        tr.run_served(tr.init(_params()), bx, by, _server(tr), "x", uniforms=u[:3])


def test_run_served_matches_jax_run_served():
    rounds = 3
    key = jax.random.PRNGKey(3)
    bx, by, _ = _data(5)
    jtr = JaxTrainer(JaxConfig(**CFG), JaxGLRCUCB(NCH, M, history=32),
                     jax_make_piecewise(MEANS, BREAKS.astype(np.int32)), _jax_loss)
    jparams = {"w": jnp.zeros((D,), jnp.float32), "b": jnp.zeros((), jnp.float32)}
    keys = jax.random.split(jax.random.PRNGKey(9), rounds)
    jserver = JaxServer(jtr.scheduler, capacity=4, slots=2, use_matching=True,
                        matcher_beta=jtr.cfg.matcher_beta, donate=False)
    jserver.join("job", key=key)
    jstate, jm = jtr.run_served(jtr.init(jparams, key), jnp.asarray(bx[:rounds].numpy()),
                                jnp.asarray(by[:rounds].numpy()), keys, jserver, "job")

    u = torch.from_numpy(np.stack([np.stack([np.array(jax.random.uniform(k2, (NCH,)))
                                             for k2 in jax.random.split(k)]) for k in keys]))
    tr = _trainer()
    server = _server(tr)
    server.join("job")
    state, mets = tr.run_served(tr.init(_params()), bx[:rounds], by[:rounds], server, "job",
                                uniforms=u)
    np.testing.assert_array_equal(mets["n_success"].numpy(), np.array(jm["n_success"]))
    np.testing.assert_array_equal(state.aoi.numpy(), np.array(jstate.aoi))
    np.testing.assert_array_equal(state.has_update.numpy(), np.array(jstate.has_update))
    np.testing.assert_array_equal(server.tenant_state("job").sched_state.counts.numpy(),
                                  np.array(jserver.tenant_state("job").sched_state.counts))
    close = lambda a, b, what: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=what)
    for k in ("w", "b"):
        close(state.params[k].numpy(), jstate.params[k], k)
    for name in ("buffers", "contrib", "zeta"):
        close(getattr(state, name).numpy(), getattr(jstate, name), name)
    for k in ("local_loss", "mean_aoi", "beta_t", "zeta_max"):
        close(mets[k].numpy(), jm[k], k)
    for a, b in zip(state.matcher_state, jstate.matcher_state):
        close(a.numpy(), b, "matcher_state")
