"""Fault injection parity and the Byzantine FL slice against the JAX package.

Randomness: a JAX family draws on ``k_fault = fold_in(key, 0xFA17)``; the
port takes the uniforms behind those draws (``jax_fault_uniforms`` below,
the layout ``repro_torch.core.faults`` documents), since
``jax.random.bernoulli(k, p, s)`` is ``uniform(k, s) < p`` bitwise.

Tolerances.  Hit masks, dropped masks, the burst carry and the sign-flip,
byte-flip and NaN rows are bitwise (a product by an exact factor, or a
select).  ``inner_product`` averages the honest rows in another order than
XLA: rtol 1e-6 / atol 1e-7.  The trainer runs (the chaos suite's Byzantine
setup: M = 6 clients, N = 9 channels, a 12-dim linear model, GLR-CUCB
history 64, 15 rounds a cell) hold n_success bitwise each round and the
final per-client AoI, has_update, fault carry and bandit counts bitwise;
mean AoI at rtol 1e-6 (XLA's ``mean`` and torch's round the last bit
apart on a few rounds); params and the local loss at rtol 1e-4 /
atol 1e-5: local SGD runs torch autograd against ``jax.grad``, the sums
of Eq. 7 run in another order, and 15 rounds compound the ulps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.channels import make_stationary as jax_stationary  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.channels import make_stationary  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402

FAULT_TAG = 0xFA17
KEY = jax.random.PRNGKey(0)
M, N, D, ROUNDS = 6, 9, 12, 15


def jax_fault_uniforms(fault, key, m):
    """The f32 uniforms behind ``fault``'s JAX draws on ``key``."""
    if fault.FAMILY == "burst":
        k_flip, k_base = jax.random.split(key)
        return np.concatenate([np.array(jax.random.uniform(k_flip, ()))[None],
                               jax_fault_uniforms(fault.base, k_base, m)])
    if fault.FAMILY == "nan_grads":
        k0, k1 = jax.random.split(key)
        return np.concatenate([np.array(jax.random.uniform(k0, (m,))),
                               np.array(jax.random.uniform(k1, (m,)))])
    return np.array(jax.random.uniform(key, (m,)))


FAULTS = {
    "dropout": dict(rate=0.3),
    "nan_grads": dict(rate=0.3, inf_frac=0.4),
    "byte_flip": dict(rate=0.3, exponent=24.0),
    "sign_flip": dict(rate=0.2, scale=8.0),
    "inner_product": dict(rate=0.3, strength=8.0),
}


def _burst(base="sign_flip", **kw):
    base_j = jfaults.make_fault(base, **FAULTS[base])
    return jfaults.make_fault("burst", base=base_j, **kw)


def test_registry_lists_the_jax_families():
    assert sorted(tfaults.registered_faults()) == sorted(jfaults.registered_faults())
    for fam in jfaults.registered_faults():
        assert tfaults.example_fault(fam) == convert.fault(jfaults.example_fault(fam))


def test_make_fault_checks_knobs_like_jax():
    for kwargs in (dict(rat=0.1), dict(rate=0.1, extra=1)):
        with pytest.raises(ValueError) as mine:
            tfaults.make_fault("sign_flip", **kwargs)
        with pytest.raises(ValueError) as theirs:
            jfaults.make_fault("sign_flip", **kwargs)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown family"):
        tfaults.make_fault("bit_rot")
    with pytest.raises(ValueError, match="no traced 'rate' knob"):
        tfaults.BurstFaults(base=_NoRate())


class _NoRate(tfaults.FaultProcess):
    """A family without a ``rate`` knob: nothing for ``burst`` to modulate."""

    TRACED = ("scale",)


def test_convert_nests_the_burst_base():
    jb = _burst(p_on=0.15, p_off=0.35)
    tb = convert.fault(jb)
    assert tb == tfaults.make_fault("burst", base=tfaults.make_fault("sign_flip", rate=0.2,
                                                                     scale=8.0),
                                    p_on=0.15, p_off=0.35)
    assert tb.n_uniforms(M) == 1 + M


def _updates(seed, m=M, p=40):
    return np.random.default_rng(seed).standard_normal((m, p)).astype(np.float32)


@pytest.mark.parametrize("family", sorted(FAULTS))
@pytest.mark.parametrize("stateful", [False, True], ids=["inject", "inject_sched"])
def test_inject_matches_jax(family, stateful):
    jf = jfaults.make_fault(family, **FAULTS[family])
    tf = convert.fault(jf)
    hits = 0
    for r in range(12):
        key = jax.random.fold_in(jax.random.fold_in(KEY, r), FAULT_TAG)
        x = _updates(r)
        u = torch.from_numpy(jax_fault_uniforms(jf, key, M))
        if stateful:
            jout, jdrop, jst = jf.inject_sched(key, jnp.int32(r), jnp.asarray(x), jnp.float32(0.0))
            tout, tdrop, tst = tf.inject_sched(u, r, torch.from_numpy(x), torch.tensor(0.0))
            assert float(tst) == float(jst) == 0.0
        else:
            jout, jdrop = jf.inject(key, jnp.int32(r), jnp.asarray(x))
            tout, tdrop = tf.inject(u, r, torch.from_numpy(x))
        jout, tout = np.array(jout), tout.numpy()
        np.testing.assert_array_equal(tdrop.numpy(), np.array(jdrop))
        changed = ~np.all(jout == x, axis=1) | np.array(jdrop, bool)
        np.testing.assert_array_equal(~np.all(tout == x, axis=1) | tdrop.numpy().astype(bool),
                                      changed)
        hits += int(changed.sum())
        if family == "inner_product":
            np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(tout, jout)
    assert hits > 0


def test_uniform_count_is_checked():
    tf = tfaults.make_fault("nan_grads")
    with pytest.raises(ValueError, match=r"\(12,\) uniforms"):
        tf.inject(torch.rand(6), 0, torch.zeros((6, 3)))


@pytest.mark.parametrize("base", ["sign_flip", "dropout", "nan_grads"])
def test_burst_carry_matches_jax_over_200_rounds(base):
    jb = _burst(base, p_on=0.15, p_off=0.35)
    tb = convert.fault(jb)
    jst, tst = jnp.float32(0.0), tb.schedule_init("cpu")
    states = []
    for r in range(200):
        key = jax.random.fold_in(jax.random.fold_in(KEY, 1000 + r), FAULT_TAG)
        x = _updates(r, p=8)
        jout, jdrop, jst = jb.inject_sched(key, jnp.int32(r), jnp.asarray(x), jst)
        tout, tdrop, tst = tb.inject_sched(torch.from_numpy(jax_fault_uniforms(jb, key, M)), r,
                                           torch.from_numpy(x), tst)
        assert tst.numpy().tobytes() == np.array(jst).tobytes(), f"round {r}"
        np.testing.assert_array_equal(tout.numpy(), np.array(jout))
        np.testing.assert_array_equal(tdrop.numpy(), np.array(jdrop))
        states.append(float(tst))
    occupancy = float(np.mean(states))
    assert 0.1 < occupancy < 0.6            # p_on / (p_on + p_off) = 0.3


# ---------------------------------------------------------------------------
# the slice as a whole: the chaos suite's Byzantine setup, trainer against trainer
# ---------------------------------------------------------------------------

def _jax_loss(p, x, y):
    return jnp.mean((x @ p["w"] - y) ** 2)


def _torch_loss(p, x, y):
    return torch.mean((x @ p["w"] - y) ** 2)


@pytest.fixture(scope="module")
def chaos():
    bx = np.array(jax.random.normal(jax.random.fold_in(KEY, 31), (ROUNDS, M, 1, 4, D)))
    by = (bx.sum(-1) * 0.3).astype(np.float32)
    keys = [jax.random.fold_in(jax.random.fold_in(KEY, 32), r) for r in range(ROUNDS)]
    return dict(bx=bx, by=by, keys=keys)


CELLS = {
    "sign_flip+mean": ("sign_flip", "mean"),
    "sign_flip+trimmed_mean": ("sign_flip", "trimmed_mean"),
    "sign_flip+coordinate_median": ("sign_flip", "coordinate_median"),
    "sign_flip+norm_clip": ("sign_flip", "norm_clip"),
    "inner_product+mean": ("inner_product", "mean"),
    "inner_product+trimmed_mean": ("inner_product", "trimmed_mean"),
    "inner_product+coordinate_median": ("inner_product", "coordinate_median"),
    "inner_product+norm_clip": ("inner_product", "norm_clip"),
    "burst+coordinate_median": ("burst", "coordinate_median"),
    "burst+trimmed_mean": ("burst", "trimmed_mean"),
    "dropout+mean": ("dropout", None),
    "nan_grads+coordinate_median": ("nan_grads", "coordinate_median"),
}
AGGS = {"mean": {}, "trimmed_mean": dict(trim_frac=0.34), "coordinate_median": {},
        "norm_clip": dict(clip_norm=1.0)}


def _instances(cell):
    fam, agg = CELLS[cell]
    if fam == "burst":
        jf = jfaults.make_fault("burst", base=jfaults.make_fault("sign_flip", rate=0.3, scale=6.0),
                                p_on=0.15, p_off=0.35)
    else:
        jf = jfaults.make_fault(fam, **FAULTS[fam])
    ja = jagg.make_aggregator(agg, **AGGS[agg]) if agg else None
    return jf, ja


def _round_uniforms(jf, keys):
    """(R, 2, N) channel/scheduler uniforms and (R, K) fault uniforms behind
    the JAX round keys."""
    def env_sel(k):
        k_env, k_sel = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k_env, (N,)), jax.random.uniform(k_sel, (N,))])

    u = torch.from_numpy(np.array(jax.vmap(env_sel)(jnp.stack(keys))))
    f = np.stack([jax_fault_uniforms(jf, jax.random.fold_in(k, FAULT_TAG), M) for k in keys])
    return u, torch.from_numpy(f)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_byzantine_trainer_matches_jax(chaos, cell):
    jf, ja = _instances(cell)
    cfg = dict(n_clients=M, n_channels=N)
    means = np.full((N,), 0.8, np.float32)
    jtr = JaxTrainer(cfg=JaxConfig(**cfg), scheduler=JaxGLRCUCB(N, M, history=64),
                     env=jax_stationary(jnp.asarray(means)), loss_fn=_jax_loss,
                     faults=jf, aggregator=ja)
    ttr = AsyncFLTrainer(AsyncFLConfig(**cfg), GLRCUCB(N, M, history=64),
                         make_stationary(means, device="cpu"), _torch_loss, device="cpu",
                         faults=convert.fault(jf),
                         aggregator=None if ja is None else convert.aggregator(ja))
    params = {"w": np.full((D,), 0.5, np.float32)}
    jstate, jm = jtr.run(jtr.init({"w": jnp.asarray(params["w"])}, KEY),
                         jnp.asarray(chaos["bx"]), jnp.asarray(chaos["by"]),
                         jnp.stack(chaos["keys"]))
    u, fu = _round_uniforms(jf, chaos["keys"])
    tstate, tm = ttr.run(ttr.init(convert.params(params, "cpu")), torch.from_numpy(chaos["bx"]),
                         torch.from_numpy(chaos["by"]), uniforms=u, fault_uniforms=fu)
    np.testing.assert_array_equal(tm["n_success"].numpy(), np.array(jm["n_success"]))
    np.testing.assert_allclose(tm["mean_aoi"].numpy(), np.array(jm["mean_aoi"]), rtol=1e-6)
    np.testing.assert_allclose(tm["local_loss"].numpy(), np.array(jm["local_loss"]),
                               rtol=1e-4, atol=1e-5)
    for f in ("aoi", "has_update", "last_success", "staleness", "fault_state"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.array(getattr(jstate, f)),
                                      err_msg=f)
    for f in ("counts", "restarts", "tau"):
        np.testing.assert_array_equal(getattr(tstate.sched_state, f).numpy(),
                                      np.array(getattr(jstate.sched_state, f)), err_msg=f)
    np.testing.assert_allclose(tstate.params["w"].numpy(), np.array(jstate.params["w"]),
                               rtol=1e-4, atol=1e-5)
    assert np.isfinite(tstate.params["w"].numpy()).all()
    assert float(tm["n_success"].sum()) > 0

    # ``round`` by round with the same uniforms gives ``run``'s bits
    state = ttr.init(convert.params(params, "cpu"))
    for r in range(ROUNDS):
        state, mets = ttr.round(state, torch.from_numpy(chaos["bx"][r]),
                                torch.from_numpy(chaos["by"][r]), u_env=u[r, 0], u_sel=u[r, 1],
                                u_fault=fu[r])
        for k in mets:
            assert torch.equal(mets[k], tm[k][r]), (r, k)
    assert torch.equal(state.params["w"], tstate.params["w"])


def test_state_carries_across_from_jax(chaos):
    """``convert.async_fl_state`` carries the fault carry; one port round
    from a carried burst state equals JAX's next round."""
    jf, ja = _instances("burst+coordinate_median")
    cfg = dict(n_clients=M, n_channels=N)
    means = np.full((N,), 0.8, np.float32)
    jtr = JaxTrainer(cfg=JaxConfig(**cfg), scheduler=JaxGLRCUCB(N, M, history=64),
                     env=jax_stationary(jnp.asarray(means)), loss_fn=_jax_loss,
                     faults=jf, aggregator=ja)
    ttr = AsyncFLTrainer(AsyncFLConfig(**cfg), GLRCUCB(N, M, history=64),
                         make_stationary(means, device="cpu"), _torch_loss, device="cpu",
                         faults=convert.fault(jf), aggregator=convert.aggregator(ja))
    jstate = jtr.init({"w": jnp.full((D,), 0.5, jnp.float32)}, KEY)
    carried = 0
    for r, key in enumerate(chaos["keys"]):
        tstate = convert.async_fl_state(jstate, "cpu")
        k_env, k_sel = jax.random.split(key)
        jnext, jm = jtr.round(jstate, jnp.asarray(chaos["bx"][r]), jnp.asarray(chaos["by"][r]), key)
        _, tm = ttr.round(tstate, torch.from_numpy(chaos["bx"][r]),
                          torch.from_numpy(chaos["by"][r]),
                          u_env=torch.from_numpy(np.array(jax.random.uniform(k_env, (N,)))),
                          u_sel=torch.from_numpy(np.array(jax.random.uniform(k_sel, (N,)))),
                          u_fault=torch.from_numpy(jax_fault_uniforms(
                              jf, jax.random.fold_in(key, FAULT_TAG), M)))
        np.testing.assert_array_equal(tm["n_success"].numpy(), np.array(jm["n_success"]))
        carried += int(float(jstate.fault_state) > 0.5)
        jstate = jnext
    assert carried > 0


def test_faultless_round_rejects_fault_uniforms_and_draws_both_with_faults():
    means = np.full((N,), 0.8, np.float32)
    env = make_stationary(means, device="cpu")
    bx = torch.randn((2, M, 1, 4, D), generator=torch.Generator().manual_seed(0))
    by = bx.sum(-1) * 0.3
    params = {"w": torch.full((D,), 0.5)}
    plain = AsyncFLTrainer(AsyncFLConfig(n_clients=M, n_channels=N), GLRCUCB(N, M, history=64),
                           env, _torch_loss, device="cpu")
    with pytest.raises(ValueError, match="without faults"):
        plain.round(plain.init(params), bx[0], by[0], u_env=torch.rand(N), u_sel=torch.rand(N),
                    u_fault=torch.rand(M))
    faulty = AsyncFLTrainer(AsyncFLConfig(n_clients=M, n_channels=N), GLRCUCB(N, M, history=64),
                            env, _torch_loss, device="cpu",
                            faults=tfaults.make_fault("sign_flip", rate=0.5))
    with pytest.raises(ValueError, match="u_fault"):
        faulty.round(faulty.init(params), bx[0], by[0], u_env=torch.rand(N), u_sel=torch.rand(N))
    runs = [faulty.run(faulty.init(params), bx, by, generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
