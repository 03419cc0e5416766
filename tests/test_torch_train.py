"""Parity of the port's training path with the JAX package's.

``synthetic_lm_batches`` gives JAX's tokens bit for bit.  ``Model.loss`` on
the three dense smoke configs in f32 (2 layers, width 256), JAX ``init`` ->
``convert.model_params`` -> the port, with example weights that include
zeros: loss and ``per_example`` at rtol 1e-5, gradients against
``jax.grad`` at rtol 1e-4 (torch autograd against XLA's derivative; sums
in another order, ``logsumexp`` an ulp apart), with an absolute floor of
1e-4 of the tensor's largest entry: an embedding row's gradient sums a
token's contributions, which cancel to a few thousandths of the rest.
The model variants (``ce_chunk`` on a length that leaves padding,
``seq_shard``) equal the base at rtol 1e-5 (floor 1e-5 of the largest
entry: the chunks sum the unembedding's gradient in another order); the
three ``remat`` policies
give bitwise losses and gradients, on the plain route and on the kernel
route (whose plain version runs here); the kernel route equals the plain
route at rtol 1e-5.

``make_fl_train_step`` runs five rounds from JAX's initial state
(``convert.train_state``) with the uniforms behind JAX's round keys, on a
stationary env and on a piecewise env with a change at round 2, in one
batch and (piecewise) in four microbatches against JAX's ``lax.scan``
accumulation: the discrete FL state (AoI, every scheduler leaf,
``n_success``) bit for bit; loss, contributions, zeta, ``mean_aoi`` and
``aoi_var`` at rtol 1e-5; AdamW's moments and the parameters as
``chip_smoke.adam_round_close`` holds the card to the CPU: moments at rtol
1e-4 / atol min(1e-6, 1e-4 of the tensor's largest entry), parameters at
rtol 1e-4 / atol 1e-6 plus twice the AdamW steps' first-order response to
the two sides' moment differences, lr (|dm| + |d sqrt v|) / (sqrt v +
eps) an entry a round (bias-corrected), summed over the rounds and at
most two steps' difference a round.  AdamW's step is scale free: an entry
whose gradient cancels to a few thousandths of its terms (embedding rows
summing a token's contributions) or is rounding noise steps by a
different fraction of lr on each side.  Then the twins of
``tests/test_scale_steps.py`` (microbatching at its tolerances, the FL
bookkeeping) and of ``tests/test_system.py::test_full_fl_pipeline_then_serve``
on the bf16 smoke config, and the launcher on the CPU.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.bandits import GLRCUCB as JGLRCUCB  # noqa: E402
from repro.core.channels import make_piecewise as j_piecewise  # noqa: E402
from repro.core.channels import make_stationary as j_stationary  # noqa: E402
from repro.data.synthetic import synthetic_lm_batches as j_lm_batches  # noqa: E402
from repro.launch.steps import make_fl_train_step as j_make_step  # noqa: E402
from repro.launch.steps import make_train_state_init as j_make_init  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.channels import make_stationary  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    loss_and_grads,
    make_fl_train_step,
    make_serve_step,
    make_train_state_init,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ["qwen3-32b", "qwen2.5-32b", "qwen1.5-0.5b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs each test in
    seconds, where torch's default pool (a thread a core) contends with the
    other test workers' threads (on 8 cores, beside five other test files
    on six workers, this file took 330 s with the pool and 36 s without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
KEY = jax.random.PRNGKey(0)
WEIGHTS = np.array([0.0, 1.5, 0.0, 0.5], np.float32)
N_CH, N_CL, ROUNDS = 8, 4, 5


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.array(jnp.asarray(x, jnp.float32))


def _f32(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("batch,seq,vocab,seed", [(8, 32, 512, 0), (3, 17, 151936, 5),
                                                  (2, 4, 7, 11)])
def test_synthetic_lm_batches_are_jax_bit_for_bit(batch, seq, vocab, seed):
    mine, theirs = synthetic_lm_batches(batch, seq, vocab, seed), j_lm_batches(
        batch, seq, vocab, seed)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert a.dtype == b.dtype == np.int32 and a.shape == (batch, seq)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Model.loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    jm = j_build(cfg, remat="none")
    jp, _ = jm.init(KEY)
    toks = _tokens(cfg.vocab_size, (4, 24))
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}, jnp.asarray(WEIGHTS)),
        has_aux=True))(jp)
    pm = build_model(_f32(arch), remat="none")
    tl, tmet, tg = loss_and_grads(pm, convert.model_params(jp, "cpu"),
                          {"tokens": torch.from_numpy(toks)}, torch.from_numpy(WEIGHTS))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for k in ("loss", "per_example", "moe_aux"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-5, err_msg=k)
    assert set(tg) == set(jg)
    for k, g in jg.items():
        assert tg[k].dtype == torch.float32 and tuple(tg[k].shape) == g.shape
        _close_grad(tg[k], g, 1e-4, k)


def test_loss_without_weights_is_the_mean():
    pm = build_model(_f32("qwen1.5-0.5b"), remat="none")
    params, _ = pm.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(512, (4, 16)))}
    total, met = pm.loss(params, batch)
    np.testing.assert_allclose(_np(met["loss"]), _np(met["per_example"].mean()), rtol=1e-6)
    assert float(met["moe_aux"]) == 0.0 and float(total) == float(met["loss"])


def _setup_pair(arch="qwen2.5-32b", seq=64):
    cfg = _f32(arch)
    base = Model(cfg, remat="none")
    params, _ = base.init(torch.Generator().manual_seed(1), device="cpu")
    return cfg, base, params, {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, (2, seq)))}


def test_seq_shard_and_ce_chunk_model_variants_agree():
    """Twin of ``tests/test_scale_steps.py``'s: 63 predicted positions in
    chunks of 16 (one padded), and ``seq_shard``, equal the base."""
    cfg, base, params, batch = _setup_pair()
    l1, m1, g1 = loss_and_grads(base, params, batch)
    for variant in (Model(cfg, remat="none", ce_chunk=16, seq_shard=True),
                    Model(cfg, remat="full", ce_chunk=16), Model(cfg, remat="none", ce_chunk=7)):
        l2, m2, g2 = loss_and_grads(variant, params, batch)
        np.testing.assert_allclose(_np(l2), _np(l1), rtol=1e-5)
        np.testing.assert_allclose(_np(m2["per_example"]), _np(m1["per_example"]), rtol=1e-5)
        for k in g1:
            _close_grad(g2[k], g1[k], 1e-5, k)


@pytest.mark.parametrize("attn_impl", [None, "kernel"])
def test_remat_policies_are_bitwise(attn_impl):
    """Checkpointing recomputes the same operations on the same inputs,
    through ``_KernelAttention``'s saved q, k, v too."""
    cfg, _, params, batch = _setup_pair("qwen1.5-0.5b", seq=40)
    ref = None
    for remat in ("none", "full", "dots"):
        model = Model(cfg, remat=remat, attn_impl=attn_impl)
        loss, met, g = loss_and_grads(model, params, batch, torch.tensor([1.0, 0.0]))
        if ref is None:
            ref = (loss, met, g)
            continue
        assert torch.equal(loss, ref[0]) and torch.equal(met["per_example"], ref[1]["per_example"])
        for k in g:
            assert torch.equal(g[k], ref[2][k]), (remat, k)


def test_remat_recomputes_the_blocks(monkeypatch):
    """``"full"`` runs each block's forward again in the backward pass (the
    kernel route's attention too), ``"none"`` once; no gradient, no
    recompute."""
    from repro_torch.models import attention as attn_mod

    calls = []
    plain = attn_mod._attn_core_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(attn_mod, "_attn_core_plain", counted)
    cfg, _, params, batch = _setup_pair("qwen1.5-0.5b", seq=24)
    for remat, want in (("none", 2), ("full", 4)):
        calls.clear()
        loss_and_grads(Model(cfg, remat=remat, attn_impl="plain"), params, batch)
        assert len(calls) == want * cfg.n_layers // 2, remat
    calls.clear()
    Model(cfg, remat="full", attn_impl="plain").loss(params, batch)
    assert len(calls) == cfg.n_layers


def test_kernel_route_matches_plain_route():
    cfg, _, params, batch = _setup_pair("qwen3-32b", seq=48)
    w = torch.tensor([2.0, 1.0])
    lk, mk, gk = loss_and_grads(Model(cfg, remat="full", attn_impl="kernel"), params, batch, w)
    lp, mp, gp = loss_and_grads(Model(cfg, remat="full", attn_impl="plain"), params, batch, w)
    np.testing.assert_allclose(_np(lk), _np(lp), rtol=1e-5)
    for k in gp:
        _close_grad(gk[k], gp[k], 1e-5, k)


def test_unknown_remat_is_refused():
    with pytest.raises(ValueError, match="remat"):
        Model(get_smoke_config("qwen1.5-0.5b"), remat="some")


# ---------------------------------------------------------------------------
# make_fl_train_step against JAX
# ---------------------------------------------------------------------------

def _j_uniforms(key):
    k_env, k_sel = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(k_env, (N_CH,)))),
            torch.from_numpy(np.array(jax.random.uniform(k_sel, (N_CH,)))))


ENVS = {
    "stationary": lambda: j_stationary(jnp.linspace(0.9, 0.3, N_CH)),
    "piecewise": lambda: j_piecewise(
        np.array([np.linspace(0.9, 0.2, N_CH), np.linspace(0.2, 0.9, N_CH)], np.float32),
        np.array([2], np.int32)),
}
SCHED = dict(history=16, min_samples=2, delta=0.05)


def _close_grad(got, want, rtol, what):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=what)


def _chip_smoke():
    """``chip_smoke.py`` (at the repo's root) as a module: the AdamW rule it
    holds the card to the CPU with is the one held here to JAX."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


def _same_fl(got, want, r):
    where = f"round {r}"
    np.testing.assert_array_equal(_np(got.aoi), _np(want.aoi), err_msg=f"{where} aoi")
    assert got.t == int(want.t) == r + 1
    for f in ("mu_tilde", "counts", "tau", "restarts", "cum", "total", "base"):
        np.testing.assert_array_equal(getattr(got.sched_state, f).numpy(),
                                      np.array(getattr(want.sched_state, f)),
                                      err_msg=f"{where} sched {f}")
    for f in ("v_max", "a_max", "beta_t"):
        np.testing.assert_allclose(getattr(got.matcher_state, f).numpy(),
                                   np.array(getattr(want.matcher_state, f)), rtol=1e-5,
                                   err_msg=f"{where} matcher {f}")
    for f in ("contrib", "zeta"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)), rtol=1e-5,
                                   err_msg=f"{where} {f}")


@pytest.mark.parametrize("env_name,microbatches", [("stationary", 1), ("piecewise", 1),
                                                   ("piecewise", 4)])
def test_fl_train_step_matches_jax(env_name, microbatches):
    cfg = dataclasses.replace(j_smoke("qwen1.5-0.5b"), dtype="float32")
    jm = j_build(cfg, remat="none")
    jsched, jenv, jopt = JGLRCUCB(N_CH, N_CL, **SCHED), ENVS[env_name](), j_adamw(1e-3)
    jstate = j_make_init(jm, jopt, jsched, N_CL)(KEY)
    jstep = jax.jit(j_make_step(jm, jopt, jsched, jenv, N_CL, microbatches=microbatches))

    pm = build_model(_f32("qwen1.5-0.5b"), remat="full")
    sched = GLRCUCB(N_CH, N_CL, **SCHED)
    step = make_fl_train_step(pm, adamw(1e-3), sched, convert.env(jenv, "cpu"), N_CL,
                              microbatches=microbatches)
    state = convert.train_state(jstate, "cpu")
    data = synthetic_lm_batches(8, 32, cfg.vocab_size, seed=4)
    slack = {k: torch.zeros(p.shape) for k, p in state.params.items()}
    for r in range(ROUNDS):
        toks = next(data)
        key = jax.random.fold_in(KEY, r)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)}, key)
        state, met = step(state, {"tokens": torch.from_numpy(toks)}, *_j_uniforms(key))
        assert float(met["n_success"]) == float(jmet["n_success"]), r
        for k in ("loss", "mean_aoi", "aoi_var", "moe_aux"):
            np.testing.assert_allclose(_np(met[k]), _np(jmet[k]), rtol=1e-5,
                                       err_msg=f"round {r} {k}")
        _same_fl(state.fl, jstate.fl, r)
        assert int(state.opt_state["count"]) == int(jstate.opt_state["count"]) == r + 1
        slack, _ = _chip_smoke().adam_round_close(
            torch, state.params, state.opt_state, convert.model_params(jstate.params, "cpu"),
            convert.optimizer_state(jstate.opt_state, "cpu"), slack, 1e-3, f"round {r}")
    if env_name == "piecewise":          # the change reached the schedule
        assert int(np.array(jstate.fl.sched_state.counts).sum()) == ROUNDS * N_CL


def test_convert_carries_sgd_states():
    p = {"a": np.ones((2, 3), np.float32)}
    assert convert.optimizer_state((), "cpu") == ()
    mom = convert.optimizer_state({"a": np.full((2, 3), 0.5, np.float32)}, "cpu")
    assert set(mom) == {"a"} and mom["a"].dtype == torch.float32
    adam = convert.optimizer_state({"mu": p, "nu": p, "count": np.array(3, np.int32)}, "cpu")
    assert adam["count"].dtype == torch.int32 and int(adam["count"]) == 3


# ---------------------------------------------------------------------------
# twins of tests/test_scale_steps.py and tests/test_system.py
# ---------------------------------------------------------------------------

def _setup(microbatches=1, n_clients=4):
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = build_model(cfg, remat="none")
    sched = GLRCUCB(8, n_clients, history=32)
    env = make_stationary(torch.linspace(0.9, 0.5, 8), device="cpu")
    opt = adamw(1e-3)
    state = make_train_state_init(model, opt, sched, n_clients)(
        torch.Generator().manual_seed(0), device="cpu")
    step = make_fl_train_step(model, opt, sched, env, n_clients, microbatches=microbatches)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, (8, 32)))}
    return state, step, batch


def _round_uniforms(t):
    u = torch.rand((2, N_CH), generator=torch.Generator().manual_seed(100 + t))
    return u[0], u[1]


def test_microbatched_step_matches_single_batch():
    """Gradient accumulation is exact: same params after one round."""
    s1, step1, batch = _setup(microbatches=1)
    s2, step2, _ = _setup(microbatches=4)
    n1, m1 = step1(s1, batch, *_round_uniforms(7))
    n2, m2 = step2(s2, batch, *_round_uniforms(7))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=2e-4)
    for k in n1.params:
        assert n1.params[k].dtype == n2.params[k].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(n1.params[k]), _np(n2.params[k]), rtol=2e-2, atol=3e-3)
    assert float(m1["mean_aoi"]) == float(m2["mean_aoi"])


def test_fl_state_bookkeeping_at_scale():
    state, step, batch = _setup()
    for t in range(5):
        state, mets = step(state, batch, *_round_uniforms(t))
        assert np.isfinite(float(mets["loss"]))
        assert (state.fl.aoi.numpy() >= 1).all()
        assert abs(float(state.fl.zeta.sum()) - 1) < 1e-5
    assert state.fl.t == 5


def test_batch_must_split_over_clients():
    state, step, _ = _setup()
    with pytest.raises(ValueError, match="split evenly"):
        step(state, {"tokens": torch.zeros((6, 8), dtype=torch.int32)}, *_round_uniforms(0))


def test_full_fl_pipeline_then_serve():
    """Train the smoke qwen on one token batch through the FL round, then
    serve greedily from the result."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = build_model(cfg, remat="none")
    sched = GLRCUCB(8, 4, history=64)
    env = make_stationary(torch.linspace(0.95, 0.4, 8), device="cpu")
    opt = adamw(1e-3)
    state = make_train_state_init(model, opt, sched, 4)(torch.Generator().manual_seed(0),
                                                        device="cpu")
    step = make_fl_train_step(model, opt, sched, env, 4)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, (8, 32), seed=2))}
    losses = []
    for t in range(8):
        state, mets = step(state, batch, *_round_uniforms(t))
        losses.append(float(mets["loss"]))
        assert np.isfinite(losses[-1]) and float(mets["mean_aoi"]) >= 1.0
    assert losses[-1] < losses[0]          # same batch -> loss must drop

    serve = make_serve_step(model)
    cache = model.init_cache(8, 16, device="cpu")
    tok = torch.zeros((8,), dtype=torch.int32)
    for _ in range(4):
        tok, cache = serve(state.params, cache, tok)
    assert tok.shape == (8,) and int(cache["pos"]) == 4


def test_train_launcher_on_the_cpu(capsys, tmp_path):
    assert train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "3", "--device", "cpu",
                       "--ckpt", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[train] qwen1.5-smoke (dense) — 4 clients, 8 channels, 3 rounds")
    rounds = [ln for ln in out.splitlines() if ln.startswith("  round")]
    assert len(rounds) == 3 and all("|S_t|=" in ln and "mean_aoi=" in ln for ln in rounds)
    flat, step = restore_checkpoint(str(tmp_path))
    assert step == 3 and "params/embed" in flat
