"""Parity of the port's training path with the JAX package's for the SSM,
RG-LRU hybrid, VLM and audio families.

``Model.loss`` and its gradients on the mamba2, recurrentgemma and
phi-3-vision smoke configs in f32 (JAX ``init`` -> ``convert.model_params``
-> the port; phi-3-vision behind its patch embeddings; mamba2 over two SSD
chunks, the second shorter) against ``jax.value_and_grad(jm.loss)``: loss
rtol 1e-5, gradients rtol 1e-4 with an absolute floor of 1e-4 of the
tensor's largest entry (``tests/test_torch_train.py``'s rule; hubert's are
in ``tests/test_torch_audio.py``).  The pieces under autograd: the SSD
chunk's gradient where the upper triangle's exponent passes exp's f32
overflow (the port's finite, and equal to an f64 recurrence; the JAX
reference's own gradient is NaN there, ROADMAP Queue 3), the doubling scan's
gradients against ``lax.associative_scan``'s (rtol 1e-5 / atol 1e-6, the
forward's tolerance), and the checkpoints this slice adds (each SSD chunk,
each unrolled layer under ``remat``) bitwise the run without them.

``make_fl_train_step`` runs three rounds from JAX's initial state for each
of the four families, with the uniforms behind JAX's round keys and the
same numpy batches: the discrete FL state bit for bit and the floats at
rtol 1e-5 over the three rounds, as ``tests/test_torch_train.py`` holds
the dense model, and AdamW's moments and parameters by
``chip_smoke.adam_round_close`` for each round stepped from JAX's state
(the test says why).  Then the launcher and ``make_batch`` on the CPU for
each family.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.bandits import GLRCUCB as JGLRCUCB  # noqa: E402
from repro.launch.steps import make_fl_train_step as j_make_step  # noqa: E402
from repro.launch.steps import make_train_state_init as j_make_init  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_fl_train_step  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import ENVS, N_CH, N_CL, SCHED, _chip_smoke, _j_uniforms  # noqa: E402
from test_torch_train import _same_fl  # noqa: E402

KEY = jax.random.PRNGKey(0)
WEIGHTS = np.array([0.0, 1.5, 0.0, 0.5], np.float32)
FAMILIES = ["mamba2-1.3b", "recurrentgemma-2b", "phi-3-vision-4.2b"]
ROUNDS = 3
EXP_OVERFLOW = 88.72          # log of f32's largest finite value


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread, so the test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.array(jnp.asarray(x, jnp.float32))


def _f32(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _close_grad(got, want, rtol, what):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=what)


def _batch(cfg, b, t, rng):
    """A numpy batch of ``cfg``'s family (f32 frames or patch embeddings)
    as (JAX's, the port's)."""
    if cfg.arch_type == "audio":
        arrays = {"frames": rng.standard_normal((b, t, cfg.d_model)).astype(np.float32),
                  "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
                  "mask": rng.random((b, t)) < 0.3}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
        if cfg.arch_type == "vlm":
            arrays["vision_embeds"] = rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _jax_model(arch):
    return j_build(dataclasses.replace(j_smoke(arch), dtype="float32"), remat="none")


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    jm = _jax_model(arch)
    jp, _ = jm.init(KEY)
    jb, tb = _batch(jm.cfg, 4, 40, np.random.default_rng(1))
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jnp.asarray(WEIGHTS)), has_aux=True))(jp)
    pm = Model(_f32(arch), remat="none")
    tl, tmet, tg = loss_and_grads(pm, convert.model_params(jp, "cpu"), tb,
                                  torch.from_numpy(WEIGHTS))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for k in ("loss", "per_example", "moe_aux"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-5, err_msg=k)
    assert set(tg) == set(jg)
    for k, g in jg.items():
        assert tg[k].dtype == torch.float32 and tuple(tg[k].shape) == g.shape, k
        _close_grad(tg[k], g, 1e-4, k)


def _ssd_recurrence(state, x, b, c, dt, a_heads):
    """The SSD chunk as its recurrence, step by step, in the inputs' dtype:
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t b_t^T, y_t = h_t c_t."""
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t] * a_heads)[..., None, None]                  # (B,H,1,1)
        state = decay * state + (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None]
        ys.append((state @ c[:, t, None, :, None])[..., 0])
    return state, torch.stack(ys, dim=1)


def test_ssd_chunk_gradient_where_exp_overflows():
    """A 64-step chunk with dt ~ 3: the upper triangle's exponent reaches
    ~190, past exp's f32 overflow.  The port's f32 gradients (with respect
    to the state, x, B, C, dt and the decay rates) are finite and equal the
    recurrence's in f64 (rtol 5e-4, atol 1e-5 of the largest entry: the
    cumulative sums reach |cum| ~ 190, where an f32 ulp is 2^-16, and 64
    adds may leave an exponent 64 half-ulps = 4.9e-4 off, the relative
    error of its decay weight); JAX's
    gradient is NaN there (0 * inf in its backward)."""
    rng = np.random.default_rng(3)
    b_, el, h, p, n = 2, 64, 3, 4, 8
    arrays = [rng.standard_normal((b_, h, p, n)), rng.standard_normal((b_, el, h, p)),
              rng.standard_normal((b_, el, n)), rng.standard_normal((b_, el, n)),
              rng.uniform(2.0, 4.0, (b_, el, h)), -rng.uniform(0.5, 1.5, (h,))]
    arrays = [a.astype(np.float32) for a in arrays]
    w_state, w_y = (rng.standard_normal(s).astype(np.float32) for s in ((b_, h, p, n),
                                                                         (b_, el, h, p)))
    cum = np.cumsum(arrays[4] * arrays[5], axis=1)
    assert float((cum[:, :, None] - cum[:, None]).max()) > 2 * EXP_OVERFLOW

    def grads(fn, dtype):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
        st, y = fn(leaves[0], tuple(leaves[1:5]), leaves[5])
        out = (st * torch.from_numpy(w_state).to(dtype)).sum() \
            + (y * torch.from_numpy(w_y).to(dtype)).sum()
        return torch.autograd.grad(out, leaves)

    got = grads(ssm._ssd_chunk, torch.float32)
    want = grads(lambda s, xs, a: _ssd_recurrence(s, *xs, a), torch.float64)
    for name, g, w in zip(("state", "x", "b", "c", "dt", "a"), got, want):
        assert bool(torch.isfinite(g).all()), name
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)

    def j_out(*leaves):
        st, y = j_ssm._ssd_chunk(leaves[0], tuple(leaves[1:5]), leaves[5])
        return jnp.sum(st * w_state) + jnp.sum(y * w_y)

    j_grads = jax.jit(jax.grad(j_out, argnums=tuple(range(6))))(*map(jnp.asarray, arrays))
    assert not all(bool(jnp.isfinite(g).all()) for g in j_grads)


@pytest.mark.parametrize("s", [1, 5, 64])
def test_linear_scan_gradients_match_jax(s):
    rng = np.random.default_rng(5)
    a = rng.uniform(0.0, 1.0, (2, s, 6)).astype(np.float32)
    b = rng.standard_normal((2, s, 6)).astype(np.float32)
    w = rng.standard_normal((2, s, 6)).astype(np.float32)

    def combine(lft, rgt):
        return lft[0] * rgt[0], lft[1] * rgt[0] + rgt[1]

    want = jax.jit(jax.grad(lambda a, b: jnp.sum(
        jax.lax.associative_scan(combine, (a, b), axis=1)[1] * w), argnums=(0, 1)))(
            jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (a, b))
    # at S = 1 the scan never reads a: its gradient is JAX's zeros
    got = torch.autograd.grad((rglru.linear_scan(ta, tb) * torch.from_numpy(w)).sum(), (ta, tb),
                              allow_unused=True, materialize_grads=True)
    for name, g, j in zip("ab", got, want):
        np.testing.assert_allclose(g.numpy(), _np(j), rtol=1e-5, atol=1e-6, err_msg=name)


def _hybrid_inputs():
    cfg = _f32("recurrentgemma-2b")
    params, _ = Model(cfg).init(torch.Generator().manual_seed(2), device="cpu")
    _, tb = _batch(cfg, 2, 40, np.random.default_rng(4))
    return cfg, params, tb


@pytest.mark.parametrize("attn_impl", [None, "kernel"])
def test_unrolled_layers_remat_is_bitwise(attn_impl):
    """The hybrid's unrolled layers run under the ``remat`` policy where a
    gradient is taken: the three policies give bitwise losses and
    gradients (the twin of ``tests/test_torch_train.py``'s
    ``test_remat_policies_are_bitwise`` for the layers JAX unrolls)."""
    cfg, params, batch = _hybrid_inputs()
    ref = None
    for remat in ("none", "full", "dots"):
        loss, met, g = loss_and_grads(Model(cfg, remat=remat, attn_impl=attn_impl), params,
                                      batch, torch.tensor([1.0, 0.5]))
        if ref is None:
            ref = (loss, met, g)
            continue
        assert torch.equal(loss, ref[0]) and torch.equal(met["per_example"], ref[1]["per_example"])
        for k in g:
            assert torch.equal(g[k], ref[2][k]), (remat, k)


def test_remat_recomputes_the_unrolled_layers(monkeypatch):
    """``"full"`` runs each rglru layer's forward again in the backward
    pass, ``"none"`` once; without a gradient, once."""
    calls = []
    plain = rglru.rglru_forward

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(rglru, "rglru_forward", counted)
    cfg, params, batch = _hybrid_inputs()
    n_rglru = sum(cfg.layer_kind(i) == "rglru" for i in range(cfg.n_layers))
    for remat, want in (("none", 1), ("full", 2)):
        calls.clear()
        loss_and_grads(Model(cfg, remat=remat), params, batch)
        assert len(calls) == want * n_rglru, remat
    calls.clear()
    Model(cfg, remat="full").loss(params, batch)
    assert len(calls) == n_rglru


def test_ssd_chunks_are_checkpointed(monkeypatch):
    """Under a gradient each SSD chunk runs twice (its forward, then the
    recompute in the backward pass) and gives bitwise the gradients of the
    chunks run without a checkpoint; without a gradient, once."""
    cfg = _f32("mamba2-1.3b")
    model = Model(cfg, remat="none")
    params, _ = model.init(torch.Generator().manual_seed(5), device="cpu")
    _, batch = _batch(cfg, 2, 80, np.random.default_rng(6))
    chunks = cfg.n_layers * -(-80 // cfg.ssm_chunk)
    calls = []
    plain = ssm._ssd_chunk

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(ssm, "_ssd_chunk", counted)
    loss, _, g = loss_and_grads(model, params, batch)
    assert len(calls) == 2 * chunks
    calls.clear()
    model.loss(params, batch)
    assert len(calls) == chunks
    monkeypatch.setattr(ssm, "checkpoint", lambda fn, *a, **k: fn(*a))
    calls.clear()
    loss2, _, g2 = loss_and_grads(model, params, batch)
    assert len(calls) == chunks and torch.equal(loss, loss2)
    for k in g:
        assert torch.equal(g[k], g2[k]), k


# ---------------------------------------------------------------------------
# make_fl_train_step against JAX, and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES + ["hubert-xlarge"])
def test_fl_train_step_matches_jax(arch):
    """Three rounds of the port's own state against JAX's: the discrete FL
    state bit for bit, the losses and FL floats at rtol 1e-5.  AdamW's
    state is held one round at a time: each round is also stepped from
    JAX's state before it and held to JAX's after it by ``adam_round_close``.
    Carried over rounds, AdamW's scale-free first steps move the entries
    whose gradient is rounding noise (|g| ~ 1e-6 of the tensor's largest)
    by other fractions of lr on each side, and on the hybrid the gradients
    those moves induce a round later pass the moments' rtol 1e-4 (by up to
    1.6x the tolerance, measured here on the CPU)."""
    fl_train_step_matches_jax(arch)


def fl_train_step_matches_jax(arch):
    """``test_fl_train_step_matches_jax``'s check on ``arch``'s smoke config."""
    jm = _jax_model(arch)
    jsched, jenv, jopt = JGLRCUCB(N_CH, N_CL, **SCHED), ENVS["piecewise"](), j_adamw(1e-3)
    jstate = j_make_init(jm, jopt, jsched, N_CL)(KEY)
    jstep = jax.jit(j_make_step(jm, jopt, jsched, jenv, N_CL))

    step = make_fl_train_step(Model(_f32(arch), remat="full"), adamw(1e-3),
                              GLRCUCB(N_CH, N_CL, **SCHED), convert.env(jenv, "cpu"), N_CL)
    state = convert.train_state(jstate, "cpu")
    rng = np.random.default_rng(7)
    tokens = synthetic_lm_batches(8, 24, jm.cfg.vocab_size, seed=4)
    for r in range(ROUNDS):
        jb, tb = _batch(jm.cfg, 8, 24, rng)
        if "tokens" in jb:
            toks = next(tokens)
            jb["tokens"], tb["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
        key = jax.random.fold_in(KEY, r)
        forced, _ = step(convert.train_state(jstate, "cpu"), tb, *_j_uniforms(key))
        jstate, jmet = jstep(jstate, jb, key)
        state, met = step(state, tb, *_j_uniforms(key))
        assert float(met["n_success"]) == float(jmet["n_success"]), r
        for k in ("loss", "mean_aoi", "aoi_var", "moe_aux"):
            np.testing.assert_allclose(_np(met[k]), _np(jmet[k]), rtol=1e-5,
                                       err_msg=f"round {r} {k}")
        _same_fl(state.fl, jstate.fl, r)
        assert int(state.opt_state["count"]) == int(jstate.opt_state["count"]) == r + 1
        _chip_smoke().adam_round_close(
            torch, forced.params, forced.opt_state, convert.model_params(jstate.params, "cpu"),
            convert.optimizer_state(jstate.opt_state, "cpu"),
            {k: torch.zeros(p.shape) for k, p in forced.params.items()}, 1e-3, f"round {r}")


@pytest.mark.parametrize("arch,name", [("mamba2-1.3b", "mamba2-smoke (ssm)"),
                                       ("recurrentgemma-2b", "recurrentgemma-smoke (hybrid)"),
                                       ("phi-3-vision-4.2b", "phi-3-vision-smoke (vlm)"),
                                       ("hubert-xlarge", "hubert-smoke (audio)")])
def test_train_launcher_on_the_cpu(capsys, arch, name):
    train_launcher_on_the_cpu(capsys, arch, name)


def train_launcher_on_the_cpu(capsys, arch, name):
    """Two rounds of ``launch/train.py``'s CLI on ``arch``'s smoke config on
    the CPU: its header names ``name``, each round a finite loss."""
    assert train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "4", "--seq", "32",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"[train] {name} — 4 clients, 8 channels, 2 rounds")
    rounds = [ln for ln in out.splitlines() if ln.startswith("  round")]
    assert len(rounds) == 2 and all("loss=" in ln and "nan" not in ln for ln in rounds)


@pytest.mark.parametrize("arch", FAMILIES + ["hubert-xlarge"])
def test_make_batch_builds_each_family(arch):
    """JAX's batch shapes and dtypes: bf16 frames, int32 labels and a bool
    mask for audio (no token stream), tokens and bf16 patch embeddings for
    a VLM, tokens alone otherwise."""
    cfg = get_smoke_config(arch)
    gen, dev = torch.Generator().manual_seed(0), torch.device("cpu")
    data = None if cfg.arch_type == "audio" else synthetic_lm_batches(4, 16, cfg.vocab_size)
    batch = train.make_batch(cfg, 4, 16, gen, dev, data)
    want = {"audio": {"frames": ((4, 16, cfg.d_model), torch.bfloat16),
                      "labels": ((4, 16), torch.int32), "mask": ((4, 16), torch.bool)},
            "vlm": {"tokens": ((4, 16), torch.int32),
                    "vision_embeds": ((4, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)},
            }.get(cfg.arch_type, {"tokens": ((4, 16), torch.int32)})
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == want
    if cfg.arch_type == "audio":
        assert int(batch["labels"].max()) < cfg.vocab_size and bool(batch["mask"].any())


def test_federated_llm_example_on_the_cpu(capsys, monkeypatch, tmp_path):
    """``examples/torch/federated_llm_train.py`` at its smallest size for two
    steps on the CPU, with a checkpoint; without CUDA and without
    ``--device`` it raises before printing."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch" / "federated_llm_train.py"
    spec = importlib.util.spec_from_file_location("federated_llm_train_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--steps", "2", "--seq", "32", "--device", "cpu",
                         "--ckpt", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("model: fed-qwen-15m (8.1M params), 4 FL clients over 8 channels")
    steps = [ln for ln in out.splitlines() if ln.startswith("  step")]
    assert len(steps) == 2 and all("loss=" in ln and "nan" not in ln for ln in steps)
    assert (tmp_path / "step_2.npz").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(["--steps", "1"])
    assert capsys.readouterr().out == ""


def test_donated_step_equals_the_functional_step():
    """``donate=True`` (the launcher's) writes the new parameters and AdamW
    moments into the given state's tensors, with the functional step's
    bits, over three rounds on recurrentgemma's smoke config in bf16 (the
    launcher's dtype); SGD, which has no in-place step, is refused."""
    donated_step_equals_the_functional_step("recurrentgemma-2b")


def donated_step_equals_the_functional_step(arch):
    """``test_donated_step_equals_the_functional_step``'s check on
    ``arch``'s smoke config."""
    from repro_torch.core.channels import make_stationary
    from repro_torch.launch.steps import make_train_state_init
    from repro_torch.optim import sgd
    from repro_torch.utils.tree import tree_map

    cfg = get_smoke_config(arch)
    model, opt = Model(cfg, remat="full"), adamw(1e-3)
    sched = GLRCUCB(N_CH, N_CL, history=16)
    env = make_stationary(torch.linspace(0.9, 0.4, N_CH), device="cpu")
    state0 = make_train_state_init(model, opt, sched, N_CL)(torch.Generator().manual_seed(3),
                                                           device="cpu")
    runs = {}
    for donate in (False, True):
        step = make_fl_train_step(model, opt, sched, env, N_CL, donate=donate)
        state = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state0)
        given = state
        tokens = synthetic_lm_batches(8, 24, cfg.vocab_size, seed=9)
        for r in range(3):
            u = torch.rand((2, N_CH), generator=torch.Generator().manual_seed(r))
            state, met = step(state, {"tokens": torch.from_numpy(next(tokens))}, u[0], u[1])
        runs[donate] = state, met, given
    (fs, fm, _), (ds, dm, given) = runs[False], runs[True]
    assert all(ds.params[k] is given.params[k] and ds.opt_state["mu"][k] is given.opt_state["mu"][k]
               for k in ds.params)
    assert int(ds.opt_state["count"]) == int(fs.opt_state["count"]) == 3
    # a bf16 norm gain of 1 stays 1 under steps of ~lr; the matrices move
    moved = [k for k in fs.params if not torch.equal(fs.params[k], state0.params[k])]
    assert "embed" in moved and len(moved) > len(fs.params) // 2
    for k in fs.params:
        assert torch.equal(ds.params[k], fs.params[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(ds.opt_state[m][k], fs.opt_state[m][k]), (m, k)
    assert all(torch.equal(dm[k], fm[k]) for k in fm)
    with pytest.raises(ValueError, match="step_"):
        make_fl_train_step(model, sgd(1e-3), sched, env, N_CL, donate=True)
