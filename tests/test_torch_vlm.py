"""Parity of the port's VLM input path (phi-3-vision) with the JAX package's.

phi-3-vision's smoke config (2 GQA layers, width 256, 8 heads, 16 patch
embeddings ahead of the tokens): JAX ``init`` -> ``convert.model_params``
-> the port, so both run the same weights, on the same ``vision_embeds``
(B, 16, 256) drawn with numpy.  The CLIP encoder is a stub in both
packages: the embeddings are cast to the token dtype and prepended.

Tolerances: f32 logits and losses rtol 1e-4 / atol 1e-5 (sums in another
order); bf16 logits within 3e-2 of the largest logit (the dense models'
rule, ``tests/test_torch_models.py``); decode against prefill rtol/atol
2e-3 (the JAX test's own); greedy tokens bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "phi-3-vision-4.2b"
KEY = jax.random.PRNGKey(0)
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A tiny model: one intra-op thread, so the test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _pair(dtype="float32"):
    """The JAX model, its parameters, the port's model and the same
    parameters converted (drawn once, in f32 under ``jit``, rounded to
    bf16 for the bf16 model)."""
    if dtype not in _PARAMS:
        if dtype == "float32":
            jm = j_build(dataclasses.replace(j_smoke(ARCH), dtype=dtype), remat="none")
            jp = jax.jit(lambda key: jm.init(key)[0])(KEY)
        else:
            jp = jax.tree.map(lambda a: a.astype(dtype), _pair()[1])
        _PARAMS[dtype] = jp, convert.model_params(jp, "cpu")
    jp, pp = _PARAMS[dtype]
    jm = j_build(dataclasses.replace(j_smoke(ARCH), dtype=dtype), remat="none")
    pm = build_model(dataclasses.replace(get_smoke_config(ARCH), dtype=dtype), remat="none")
    return jm, jp, pm, pp


def _batch(cfg, b, t, seed=0, dtype=np.float32, vision=True):
    """Tokens and (with ``vision``) patch embeddings drawn with numpy: the
    JAX batch and the port's."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if vision:
        emb = rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model)).astype(dtype)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(emb), torch.from_numpy(emb)
    return jb, tb


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.array(jnp.asarray(x, jnp.float32))


def test_converted_params_have_the_jax_layout():
    jm, jp, pm, pp = _pair(dtype="bfloat16")
    specs, jlogical = jm.param_specs()
    mine, logical = pm.param_specs()
    assert set(pp) == set(specs) == set(mine) and logical == jlogical
    for k, s in specs.items():
        assert tuple(pp[k].shape) == tuple(s.shape) == tuple(mine[k].shape), k
        assert pp[k].dtype == mine[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(pp[k].view(torch.int16).numpy(),
                                      np.array(jp[k]).view(np.int16), err_msg=k)


def test_full_config_has_the_jax_layout():
    from repro.configs import get_config as j_config

    jspecs, _ = j_build(j_config(ARCH)).param_specs()
    mine, _ = build_model(get_config(ARCH)).param_specs()
    assert set(mine) == set(jspecs)
    for k, s in jspecs.items():
        assert tuple(mine[k].shape) == tuple(s.shape) and mine[k].dtype == torch.bfloat16, k


@pytest.mark.parametrize("vision", [True, False])
@pytest.mark.parametrize("last_only", [False, True])
def test_apply_matches_jax_f32(vision, last_only):
    """With patch embeddings (16 + 24 positions) and without (the tokens
    alone, as JAX allows)."""
    jm, jp, pm, pp = _pair()
    jb, tb = _batch(pm.cfg, 2, 24, vision=vision)
    want, _ = jax.jit(jm.apply, static_argnames="last_only")(jp, jb, last_only=last_only)
    got, aux = pm.apply(pp, tb, last_only=last_only)
    s = 1 if last_only else 24 + 16 * vision
    assert got.shape == (2, s, pm.cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_apply_matches_jax_bf16():
    """bf16 weights, f32 patch embeddings cast to bf16 on the way in."""
    jm, jp, pm, pp = _pair(dtype="bfloat16")
    jb, tb = _batch(pm.cfg, 2, 24, seed=1)
    want = _np(jax.jit(jm.apply)(jp, jb)[0])
    got, _ = pm.apply(pp, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 40, pm.cfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_vision_embeds_reach_the_logits():
    """The embeddings are prepended: the token positions' logits depend on
    them, and the first position's logits are those of the first patch."""
    _, _, pm, pp = _pair()
    _, tb = _batch(pm.cfg, 1, 8, seed=2)
    base, _ = pm.apply(pp, tb)
    moved = dict(tb, vision_embeds=tb["vision_embeds"] + 1.0)
    other, _ = pm.apply(pp, moved)
    assert not torch.allclose(base[:, 16:], other[:, 16:])
    alone, _ = pm.apply(pp, {"tokens": tb["tokens"]})
    assert not torch.allclose(base[:, 16:], alone)


def test_prefill_step_matches_jax():
    jm, jp, pm, pp = _pair()
    jb, tb = _batch(pm.cfg, 3, 33, seed=3)
    want = jax.jit(j_steps.make_prefill_step(jm))(jp, jb)
    got = steps.make_prefill_step(pm)(pp, tb)
    assert got.shape == (3, 1, pm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_loss_matches_jax():
    """``Model.loss`` of a VLM predicts token t+1 from position 16 + t: its
    value, per-example losses and gradients equal JAX's, with example
    weights."""
    jm, jp, pm, pp = _pair()
    jb, tb = _batch(pm.cfg, 4, 20, seed=4)
    weights = np.array([0.0, 1.5, 0.0, 0.5], np.float32)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jnp.asarray(weights)), has_aux=True))(jp)
    tl, tmet, tg = loss_and_grads(pm, pp, tb, torch.from_numpy(weights))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4)
    for k in ("loss", "per_example"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-4, err_msg=k)
    assert set(tg) == set(jg)
    for k, g in jg.items():
        want = _np(g)
        np.testing.assert_allclose(_np(tg[k]), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)
    # without the offset the loss would read the patch positions: it differs
    plain = dataclasses.replace(pm.cfg, arch_type="dense")
    other, _ = build_model(plain, remat="none").loss(pp, tb)
    assert abs(float(other) - float(tl)) > 1e-3


def test_decode_steps_match_jax_and_prefill():
    """Decode takes tokens only, as in JAX: 12 steps equal JAX's decode and
    the port's own prefill of the tokens (rtol/atol 2e-3)."""
    jm, jp, pm, pp = _pair()
    jb, tb = _batch(pm.cfg, 2, 12, seed=5, vision=False)
    full, _ = pm.apply(pp, tb)
    jcache = jm.init_cache(2, 12, dtype=jnp.float32)
    cache = pm.init_cache(2, 12, dtype=torch.float32, device="cpu")
    jdecode = jax.jit(jm.decode_step)
    toks = np.array(jb["tokens"])
    for t in range(12):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t]))
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), _np(jl), **F32)
        torch.testing.assert_close(lg, full[:, t], rtol=2e-3, atol=2e-3)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["blocks"][name].numpy(), _np(jcache["blocks"][name]),
                                   **F32)


def test_serve_cli_serves_phi_3_vision_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[serve] phi-3-vision-smoke: 3 tokens x 8 seqs in ")
    assert "tok/s" in out and out.rstrip().endswith("cache pos=3")
