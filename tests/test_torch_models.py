"""Parity of the port's dense GQA decoders with the JAX package's model zoo.

The three dense smoke configs (qwen3 with qk-norm and head_dim 32, qwen2.5
with QKV bias, qwen1.5 with tied embeddings; 2 layers, width 256): JAX
``init`` -> ``convert.model_params`` -> the port, so both run the same
weights.  On the CPU the port's attention is the chunked plain path and
JAX's the XLA path.  Tolerances: f32 logits rtol 1e-4 / atol 1e-5 (sums in
another order); bf16 logits within 3e-2 of the largest logit (both round
each product and norm to bf16, and a one-ulp difference early on carries
through the layers: about 2.5 bf16 ulps at the top of the range);
decode against prefill rtol/atol 2e-3 (the JAX test's own); greedy tokens
bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ["qwen3-32b", "qwen2.5-32b", "qwen1.5-0.5b"]
KEY = jax.random.PRNGKey(0)


def _pair(arch, dtype="float32", **over):
    """The JAX model, its parameters, the port's model and the same
    parameters converted."""
    jm = j_build(dataclasses.replace(j_smoke(arch), dtype=dtype, **over), remat="none")
    jp, _ = jm.init(KEY)
    pm = build_model(dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over))
    return jm, jp, pm, convert.model_params(jp, "cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_have_the_jax_layout(arch):
    jm, jp, pm, pp = _pair(arch, dtype="bfloat16")
    specs, _ = jm.param_specs()
    mine, _ = pm.param_specs()
    assert set(pp) == set(specs) == set(mine)
    for k, s in specs.items():
        assert tuple(pp[k].shape) == tuple(s.shape) == tuple(mine[k].shape), k
        assert pp[k].dtype == mine[k].dtype == torch.bfloat16, k
        assert str(s.dtype) == "bfloat16", k
        np.testing.assert_array_equal(pp[k].view(torch.int16).numpy(),
                                      np.array(jp[k]).view(np.int16), err_msg=k)


def test_convert_carries_bf16_bit_for_bit():
    vals = np.array([0.0, -0.0, 1.0, -2.5, 3.0e38, 1.0e-40, np.inf, -np.inf, np.nan,
                     0.1, 65504.0, -1.0e-3], np.float32)
    src = {"a/w": jnp.asarray(vals, jnp.bfloat16),
           "b/w": jax.random.normal(KEY, (64, 48), jnp.bfloat16),
           "c/f32": jax.random.normal(KEY, (5,), jnp.float32),
           "d/i32": jnp.arange(4, dtype=jnp.int32)}
    got = convert.model_params(src, "cpu")
    for k, v in src.items():
        want = np.array(v)
        assert str(got[k].dtype).split(".")[-1] == str(want.dtype), k
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    assert convert.tensor(src["b/w"], "cpu").dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("last_only", [False, True])
def test_apply_matches_jax_f32(arch, last_only):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (2, 40))
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, last_only=last_only)
    got, aux = pm.apply(pp, {"tokens": torch.from_numpy(toks)}, last_only=last_only)
    assert got.shape == (2, 1 if last_only else 40, pm.cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax_bf16(arch):
    jm, jp, pm, pp = _pair(arch, dtype="bfloat16")
    toks = _tokens(pm.cfg, (2, 40), seed=1)
    want = _np(jm.apply(jp, {"tokens": jnp.asarray(toks)})[0])
    got, _ = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (2, 3), seed=2)
    jcache = jm.init_cache(2, 16, dtype=jnp.float32)
    cache = pm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    for t in range(3):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]))
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), _np(jl), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), np.array(jnp.argmax(jl, -1)))
    assert int(cache["pos"]) == int(jcache["pos"]) == 3
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["blocks"][name].numpy(), _np(jcache["blocks"][name]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_f32(arch):
    """The twin of tests/test_arch_smoke.py::test_decode_matches_prefill_f32."""
    _, _, pm, pp = _pair(arch)
    toks = torch.from_numpy(_tokens(pm.cfg, (1, 12), seed=3))
    full, _ = pm.apply(pp, {"tokens": toks})
    cache = pm.init_cache(1, 12, dtype=torch.float32, device="cpu")
    for t in range(12):
        lg, cache = pm.decode_step(pp, cache, toks[:, t])
        torch.testing.assert_close(lg, full[:, t], rtol=2e-3, atol=2e-3)


def test_ring_cache_decode_matches_windowed_prefill_and_jax():
    """A ring cache of 8 slots over 12 steps (it wraps at step 8) equals a
    prefill whose attention window is 8, and JAX's ring decode."""
    jm, jp, pm, pp = _pair("qwen3-32b", local_attn_window=8)
    toks = _tokens(pm.cfg, (1, 12), seed=4)
    full, _ = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    cache = pm.init_cache(1, 12, window=8, dtype=torch.float32, device="cpu")
    jcache = jm.init_cache(1, 12, window=8, dtype=jnp.float32)
    assert cache["blocks"]["k"].shape[3] == 8
    for t in range(12):
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]), window=8)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]), window=8)
        torch.testing.assert_close(lg, full[:, t], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(lg.numpy(), _np(jl), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_follows_the_init_rule(arch):
    """The port draws its own weights (equal to JAX's in distribution only):
    every path has JAX's shape and dtype, and each draw's std is the init
    rule's within 5 % (at least 4096 draws a tensor)."""
    pm = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    params, specs = pm.init(torch.Generator().manual_seed(0), device="cpu")
    jspecs, _ = j_build(dataclasses.replace(j_smoke(arch), dtype="float32")).param_specs()
    assert set(params) == set(jspecs) == set(specs)
    for k, p in params.items():
        assert tuple(p.shape) == tuple(jspecs[k].shape) and p.dtype == torch.float32, k
        leaf = k.rsplit("/", 1)[-1]
        if "norm" in leaf:
            assert bool((p == 1).all()), k
        elif leaf in ("bq", "bk", "bv"):
            assert not bool(p.any()), k
        else:
            std = 0.02 if k == "embed" else 1.0 / np.sqrt(p.shape[-2])
            assert p.numel() >= 4096, k
            assert abs(float(p.std()) / std - 1.0) < 0.05, (k, float(p.std()), std)
            assert abs(float(p.mean())) < 0.05 * std, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    """rms_norm, apply_rope (pairs (2i, 2i+1), f32 angles), swiglu and the
    GELU MLP against their JAX twins; f32 at rtol 1e-5 / atol 1e-6, bf16
    within one bf16 ulp of the output (2**-7 relative)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(6)
    jdt, tdt = jnp.dtype(dtype), tl.torch_dtype(dtype)
    x = rng.standard_normal((2, 3, 10, 32)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    w = [(rng.standard_normal(s) / 6).astype(np.float32)
         for s in ((32, 48), (32, 48), (48, 32), (48,), (32,))]
    pos = np.arange(10, dtype=np.int32) * 97

    def pair(a):
        j = jnp.asarray(a, jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    (jx, tx), (jg, tg) = pair(x), pair(g)
    jw, tw = zip(*(pair(a) for a in w))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    cases = [
        (jl.rms_norm(jx, jg), tl.rms_norm(tx, tg)),
        (jl.apply_rope(jx, jnp.asarray(pos), 1e6), tl.apply_rope(tx, torch.from_numpy(pos), 1e6)),
        (jl.swiglu(jx, *jw[:3]), tl.swiglu(tx, *tw[:3])),
        (jl.gelu_mlp(jx, jw[0], jw[3], jw[2], jw[4]), tl.gelu_mlp(tx, tw[0], tw[3], tw[2], tw[4])),
    ]
    for want, got in cases:
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)
