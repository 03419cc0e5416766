"""Parity of the port's ``flash_attention`` and ``attn_core`` with the JAX package's.

On the CPU the port's ``ops.flash_attention`` is its plain version
(``ref.mha_attention``).  It is held against JAX's Pallas kernel in
interpret mode (``repro.kernels.ops.flash_attention``) at the JAX tests'
tolerance, rtol/atol 2e-3 in f32 and 3e-2 in bf16 (another algorithm: an
online softmax over tiles), and against JAX's own oracle at rtol 1e-5 (the
same arithmetic).  ``attn_core``'s chunked plain path is held against JAX's
XLA path at rtol 1e-5 / atol 1e-6.  Gradients through the kernel route's
``autograd.Function`` (plain forward, chunked-path recompute backward)
are held against JAX's ``REPRO_ATTN_IMPL=flash`` gradients (Pallas forward,
XLA recompute backward) at JAX's own test tolerance, rtol 1e-3 / atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import attn_core as j_attn_core  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.attention import attn_core  # noqa: E402

# tests/test_kernels.py:155-159
JAX_SHAPES = [
    (1, 2, 2, 128, 64, True, 0),
    (2, 4, 2, 257, 72, True, 0),
    (1, 4, 1, 200, 128, False, 0),
    (1, 2, 2, 300, 64, True, 64),
    (2, 8, 4, 64, 96, True, 16),
]
# head dims past 128, which the card's tensor-core route takes with 64-key tiles:
# recurrentgemma's D = 256 with one KV head and a window, and D = 200 padded to 256
WIDE_SHAPES = [
    (1, 4, 1, 300, 256, True, 128),
    (1, 4, 2, 257, 200, True, 0),
]


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, s, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", JAX_SHAPES + WIDE_SHAPES)
def test_flash_attention_matches_jax(b, hq, hkv, s, d, causal, window):
    q, k, v = _qkv(b, hq, hkv, s, d, seed=s * d)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window).numpy()
    kernel = np.array(jops.flash_attention(*_j(q, k, v), causal=causal, window=window))
    np.testing.assert_allclose(got, kernel, rtol=2e-3, atol=2e-3)
    oracle = np.array(jref.mha_attention(*_j(q, k, v), causal=causal, window=window))
    mine = ref.mha_attention(*_t(q, k, v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(mine, oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, mine)


def test_flash_attention_bf16_matches_jax():
    q, k, v = _qkv(1, 2, 2, 128, 64, seed=7)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (qb, kb, vb))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    kernel = np.array(jops.flash_attention(qb, kb, vb).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), kernel, rtol=3e-2, atol=3e-2)
    # the same f32 arithmetic, one rounding to bf16 at the end: within one bf16 ulp
    oracle = np.array(jref.mha_attention(qb, kb, vb).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), oracle, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("chunk", [64, 100, 128, 200])
def test_attn_core_chunks_match_jax(chunk):
    q, k, v = _qkv(1, 4, 2, 200, 32, seed=1)
    q, k = q * 0.8, k * 0.8
    got = attn_core(*_t(q, k, v), causal=True, chunk=chunk).numpy()
    want = np.array(j_attn_core(*_j(q, k, v), causal=True, chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    whole = attn_core(*_t(q, k, v), causal=True, chunk=200).numpy()
    np.testing.assert_allclose(got, whole, rtol=1e-4, atol=1e-5)    # chunk invariance


@pytest.mark.parametrize("window", [8, 64])
def test_attn_core_window_matches_jax(window):
    q, k, v = _qkv(1, 2, 2, 64, 32, seed=2)
    got = attn_core(*_t(q, k, v), causal=True, window=window, chunk=16).numpy()
    want = np.array(j_attn_core(*_j(q, k, v), causal=True, window=window, chunk=16))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    full = attn_core(*_t(q, k, v), causal=True).numpy()
    if window == 64:                                  # as wide as the sequence
        np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(got - full).max() > 1e-3         # the window bites


def test_kernel_route_forward_equals_plain_route():
    q, k, v = _qkv(2, 8, 2, 300, 64, seed=3)
    a = attn_core(*_t(q, k, v), causal=True, window=40, impl="kernel")
    b = attn_core(*_t(q, k, v), causal=True, window=40, impl="plain", chunk=128)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_kernel_route_grads_match_jax(monkeypatch):
    """The twin of tests/test_attention_variants.py::test_flash_routing_matches_xla_incl_grads."""
    q, k, v = _qkv(1, 4, 2, 300, 64, seed=4)
    q, k = q * 0.6, k * 0.6

    def f(q_, k_, v_):
        return jnp.sum(j_attn_core(q_, k_, v_, causal=True) ** 2)

    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    y_j, g_j = jax.value_and_grad(f, argnums=(0, 1, 2))(*_j(q, k, v))

    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    y = (attn_core(tq, tk, tv, causal=True, impl="kernel") ** 2).sum()
    grads = torch.autograd.grad(y, (tq, tk, tv))
    np.testing.assert_allclose(float(y.detach()), float(y_j), rtol=1e-4)
    for g, gj in zip(grads, g_j):
        np.testing.assert_allclose(g.numpy(), np.array(gj), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", JAX_SHAPES + WIDE_SHAPES)
def test_kernel_route_grads_match_jax_at_every_shape(monkeypatch, b, hq, hkv, s, d, causal,
                                                     window):
    """``test_kernel_route_grads_match_jax`` at every parity shape (causal,
    non-causal, a window, GQA, MQA, the D and S tails): the port's kernel
    route takes its gradient through ``ref.mha_attention_bwd`` (the backward
    kernels' plain version, from the forward's logsumexp), JAX's through the
    XLA recompute of its ``custom_vjp``; rtol 1e-3 / atol 1e-4."""
    q, k, v = _qkv(b, hq, hkv, s, d, seed=s * d + 1)
    q, k = q * 0.6, k * 0.6

    def f(q_, k_, v_):
        return jnp.sum(j_attn_core(q_, k_, v_, causal=causal, window=window) ** 2)

    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    y_j, g_j = jax.value_and_grad(f, argnums=(0, 1, 2))(*_j(q, k, v))

    calls = []
    bwd = ref.mha_attention_bwd
    monkeypatch.setattr(ref, "mha_attention_bwd", lambda *a, **kw: calls.append(1) or bwd(*a, **kw))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    y = (attn_core(tq, tk, tv, causal=causal, window=window, impl="kernel") ** 2).sum()
    grads = torch.autograd.grad(y, (tq, tk, tv))
    assert calls == [1]
    np.testing.assert_allclose(float(y.detach()), float(y_j), rtol=1e-4)
    for g, gj in zip(grads, g_j):
        np.testing.assert_allclose(g.numpy(), np.array(gj), rtol=1e-3, atol=1e-4)
