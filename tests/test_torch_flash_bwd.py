"""The backward of the port's ``flash_attention`` on the CPU.

``ref.mha_attention_bwd`` (the plain version of the backward kernels of
``csrc/flash_attention_bwd.cu``) computes the FlashAttention-2 backward
from the forward's output and row logsumexp.  In f64 it is held against
autograd through the plain chunked path (``_attn_core_plain``, the
recompute the card keeps for f32) at rtol 1e-10, and the logsumexp
``ref.mha_attention(return_lse=True)`` gives against ``torch.logsumexp``
of the masked, scaled logits.  The model's kernel route takes its gradient
through it on the CPU, and never through the chunked recompute; the cost
the dry run counts for a backward call gives the bounds of the kernel
table.  The card's own checks are in ``tests/test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402

# tests/test_torch_flash_attention.py's JAX_SHAPES + WIDE_SHAPES, and a non-causal window
SHAPES = [
    (1, 2, 2, 128, 64, True, 0),
    (2, 4, 2, 257, 72, True, 0),
    (1, 4, 1, 200, 128, False, 0),
    (1, 2, 2, 300, 64, True, 64),
    (2, 8, 4, 64, 96, True, 16),
    (1, 4, 1, 300, 256, True, 128),
    (1, 4, 2, 257, 200, True, 0),
    (1, 4, 2, 150, 32, False, 40),
]


def _inputs(b, hq, hkv, s, d, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: torch.from_numpy(rng.standard_normal(shape) * sd).to(dtype)
    return (f(b, hq, s, d, sd=0.5), f(b, hkv, s, d, sd=0.5), f(b, hkv, s, d),
            f(b, hq, s, d))


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", SHAPES)
def test_plain_backward_equals_autograd_of_the_chunked_path_in_f64(b, hq, hkv, s, d, causal,
                                                                   window):
    q, k, v, do = _inputs(b, hq, hkv, s, d, seed=s + d)
    scale = 1.0 / math.sqrt(d)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn_mod._attn_core_plain(*leaves, causal, window, scale, 64)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = ref.mha_attention(q, k, v, causal=causal, window=window, return_lse=True)
    torch.testing.assert_close(o, out.detach(), rtol=1e-10, atol=1e-12)
    got = ref.mha_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", SHAPES)
def test_logsumexp_is_that_of_the_masked_scaled_logits(b, hq, hkv, s, d, causal, window):
    q, k, v, _ = _inputs(b, hq, hkv, s, d, seed=2 * s + d, dtype=torch.float32)
    scale = 0.7 / math.sqrt(d)
    _, lse = ref.mha_attention(q, k, v, causal=causal, window=window, scale=scale,
                               return_lse=True)
    kx = k.repeat_interleave(hq // hkv, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kx) * scale
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    want = torch.logsumexp(logits.masked_fill(~mask, -math.inf), dim=-1)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    out, lse2 = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                    return_lse=True)
    assert torch.equal(lse2, lse)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal, window=window,
                                                scale=scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_is_the_plain_version(dtype):
    """``ops.flash_attention_bwd`` on CPU tensors is ``ref.mha_attention_bwd``
    bit for bit, its gradients in the inputs' dtypes."""
    q, k, v, do = _inputs(1, 4, 2, 70, 32, seed=3, dtype=dtype)
    out, lse = ops.flash_attention(q, k, v, causal=True, window=20, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=True, window=20)
    want = ref.mha_attention_bwd(q, k, v, out, lse, do, causal=True, window=20)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32), (torch.bfloat16, 64),
                                     (torch.bfloat16, 36)])
def test_kernel_route_backward_never_recomputes_on_the_cpu(monkeypatch, dtype, d):
    """The model's kernel route on CPU tensors saves the forward's
    logsumexp and takes its gradient through the backward's plain version,
    whatever the dtype and D: never through the chunked recompute."""
    monkeypatch.setattr(attn_mod, "_attn_core_plain",
                        lambda *a, **k: pytest.fail("reached the chunked recompute"))
    calls = []
    bwd = ref.mha_attention_bwd
    monkeypatch.setattr(ref, "mha_attention_bwd", lambda *a, **kw: calls.append(1) or bwd(*a, **kw))
    q, k, v, do = _inputs(1, 4, 2, 40, d, seed=4, dtype=dtype)
    before = attn_mod._KernelAttention.plain_backward_calls
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = attn_mod.attn_core(*leaves, causal=True, impl="kernel")
    grads = torch.autograd.grad(out, leaves, do)
    assert calls == [1] and attn_mod._KernelAttention.plain_backward_calls == before
    assert [g.dtype for g in grads] == [dtype] * 3
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def test_kernel_backward_route_is_picked_from_device_dtype_and_head_dim():
    """On the card the backward kernels take exactly what the tensor-core
    forward takes; every CPU and meta call takes the backward's plain
    version or meta route."""
    class Fake:
        is_cuda = True

        def __init__(self, dtype, d):
            self.dtype, self.shape = dtype, (1, 2, 3, d)

    for d in range(1, 257):
        for dtype in (torch.float32, torch.bfloat16):
            assert attn_mod.kernel_backward(Fake(dtype, d)) == fa_mod.tc_route(dtype, d)
    for device in ("cpu", "meta"):
        for dtype, d in ((torch.float32, 64), (torch.bfloat16, 36)):
            assert attn_mod.kernel_backward(torch.empty((1, 2, 3, d), dtype=dtype, device=device))


@pytest.mark.parametrize("shape,causal,window,bound_ms", [
    ((8, 16, 16, 2048, 64), True, 0, 0.1738),      # qwen1.5-0.5b
    ((8, 16, 16, 2048, 80), False, 0, 0.4343),     # hubert-xlarge
    ((8, 10, 1, 2048, 256), True, 2048, 0.4345),   # recurrentgemma-2b
    ((8, 32, 32, 2192, 96), True, 0, 0.5973),      # phi-3-vision-4.2b
    ((8, 48, 8, 2048, 128), True, 0, 1.0428),      # dbrx-132b
])
def test_backward_cost_gives_the_kernel_tables_bounds(shape, causal, window, bound_ms):
    """10 D flops a visible pair a query head at 989 TFLOP/s: the training
    shapes' backward is bound by operations."""
    c = fa_mod.cost_bwd(shape, causal, window, torch.bfloat16)
    b, hq, hkv, s, d = shape
    assert c.ops == 10 * b * hq * d * fa_mod.pairs(s, causal, window)
    assert c.nbytes == (4 * b * hq + 4 * b * hkv) * s * d * 2 + 3 * b * hq * s * 4
    assert (round(c.bound_ms, 4), c.bound_by) == (bound_ms, "operations")


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_the_cost_walker_counts_the_backward_kernel(device):
    """A gradient through the model's kernel route, traced by the dry run's
    walker on meta tensors (its meta route) or on CPU tensors (its plain
    version, uncounted inside), is one backward launch with
    ``cost_bwd``'s FLOPs and bytes beside the forward's one launch, which
    wrote the logsumexp."""
    from repro_torch.utils import cost

    shape = (1, 4, 2, 64, 32)
    b, hq, hkv, s, d = shape
    make = lambda h: torch.randn((b, h, s, d), dtype=torch.bfloat16).to(device)
    q, k, v, do = make(hq), make(hkv), make(hkv), make(hq)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]

    def step():
        out = attn_mod.attn_core(*leaves, causal=True, window=16, impl="kernel")
        return torch.autograd.grad(out, leaves, do)

    tr = cost.trace(step)
    assert tr.kernel_launches == {"flash_attention": 1, "flash_attention_bwd": 1}
    want = fa_mod.cost_bwd(shape, True, 16, torch.bfloat16)
    got = tr.kernel_cost["flash_attention_bwd"]
    assert (got.flops, got.bytes) == (want.ops, want.nbytes)
    fwd = fa_mod.cost(shape, True, 16, torch.bfloat16, lse=True)
    assert tr.kernel_cost["flash_attention"].bytes == fwd.nbytes
    assert [tuple(g.shape) for g in tr.result] == [tuple(t.shape) for t in (q, k, v)]


@pytest.mark.parametrize("s,s_pad", [(1, 64), (64, 64), (65, 128), (2192, 2240)])
def test_backward_scratch_pads_rows_to_the_streamed_tile(s, s_pad):
    """The backward kernels' f32 scratch holds each query row's lse log2(e)
    and Delta, (2, B Hq, S_pad) with S_pad a multiple of the 64-row tile
    the dK/dV kernel fetches them by; the meta route allocates the same
    before its outputs and frees it on return."""
    q = torch.empty((2, 3, s, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 1, s, 16), dtype=torch.bfloat16, device="meta")
    scratch = fa_mod._bwd_scratch(q)
    assert tuple(scratch.shape) == (2, 6, s_pad) and scratch.dtype == torch.float32
    assert s_pad % fa_mod._BWD_TILE == 0 and s_pad - s < fa_mod._BWD_TILE
    grads = fa_mod.meta_bwd(q, k, k)
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape), tuple(k.shape), tuple(k.shape)]
    assert all(g.dtype == torch.bfloat16 for g in grads)
