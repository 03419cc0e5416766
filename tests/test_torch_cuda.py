"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels
are compiled by ``nvcc`` for sm_90a at first use).  On the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the carried prefix state is bitwise for {0, 1} rewards; the
GLR statistic goes through CUDA's ``logf``, rtol 1e-5; the aggregation sums
the same rounded products in row order, rtol 1e-5 / atol 1e-6 against the
plain version (whose ``sum`` may take another order) and bitwise against a
row-order sum ``acc = acc + scale[r] * x[r]`` (every load width, row
chunk and base alignment).  The coordinate median sums at most two kept
values: bitwise, NaN, +-inf and +-0 rows included.  The trimmed mean
adds the kept values in row order like the plain version; it is held to
|kernel - plain| <= M * 2**-24 * max|x| (any summation order of at most M
kept values, divided by their count).  ``glr_scan`` is bitwise on {0, 1}
histories (exact integer prefixes, the same split term as ``glr_step``);
on real-valued ones its block scan adds in another order than
``torch.cumsum``, so each prefix and the window total are rounded once from
an f64 sum and the statistic must land inside ``ref.glr_scan_bounds``, the
split term's derived forward error around the exact value.  ``flash_attention`` in f32 is held to its
f32 plain version at rtol/atol 1e-4 (another order of the D-term sums and
an online softmax: a few ulps of logits of size ~10, carried through exp);
in bf16 to the plain version on the same inputs in f32, at rtol 2**-8 (the
output's one rounding to bf16 is at most 2**-9 relative) and atol 1e-4;
bf16 with D % 8 == 0 and D <= 128 must take the tensor-core route (which
splits P into two bf16 terms to stay inside that tolerance), every other
call the FMA route.  ``regret_scan`` (a whole regret-harness run in one
launch) equals the per-round route with the plain detector bit for bit in
schedule, restarts, regret, AoI, success rate and final state; the
variance sums at rtol 1e-6 (the kernel adds the M squared deviations in
another order than torch's reduction).  A batch of runs in one launch (one
block a run; env, uniforms and hyper-parameters per run or shared) equals
the B single-run launches bit for bit, variance sums included, and a batch
the kernel refuses takes the batched per-round route and says so.  ``glr_step_tenants`` (the
scheduler service's detector step, in place on the slot state) is held to
``ref.glr_step_tenants`` as ``glr_step`` is to its plain version, rows not
live untouched; a served trace on the card equals the CPU server bit for
bit, and a serve step makes no host sync.  The baseline policies' runs on
the per-round route equal the CPU runs bit for bit (a draw through
``log``/``exp`` may fork only at a near-tie within 1e-5 relative), and the
mean AoI is the correctly rounded f32 quotient on both devices.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.aggregation import make_aggregator  # noqa: E402
from repro_torch.core.bandits import GLRCUCB, MExp3  # noqa: E402
from repro_torch.core.bandits.base import stack_params  # noqa: E402
from repro_torch.core.channels import (  # noqa: E402
    make_piecewise,
    make_stationary,
    stack_envs,
    table_env,
)
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.sim import simulate_aoi_regret_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, tc_route  # noqa: E402
from repro_torch.kernels.glr_scan import glr_scan  # noqa: E402
from repro_torch.kernels.glr_step import glr_step  # noqa: E402
from repro_torch.kernels.regret_scan import regret_scan  # noqa: E402
from repro_torch.kernels.robust_agg import robust_trimmed  # noqa: E402
from repro_torch.kernels.weighted_aggregate import weighted_aggregate  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    h, rows = shape[-1], shape[:-1]
    counts = rng.integers(0, 3 * h, rows).astype(np.float32)
    cum = rng.integers(0, 2 * h, shape).astype(np.float32)
    total = rng.integers(0, 3 * h, rows).astype(np.float32)
    base = rng.integers(0, h, rows).astype(np.float32)
    r_vec = rng.integers(0, 2, rows).astype(np.float32)
    sched = rng.random(rows) < 0.7
    return [torch.from_numpy(a) for a in (cum, total, base, counts, r_vec, sched)]


@pytest.mark.parametrize("shape", [(5, 64), (30, 256), (7, 1000), (4, 3, 40)])
@pytest.mark.parametrize("split_grid", ["all", "geometric"])
def test_glr_step_kernel_matches_plain(cuda, shape, split_grid):
    args = _inputs(shape, sum(shape))
    before = glr_step.launches
    got = [g.cpu() for g in ops.glr_step(*(a.to(cuda) for a in args), split_grid=split_grid)]
    assert glr_step.launches == before + 1
    want = ops.glr_step(*args, split_grid=split_grid)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert torch.equal(torch.isneginf(got[3]), torch.isneginf(want[3]))
    fin = torch.isfinite(want[3])
    torch.testing.assert_close(got[3][fin], want[3][fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,p", [(20, 5674), (8, 4096), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_aggregate_kernel_matches_plain(cuda, m, p, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m * p)
    upd = torch.randn((m, p), generator=gen, device=cuda).to(dtype)
    scale = torch.rand((m,), generator=gen, device=cuda) / m
    before = weighted_aggregate.launches
    got = ops.weighted_aggregate(upd, scale)
    assert weighted_aggregate.launches == before + 1
    torch.testing.assert_close(got, ref.weighted_aggregate(upd, scale), rtol=1e-5, atol=1e-6)


def test_card_fused_path_equals_cpu_split_path(cuda):
    """The detector on the card (fused kernel path) and on the CPU (split
    plain path) give equal states over 300 {0, 1} updates."""
    n, m = 6, 3
    sched = GLRCUCB(n, m, history=32, detector_stride=3, min_samples=4, delta=0.05)
    rng = np.random.default_rng(4)
    mu0 = rng.random(n)
    states = {"cpu": sched.init("cpu"), "cuda": sched.init(cuda)}
    for t in range(300):
        mu = (mu0, 1.0 - mu0, mu0)[min(t // 100, 2)]
        ch = rng.permutation(n)[:m]
        rw = (rng.random(m) < mu[ch]).astype(np.float32)
        for dev in states:
            states[dev] = sched.update(states[dev], t, torch.from_numpy(ch).to(dev),
                                       torch.from_numpy(rw).to(dev), None)
    a, b = states["cuda"], states["cpu"]
    assert int(b.restarts) > 0
    for f in ("counts", "cum", "total", "base", "tau", "restarts"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    torch.testing.assert_close(a.mu_tilde.cpu(), b.mu_tilde, rtol=1e-6, atol=0)


def _trim_inputs(m, p, mask_kind, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.round(torch.randn((m, p), generator=gen, device=device) * 3.0) / 2.0).to(dtype)
    if mask_kind == "empty":
        mask = torch.zeros(m, device=device)
    elif mask_kind == "full":
        mask = torch.ones(m, device=device)
    else:
        mask = (torch.rand(m, generator=gen, device=device) < 0.6).to(torch.float32)
    return x, mask


@pytest.mark.parametrize("m,p", [(20, 5674), (64, 4099), (3, 1), (1, 300)])
@pytest.mark.parametrize("mask_kind", ["random", "full", "empty"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_robust_trimmed_kernel_matches_plain(cuda, m, p, mask_kind, dtype):
    x, mask = _trim_inputs(m, p, mask_kind, dtype, cuda, seed=m * p)
    n = mask.sum()
    n_int = int(n)
    bound = m * 2.0 ** -24 * float(x.float().abs().max())
    for k in sorted({0, max(n_int - 1, 0) // 4, max(n_int - 1, 0) // 2}):
        kt = torch.tensor(float(k), device=cuda)
        before = robust_trimmed.launches
        got = ops.robust_trimmed(x, mask, n, kt)
        assert robust_trimmed.launches == before + 1
        want = ref.robust_trimmed(x, mask, n, kt)
        if k == max(n_int - 1, 0) // 2:                 # the median
            assert torch.equal(got, want), k
        else:
            assert float((got - want).abs().max()) <= bound, k
        if n_int == 0:
            assert not bool(got.any())


_WA_M = (1, 8, 9, 16, 17, 32, 33, 64)            # both sides of the kernel's 16-row chunk edges


def _row_order_sum(upd, scale):
    acc = torch.zeros(upd.shape[1], device=upd.device)
    for r in range(upd.shape[0]):
        acc = acc + scale[r] * upd[r].float()
    return acc


@pytest.mark.parametrize("p", [5674, 2**20 + 2, 4096, 1, 3])
@pytest.mark.parametrize("m", _WA_M)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_aggregate_equals_row_order_sum(cuda, p, m, offset, dtype):
    """Bitwise against the row-order sum at every load width (P % 4 == 0,
    P even, P odd), on both sides of each 16-row chunk's edge, with a base
    pointer 16-byte aligned and one element past it (a contiguous view)."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + p)
    buf = torch.randn(m * p + offset, generator=gen, device=cuda).to(dtype)
    upd = buf[offset:].view(m, p)
    assert upd.is_contiguous() and (upd.data_ptr() % 16 == 0) == (offset == 0)
    scale = torch.rand((m,), generator=gen, device=cuda) * 2.0 - 0.5
    before = weighted_aggregate.launches
    got = ops.weighted_aggregate(upd, scale)
    assert weighted_aggregate.launches == before + 1
    assert torch.equal(got, _row_order_sum(upd, scale))


_TRIM_M = (1, 2, 8, 9, 16, 17, 32, 33, 63, 64)
_SPECIAL = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1.0, -1.0, 0.5, 0.5, 2.5)


def _special_inputs(m, p, mask_kind, dtype, device, seed):
    """Values drawn from NaN, +-inf, +-0 and ties; each row holds every one
    of them in its first columns."""
    rng = np.random.default_rng(seed)
    table = np.array(_SPECIAL, np.float32)
    x = rng.choice(table, size=(m, p))
    x[:, :len(table)] = table[(np.arange(m)[:, None] + np.arange(len(table))) % len(table)]
    mask = np.ones(m, np.float32) if mask_kind == "full" else \
        (rng.random(m) < 0.6).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype), torch.from_numpy(mask).to(device)


def _same_bits(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    zero = want == 0
    assert torch.equal(torch.signbit(got[zero]), torch.signbit(want[zero]))


@pytest.mark.parametrize("m", _TRIM_M)
@pytest.mark.parametrize("mask_kind", ["random", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_robust_trimmed_special_values(cuda, m, mask_kind, dtype):
    """NaN, +-inf, +-0 and ties, in rows that participate and rows that do
    not: the median bitwise (the sign of zero too), the trimmed mean within
    M * 2**-24 * max|x| over the finite values, at every register bucket's
    edge."""
    x, mask = _special_inputs(m, 3001, mask_kind, dtype, cuda, seed=m)
    n = mask.sum()
    n_int = int(n)
    finite = x.float()[torch.isfinite(x.float())]
    bound = m * 2.0 ** -24 * float(finite.abs().max())
    med = max(n_int - 1, 0) // 2
    for k in sorted({0, med // 2, med}):
        kt = torch.tensor(float(k), device=cuda)
        before = robust_trimmed.launches
        got = ops.robust_trimmed(x, mask, n, kt)
        assert robust_trimmed.launches == before + 1
        want = ref.robust_trimmed(x, mask, n, kt)
        if k == med:
            _same_bits(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=bound, equal_nan=True)


@pytest.mark.parametrize("kernel", ["weighted_aggregate", "robust_trimmed"])
def test_aggregation_runs_on_the_current_stream(cuda, kernel):
    """Under ``torch.cuda.stream(s)`` the kernel is ordered after what was
    queued on ``s`` before it: ``s`` spins, then overwrites the input, then
    the kernel reads it.  On any other stream the kernel would read the old
    input while ``s`` still spins."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    m, p = 20, 5674
    upd = torch.randn((m, p), generator=gen, device=cuda)
    fresh = torch.randn((m, p), generator=gen, device=cuda)
    scale = torch.rand((m,), generator=gen, device=cuda)
    mask = torch.ones(m, device=cuda)
    n, k = mask.sum(), torch.tensor(4.0, device=cuda)
    if kernel == "weighted_aggregate":
        launch, counter = (lambda u: ops.weighted_aggregate(u, scale)), weighted_aggregate
    else:
        launch, counter = (lambda u: ops.robust_trimmed(u, mask, n, k)), robust_trimmed
    want = launch(fresh)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)
        upd.copy_(fresh)
        before = counter.launches
        got = launch(upd)
        assert counter.launches == before + 1
    s.synchronize()
    assert torch.equal(got, want)


def test_robust_aggregation_adds_no_host_sync(cuda):
    """The order-statistic families compute n and k on the device and the
    kernel reads them there: no ``.item()``, no device-to-host copy.  The
    knobs are made on the device once, as ``AsyncFLTrainer`` does."""
    x, mask = _trim_inputs(20, 5674, "random", torch.float32, cuda, seed=1)
    zeta = torch.full((20,), 0.05, device=cuda)
    aggs = [make_aggregator("trimmed_mean", trim_frac=0.34), make_aggregator("coordinate_median")]
    knobs = [agg.params(cuda) for agg in aggs]
    for agg, sp in zip(aggs, knobs):                   # build and load first
        agg.aggregate(x, mask, zeta, mask.sum(), sp)
    torch.cuda.synchronize()
    before = robust_trimmed.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for agg, sp in zip(aggs, knobs):
            agg.aggregate(x, mask, zeta, mask.sum(), sp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert robust_trimmed.launches == before + 2


@pytest.mark.parametrize("n,h", [(5, 1024), (30, 256), (7, 1000), (3, 33)])
@pytest.mark.parametrize("binary", [True, False])
def test_glr_scan_kernel_matches_plain(cuda, n, h, binary):
    gen = torch.Generator(device=cuda).manual_seed(n * h)
    hist = (torch.randint(0, 2, (n, h), generator=gen, device=cuda).float() if binary
            else torch.rand((n, h), generator=gen, device=cuda))
    counts = torch.randint(0, h + 1, (n,), generator=gen, device=cuda).to(torch.int32)
    counts[:3] = torch.tensor([0, 1, h], device=cuda)[:n]
    before = glr_scan.launches
    got = ops.glr_scan(hist, counts)
    assert glr_scan.launches == before + 1
    want = ref.glr_scan(hist, counts)
    if binary:
        assert torch.equal(got, want)
    else:
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        lo, hi = ref.glr_scan_bounds(hist.cpu(), counts.cpu())
        got = got.cpu().double()
        fin = torch.isfinite(got)
        assert bool(((got >= lo) & (got <= hi))[fin].all())


def test_card_recompute_detector_equals_cpu_and_streaming(cuda):
    """The recompute detector on the card equals its CPU run and the card's
    streaming detector over 300 {0, 1} updates."""
    n, m = 6, 3
    mk = lambda impl: GLRCUCB(n, m, history=32, detector_stride=3, min_samples=4, delta=0.05,
                              detector_impl=impl)
    rng = np.random.default_rng(4)
    mu0 = rng.random(n)
    runs = [("recompute", "cpu"), ("recompute", "cuda"), ("streaming", "cuda")]
    states = {k: mk(k[0]).init(k[1]) for k in runs}
    for t in range(300):
        mu = (mu0, 1.0 - mu0, mu0)[min(t // 100, 2)]
        ch = rng.permutation(n)[:m]
        rw = (rng.random(m) < mu[ch]).astype(np.float32)
        for k in states:
            states[k] = mk(k[0]).update(states[k], t, torch.from_numpy(ch).to(k[1]),
                                        torch.from_numpy(rw).to(k[1]), None)
    a, b, c = states[("recompute", "cuda")], states[("recompute", "cpu")], \
        states[("streaming", "cuda")]
    assert int(b.restarts) > 0
    for f in ("counts", "hist", "tau", "restarts"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    for f in ("counts", "tau", "restarts", "mu_tilde"):
        assert torch.equal(getattr(a, f), getattr(c, f)), f


_FLASH_SHAPES = [
    (1, 2, 2, 128, 64, True, 0),      # the JAX package's five (tests/test_kernels.py)
    (2, 4, 2, 257, 72, True, 0),
    (1, 4, 1, 200, 128, False, 0),
    (1, 2, 2, 300, 64, True, 64),
    (2, 8, 4, 64, 96, True, 16),
    (1, 8, 2, 300, 128, True, 8),     # windows narrower than a tile: fully masked first tiles
    (1, 8, 2, 300, 32, True, 16),
    (1, 4, 2, 300, 256, False, 40),   # non-causal window, the largest head dim
    (1, 4, 2, 300, 128, False, 40),   # non-causal window on the tensor-core route
    (2, 64, 8, 256, 128, True, 0),    # qwen3-32b's heads, group 8
    (1, 2, 1, 1, 64, True, 0),        # one token
    (1, 4, 4, 100, 128, False, 0),    # group 1, S not a multiple of 64
    (1, 8, 2, 190, 64, True, 8),      # group 4, window 8
    (1, 16, 2, 1500, 128, True, 1024),  # group 8, window 1024, S not a multiple of 128
    (1, 2, 1, 77, 8, True, 0),        # the smallest tensor-core head dim
    (1, 4, 2, 150, 36, True, 0),      # bf16 on the FMA route: D % 8 != 0
]


def _attn_inputs(b, hq, hkv, s, d, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, hq, s, d), generator=gen, device=device) * 0.5
    k = torch.randn((b, hkv, s, d), generator=gen, device=device) * 0.5
    v = torch.randn((b, hkv, s, d), generator=gen, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", _FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, s, d, causal, window, dtype):
    q, k, v = _attn_inputs(b, hq, hkv, s, d, dtype, cuda, seed=s * d + hq)
    before = flash_attention.launches, flash_attention.tc_launches, flash_attention.fma_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    tc = tc_route(dtype, d)
    assert (flash_attention.launches, flash_attention.tc_launches, flash_attention.fma_launches) \
        == (before[0] + 1, before[1] + tc, before[2] + (not tc))
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.mha_attention(q.float(), k.float(), v.float(), causal=causal, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-4)


@pytest.mark.parametrize("scale", [-0.1, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_a_scale_of_any_sign(cuda, scale, dtype):
    """Both routes scale each logit before the mask and the row max, so a
    negative scale (the max of the scaled logits is the min of the raw ones)
    and a scale of 0 (masked keys stay at -inf) match the plain version."""
    q, k, v = _attn_inputs(1, 4, 2, 300, 64, dtype, cuda, seed=7)
    got = ops.flash_attention(q, k, v, causal=True, window=0, scale=scale)
    want = ref.mha_attention(q.float(), k.float(), v.float(), causal=True, scale=scale)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-4)


def test_attn_core_takes_the_kernel_at_every_length(cuda):
    """On the card the model's attention reaches the kernel even for a
    prompt of a few tokens, and its gradients (the plain path's recompute)
    equal the plain path's own."""
    from repro_torch.models.attention import attn_core

    for s in (3, 300):
        q, k, v = _attn_inputs(1, 4, 2, s, 64, torch.float32, cuda, seed=s)
        q.requires_grad_(True)
        before = flash_attention.launches
        y = attn_core(q, k, v, causal=True)
        assert flash_attention.launches == before + 1
        (g,) = torch.autograd.grad((y ** 2).sum(), q)
        q2 = q.detach().clone().requires_grad_(True)
        y2 = attn_core(q2, k, v, causal=True, impl="plain")
        (g2,) = torch.autograd.grad((y2 ** 2).sum(), q2)
        assert flash_attention.launches == before + 1
        torch.testing.assert_close(y, y2, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g, g2, rtol=1e-4, atol=1e-4)


_SCAN_T = 2500
_FAST = dict(delta=0.1, min_samples=4)
# label -> (GLRCUCB arguments, env kind); every env but "stationary" flips each
# channel's mean every 250 rounds, so the detectors restart several times
# (but at stride 1e9, which tests round 0 only)
_SCAN_CASES = {
    "table": (dict(n=5, m=2, history=64, detector_stride=5, **_FAST), "table"),
    "stationary": (dict(n=5, m=2, history=1024, detector_stride=5), "stationary"),
    "alpha": (dict(n=5, m=2, history=64, detector_stride=5, alpha=0.2, **_FAST), "flip"),
    "geometric": (dict(n=5, m=2, history=256, split_grid="geometric", **_FAST), "flip"),
    "h33": (dict(n=5, m=2, history=33, **_FAST), "flip"),
    "n30_m20_stride1": (dict(n=30, m=20, history=256, **_FAST), "flip"),
    "n32": (dict(n=32, m=8, history=1024, detector_stride=5, **_FAST), "flip"),
    "static_stride": (dict(n=5, m=2, history=64, detector_stride=10**9), "flip"),
    "recompute_h33": (dict(n=5, m=2, history=33, detector_impl="recompute", **_FAST), "flip"),
    "recompute_table": (dict(n=5, m=3, history=64, detector_stride=3, detector_impl="recompute",
                             **_FAST), "table"),
}


def _scan_env(kind, n, rng, device):
    a = rng.random(n).astype(np.float32)
    if kind == "stationary":
        return make_stationary(a, device=device)
    segs = -(-_SCAN_T // 250)
    means = np.stack([a if s % 2 == 0 else 1.0 - a for s in range(segs)])
    if kind == "table":
        table = np.repeat(means, 250, axis=0)[:_SCAN_T]
        table = table + rng.uniform(-0.05, 0.05, table.shape).astype(np.float32)
        return table_env(table.clip(0.0, 1.0), device=device)
    return make_piecewise(means, [250 * s for s in range(1, segs)], device=device)


@pytest.mark.parametrize("case", list(_SCAN_CASES))
def test_regret_scan_matches_rounds(cuda, case):
    """One ``regret_scan`` launch against the per-round route on the card:
    the streaming rounds with ``detector_backend="torch"`` (plain ops), the
    recompute rounds through ``glr_scan``."""
    cfg, kind = _SCAN_CASES[case]
    cfg = dict(cfg)
    sched = GLRCUCB(cfg.pop("n"), cfg.pop("m"), **cfg)
    rng = np.random.default_rng(11)
    env = _scan_env(kind, sched.n_channels, rng, cuda)
    u = torch.from_numpy(rng.random((_SCAN_T, 2, sched.n_channels)).astype(np.float32)).to(cuda)
    before = regret_scan.launches, glr_step.launches
    got = simulate_aoi_regret(sched, env, _SCAN_T, uniforms=u, return_state=True)
    assert (regret_scan.launches, glr_step.launches) == (before[0] + 1, before[1])
    plain = sched if sched.detector_impl == "recompute" else \
        dataclasses.replace(sched, detector_backend="torch")
    want = simulate_aoi_regret(plain, env, _SCAN_T, uniforms=u, return_state=True, impl="rounds")
    assert regret_scan.launches == before[0] + 1
    if kind != "stationary" and sched.detector_stride < _SCAN_T:
        assert int(want["restarts"]) > 0
    for k in ("channels", "restarts", "regret", "final_regret", "aoi_pi", "aoi_star",
              "success_rate"):
        assert torch.equal(got[k], want[k]), k
    gs, ws = got["final_sched_state"], want["final_sched_state"]
    for f in ("mu_tilde", "counts", "tau", "hist", "restarts", "cum", "total", "base"):
        assert torch.equal(getattr(gs, f), getattr(ws, f)), f
    for k in ("cum_aoi_var", "final_cum_aoi_var", "oracle_cum_aoi_var"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)


def test_fig2_rounds_route_launches_glr_step(cuda):
    """``impl="rounds"`` keeps the standalone detector kernel: T/stride
    ``glr_step`` launches and no ``regret_scan``."""
    sched = GLRCUCB(5, 2, history=64, detector_stride=5)
    rng = np.random.default_rng(3)
    env = _scan_env("flip", 5, rng, cuda)
    u = torch.from_numpy(rng.random((500, 2, 5)).astype(np.float32)).to(cuda)
    before = regret_scan.launches, glr_step.launches
    simulate_aoi_regret(sched, env, 500, uniforms=u, impl="rounds")
    assert (regret_scan.launches, glr_step.launches) == (before[0], before[1] + 100)


def _batch_inputs(b, kind, shared, recompute, cuda):
    """A batch of B runs: per-run envs and uniforms (``shared=False``), or
    one env and one stream with a per-run hp grid (``shared=True``)."""
    sched = GLRCUCB(5, 2, history=64, detector_stride=5, delta=0.1, min_samples=4,
                    detector_impl="recompute" if recompute else "streaming")
    rng = np.random.default_rng(b)
    t = 600
    envs = [_scan_env(kind, 5, rng, cuda) for _ in range(1 if shared else b)]
    envs = [dataclasses.replace(e, table=e.table[:t].contiguous()) for e in envs]
    u = torch.from_numpy(rng.random(((1 if shared else b), t, 2, 5)).astype(np.float32)).to(cuda)
    grid = [sched.replace_traced(gamma=float(g), delta=float(d))
            for g, d in zip(rng.uniform(0.3, 1.5, b), rng.uniform(1e-3, 0.2, b))]
    if shared:
        batch = dict(envs=envs[0], env_axis=None, uniforms=u[0], uniforms_axis=None,
                     hparams=stack_params(grid, cuda), hp_axis=0)
        runs = [(g, envs[0], u[0]) for g in grid]
    else:
        batch = dict(envs=stack_envs(envs), uniforms=u)
        runs = [(sched, envs[i], u[i]) for i in range(b)]
    return sched, t, batch, runs


@pytest.mark.parametrize("b", [1, 3, 133])
@pytest.mark.parametrize("kind", ["flip", "table"], ids=["segments", "table"])
@pytest.mark.parametrize("recompute", [False, True], ids=["streaming", "recompute"])
@pytest.mark.parametrize("shared", [False, True], ids=["stacked", "broadcast"])
def test_batched_regret_scan_equals_single_runs(cuda, b, kind, recompute, shared):
    """One launch for the whole batch, each run equal to its own single-run
    launch bit for bit (the variance sums too: the same kernel adds them),
    the shared operands read and never written."""
    sched, t, batch, runs = _batch_inputs(b, kind, shared, recompute, cuda)
    before = regret_scan.launches
    envs = batch.pop("envs")
    snapshot = [x.clone() for x in (envs.means, envs.table, batch["uniforms"])]
    got = simulate_aoi_regret_batch(sched, envs, t, return_state=True, **batch)
    assert regret_scan.launches == before + 1 and got["route"] == "scan"
    assert int(regret_scan.splits.sum()) > 0
    for x, y in zip(snapshot, (envs.means, envs.table, batch["uniforms"])):
        assert torch.equal(x, y)
    for i, (s_i, env_i, u_i) in enumerate(runs):
        want = simulate_aoi_regret(s_i, env_i, t, uniforms=u_i, return_state=True)
        for k in ("channels", "restarts", "regret", "final_regret", "aoi_pi", "aoi_star",
                  "success_rate", "cum_aoi_var", "final_cum_aoi_var", "oracle_cum_aoi_var"):
            assert torch.equal(got[k][i], want[k]), (i, k)
        gs, ws = got["final_sched_state"], want["final_sched_state"]
        for f in ("mu_tilde", "counts", "tau", "hist", "restarts", "cum", "total", "base"):
            assert torch.equal(getattr(gs, f)[i], getattr(ws, f)), (i, f)
    assert regret_scan.launches == before + 1 + b


def test_refused_batch_takes_the_rounds_route(cuda):
    """N = 40 channels is past the kernel's 32: the batch runs the batched
    per-round route (``glr_step`` on every detection round), says so, and
    equals the serial runs; ``impl="scan"`` raises with the reason."""
    sched = GLRCUCB(40, 4, history=32, detector_stride=5)
    rng = np.random.default_rng(9)
    envs = [make_piecewise(rng.random((3, 40)).astype(np.float32), [40, 80], device=cuda)
            for _ in range(3)]
    u = torch.from_numpy(rng.random((3, 200, 2, 40)).astype(np.float32)).to(cuda)
    before = regret_scan.launches, glr_step.launches
    got = simulate_aoi_regret_batch(sched, stack_envs(envs), 200, uniforms=u)
    assert got["route"] == "rounds"
    assert (regret_scan.launches, glr_step.launches) == (before[0], before[1] + 40)
    for i in range(3):
        want = simulate_aoi_regret(sched, envs[i], 200, uniforms=u[i])
        assert torch.equal(got["channels"][i], want["channels"])
        assert torch.equal(got["regret"][i], want["regret"])
    with pytest.raises(ValueError, match="impl='scan' does not apply.*N=40"):
        simulate_aoi_regret_batch(sched, stack_envs(envs), 200, uniforms=u, impl="scan")


def test_mexp3_batch_on_the_card_equals_serial_runs(cuda):
    """The batched per-round route of M-Exp3 (its CDF an f64 sum rounded
    once, its ``logsumexp`` over the last axis) equals the serial runs on
    the card bit for bit."""
    sched = MExp3(6, 2, share_alpha=1e-3)
    rng = np.random.default_rng(4)
    tables = [(rng.random((300, 6)) < 0.5).astype(np.float32) for _ in range(4)]
    envs = [table_env(tb_, score_kind="mean", device=cuda) for tb_ in tables]
    u = torch.from_numpy(rng.random((300, 2, 6)).astype(np.float32)).to(cuda)
    got = simulate_aoi_regret_batch(sched, stack_envs(envs), 300, uniforms=u, uniforms_axis=None,
                                    return_state=True)
    for i in range(4):
        want = simulate_aoi_regret(sched, envs[i], 300, uniforms=u, return_state=True)
        for k in ("channels", "regret", "aoi_pi", "aoi_star", "success_rate"):
            assert torch.equal(got[k][i], want[k]), (i, k)
        assert torch.equal(got["final_sched_state"].log_w[i], want["final_sched_state"].log_w)


def _tenant_inputs(r, b, n, h, seed, binary):
    """A serve step's operands: slot state (R, N, H), B distinct slots, the
    last two rows padding on the scratch slot R - 1, a fifth of the live
    rows detecting (at least one)."""
    rng = np.random.default_rng(seed)
    if binary:
        cum = rng.integers(0, 2 * h, (r, n, h)).astype(np.float32)
        r_vec = rng.integers(0, 2, (b, n)).astype(np.float32)
    else:
        cum = (np.sort(rng.random((r, n, h)), -1) * h).astype(np.float32)
        r_vec = rng.random((b, n)).astype(np.float32)
    total = rng.integers(0, 3 * h, (r, n)).astype(np.float32)
    base = rng.integers(0, h, (r, n)).astype(np.float32)
    counts = rng.integers(0, 3 * h, (b, n)).astype(np.int32)
    slots = rng.permutation(r - 1)[:b].astype(np.int32)
    live = np.ones(b, bool)
    slots[-2:], live[-2:] = r - 1, False
    detect = (rng.random(b) < 0.2) & live
    detect[0] = True
    sched = rng.random((b, n)) < 0.7
    return [torch.from_numpy(a) for a in (cum, total, base, slots, live, detect, counts,
                                          r_vec, sched)]


@pytest.mark.parametrize("r,b,n,h", [(256, 250, 16, 1024), (257, 64, 16, 256),
                                     (10001, 64, 16, 64), (20, 12, 5, 33), (20, 12, 5, 130)])
@pytest.mark.parametrize("split_grid", ["all", "geometric"])
@pytest.mark.parametrize("binary", [True, False], ids=["bernoulli", "uniform"])
def test_glr_step_tenants_kernel_matches_plain(cuda, r, b, n, h, split_grid, binary):
    """The in-place kernel against ``ref.glr_step_tenants`` on the same
    inputs: the slot state bitwise on {0, 1} rewards (rtol 1e-6 on U[0, 1]),
    rows not live untouched, the statistic at rtol/atol 1e-5 with -inf at
    the same places; one launch."""
    from repro_torch.kernels.glr_step_tenants import glr_step_tenants

    args = _tenant_inputs(r, b, n, h, r + b + h, binary)
    card = [a.to(cuda) for a in args]
    before = glr_step_tenants.launches
    got = ops.glr_step_tenants(*card, split_grid=split_grid).cpu()
    assert glr_step_tenants.launches == before + 1
    plain = [a.clone() for a in args[:3]]
    want = ref.glr_step_tenants(*plain, *args[3:], split_grid=split_grid)
    for g, w in zip(card[:3], plain):
        if binary:
            assert torch.equal(g.cpu(), w)
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=0)
    assert torch.equal(card[0][-1].cpu(), args[0][-1])            # the scratch slot
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_matching", [False, True], ids=["policy", "matched"])
def test_served_tenants_on_the_card_equal_the_cpu(cuda, use_matching):
    """Three tenants served 80 requests on the card equal the CPU server bit
    for bit (assignments, every slot leaf but the matcher's normalizers,
    held at rtol 1e-6); ``glr_step_tenants`` launches
    once a step, ``glr_step`` never; a step does not wait on the device."""
    from collections import deque

    from repro_torch.kernels.glr_step_tenants import glr_step_tenants
    from repro_torch.sim import SchedServer, ServeRequest

    sched = GLRCUCB(8, 3, history=32, detector_stride=5, min_samples=4, delta=0.1)
    servers = {dev: SchedServer(sched, capacity=4, slots=4, use_matching=use_matching,
                                device=dev) for dev in ("cpu", cuda)}
    rng = np.random.default_rng(7)
    reqs = [ServeRequest(f"t{j % 3}", (rng.random(8) < 0.6).astype(np.float32),
                         rng.random(8).astype(np.float32)) for j in range(80)]
    out = {}
    for dev, server in servers.items():
        for i in range(3):
            server.join(f"t{i}", hp={"gamma": 0.8 + 0.1 * i})
        before = (glr_step_tenants.launches, glr_step.launches)
        out[dev] = server.serve(reqs)
    card = servers[cuda]
    assert glr_step_tenants.launches - before[0] == card.stats()["steps"] > 0
    assert glr_step.launches == before[1]
    for a, b in zip(out["cpu"], out[cuda]):
        np.testing.assert_array_equal(a, b)
    for tid in ("t0", "t1", "t2"):
        cpu_row, card_row = servers["cpu"].tenant_state(tid), card.tenant_state(tid)
        for a, b in zip(_leaves(cpu_row._replace(matcher_state=None)),
                        _leaves(card_row._replace(matcher_state=None))):
            assert torch.equal(a, b.cpu())
        # the matcher's AoI variance goes through torch's mean, which divides
        # on the CPU and multiplies by 1/M on CUDA: v_max and beta_t at 1e-6
        for a, b in zip(cpu_row.matcher_state, card_row.matcher_state):
            torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=0)
    batch = card._take_batch(deque(enumerate(reqs[:3])), 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inflight = card._dispatch(batch, 4, False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    card._retire(inflight)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree for x in _leaves(f)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# the baselines (phase 9 of chip_smoke.py): the per-round route on the card
# ---------------------------------------------------------------------------

_BASELINE_T = 300


def _baselines(n, m):
    from repro_torch.core.bandits import (AoIAware, ChannelAwareAsync, LyapunovSched, MExp3,
                                          RandomScheduler, RoundRobinScheduler)

    return {"random": RandomScheduler(n, m), "round-robin": RoundRobinScheduler(n, m),
            "lyapunov": LyapunovSched(n, m), "channel-aware": ChannelAwareAsync(n, m),
            "m-exp3": MExp3(n, m, share_alpha=1e-3),
            "aa-glr-cucb": AoIAware(GLRCUCB(n, m, history=64, detector_stride=5)),
            "aa-m-exp3": AoIAware(MExp3(n, m))}


def _draw_near_tie(sched, state, u, rel=1e-5):
    """A draw that the card's and the CPU's ``log``/``exp`` may decide apart:
    channel-aware's perturbed scores or M-Exp3's CDF within ``rel``."""
    from repro_torch.core.bandits import AoIAware, ChannelAwareAsync, MExp3

    if isinstance(sched, AoIAware):
        return _draw_near_tie(sched.base, state.base, u, rel)
    if isinstance(sched, ChannelAwareAsync):
        g = -torch.log(-torch.log((u * (1.0 - 1e-12) + 1e-12).clamp_min(1e-12)))
        top = torch.sort(torch.log(sched._weights(state)) + g, descending=True).values
        return bool(((top[:-1] - top[1:]).abs() <= rel * top[:-1].abs()).any())
    if isinstance(sched, MExp3):
        cdf = torch.cumsum(sched._probs(state), 0)
        r = cdf[-1] * (1.0 - u[0])
        return bool(((cdf - r).abs() <= rel * r.abs()).any())
    return False


@pytest.mark.parametrize("env_kind", ["piecewise", "adversarial"])
@pytest.mark.parametrize("name", list(_baselines(5, 2)))
def test_baseline_rounds_on_the_card_equal_the_cpu(cuda, name, env_kind):
    """A baseline's run on the card (the per-round route: the scan takes
    only GLR-CUCB) equals the CPU run on the same uniforms: schedule, AoI,
    regret and counters bit for bit.  Only a draw through ``log``/``exp``
    (channel-aware, M-Exp3) may fork, at a near-tie within 1e-5 relative;
    AoI-Aware over GLR-CUCB launches ``glr_step`` every fifth round."""
    from repro_torch.core.channels import random_adversarial_env, random_piecewise_env
    from repro_torch.core.regret import policy_round

    sched = _baselines(5, 2)[name]
    gen = torch.Generator().manual_seed(4)
    make = random_piecewise_env if env_kind == "piecewise" else random_adversarial_env
    env = make(gen, 5, _BASELINE_T, 3, device="cpu") if env_kind == "piecewise" else \
        make(gen, 5, _BASELINE_T, flip_prob=0.02, device="cpu")
    u = torch.rand((_BASELINE_T, 2, 5), generator=gen)
    before = regret_scan.launches, glr_step.launches
    got = simulate_aoi_regret(sched, env.to(cuda), _BASELINE_T, uniforms=u.to(cuda))
    detects = _BASELINE_T // 5 if name == "aa-glr-cucb" else 0
    assert (regret_scan.launches, glr_step.launches) == (before[0], before[1] + detects)
    want = simulate_aoi_regret(sched, env, _BASELINE_T, uniforms=u, device="cpu")
    differ = (got["channels"].cpu() != want["channels"]).any(1).nonzero()
    if differ.numel():
        t0 = int(differ[0])
        assert name in ("channel-aware", "m-exp3", "aa-m-exp3"), (name, t0)
        state, aoi = sched.init("cpu"), torch.ones(2)
        for t in range(t0):
            state, aoi, _, _ = policy_round(sched, state, aoi, t, u[t, 1], env.sample(t, u[t, 0]))
        assert _draw_near_tie(sched, state, u[t0, 1]), (name, t0)
        assert torch.equal(got["regret"][:t0].cpu(), want["regret"][:t0])
        return
    for k in ("channels", "regret", "aoi_pi", "aoi_star", "restarts", "exploit_rounds"):
        if k in want:
            assert torch.equal(got[k].cpu(), want[k]), k


def test_mean_aoi_is_correctly_rounded_on_the_card(cuda):
    """62 / 20: torch's CUDA ``mean`` (a multiply by 1/20) gives 3.1000001;
    the port's ``mean_aoi`` gives the correctly rounded 3.0999999, as the
    CPU and JAX do."""
    from repro_torch.core.aoi import mean_aoi

    aoi = torch.tensor([3.0] * 18 + [4.0, 4.0])
    want = torch.tensor(np.float32(62.0 / 20.0))
    assert torch.equal(mean_aoi(aoi), want)
    assert torch.equal(mean_aoi(aoi.to(cuda)).cpu(), want)
    rows = torch.stack([aoi, aoi.flip(0)]).to(cuda)
    assert torch.equal(mean_aoi(rows).cpu(), torch.stack([want, want]))
