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
bf16 with D % 8 == 0 and D <= 256 must take the tensor-core route (which
splits P into two bf16 terms to stay inside that tolerance), every other
call the FMA route.  The tensor-core forward's logsumexp is held to the
plain version's at rtol / atol 1e-5 (the same f32 logits), and the backward
kernels' dq, dk, dv to ``ref.mha_attention_bwd`` in f32 on the same bf16
inputs, per tensor within 2^-6 |want| + 2^-7 max|want| (the emulation of
their arithmetic in ``tests/test_torch_flash_bwd_split.py``), two calls
bitwise (no atomics).  ``regret_scan`` (a whole regret-harness run in one
launch) equals the per-round route with the plain detector bit for bit in
schedule, restarts, regret, AoI, success rate and final state; the
variance sums at rtol 1e-6 (the kernel adds the M squared deviations in
another order than torch's reduction); so does its reactive template (the
closed-loop env's load carried in a register) against the per-round route
threading the carry, for one run and for a batch with per-run or shared
reaction coefficients, and the occupancy query answers for every form.  A batch of runs in one launch (one
block a run; env, uniforms and hyper-parameters per run or shared) equals
the B single-run launches bit for bit, variance sums included, and a batch
the kernel refuses takes the batched per-round route and says so.  ``glr_step_tenants`` (the
scheduler service's detector step, in place on the slot state) is held to
``ref.glr_step_tenants`` as ``glr_step`` is to its plain version, rows not
live untouched; a served trace on the card equals the CPU server bit for
bit, and a serve step makes no host sync.  ``glr_scan``'s tenant entry (the
recompute detector served) is bitwise its plain version on {0, 1}
histories and the single-run kernel on the gathered rows on U[0, 1] ones;
every served policy's trace on the card equals the CPU server's (M-Exp3's
log-weights at rtol 1e-5), with one tenant ``glr_scan`` launch a recompute
step and none for the detector-free policies.  The baseline policies' runs on
the per-round route equal the CPU runs bit for bit (a draw through
``log``/``exp`` may fork only at a near-tie within 1e-5 relative), and the
mean AoI is the correctly rounded f32 quotient on both devices.  The
Step-4 kernels' batch form (one launch for B runs) equals the single-run
kernel row by row bit for bit; a batch of FL runs on the card launches
each Step-4 kernel and ``glr_step`` once a round for the batch and keeps
the CPU batch's discrete state and ``n_success`` bit for bit (params at
rtol 1e-4), and a batch of one is ``run()`` bit for bit.  Three rounds of
the LLM-scale training step (``make_fl_train_step``, qwen1.5's smoke
config in f32) equal the CPU rounds in the discrete state bit for bit, the
floats and AdamW's moments at rtol 1e-4 (parameters plus the slack
that ``chip_smoke.adam_round_close`` derives from the moments), launching ``glr_step`` once and ``flash_attention``
twice a layer a round; the step synchronises the host only where the
channel draw does.
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
    reactive_env,
    stack_envs,
    table_env,
)
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.sim import simulate_aoi_regret_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, tc_route  # noqa: E402
from repro_torch.kernels.glr_scan import glr_scan  # noqa: E402
from repro_torch.kernels.glr_step import glr_step  # noqa: E402
from repro_torch.kernels.regret_scan import occupancy, regret_scan  # noqa: E402
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
    (1, 48, 8, 2048, 128, True, 0),   # dbrx-132b's heads, group 6
    (1, 2, 1, 77, 8, True, 0),        # the smallest tensor-core head dim
    (1, 4, 2, 150, 36, True, 0),      # bf16 on the FMA route: D % 8 != 0
    (1, 10, 1, 300, 256, True, 0),    # tensor cores at D = 256, 64-key tiles: MQA
    (1, 4, 1, 600, 256, True, 40),    # a window narrower than a 64-key tile
    (2, 8, 2, 257, 200, True, 0),     # D = 200 padded to 256 in shared memory
    (1, 4, 2, 300, 136, False, 0),    # D = 136, the narrowest head dim padded to 256
    (1, 16, 16, 2048, 80, False, 0),  # hubert-xlarge's heads: non-causal at full length, D = 80
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


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("scale", [-0.1, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_a_scale_of_any_sign(cuda, scale, dtype, d):
    """Both routes scale each logit before the mask and the row max, so a
    negative scale (the max of the scaled logits is the min of the raw ones)
    and a scale of 0 (masked keys stay at -inf) match the plain version, at
    both key tiles of the tensor-core route (D = 64 and 256)."""
    q, k, v = _attn_inputs(1, 4, 2, 300, d, dtype, cuda, seed=7)
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


# label -> (GLRCUCB arguments, react [decay, gain, thresh, sharp]); the base is
# the flipping table of _scan_env, so the detectors restart as well
_REACT_CASES = {
    "jammer": (dict(n=5, m=2, history=64, detector_stride=5, **_FAST), (0.8, 0.9, 0.3, 16.0)),
    "congestion_recompute": (dict(n=5, m=3, history=64, detector_stride=3,
                                  detector_impl="recompute", **_FAST), (0.9, 0.6, 0.5, 4.0)),
    "geometric": (dict(n=5, m=2, history=256, split_grid="geometric", **_FAST),
                  (0.5, 1.0, 0.2, 8.0)),
    "n32_gain1_decay0": (dict(n=32, m=8, history=256, detector_stride=5, **_FAST),
                         (0.0, 1.0, 0.3, 16.0)),
    "n32_gain1_decay1": (dict(n=32, m=8, history=256, detector_stride=5, **_FAST),
                         (1.0, 1.0, 0.3, 16.0)),
    "out_of_range": (dict(n=5, m=2, history=64, detector_stride=5, **_FAST),
                     (-0.5, 1.7, 0.0, 40.0)),
}


def _react_env(n, react, rng, device):
    return reactive_env(_scan_env("table", n, rng, device).table, *react, device=device)


def _same_runs(got, want, where=""):
    for k in ("channels", "restarts", "regret", "final_regret", "aoi_pi", "aoi_star",
              "success_rate"):
        assert torch.equal(got[k], want[k]), (where, k)
    gs, ws = got["final_sched_state"], want["final_sched_state"]
    for f in ("mu_tilde", "counts", "tau", "hist", "restarts", "cum", "total", "base"):
        assert torch.equal(getattr(gs, f), getattr(ws, f)), (where, f)
    for k in ("cum_aoi_var", "final_cum_aoi_var", "oracle_cum_aoi_var"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", list(_REACT_CASES))
def test_reactive_regret_scan_matches_rounds(cuda, case):
    """The reactive template (one launch) against the per-round route on the
    card, which threads the load carry through ``means_dyn`` /
    ``interact_step`` with plain ops: bit for bit, as the open-loop forms."""
    cfg, react = _REACT_CASES[case]
    cfg = dict(cfg)
    sched = GLRCUCB(cfg.pop("n"), cfg.pop("m"), **cfg)
    rng = np.random.default_rng(13)
    env = _react_env(sched.n_channels, react, rng, cuda)
    u = torch.from_numpy(rng.random((_SCAN_T, 2, sched.n_channels)).astype(np.float32)).to(cuda)
    before = regret_scan.launches, regret_scan.reactive_launches, glr_step.launches
    got = simulate_aoi_regret(sched, env, _SCAN_T, uniforms=u, return_state=True)
    assert (regret_scan.launches, regret_scan.reactive_launches, glr_step.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    plain = sched if sched.detector_impl == "recompute" else \
        dataclasses.replace(sched, detector_backend="torch")
    want = simulate_aoi_regret(plain, env, _SCAN_T, uniforms=u, return_state=True, impl="rounds")
    assert regret_scan.launches == before[0] + 1
    _same_runs(got, want, case)


@pytest.mark.parametrize("shared", [False, True], ids=["per_run_react", "shared_react"])
@pytest.mark.parametrize("b", [3, 133])
def test_batched_reactive_scan_equals_rounds(cuda, b, shared):
    """A batch on the reactive template: per-run envs with their own (B, 4)
    react rows, or one env (its (4,) react at stride 0) under per-run
    uniforms; one launch equal to the batched per-round route bit for bit."""
    sched = GLRCUCB(5, 2, history=64, detector_stride=5, **_FAST)
    rng = np.random.default_rng(b + 7)
    t = 600
    if shared:
        env = _react_env(5, (0.7, 0.9, 0.3, 16.0), rng, cuda)
        envs = dataclasses.replace(env, table=env.table[:t].contiguous())
        kw = dict(env_axis=None)
    else:
        rows = [_react_env(5, (rng.uniform(0, 1), rng.uniform(0.5, 1), rng.uniform(0.1, 0.6),
                               rng.uniform(2, 20)), rng, cuda) for _ in range(b)]
        envs = stack_envs([dataclasses.replace(e, table=e.table[:t].contiguous()) for e in rows])
        assert envs.react.shape == (b, 4)
        kw = {}
    u = torch.from_numpy(rng.random((b, t, 2, 5)).astype(np.float32)).to(cuda)
    before = regret_scan.launches, regret_scan.reactive_launches
    got = simulate_aoi_regret_batch(sched, envs, t, uniforms=u, return_state=True, **kw)
    assert got["route"] == "scan"
    assert (regret_scan.launches, regret_scan.reactive_launches) == (before[0] + 1, before[1] + 1)
    want = simulate_aoi_regret_batch(dataclasses.replace(sched, detector_backend="torch"), envs,
                                     t, uniforms=u, return_state=True, impl="rounds", **kw)
    assert want["route"] == "rounds" and regret_scan.launches == before[0] + 1
    _same_runs(got, want, f"B={b}")


@pytest.mark.parametrize("form", ["segments", "table", "reactive"])
@pytest.mark.parametrize("impl", ["streaming", "recompute"])
def test_regret_scan_occupancy_for_each_form(cuda, form, impl):
    """The occupancy query answers for every template; the reactive form's
    extra registers keep the one block an SM of the open-loop forms."""
    sched = GLRCUCB(5, 2, history=1024, detector_stride=5, detector_impl=impl)
    occ = occupancy(sched, form)
    assert occ >= 1
    assert occ == occupancy(sched, "segments")


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


@pytest.mark.parametrize("r,b,n,h", [(257, 64, 16, 256), (10001, 64, 16, 64), (20, 12, 5, 33),
                                     (20, 12, 5, 130)])
@pytest.mark.parametrize("binary", [True, False], ids=["bernoulli", "uniform"])
def test_glr_scan_tenants_kernel_matches_plain(cuda, r, b, n, h, binary):
    """``glr_scan``'s tenant entry reads the named slots' histories in place
    (never writing them): bitwise ``ref.glr_scan_tenants`` on {0, 1}
    histories; on U[0, 1] ones bitwise the single-run kernel on the
    gathered rows; -inf on every row not detecting; one launch."""
    from repro_torch.kernels.glr_scan import glr_scan_tenants

    rng = np.random.default_rng(r + b + h)
    hist = (rng.integers(0, 2, (r, n, h)) if binary else rng.random((r, n, h))).astype(np.float32)
    counts = rng.integers(0, h + 1, (b, n)).astype(np.int32)
    counts.reshape(-1)[:4] = [0, 1, 2, h]
    slots = rng.permutation(r - 1)[:b].astype(np.int32)
    slots[-2:] = r - 1                                          # padding rows on the scratch slot
    detect = rng.random(b) < 0.3
    detect[0], detect[-2:] = True, False
    args = [torch.from_numpy(a) for a in (hist, slots, detect, counts)]
    card = [a.to(cuda) for a in args]
    before = glr_scan_tenants.launches
    got = ops.glr_scan_tenants(*card)
    assert glr_scan_tenants.launches == before + 1
    assert torch.equal(card[0].cpu(), args[0])
    want = ref.glr_scan_tenants(*card)            # the plain version on the card's logf
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert bool(torch.isneginf(got[~card[2]]).all())
    if binary:
        assert torch.equal(got, want)
    else:
        det = card[2]
        rows = card[0].index_select(0, card[1].long())[det].reshape(-1, h).contiguous()
        assert torch.equal(got[det].reshape(-1), glr_scan(rows, card[3][det].reshape(-1)))


@pytest.mark.parametrize("name", ["random", "round-robin", "channel-aware", "lyapunov", "m-exp3",
                                  "recompute", "recompute-matched"])
def test_served_policies_on_the_card_equal_the_cpu(cuda, name):
    """Three tenants served 80 requests on the card equal the CPU server:
    assignments and every slot leaf bit for bit but M-Exp3's ``log_w``
    (exp and log round apart on the two devices: rtol 1e-5) and the
    matcher's normalizers (rtol 1e-6, as above); the recompute detector
    launches the tenant ``glr_scan`` once a step, the others no kernel; a
    step does not wait on the device."""
    from collections import deque

    from repro_torch.core.bandits import (ChannelAwareAsync, LyapunovSched, RandomScheduler,
                                          RoundRobinScheduler)
    from repro_torch.kernels import glr_scan as gsc
    from repro_torch.kernels.glr_step_tenants import glr_step_tenants
    from repro_torch.sim import SchedServer, ServeRequest

    n, m = 8, 3
    sched = {"random": RandomScheduler(n, m), "round-robin": RoundRobinScheduler(n, m),
             "channel-aware": ChannelAwareAsync(n, m), "lyapunov": LyapunovSched(n, m),
             "m-exp3": MExp3(n, m, gamma=0.5, share_alpha=1e-3)}.get(
        name, GLRCUCB(n, m, history=32, detector_stride=5, min_samples=4, delta=0.1,
                      detector_impl="recompute"))
    matched = name.endswith("matched")
    servers = {dev: SchedServer(sched, capacity=4, slots=4, use_matching=matched, device=dev)
               for dev in ("cpu", cuda)}
    rng = np.random.default_rng(9)
    reqs = [ServeRequest(f"t{j % 3}", (rng.random(n) < 0.6).astype(np.float32),
                         rng.random(n).astype(np.float32)) for j in range(80)]
    counters = (gsc.glr_scan_tenants, gsc.glr_scan, glr_step_tenants, glr_step)
    out = {}
    for dev, server in servers.items():
        for i in range(3):
            server.join(f"t{i}")
        before = [c.launches for c in counters]
        out[dev] = server.serve(reqs)
    card = servers[cuda]
    launched = [c.launches - b for c, b in zip(counters, before)]
    steps = card.stats()["steps"]
    assert launched == ([steps, 0, 0, 0] if name.startswith("recompute") else [0, 0, 0, 0])
    for a, b in zip(out["cpu"], out[cuda]):
        np.testing.assert_array_equal(a, b)
    for tid in ("t0", "t1", "t2"):
        cpu_row, card_row = servers["cpu"].tenant_state(tid), card.tenant_state(tid)
        close = ("log_w",) if name == "m-exp3" else ()
        for f in cpu_row.sched_state._fields:
            for a, b in zip(_leaves(getattr(cpu_row.sched_state, f)),
                            _leaves(getattr(card_row.sched_state, f))):
                if f in close:
                    torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-6)
                else:
                    assert torch.equal(a, b.cpu()), f
        for a, b in zip(_leaves(cpu_row._replace(sched_state=None, matcher_state=None)),
                        _leaves(card_row._replace(sched_state=None, matcher_state=None))):
            assert torch.equal(a, b.cpu())
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


# ---------------------------------------------------------------------------
# the Step-4 kernels' batch form and the batched FL engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,m,p", [(8, 20, 5674), (3, 7, 4099), (5, 64, 4096), (2, 1, 3)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_weighted_aggregate_rows_equal_the_single_run_kernel(cuda, b, m, p, offset,
                                                                     dtype):
    """One launch for B runs; row i is the single-run kernel's result on run
    i bit for bit (whatever load width each picks), and the batch is close
    to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(b * m + p)
    flat = torch.randn((b * m * p + offset,), generator=gen, device=cuda).to(dtype)
    upd = flat[offset:].view(b, m, p)
    scale = torch.rand((b, m), generator=gen, device=cuda) / m
    before = weighted_aggregate.launches, weighted_aggregate.batch_launches
    got = ops.weighted_aggregate(upd, scale)
    assert (weighted_aggregate.launches, weighted_aggregate.batch_launches) == \
        (before[0] + 1, before[1] + 1)
    for i in range(b):
        assert torch.equal(got[i], weighted_aggregate(upd[i].contiguous(), scale[i])), i
    torch.testing.assert_close(got, ref.weighted_aggregate(upd, scale), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [5, 20, 33, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_robust_trimmed_rows_equal_the_single_run_kernel(cuda, m, dtype):
    """Per-run masks, n and k (n = 0, the median, 0, between) over rows of
    NaN, +-inf, +-0 and ties: row i is the single-run kernel's on run i bit
    for bit, and the median rows are the plain version's bit for bit."""
    b, p = 6, 517
    rng = np.random.default_rng(m)
    table = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, 0.5, 2.5], np.float32)
    x = torch.from_numpy(table[rng.integers(0, len(table), (b, m, p))]).to(dtype).to(cuda)
    mask = torch.from_numpy((rng.random((b, m)) < 0.7).astype(np.float32)).to(cuda)
    mask[0] = 0.0
    n = mask.sum(-1)
    med = torch.floor((n - 1.0) / 2.0).clamp_min(0.0)
    k = torch.stack([med, torch.zeros_like(med), torch.floor(med / 2)])[
        torch.arange(b) % 3, torch.arange(b)]
    before = robust_trimmed.batch_launches
    got = ops.robust_trimmed(x, mask, n, k)
    assert robust_trimmed.batch_launches == before + 1
    want = ref.robust_trimmed(x, mask, n, k)

    def bits(a):
        return torch.where(torch.isnan(a), torch.zeros_like(a), a).view(torch.int32), \
            torch.isnan(a)

    for i in range(b):
        one = robust_trimmed(x[i].contiguous(), mask[i].contiguous(), n[i:i + 1], k[i:i + 1])
        assert all(torch.equal(u, v) for u, v in zip(bits(got[i]), bits(one))), i
        if i % 3 == 0:
            assert all(torch.equal(u, v) for u, v in zip(bits(got[i]), bits(want[i]))), i
    assert not got[0].any()


def _fl_trainer(device, **kw):
    from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer

    def loss(p, x, y):
        lg = torch.log_softmax(torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"], dim=-1)
        return -torch.gather(lg, -1, y[..., None]).mean()

    cfg = AsyncFLConfig(n_clients=5, n_channels=7, local_epochs=2, client_lr=0.1, server_lr=0.1)
    env = make_piecewise(np.random.default_rng(3).random((3, 7)).astype(np.float32) * 0.8 + 0.1,
                         np.array([3, 6]), device=device)
    return AsyncFLTrainer(cfg, GLRCUCB(7, 5, history=16), env, loss, device=device, **kw)


def _fl_inputs(b, r=8):
    g = torch.Generator().manual_seed(b)
    params = {"w1": torch.randn((6, 12), generator=g) * 0.3, "b1": torch.zeros(12),
              "w2": torch.randn((12, 3), generator=g) * 0.3, "b2": torch.zeros(3)}
    bx = torch.randn((b, r, 5, 2, 4, 6), generator=g)
    by = torch.randint(0, 3, (b, r, 5, 2, 4), generator=g)
    return params, bx, by, torch.rand((b, r, 2, 7), generator=g)


@pytest.mark.parametrize("agg", [None, "coordinate_median"])
def test_batched_fl_on_the_card_equals_the_cpu_batch(cuda, agg):
    """A batch of 3 FL runs on the card: one batched Step-4 launch and one
    ``glr_step`` a round for the batch; n_success and the discrete state
    equal the CPU batch bit for bit, the rest at rtol 1e-4 (local SGD's
    sums run in other orders on the card)."""
    from repro_torch.sim import simulate_fl_batch

    kw = {} if agg is None else dict(aggregator=make_aggregator(agg))
    params, bx, by, u = _fl_inputs(3)
    tr_cpu, tr_gpu = _fl_trainer("cpu", **kw), _fl_trainer(cuda, **kw)
    want = simulate_fl_batch(tr_cpu, tr_cpu.init_batch(params, 3), bx, by, uniforms=u)
    kernel = robust_trimmed if agg else weighted_aggregate
    before = kernel.batch_launches, glr_step.launches
    got = simulate_fl_batch(tr_gpu, tr_gpu.init_batch(params, 3), bx, by, uniforms=u)
    torch.cuda.synchronize()
    assert (kernel.batch_launches - before[0], glr_step.launches - before[1]) == (8, 8)
    for f in ("aoi", "has_update", "last_success", "staleness"):
        assert torch.equal(getattr(got[0], f).cpu(), getattr(want[0], f)), f
    for k in ("n_success", "mean_aoi"):
        assert torch.equal(got[1][k].cpu(), want[1][k]), k
    for k in want[0].params:
        torch.testing.assert_close(got[0].params[k].cpu(), want[0].params[k], rtol=1e-4,
                                   atol=1e-5)


def test_fl_batch_of_one_on_the_card_is_run(cuda):
    from repro_torch.sim import simulate_fl_batch

    params, bx, by, u = _fl_inputs(1)
    tr = _fl_trainer(cuda)
    st, mets = tr.run(tr.init(params), bx[0], by[0], uniforms=u[0].to(cuda))
    st1, mets1 = simulate_fl_batch(tr, tr.init_batch(params, 1), bx, by, uniforms=u)
    for k in mets:
        assert torch.equal(mets1[k][0], mets[k]), k
    for k in st.params:
        assert torch.equal(st1.params[k][0], st.params[k]), k
    assert torch.equal(st1.contrib[0], st.contrib) and torch.equal(st1.zeta[0], st.zeta)


def test_sparse_top_m_and_batch_draw_on_the_card_equal_the_cpu(cuda):
    """The sparse substrate's stable top-M at N = 10^5 (all ties, a random
    mask, tied groups) and its hashed batch draw give the CPU's bits."""
    from repro_torch.core.availability import MarkovChurn
    from repro_torch.data import client_batch_indices
    from repro_torch.fl import SparseAsyncFLTrainer, SparseFLConfig

    n, m, nch = 100_000, 64, 16
    rng = np.random.default_rng(0)
    cases = [(np.ones(n), np.ones(n), np.ones(n)),
             (np.ones(n), np.ones(n), rng.random(n) < 0.0004),
             (rng.integers(1, 4, n), rng.integers(1, 6, n), rng.random(n) < 0.5)]
    picks = {}
    for dev in ("cpu", cuda):
        tr = SparseAsyncFLTrainer(
            SparseFLConfig(n_clients=n, n_sched=m, n_channels=nch, batch_size=4),
            GLRCUCB(nch, m, history=16), make_stationary(torch.full((nch,), 0.5), device=dev),
            lambda p, x, y: (x @ p["w"] - y).pow(2).mean(), device=dev,
            availability=MarkovChurn())
        st = tr.init({"w": torch.zeros(4)})
        picks[str(dev)] = [tr._select(st._replace(
            contrib=torch.as_tensor(c, dtype=torch.float32, device=dev),
            aoi=torch.as_tensor(a, dtype=torch.float32, device=dev),
            avail=torch.as_tensor(v, dtype=torch.float32, device=dev))).cpu()
            for c, a, v in cases]
    for got, want in zip(picks["cuda"], picks["cpu"]):
        assert torch.equal(got, want)
    assert torch.equal(picks["cpu"][0], torch.arange(m))
    ids = torch.randint(0, n, (m,), generator=torch.Generator().manual_seed(1))
    for seed in (0, 12345, torch.tensor([3, 4])):
        idx = ids if not isinstance(seed, torch.Tensor) else ids.expand(2, -1)
        want = client_batch_indices(seed, 7, idx, 8, 2, 4)
        got = client_batch_indices(seed.to(cuda) if isinstance(seed, torch.Tensor) else seed,
                                   7, idx.to(cuda), 8, 2, 4)
        assert torch.equal(got.cpu(), want)


def test_sparse_equals_dense_bit_for_bit_on_the_card(cuda):
    """At M = N the sparse round is the dense round's arithmetic on the
    card too: the dense trainer fed the sparse draw gives every state leaf
    and metric bit for bit, and each launches ``weighted_aggregate`` and
    ``glr_step`` once a round."""
    from repro_torch.data import client_batch_indices, gather_client_batches
    from repro_torch.fl import (AsyncFLConfig, AsyncFLTrainer, SparseAsyncFLTrainer,
                                SparseFLConfig)

    n, nch, r, e, b = 20, 30, 6, 2, 3
    g = torch.Generator().manual_seed(5)
    cx, cy = torch.randn((n, 12, 9), generator=g), torch.randn((n, 12), generator=g)
    u = torch.rand((r, 2, nch), generator=g).to(cuda)
    means = np.random.default_rng(2).random((3, nch)).astype(np.float32)
    env = make_piecewise(means, np.array([2, 4]), device=cuda)
    loss = lambda p, x, y: ((x @ p["w"] + p["b"] - y) ** 2).mean()
    params = {"w": torch.zeros(9), "b": torch.zeros(())}
    common = dict(local_epochs=e, max_update_norm=50.0, staleness_cap=3)
    dense = AsyncFLTrainer(AsyncFLConfig(n_clients=n, n_channels=nch, **common),
                           GLRCUCB(nch, n, history=32), env, loss, device=cuda)
    sparse = SparseAsyncFLTrainer(SparseFLConfig(n_clients=n, n_sched=n, n_channels=nch,
                                                 batch_size=b, **common),
                                  GLRCUCB(nch, n, history=32), env, loss, device=cuda)
    ids = torch.arange(n, device=cuda)
    draws = [gather_client_batches(cx.to(cuda), cy.to(cuda), ids,
                                   client_batch_indices(0, t, ids, 12, e, b)) for t in range(r)]
    bx, by = torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws])
    before = weighted_aggregate.launches, glr_step.launches
    ds, dm = dense.run(dense.init(params), bx, by, uniforms=u)
    mid = weighted_aggregate.launches, glr_step.launches
    ss, sm = sparse.run(sparse.init(params), cx, cy, uniforms=u)
    torch.cuda.synchronize()
    assert (mid[0] - before[0], mid[1] - before[1]) == (r, r)
    assert (weighted_aggregate.launches - mid[0], glr_step.launches - mid[1]) == (r, r)
    for f in ("buffers", "has_update", "last_success", "aoi", "staleness", "contrib", "zeta"):
        assert torch.equal(getattr(ds, f), getattr(ss, f)), f
    for k in ds.params:
        assert torch.equal(ds.params[k], ss.params[k]), k
    for a, c in zip(ds.sched_state[:5], ss.sched_state[:5]):
        assert torch.equal(a, c)
    for k in dm:
        assert torch.equal(dm[k], sm[k]), k


def _chip_smoke():
    """``chip_smoke.py`` (at the repo's root) as a module."""
    import importlib.util
    import sys
    from pathlib import Path

    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


def test_fl_train_step_on_the_card_equals_the_cpu(cuda):
    """``chip_smoke.py`` phase 14 (b), run as it is there: three
    ``make_fl_train_step`` rounds at the qwen1.5 smoke config in f32
    (``remat="full"``) on the card against the same rounds on the CPU, from
    the same initial state with the same tokens and uniforms.  AoI, every
    scheduler leaf, the count and ``n_success`` bit for bit; loss,
    contributions and zeta at rtol 1e-4; moments and parameters as
    ``chip_smoke.adam_round_close`` holds them.  Each round launches
    ``glr_step`` once and ``flash_attention`` twice a layer (the forward and
    the checkpoint's recompute) on the FMA route (f32); the CPU rounds launch
    nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _chip_smoke().train_card_vs_cpu(torch, 0)


def test_fl_train_step_adds_no_host_sync(cuda, monkeypatch):
    """One ``make_fl_train_step`` round on the card synchronises the host only
    where the FL round's channel draw does: ``ChannelEnv.means_at`` indexes
    a segment env's means with a 0-d device tensor, once a round.  The step
    itself (schedule, loss, backward, AdamW, bookkeeping) adds none."""
    import traceback
    import warnings

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_fl_train_step, make_train_state_init
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    model, sched, opt = (build_model(get_smoke_config("qwen1.5-0.5b"), remat="full"),
                         GLRCUCB(8, 4, history=32), adamw(1e-3))
    means = np.array([np.linspace(0.9, 0.2, 8), np.linspace(0.2, 0.9, 8)], np.float32)
    step = make_fl_train_step(model, opt, sched, make_piecewise(means, [1], device=cuda), 4)
    g = torch.Generator(device=cuda).manual_seed(0)
    state = make_train_state_init(model, opt, sched, 4)(g, device=cuda)
    batch = {"tokens": torch.randint(0, 512, (8, 32), generator=g, device=cuda,
                                     dtype=torch.int32)}
    u = torch.rand((2, 8), generator=g, device=cuda)
    state, _ = step(state, batch, u[0], u[1])           # build and load first
    torch.cuda.synchronize()
    syncs = []

    def record(message, *args, **kwargs):
        if "synchronizing CUDA operation" in str(message):
            syncs.append([f.name for f in traceback.extract_stack()
                          if "repro_torch" in f.filename])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        monkeypatch.setattr(warnings, "showwarning", record)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state, batch, u[0], u[1])
            n_step = len(syncs)
            float(u.sum())                               # a sync the recorder must see
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert len(syncs) == n_step + 1 and syncs[-1] == [], syncs
    assert n_step <= 1 and all(s[-1] == "means_at" for s in syncs[:n_step]), syncs


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_moe_router_and_dispatch_on_the_card_equal_the_cpu(cuda, arch):
    """The MoE router's top-k (ties to the lower expert id, a stable sort)
    and the dispatch plan (the stable expert sort, slots, keep mask) on the
    card equal the port's CPU code on the same probabilities bit for bit, at
    full width on 2048 bf16 tokens (router std 0.02, whose bf16 product ties
    experts often: the test needs ties across the top-k boundary), and at the
    default capacity, which binds: experts 0 and 1 share a column and a
    constant input channel draws most tokens to them."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(arch)
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = moe.capacity(cfg, 2048)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 2048, cfg.d_model), generator=g, device=cuda).to(torch.bfloat16)
    router = (torch.randn((cfg.d_model, e), generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    x[..., 0] = 4.0
    router[0, :2] = 0.5
    router[:, 1] = router[:, 0]                   # experts 0 and 1 tie in every token
    probs = torch.softmax((x @ router).float(), dim=-1)

    def plan(pr):
        topw, topi = moe.route(pr, k)
        return (topw, topi) + moe.dispatch(topi, topw, e, cap)

    card = [t.cpu() for t in plan(probs)]
    cpu = plan(probs.cpu())
    desc = torch.sort(probs, dim=-1, descending=True).values
    assert int((desc[..., k - 1] == desc[..., k]).sum()) > 0
    for a, b in zip(card[1:4], cpu[1:4]):            # ids, token order, slots
        assert torch.equal(a, b)
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(card[4], cpu[4], rtol=1e-6, atol=0)
    assert torch.equal(card[4] == 0, cpu[4] == 0)     # the keep mask
    assert int((card[3] == e * cap).sum()) > 0        # the capacity binds


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_moe_gradients_repeat_bit_for_bit_on_the_card(cuda, arch):
    """One MoE layer's loss and gradients in f32 at its smoke width, 4 x 256
    tokens at a capacity that drops some: twice on the card bit for bit (a
    token's k gathered rows add their gradients in a fixed order, not with
    ``index_add``'s atomics), and equal to the CPU's run at rtol 1e-4 / atol
    1e-4 of each tensor's largest entry (TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.layers import ParamBuilder

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", capacity_factor=0.75)
    pb = ParamBuilder(torch.Generator().manual_seed(5), dtype=torch.float32, device="cpu")
    moe.add_moe_params(pb, "m", cfg)
    x = torch.randn((4, 256, cfg.d_model), generator=torch.Generator().manual_seed(6))

    def grads(dev):
        p = {k: v.to(dev).requires_grad_(True) for k, v in pb.params.items()}
        xs = x.to(dev).requires_grad_(True)
        out, aux = moe.moe_ffn(p, "m", xs, cfg)
        loss = (out.float() ** 2).mean() + 0.01 * aux
        g = torch.autograd.grad(loss, [xs] + list(p.values()))
        return [loss.detach()] + [t.detach() for t in g]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        first, again = grads(cuda), grads(cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = grads("cpu")
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for a, b in zip(first, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("s,a_log", [(600, 0.0), (256, 2.0)])
def test_ssd_chunk_loop_on_the_card_equals_the_cpu(cuda, monkeypatch, s, a_log):
    """mamba2's SSD block at full width (d = 2048, 64 heads of 64, state
    128, chunk 256) in f32 on the card equals the CPU's run of the same
    weights (TF32 off): three chunks, the last one short, at rtol 1e-4 and
    atol 1e-5 of the largest output; and with fast decays (a_log = 2) an
    upper triangle whose exponent passes exp's f32 overflow, finite all the
    same, at atol 1e-4 of the largest output: its cumulative sums reach
    |cum| ~ 10^2-10^3 inside a chunk, where one f32 ulp is 1e-5-6e-5
    absolute, and the card's cumsum adds in another order than the CPU's
    (2.2e-5 of the largest output on an H100)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.layers import ParamBuilder

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), dtype="float32")
    pb = ParamBuilder(torch.Generator(device=cuda).manual_seed(1), dtype=torch.float32,
                      device=cuda)
    ssm.add_ssm_params(pb, "s", cfg)
    p = dict(pb.params)
    p["s/a_log"] = torch.full_like(p["s/a_log"], a_log)
    u = torch.randn((1, s, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    got = ssm.ssm_forward(p, "s", u, cfg)
    want = ssm.ssm_forward({k: v.cpu() for k, v in p.items()}, "s", u.cpu(), cfg)
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=(1e-4 if a_log else 1e-5) * scale)


def test_doubling_scan_on_the_card_equals_the_cpu(cuda):
    """The RG-LRU recurrence at recurrentgemma's width (B = 2, S = 2048, W =
    2560) on the card equals the CPU's (rtol 1e-5, atol 1e-6): the same
    eleven doubling steps, elementwise."""
    from repro_torch.models.rglru import linear_scan

    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.rand((2, 2048, 2560), generator=g, device=cuda)
    b = torch.randn((2, 2048, 2560), generator=g, device=cuda)
    got = linear_scan(a, b)
    torch.testing.assert_close(got.cpu(), linear_scan(a.cpu(), b.cpu()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,window,route", [
    ((4, 10, 1, 2048, 256), 2048, "tc"),        # recurrentgemma-2b's local attention, MQA
    ((4, 32, 32, 2192, 96), 0, "tc"),           # phi-3-vision: 144 patches + 2048 tokens
])
def test_flash_attention_at_the_hybrid_and_vlm_shapes(cuda, shape, window, route):
    """bf16 causal at the two new serving shapes, on the route each must
    take, against the plain version in f32 (rtol 2**-8, atol 1e-4)."""
    b, hq, hkv, s, d = shape
    q, k, v = _attn_inputs(b, hq, hkv, s, d, torch.bfloat16, cuda, seed=s + d)
    before = flash_attention.tc_launches, flash_attention.fma_launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    tc = route == "tc"
    assert (flash_attention.tc_launches, flash_attention.fma_launches) == \
        (before[0] + tc, before[1] + (not tc))
    want = ref.mha_attention(q.float(), k.float(), v.float(), causal=True, window=window)
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-4)


@pytest.mark.parametrize("arch,n_layers", [("hubert-xlarge", 2), ("mamba2-1.3b", 2),
                                           ("recurrentgemma-2b", 3), ("phi-3-vision-4.2b", 2)])
def test_family_gradients_on_the_kernel_route_equal_the_plain_route(cuda, arch, n_layers):
    """``chip_smoke.py`` phase 18 (a), run as it is there: each new family at
    full width, cut in depth, f32, B = 2 x 512: the loss and every gradient
    on the kernel route (``flash_attention`` on the FMA route, forward and
    the checkpoint's recompute) equal the plain route's (rtol 2e-3, atol
    min(2e-3, 1e-4 of the tensor's largest entry)); mamba2's (its L = 256
    chunks overflow exp's upper triangle) finite and equal to the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _chip_smoke().train_reference(torch, 0, arch, n_layers, f"{arch} (a)")


@pytest.mark.parametrize("arch", ["hubert-xlarge", "mamba2-1.3b", "recurrentgemma-2b",
                                  "phi-3-vision-4.2b"])
def test_family_fl_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """``chip_smoke.py`` phase 18 (b): three rounds of each new family's
    smoke config in f32 on the card against the CPU's, as phase 14 (b)
    holds the dense model."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _chip_smoke().train_card_vs_cpu(torch, 0, arch, f"{arch} (b)")


# the backward kernels at the forward's shapes of the tensor-core route, and the five
# training shapes cut to B = 1 (qwen1.5, hubert, recurrentgemma, phi-3-vision, dbrx)
_FLASH_BWD_SHAPES = [
    (1, 2, 2, 128, 64, True, 0),
    (2, 4, 2, 257, 72, True, 0),
    (1, 4, 1, 200, 128, False, 0),
    (1, 2, 2, 300, 64, True, 64),
    (2, 8, 4, 64, 96, True, 16),
    (1, 2, 1, 1, 64, True, 0),        # one token
    (1, 8, 2, 190, 64, True, 8),      # a window narrower than a tile
    (1, 4, 2, 300, 128, False, 40),   # non-causal window
    (1, 2, 1, 77, 8, True, 0),        # the smallest head dim
    (2, 8, 2, 257, 200, True, 0),     # D = 200 padded to 256
    (1, 4, 2, 300, 136, False, 0),    # D = 136
    (1, 16, 16, 2048, 64, True, 0),   # qwen1.5-0.5b
    (1, 16, 16, 2048, 80, False, 0),  # hubert-xlarge
    (1, 10, 1, 2048, 256, True, 2048),  # recurrentgemma-2b: MQA, window 2048
    (1, 32, 32, 2192, 96, True, 0),   # phi-3-vision-4.2b: S not a tile multiple
    (1, 48, 8, 2048, 128, True, 0),   # dbrx-132b: group 6
    # the edges of the wgmma kernels' tiles: 128 resident rows a block (64 at D = 256)
    # against streamed 64-row tiles
    (1, 4, 2, 129, 64, True, 0),      # S one past a block and past two streamed tiles
    (2, 2, 1, 65, 128, False, 0),     # S one past a streamed tile
    (1, 10, 1, 130, 64, True, 0),     # ten query heads on one KV head at small S
    (1, 4, 4, 203, 80, False, 0),     # D = 80 (32-byte swizzle) at a ragged S
    (2, 6, 3, 157, 96, True, 0),      # D = 96 (64-byte swizzle) at a ragged S
    (1, 4, 1, 200, 256, True, 24),    # D = 256 with a window narrower than a tile
    (1, 2, 2, 65, 256, False, 0),     # D = 256, S one past its 64-row block
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", _FLASH_BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, hq, hkv, s, d, causal, window):
    """The tensor-core forward's logsumexp against the plain version's (rtol
    / atol 1e-5: the same f32 logits, summed in another order), and the
    backward kernels' dq, dk, dv against ``ref.mha_attention_bwd`` in f32 on
    the same bf16 inputs, kernel output and logsumexp, per tensor within
    ``BWD_RTOL |want| + BWD_ATOL max|want|``; a second call gives the same
    bits (no atomics)."""
    from repro_torch.kernels.flash_attention import BWD_ATOL, BWD_RTOL, bwd_within
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v = _attn_inputs(b, hq, hkv, s, d, torch.bfloat16, cuda, seed=s * d + hq)
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    do = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(torch.bfloat16)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    want_out, want_lse = ref.mha_attention(q.float(), k.float(), v.float(), causal=causal,
                                           window=window, return_lse=True)
    torch.testing.assert_close(out.float(), want_out, rtol=2.0 ** -8, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    before = flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    want = ref.mha_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse, do.float(),
                                 causal=causal, window=window)
    for name, g, a, w, like in zip(("dq", "dk", "dv"), got, again, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape, name
        assert torch.equal(g, a), f"{name}: two calls differ"
        if s == 1 and name != "dv":
            # one key: P = 1 and dS = dO.v - dO.o = 0 but for the rounding of two f32 sums
            assert float(w.abs().max()) == 0.0 and float(g.float().abs().max()) < 1e-5, name
            continue
        assert bwd_within(g, w) <= 1.0, \
            f"{name}: beyond rtol {BWD_RTOL} / atol {BWD_ATOL} max|want| ({bwd_within(g, w):.3f})"


def test_flash_attention_bwd_build_spills_nothing(cuda):
    """The compiler's report of ``csrc/flash_attention_bwd.cu`` (``-Xptxas
    -v``, kept beside the library): every kernel of it, the statistics
    launch and the dK/dV and dQ kernels at each of the five padded head
    dims, spills 0 bytes (the consumers' accumulators fit their 240
    registers)."""
    import re

    from repro_torch.kernels import _build

    text = _build.report("flash_attention_bwd")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    kernels = re.findall(r"Compiling entry function '(\w+)'", text)
    assert len(kernels) == 11 and len(spills) == len(kernels), (kernels, spills)
    assert all(st == "0" and ld == "0" for st, ld in spills), text


def test_attn_core_bf16_backward_takes_the_kernel(cuda):
    """A bf16 ``attn_core`` gradient on the card is one backward-kernel call
    and no chunked recompute; an f32 one is the chunked recompute and no
    backward-kernel call; the two agree within the card check."""
    from repro_torch.kernels.flash_attention import bwd_within, flash_attention_bwd
    from repro_torch.models.attention import _KernelAttention, attn_core

    q, k, v = _attn_inputs(2, 8, 2, 300, 64, torch.bfloat16, cuda, seed=5)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    before = flash_attention_bwd.launches, _KernelAttention.plain_backward_calls
    grads = torch.autograd.grad((attn_core(*leaves, causal=True) ** 2).sum(), leaves)
    assert (flash_attention_bwd.launches, _KernelAttention.plain_backward_calls) == \
        (before[0] + 1, before[1])
    f32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad((attn_core(*f32, causal=True) ** 2).sum(), f32)
    assert (flash_attention_bwd.launches, _KernelAttention.plain_backward_calls) == \
        (before[0] + 1, before[1] + 1)
    for g, w in zip(grads, want):
        assert bwd_within(g, w) <= 1.0
