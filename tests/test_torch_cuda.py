"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels
are compiled by ``nvcc`` for sm_90a at first use).  On the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the carried prefix state is bitwise for {0, 1} rewards; the
GLR statistic goes through CUDA's ``logf`` and FMA contraction, rtol 1e-5;
the aggregation sums the same rounded products in row order, rtol 1e-5 /
atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.glr_step import glr_step  # noqa: E402
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
