"""The rank count of ``csrc/robust_trimmed.cu``, mirrored in torch on the CPU.

The kernel cannot run here, so its arithmetic is mirrored op for op and
held against the plain version ``ref.robust_trimmed`` (the semantics of
record, itself held against the JAX package in ``test_torch_robust_agg.py``):

* each column's M values sit in a bucket of MB slots (8, 16, 32 or 64, the
  launcher's choice for M); a row that does not participate, and a slot
  past M, is held as NaN;
* for each pair a < b one compare, ``key_a <= key_b``: rank_b gains it and
  rank_a, which starts at the count of not-NaN slots after a, loses it.
  The pairs are met block by block, as the kernel meets them: the rows of
  block ib (8 rows) against each other, then against every later block
  that holds rows; counts are f32, exact at these sizes;
* a NaN slot's rank is 0; participating rows of rank in [k, n - k) are
  summed in row order and divided by max(n - 2k, 1).

The ranks must equal the reference predicate's
``(x_j < x_i) | (x_j == x_i & j < i)`` over participating rows, and the
whole result must equal ``ref.robust_trimmed`` bit for bit (NaN where it
has NaN, the sign of zero included), at every bucket edge of M, on random
values on a grid of 1/2 (ties) and on a table of NaN, +-inf, +-0 and ties,
with masks random, full and empty.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

EDGES = (1, 2, 8, 9, 16, 17, 32, 33, 63, 64)
ROWS = 8                        # rows a block of the kernel's rank loop (kRows)
SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, 0.5, -0.0],
                   np.float32)


def bucket(m):
    """The register bucket the launcher picks for M rows."""
    return next(b for b in (8, 16, 32, 64) if m <= b)


def kernel_rank(x, mask, mb, rows=ROWS):
    """(M, P) f32, (M,) mask -> (MB, P) f32 ranks as the kernel counts them,
    block by block (slots past M and non-participants hold NaN keys), and
    the keys."""
    m, p = x.shape
    key = torch.full((mb, p), float("nan"))
    part = mask > 0.5
    key[:m] = torch.where(part[:, None], x, float("nan"))
    notnan = (key == key).to(torch.float32)
    rank = notnan.flip(0).cumsum(0).flip(0) - notnan          # not-NaN slots after each
    nb = -(-m // rows)
    for ib in range(nb):                                      # block ib's rows play a
        blk = slice(ib * rows, (ib + 1) * rows)
        ka, ra = key[blk], torch.zeros((rows, p))
        for b in range(1, rows):                              # the block's own pairs
            s = (ka[:b] <= ka[b]).to(torch.float32)           # slot a < b beats slot b
            ra[b] += s.sum(0)
            ra[:b] -= s
        for g in range(ib + 1, nb):                           # later blocks holding rows
            for j in range(g * rows, (g + 1) * rows):
                s = (ka <= key[j]).to(torch.float32)
                rank[j] += s.sum(0)
                ra -= s
        rank[blk] += ra
    return torch.where(key == key, rank, 0.0), key


def kernel_trimmed(x, mask, n, k, mb):
    """The kernel's whole result, mirrored: keep by rank, sum in row order,
    divide as the kernel does."""
    m, p = x.shape
    rank, key = kernel_rank(x, mask, mb)
    n = torch.tensor(n, dtype=torch.float32)
    k = torch.tensor(k, dtype=torch.float32).clamp_min(0.0)
    hi = n - k
    acc = torch.zeros(p)
    for r in range(m):
        rf = rank[r]
        keep = bool(mask[r] > 0.5) & (rf >= k) & (rf < hi)
        acc = torch.where(keep, acc + key[r], acc)
    return acc / torch.clamp_min(n - 2.0 * k, 1.0)


def reference_rank(x, mask):
    """The reference predicate's rank, as ``ref.robust_trimmed`` counts it."""
    m = x.shape[0]
    i = torch.arange(m)
    tie_lo = (i[None, :] < i[:, None])[:, :, None]
    beats = (x[None, :, :] < x[:, None, :]) | ((x[None, :, :] == x[:, None, :]) & tie_lo)
    return (beats & (mask > 0.5)[None, :, None]).sum(dim=1)


def inputs(m, values, mask_kind, seed, p=97):
    rng = np.random.default_rng(seed)
    if values == "grid":
        x = (np.round(rng.standard_normal((m, p)) * 3.0) / 2.0).astype(np.float32)
    else:
        x = rng.choice(SPECIAL, size=(m, p))
        x[:, :len(SPECIAL)] = np.resize(SPECIAL, (m, len(SPECIAL)))    # every value in every row
    if mask_kind == "full":
        mask = np.ones(m, np.float32)
    elif mask_kind == "empty":
        mask = np.zeros(m, np.float32)
    else:
        mask = (rng.random(m) < 0.6).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(mask)


def same_bits(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and \
        torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("m", EDGES)
@pytest.mark.parametrize("values", ["grid", "special"])
@pytest.mark.parametrize("mask_kind", ["random", "full"])
def test_kernel_rank_equals_the_reference_predicate(m, values, mask_kind):
    x, mask = inputs(m, values, mask_kind, seed=m)
    want = reference_rank(x, mask)
    part = mask > 0.5
    for mb in sorted({bucket(m), 64}):                 # the padding slots change nothing
        got, _ = kernel_rank(x, mask, mb)
        assert torch.equal(got[:m][part], want[part].to(torch.float32)), mb


@pytest.mark.parametrize("m", EDGES)
@pytest.mark.parametrize("values", ["grid", "special"])
@pytest.mark.parametrize("mask_kind", ["random", "full", "empty"])
def test_kernel_arithmetic_equals_plain_robust_trimmed(m, values, mask_kind):
    x, mask = inputs(m, values, mask_kind, seed=100 + m)
    n = float(mask.sum())
    for k in range(max(int(n) - 1, 0) // 2 + 1):      # every depth up to the median
        want = ref.robust_trimmed(x, mask, torch.tensor(n), torch.tensor(float(k)))
        got = kernel_trimmed(x, mask, n, float(k), bucket(m))
        assert same_bits(got, want), (k, got, want)


def test_special_table_hits_every_case():
    """The table really holds NaN, both infinities, both zeros and ties."""
    x, _ = inputs(9, "special", "full", seed=0)
    assert bool(torch.isnan(x).any()) and bool(torch.isposinf(x).any())
    assert bool(torch.isneginf(x).any())
    zeros = x[x == 0]
    assert bool(torch.signbit(zeros).any()) and not bool(torch.signbit(zeros).all())
    assert int((x[0] == 0.5).sum()) >= 2
