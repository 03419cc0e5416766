"""Robust aggregation parity: the port's plain ``robust_trimmed`` and its four
``Aggregator`` families against the JAX package's, on the same numpy inputs.

Tolerances.  ``robust_trimmed`` ranks by exact comparisons, so the keep
sets are equal; the coordinate median sums at most two kept values and is
held bitwise, and so is the trimmed mean here (both sides add the kept
values in row order on the CPU).  The order-statistic families are
bitwise against JAX.  ``mean`` and ``norm_clip`` sum M weighted products
in another order than XLA (and ``norm_clip`` goes through ``sqrt``, which
differs by an ulp between XLA and torch on the CPU): rtol 1e-6 / atol
1e-6, about M ulps of values of order 1.  Values are rounded to a grid
of 1/2 so that ties really occur.  The JAX side runs under ``jax.jit``
(one compile per shape instead of one per primitive).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.channels.process import check_knobs as jax_check_knobs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.channels.process import check_knobs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _round_inputs(m, p, seed, mask_kind="random"):
    rng = np.random.default_rng(seed)
    x = (np.round(rng.standard_normal((m, p)) * 3.0) / 2.0).astype(np.float32)
    if mask_kind == "empty":
        mask = np.zeros(m, np.float32)
    elif mask_kind == "full":
        mask = np.ones(m, np.float32)
    else:
        mask = (rng.random(m) < 0.7).astype(np.float32)
        mask[0] = 1.0
    zeta = (rng.random(m) + 0.5).astype(np.float32)
    return x, mask, (zeta / zeta.sum()).astype(np.float32)


def _depths(n):
    return sorted({0, max(int(n - 1) // 4, 0), max(int(n - 1) // 2, 0)})


_jax_ref_trim = jax.jit(jref.robust_trimmed)


def _jax_trim(x, mask, n, k, backend, bf16):
    xj = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    args = (xj, jnp.asarray(mask), jnp.float32(n), jnp.float32(k))
    if backend == "jnp":
        return np.array(_jax_ref_trim(*args))
    return np.array(jops.robust_trimmed(*args, backend=backend))


def _port_trim(x, mask, n, k, bf16):
    xt = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    return ops.robust_trimmed(xt, torch.from_numpy(mask), torch.tensor(np.float32(n)),
                              torch.tensor(np.float32(k))).numpy()


@pytest.mark.parametrize("m,p", [(6, 40), (13, 300)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_robust_trimmed_matches_pallas_interpret(m, p, bf16):
    x, mask, _ = _round_inputs(m, p, seed=m * p)
    n = float(mask.sum())
    for k in range(int(n - 1) // 2 + 1):                 # every depth 0 .. floor((n-1)/2)
        want = _jax_trim(x, mask, n, k, "pallas_interpret", bf16)
        np.testing.assert_array_equal(_port_trim(x, mask, n, k, bf16), want, err_msg=f"k={k}")


@pytest.mark.parametrize("m,p", [(1, 7), (20, 567), (64, 33)])
@pytest.mark.parametrize("mask_kind", ["random", "full", "empty"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_robust_trimmed_matches_jax_ref(m, p, mask_kind, bf16):
    x, mask, _ = _round_inputs(m, p, seed=7 * m + p, mask_kind=mask_kind)
    n = float(mask.sum())
    for k in _depths(n):
        got = _port_trim(x, mask, n, k, bf16)
        np.testing.assert_array_equal(got, _jax_trim(x, mask, n, k, "jnp", bf16), err_msg=f"k={k}")
        if n == 0:
            assert not got.any()


def test_median_is_numpy_median_of_participants():
    x, mask, _ = _round_inputs(9, 200, seed=3)
    part = mask > 0.5
    n = float(part.sum())
    got = _port_trim(x, mask, n, (n - 1) // 2, False)
    np.testing.assert_array_equal(got, np.median(x[part], axis=0).astype(np.float32))


def test_plain_robust_trimmed_chunks_leave_the_arithmetic_alone(monkeypatch):
    """The column chunking (a cap on the (M, M, chunk) temporary) gives
    the same bits as one chunk."""
    x, mask, _ = _round_inputs(11, 257, seed=5)
    n = float(mask.sum())
    args = (torch.from_numpy(x), torch.from_numpy(mask), torch.tensor(n), torch.tensor(2.0))
    whole = ref.robust_trimmed(*args)
    monkeypatch.setattr(ref, "_TRIM_CHUNK_ELEMS", 11 * 11 * 5)
    assert torch.equal(ref.robust_trimmed(*args), whole)


def test_nan_rows_rank_as_in_the_reference():
    """A NaN row compares false with everything: rank 0, beats nobody."""
    x, mask, _ = _round_inputs(7, 30, seed=9, mask_kind="full")
    x[2, :10] = np.nan
    x[4, 5:15] = np.inf
    for k in (0, 1, 3):
        want = _jax_trim(x, mask, 7.0, k, "jnp", False)
        np.testing.assert_array_equal(_port_trim(x, mask, 7.0, k, False), want)


# ---------------------------------------------------------------------------
# the four aggregator families
# ---------------------------------------------------------------------------

FAMILIES = {
    "mean": {},
    "trimmed_mean": {"trim_frac": 0.34},
    "coordinate_median": {},
    "norm_clip": {"clip_norm": 1.5},
}


def test_registry_lists_the_jax_families():
    assert sorted(tagg.registered_aggregators()) == sorted(jagg.registered_aggregators())
    for fam in FAMILIES:
        assert tagg.example_aggregator(fam) == convert.aggregator(jagg.example_aggregator(fam))


def test_make_aggregator_rejects_unknown_and_missing_knobs():
    with pytest.raises(ValueError, match="unknown knob"):
        tagg.make_aggregator("trimmed_mean", trim=0.2)
    with pytest.raises(ValueError, match="unknown family"):
        tagg.make_aggregator("krum")


@pytest.mark.parametrize("kwargs", [dict(trim=1), dict(), dict(trim_frac=0.1, extra=2)])
def test_check_knobs_matches_jax(kwargs):
    for cls in (tagg.TrimmedMeanAgg, tagg.NormClipAgg):
        jcls = jagg.registered_aggregators()[cls.FAMILY]
        errs = []
        for fn, c in ((check_knobs, cls), (jax_check_knobs, jcls)):
            try:
                fn(c, "label", kwargs)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("m,p,mask_kind", [(6, 40, "random"), (20, 567, "random"),
                                           (9, 100, "full"), (5, 30, "empty")])
def test_aggregator_matches_jax(family, m, p, mask_kind):
    x, mask, zeta = _round_inputs(m, p, seed=m + p, mask_kind=mask_kind)
    n = np.float32(mask.sum())
    jinst = jagg.make_aggregator(family, **FAMILIES[family])
    tinst = convert.aggregator(jinst)
    assert tinst == tagg.make_aggregator(family, **FAMILIES[family])
    want = np.array(jax.jit(jinst.aggregate)(jnp.asarray(x), jnp.asarray(mask),
                                             jnp.asarray(zeta), jnp.asarray(n)))
    got = tinst.aggregate(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(zeta),
                          torch.tensor(n)).numpy()
    if family in ("mean", "norm_clip"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if mask_kind == "empty":
        assert not got.any()


def test_explicit_mean_is_bitwise_the_default_path():
    from repro_torch.fl.round import dispatch_aggregate

    x, mask, zeta = _round_inputs(20, 567, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(zeta),
            torch.tensor(mask.sum()))
    default = dispatch_aggregate(None, *args)
    assert torch.equal(dispatch_aggregate(tagg.MeanAgg(), *args), default)
    # Eq. 7 as the round computed it before aggregators existed
    xt, mt, zt, n = args
    assert torch.equal(ops.weighted_aggregate(xt, mt * zt * (20 / n.clamp_min(1.0))), default)


@pytest.mark.parametrize("family", ["trimmed_mean", "coordinate_median"])
def test_order_statistic_families_ignore_zeta(family):
    x, mask, zeta = _round_inputs(8, 64, seed=2)
    agg = tagg.make_aggregator(family, **FAMILIES[family])
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    n = torch.tensor(mask.sum())
    a = agg.aggregate(*args, torch.from_numpy(zeta), n)
    b = agg.aggregate(*args, torch.full((8,), 1.0 / 8), n)
    assert torch.equal(a, b)


def test_trim_depths_follow_the_jax_formulas():
    """``floor(clip(trim_frac) * n)`` clamped to ``floor((n-1)/2)``, in f32 on
    the tensors' device, for every n of a 20-client round."""
    x = np.zeros((20, 3), np.float32)
    jit_agg = jax.jit(lambda inst, *a: inst.aggregate(*a), static_argnums=0)
    for n in range(0, 21):
        mask = np.zeros(20, np.float32)
        mask[:n] = 1.0
        x[:, 0] = np.arange(20, dtype=np.float32)
        for frac in (0.0, 0.1, 0.34, 0.5, 0.9):
            jinst = jagg.make_aggregator("trimmed_mean", trim_frac=frac)
            want = np.array(jit_agg(jinst, jnp.asarray(x), jnp.asarray(mask),
                                    jnp.full((20,), 0.05), jnp.float32(n)))
            got = convert.aggregator(jinst).aggregate(
                torch.from_numpy(x), torch.from_numpy(mask), torch.full((20,), 0.05),
                torch.tensor(float(n))).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"n={n} frac={frac}")
