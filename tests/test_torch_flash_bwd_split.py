"""Which operands the backward kernels must split, and the card's tolerance.

A plain-torch emulation of the arithmetic of ``csrc/flash_attention_bwd.cu``
(bf16 q, k, v, dO and the forward's bf16 output; f32 logits and dO.V^T of
bf16 operands, P = exp2(scale log2(e) q.k - lse log2(e)) and dS = P (dP -
Delta) in f32; P and dS entering the products dV = P^T dO, dK = dS^T Q and
dQ = dS K as bf16 operands with f32 sums, in the kernels' tile order: dK
and dV over 64-key tiles walking the query tiles, dQ over 64-query tiles
walking the key tiles; each output rounded once to bf16; at D = 256 the
kernels hand P over in f32 and dS as its rounded bf16 fragments between
their two warpgroups, which adds no rounding) is held against
an f64 backward of the same bf16 inputs.  The card check is per tensor,
|got - want| <= rtol |want| + atol max|want|, with ``BWD_RTOL`` = 2^-6 and
``BWD_ATOL`` = 2^-7 (``kernels/flash_attention.py``; ``chip_smoke.py``
phases 14 (0) and 18 (0) and ``tests/test_torch_cuda.py`` use the same).
P and dS rounded once to bf16 meet it by a wide margin on causal, windowed
and non-causal inputs at every tile width the kernels use, so neither is
split; a four times tighter check (rtol 2^-8, atol 2^-9) is where the
single rounding falls short and the split (hi + lo terms, as the forward
splits P) would be needed.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import BWD_ATOL, BWD_RTOL  # noqa: E402

LOG2E = 1.4426950408889634
# keys of a dK/dV warpgroup and the query tiles it walks, queries of a dQ warpgroup and the
# key tiles it walks, at every head dim (csrc/flash_attention_bwd.cu)
TILE = 64


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mask(s, causal, window):
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
    m = torch.ones((s, s), dtype=torch.bool)
    if causal:
        m &= j <= i
    if window > 0:
        m &= j > i - window
    return m


def _exact(q, k, v, do, causal, window, scale):
    """f64 forward and backward of (H, S, D) bf16 inputs: out, lse, dq, dk, dv."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    logits = (qd @ kd.transpose(1, 2) * scale).masked_fill(
        ~_mask(q.shape[1], causal, window), -math.inf)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = p @ vd
    ds = p * (dod @ vd.transpose(1, 2) - (dod * out).sum(-1, keepdim=True))
    return out, lse, ds @ kd * scale, ds.transpose(1, 2) @ qd * scale, p.transpose(1, 2) @ dod


def _emulate(q, k, v, do, out, lse, causal, window, scale, split):
    """The backward kernels' arithmetic: f32 from bf16 operands; P and dS
    one bf16 rounding each (or, with ``split``, hi + lo bf16 terms); dK, dV
    for 64-key tiles over 64-query tiles, dQ for 64-query tiles over 64-key
    tiles."""
    bq = bk = TILE
    h, s, d = q.shape
    qf, kf, vf, dof, of = (t.float() for t in (q, k, v, do, out))
    mask = _mask(s, causal, window)
    lse2, sl2 = lse * LOG2E, scale * LOG2E
    delta = (dof * of).sum(-1)

    def tile(i0, i1, j0, j1):
        p = torch.exp2(qf[:, i0:i1] @ kf[:, j0:j1].transpose(1, 2) * sl2 - lse2[:, i0:i1, None])
        p = torch.where(mask[i0:i1, j0:j1], p, 0.0)
        ds = p * (dof[:, i0:i1] @ vf[:, j0:j1].transpose(1, 2) - delta[:, i0:i1, None])
        return p, ds

    def terms(x):
        hi = _bf16(x)
        return (hi, _bf16(x - hi)) if split else (hi,)

    dq, dk, dv = (torch.zeros((h, s, d)) for _ in range(3))
    for j0 in range(0, s, TILE):
        j1 = min(j0 + TILE, s)
        for i0 in range(0, s, bq):
            p, ds = tile(i0, min(i0 + bq, s), j0, j1)
            for t in terms(p):
                dv[:, j0:j1] += t.transpose(1, 2) @ dof[:, i0:i0 + bq]
            for t in terms(ds):
                dk[:, j0:j1] += t.transpose(1, 2) @ qf[:, i0:i0 + bq]
    for i0 in range(0, s, TILE):
        i1 = min(i0 + TILE, s)
        for j0 in range(0, s, bk):
            _, ds = tile(i0, i1, j0, min(j0 + bk, s))
            for t in terms(ds):
                dq[:, i0:i1] += t @ kf[:, j0:j0 + bk]
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


def _excess(got, want, rtol, atol):
    """max(|got - want| - rtol |want|) / (atol max|want|): at most 1 passes."""
    want = want.float()
    return float(((got - want).abs() - rtol * want.abs()).max() / (atol * want.abs().max()))


def _case(h, s, d, causal, window, split, rtol, atol):
    rng = np.random.default_rng(s * d + window)
    q, k, v, do = (torch.from_numpy((rng.standard_normal((h, s, d)) * sd).astype(np.float32))
                   .to(torch.bfloat16) for sd in (0.5, 0.5, 1.0, 1.0))
    scale = 1.0 / math.sqrt(d)
    out, lse, *want = _exact(q, k, v, do, causal, window, scale)
    got = _emulate(q, k, v, do, out.to(torch.bfloat16), lse.float(), causal, window, scale,
                   split)
    return [_excess(g, w, rtol, atol) for g, w in zip(got, want)]


# (H, S, D, causal, window)
CASES = [
    (4, 300, 64, True, 0),            # causal, S not a tile multiple
    (4, 257, 80, False, 0),           # non-causal (hubert's D)
    (4, 300, 96, True, 0),            # phi-3-vision's D
    (2, 300, 128, True, 0),           # dbrx's D
    (2, 300, 256, True, 128),         # recurrentgemma's D, a window
    (4, 300, 64, False, 40),          # non-causal window
    (2, 1024, 64, True, 0),           # a longer causal row
]


@pytest.mark.parametrize("h,s,d,causal,window", CASES)
def test_one_rounding_of_p_and_ds_meets_the_card_tolerance(h, s, d, causal, window):
    excess = _case(h, s, d, causal, window, False, BWD_RTOL, BWD_ATOL)
    assert (BWD_RTOL, BWD_ATOL) == (2.0 ** -6, 2.0 ** -7)
    # dq, dk, dv inside the check with a margin of 2x
    assert max(excess) <= 0.5, excess


def test_a_four_times_tighter_check_would_need_the_split():
    """At rtol 2^-8 / atol 2^-9 one rounding of P and dS misses at D = 128
    (dbrx's head dim) while the hi + lo split meets it: the margin the
    card's tolerance leaves is that of the single rounding."""
    case = (2, 300, 128, True, 0)
    one = _case(*case, False, 2.0 ** -8, 2.0 ** -9)
    split = _case(*case, True, 2.0 ** -8, 2.0 ** -9)
    assert max(one) > 1.0 and max(split) <= 1.0, (one, split)
