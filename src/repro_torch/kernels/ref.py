"""Plain PyTorch versions of the port's kernels.

The semantics of record, twin of ``repro/kernels/ref.py``: the CPU path of
``repro_torch.kernels.ops`` and the oracle every CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-6  # float32-safe: 1.0 - 1e-9 rounds to 1.0 and poisons KL with 0*log(0)


def bernoulli_kl(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p = p.clamp(_EPS, 1.0 - _EPS)
    q = q.clamp(_EPS, 1.0 - _EPS)
    return p * torch.log(p / q) + (1.0 - p) * torch.log((1.0 - p) / (1.0 - q))


# ---------------------------------------------------------------------------
# glr_scan — recompute detector (prefix sum rebuilt from the raw history)
# ---------------------------------------------------------------------------

def glr_scan(hist: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """GLR change-point statistic for each channel.

    hist (N, H) reward streams (entries at index >= counts[i] ignored);
    counts (N,) valid lengths.  Returns (N,)
    sup_s [ s*kl(mu_1:s, mu_1:n) + (n-s)*kl(mu_s+1:n, mu_1:n) ], -inf
    where n < 2, in the history's dtype (f32 on the main path; f64 gives
    an accuracy yardstick).
    """
    h = hist.shape[-1]
    idx = torch.arange(h, device=hist.device)
    n = counts.to(torch.int32)[:, None]                        # (N, 1)
    masked = torch.where(idx[None, :] < n, hist, 0.0)
    prefix = torch.cumsum(masked, dim=-1)
    total = prefix[:, -1:]                                     # the window total: the last prefix
    s = (idx + 1).to(torch.float32)[None, :]
    n_f = n.to(torch.float32)
    mu_all = total / n_f.clamp_min(1.0)
    mu_a = prefix / s
    mu_b = (total - prefix) / (n_f - s).clamp_min(1.0)
    stat = s * bernoulli_kl(mu_a, mu_all) + (n_f - s) * bernoulli_kl(mu_b, mu_all)
    valid = idx[None, :] + 1 <= n - 1
    return torch.where(valid, stat, -torch.inf).amax(dim=-1)


_U = 2.0 ** -24      # f32 unit roundoff


def glr_scan_bounds(hist: torch.Tensor, counts: torch.Tensor):
    """Where an f32 ``glr_scan`` of a real-valued history may land: per row,
    ``(lo, hi)`` (f64, -inf where n < 2) around the statistic's exact value,
    for an implementation that rounds each prefix sum and the window total
    once to f32 (the kernel's f64 scan, and ``glr_scan`` on the CPU, whose
    f32 ``cumsum`` adds in f64) and then evaluates the split term in f32
    as ``csrc/glr_kl.cuh`` does, op by op.

    The bound is the split term's first-order forward error.  At a split
    (s, n) with exact prefix P and total W (a = P/s, b = (W-P)/(n-s),
    m = W/n, every mean clipped to [1e-6, 1-1e-6] as in f32), each rounding
    moves the result by at most ``u`` (2^-24) times its coefficient: the
    prefix ``|K_p(a,m) - K_p(b,m)| P``, the total ``|K_p(b,m)| W`` plus
    its share through the mean, the three means' divisions and the
    subtraction W - P, and inside each KL term the division p/q (``p``),
    the two ``1 - x`` and the second division (``1 - p`` each), each
    ``log`` (at most 1 ulp: ``2 p |log(p/q)|``, ``2 (1-p) |log(.)|``) and
    the products and sums (their own magnitudes); K_p(p, q) =
    log(p/q) - log((1-p)/(1-q)) is the KL's slope in p.  Near the window
    mean the logs' arguments sit near 1 and those terms dominate, which
    is where a rule tied to the plain version's own error failed.  The
    sum of the terms, with 1 % for the second order, is the split's bound
    E; then ``lo = max_s (f_s - E_s)`` and ``hi = max_s (f_s + E_s)``
    bound the maximum.  ``f_s`` is evaluated in f64 with the f32 clip
    constants."""
    f64 = torch.float64
    x = hist.to(f64)
    h = x.shape[-1]
    idx = torch.arange(h, device=x.device)
    n = counts.to(torch.int64)[:, None]
    masked = torch.where(idx[None, :] < n, x, 0.0)
    P = torch.cumsum(masked, dim=-1)
    W = P[:, -1:]
    s = (idx + 1).to(f64)[None, :]
    n_f = n.to(f64)
    r = (n_f - s).clamp_min(1.0)
    lo_c, hi_c = float(torch.tensor(_EPS, dtype=torch.float32)), \
        float(torch.tensor(1.0 - _EPS, dtype=torch.float32))
    clip = lambda v: v.clamp(lo_c, hi_c)
    a, b, m = clip(P / s), clip((W - P) / r), clip(W / n_f.clamp_min(1.0))

    def kl_terms(p):
        l1, l2 = torch.log(p / m), torch.log((1.0 - p) / (1.0 - m))
        k = p * l1 + (1.0 - p) * l2
        inner = p * (1.0 + 3.0 * l1.abs()) + (1.0 - p) * (3.0 + 4.0 * l2.abs()) + k.abs()
        return k, l1 - l2, (m - p) / (m * (1.0 - m)), inner

    k_a, kp_a, kq_a, c_a = kl_terms(a)
    k_b, kp_b, kq_b, c_b = kl_terms(b)
    f = s * k_a + r * k_b
    through_m = m * (s * kq_a.abs() + r * kq_b.abs())
    coef = ((kp_a - kp_b).abs() * P                      # the prefix's rounding
            + kp_b.abs() * W + through_m                 # the total's
            + kp_a.abs() * P                             # P / s
            + 2.0 * kp_b.abs() * (W - P)                 # W - P, then / (n - s)
            + through_m                                  # W / n
            + s * c_a + r * c_b                          # inside the two KL terms
            + s * k_a.abs() + r * k_b.abs() + f.abs())   # s K_a, r K_b, their sum
    err = 1.01 * _U * coef
    valid = idx[None, :] + 1 <= n - 1
    neg = torch.tensor(-torch.inf, dtype=f64, device=x.device)
    lo = torch.where(valid, f - err, neg).amax(dim=-1)
    hi = torch.where(valid, f + err, neg).amax(dim=-1)
    return lo, hi


# ---------------------------------------------------------------------------
# glr_step — streaming (carried prefix-sum) detector
# ---------------------------------------------------------------------------
#
# Per channel the detector carries
#   cum[j]   cumulative stream total C_k for the sample k last written to
#            ring slot j
#   total    running stream total C_c (c = samples since restart)
#   base     C_{c-n}, n = min(c, H): the total just before the window's
#            oldest sample (0 until the ring wraps)
# so the window prefix at split s is ``cum[slot(s)] - base`` and the window
# total is ``total - base``.  For {0, 1} rewards every quantity is an exact
# small integer.


def glr_split_offsets(h: int, device=None) -> torch.Tensor:
    """Powers of two <= h — the geometric split-grid offsets."""
    offs = []
    d = 1
    while d <= h:
        offs.append(d)
        d *= 2
    return torch.tensor(offs, dtype=torch.int64, device=device)


def glr_stream_append(cum, total, base, counts, r_vec, sched):
    """Append one masked sample per channel to the streaming state.

    cum (N, H); total/base (N,); counts (N,) samples since restart
    (pre-append, float or int); r_vec (N,) rewards; sched (N,) bool.
    Returns the updated ``(cum, total, base)``; the evicted slot's ``cum``
    becomes ``base`` once the ring is full.
    """
    n, h = cum.shape
    c_prev = counts.to(torch.int64)
    w = torch.remainder(c_prev, h)                 # ring slot of this append
    rows = torch.arange(n, device=cum.device)
    evict = cum[rows, w]                           # C_{c-H} when the ring is full
    full = c_prev >= h
    base2 = torch.where(sched & full, evict, base)
    total2 = torch.where(sched, total + r_vec, total)
    cum2 = cum.index_put((rows, w), torch.where(sched, total2, evict))
    return cum2, total2, base2


def _stream_stat_terms(P, W, s, n):
    """GLR statistic terms at split positions ``s`` of windows of length
    ``n``; the division guards are the identity on valid splits."""
    s_f = s.to(torch.float32).clamp_min(1.0)
    n_f = n.to(torch.float32)
    mu_all = W / n_f.clamp_min(1.0)
    mu_a = P / s_f
    mu_b = (W - P) / (n_f - s_f).clamp_min(1.0)
    return (s_f * bernoulli_kl(mu_a, mu_all)
            + (n_f - s_f) * bernoulli_kl(mu_b, mu_all))


def glr_stream_stat(cum, total, base, counts, split_grid: str = "all"):
    """GLR statistic from the carried prefix state, (N,); -inf where n < 2.

    ``"all"``: every split (per ring slot j, s_j = n - ((w - j) mod H), w
    the newest slot).  ``"geometric"``: only the splits at power-of-two
    distance from either window end, gathered.
    """
    n_chan, h = cum.shape
    c = counts.to(torch.int64)[:, None]
    n = c.clamp_max(h)
    W = (total - base)[:, None]
    if split_grid == "geometric":
        d = glr_split_offsets(h, cum.device)[None, :]                # (1, L)
        s = torch.cat([d.expand(n_chan, -1), n - d], dim=1)
        slot = torch.remainder(c - n + s - 1, h)                      # slot of sample s
        P = torch.take_along_dim(cum, slot, dim=1) - base[:, None]
    elif split_grid == "all":
        j = torch.arange(h, device=cum.device)[None, :]
        w_last = torch.remainder(c - 1, h)
        s = n - torch.remainder(w_last - j, h)                        # split at slot j
        P = cum - base[:, None]
    else:
        raise ValueError(f"unknown split_grid {split_grid!r}; use 'all' or 'geometric'")
    stat = _stream_stat_terms(P, W, s, n)
    valid = (s >= 1) & (s <= n - 1)
    return torch.where(valid, stat, -torch.inf).amax(dim=-1)


def glr_step(cum, total, base, counts, r_vec, sched, split_grid: str = "all"):
    """Fused detector step: ``glr_stream_append`` then ``glr_stream_stat``
    on the post-append state.  Returns ``(cum, total, base, stats)``."""
    cum2, total2, base2 = glr_stream_append(cum, total, base, counts, r_vec, sched)
    c2 = counts.to(torch.int64) + sched.to(torch.int64)
    stats = glr_stream_stat(cum2, total2, base2, c2, split_grid)
    return cum2, total2, base2, stats


# ---------------------------------------------------------------------------
# glr_step_tenants — the detector step over the scheduler service's slots,
# in place
# ---------------------------------------------------------------------------
#
# The slot state is cum (R, N, H), total/base (R, N); a serve step names B
# rows by ``slots`` (B,).  Live slots are unique and no other row names a
# live row's slot, so the writes below never collide (the rows that are not
# live write back what they read).


def glr_tenants_append(cum, total, base, slots, live, counts, r_vec, sched):
    """``glr_stream_append`` for the rows ``slots`` where ``live``, in place
    on the slot state; ``counts``/``r_vec``/``sched`` are (B, N).  Never
    waits on the device."""
    n_chan, h = cum.shape[1:]
    idx = slots.to(torch.int64)
    c_prev = counts.to(torch.int64)
    w = torch.remainder(c_prev, h)                            # (B, N) ring position
    rows = idx[:, None].expand_as(w)
    chans = torch.arange(n_chan, device=cum.device)[None, :].expand_as(w)
    evict = cum[rows, chans, w]
    write = sched & live[:, None]
    tot, bas = total.index_select(0, idx), base.index_select(0, idx)
    base2 = torch.where(write & (c_prev >= h), evict, bas)
    total2 = torch.where(write, tot + r_vec, tot)
    cum.index_put_((rows, chans, w), torch.where(write, total2, evict))
    total.index_copy_(0, idx, total2)
    base.index_copy_(0, idx, base2)


def glr_step_tenants(cum, total, base, slots, live, detect, counts, r_vec, sched,
                     split_grid: str = "all"):
    """The rows ``slots`` (B,) of the slot state go through ``glr_step``:
    the append is written back in place where ``live`` (B,); the statistic
    (B, N) is returned where ``detect`` (B,), -inf elsewhere.  ``counts``
    (B, N) are the samples before the append.  Row for row equal to
    ``glr_step`` on the gathered rows."""
    glr_tenants_append(cum, total, base, slots, live, counts, r_vec, sched)
    b, n_chan = counts.shape
    h = cum.shape[-1]
    idx = slots.to(torch.int64)
    c2 = counts.to(torch.int64) + sched.to(torch.int64)
    stats = glr_stream_stat(cum.index_select(0, idx).reshape(b * n_chan, h),
                            total.index_select(0, idx).reshape(-1),
                            base.index_select(0, idx).reshape(-1), c2.reshape(-1),
                            split_grid).reshape(b, n_chan)
    return torch.where((detect & live)[:, None], stats, -torch.inf)


# ---------------------------------------------------------------------------
# weighted_aggregate
# ---------------------------------------------------------------------------

def weighted_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Eq. 7: out[p] = sum_m scale[m] * updates[m, p]; (M, P) any float
    dtype, (M,) f32 -> (P,) f32."""
    return (scale.to(torch.float32)[:, None] * updates.to(torch.float32)).sum(dim=0)


# ---------------------------------------------------------------------------
# robust_trimmed — masked per-coordinate trimmed mean / median
# ---------------------------------------------------------------------------

_TRIM_CHUNK_ELEMS = 1 << 28     # cap on an (M, M, chunk) temporary


def robust_trimmed(updates: torch.Tensor, mask: torch.Tensor,
                   n_succ: torch.Tensor, k_trim: torch.Tensor) -> torch.Tensor:
    """Masked coordinate-wise trimmed mean by rank selection.

    updates (M, P) any float dtype; mask (M,) f32 {0, 1}; n_succ the
    participant count and k_trim the integer-valued trim depth, 0-d f32.
    Per coordinate, a participating row's rank is the count of
    participating rows strictly below it, ties broken by row index; rows
    of rank in [k, n - k) are kept and their sum (in row order) is divided
    by ``max(n - 2k, 1)``.  ``k = floor((n-1)/2)`` gives the coordinate
    median.  Zeros when no row participates.  Returns (P,) f32.

    The columns are taken in chunks so that the (M, M, chunk) comparison
    tensor stays near 2**28 elements; every column's arithmetic is the
    same whatever the chunk.
    """
    x = updates.to(torch.float32)
    m, p = x.shape
    part = mask > 0.5
    i = torch.arange(m, device=x.device)
    tie_lo = (i[None, :] < i[:, None])[:, :, None]             # j beats i on ties
    k = torch.as_tensor(k_trim, dtype=torch.float32, device=x.device).clamp_min(0.0)
    n = torch.as_tensor(n_succ, dtype=torch.float32, device=x.device)
    denom = (n - 2.0 * k).clamp_min(1.0)
    chunk = max(1, _TRIM_CHUNK_ELEMS // max(m * m, 1))
    out = torch.empty((p,), dtype=torch.float32, device=x.device)
    for c0 in range(0, p, chunk):
        xc = x[:, c0:c0 + chunk]
        beats = (xc[None, :, :] < xc[:, None, :]) | ((xc[None, :, :] == xc[:, None, :]) & tie_lo)
        rank = (beats & part[None, :, None]).sum(dim=1).to(torch.float32)   # (M, chunk)
        keep = part[:, None] & (rank >= k) & (rank < n - k)
        kept = torch.where(keep, xc, 0.0)
        acc = torch.zeros((xc.shape[1],), dtype=torch.float32, device=x.device)
        for r in range(m):                                     # row order
            acc = acc + kept[r]
        out[c0:c0 + chunk] = acc / denom
    return out


# ---------------------------------------------------------------------------
# flash_attention — blockwise grouped-query attention, forward
# ---------------------------------------------------------------------------

def mha_attention(
    q: torch.Tensor,          # (B, Hq, S, D)
    k: torch.Tensor,          # (B, Hkv, S, D)
    v: torch.Tensor,          # (B, Hkv, S, D)
    causal: bool = True,
    window: int = 0,          # 0 => full; else sliding window of this width
    scale=None,
) -> torch.Tensor:
    """Grouped-query attention, the naive O(S^2) oracle: query head h reads
    KV head h // (Hq / Hkv); f32 logits and softmax; masked keys get -inf
    (causal: k <= q; window: k > q - window); the output in q's dtype."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k_exp = k.repeat_interleave(group, dim=1)
    v_exp = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_exp.float()) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    logits.masked_fill_(~mask, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v_exp.float())
    return out.to(q.dtype)
