"""Why the tensor-core route of the port's ``flash_attention`` splits P.

A plain-torch emulation of the kernel's arithmetic
(``csrc/flash_attention_tc.cu``: 128-key tiles up to D = 128 and 64-key
tiles at D = 256, a causal online softmax on
f32 logits of bf16 q and k, f32 accumulation, the output rounded once to
bf16) meets the card check's tolerance (rtol 2^-8 / atol 1e-4, here
against an f64 softmax) when P enters P.V as two bf16 terms,
P_hi = bf16(P) and P_lo = bf16(P - P_hi), and misses it with one bf16
rounding of P, as SDPA and other tensor-core flash kernels round it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _emulate(q, k, v, split, tile):
    """Causal attention over (H, S, D) bf16 inputs as the tensor-core kernel
    computes it: f32 logits, an online softmax over key tiles, P rounded to
    bf16 once or split into two bf16 terms, f32 accumulation, the output
    rounded once to bf16."""
    h, s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((h, s, 1), -math.inf)
    l = torch.zeros((h, s, 1))
    acc = torch.zeros((h, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        kt, vt = kf[:, k0:k0 + tile], vf[:, k0:k0 + tile]
        logits = (qf @ kt.transpose(1, 2)) / math.sqrt(d)
        logits = logits.masked_fill(torch.arange(k0, k0 + kt.shape[1])[None, :] > rows, -math.inf)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        p = torch.exp(logits - m_use)
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vt
        if split:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def _exact(q, k, v):
    s, d = q.shape[1:]
    logits = (q.double() @ k.double().transpose(1, 2)) / math.sqrt(d)
    logits = logits.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), -math.inf)
    return torch.softmax(logits, -1) @ v.double()


@pytest.mark.parametrize("h,s,d,tile", [(4, 300, 32, 128), (4, 257, 72, 128), (2, 300, 256, 64)])
def test_split_p_meets_the_card_tolerance_and_one_rounding_does_not(h, s, d, tile):
    rng = np.random.default_rng(s * d)
    q, k, v = (torch.from_numpy((rng.standard_normal((h, s, d)) * sd).astype(np.float32))
               .to(torch.bfloat16) for sd in (0.5, 0.5, 1.0))
    want = _exact(q, k, v)
    outside = {}
    for split in (True, False):
        got = _emulate(q, k, v, split, tile).double()
        outside[split] = int((~torch.isclose(got, want, rtol=2.0 ** -8, atol=1e-4)).sum())
    assert outside[True] == 0
    assert outside[False] > 0.02 * want.numel()
