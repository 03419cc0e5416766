"""The port's adversarial channel family and the legacy env shims.

``AdversarialProcess`` follows the JAX family in distribution (torch's
generator is not threefry): the same seed gives the same table; the
per-round flip rate and the Good share of the first row lie within
binomial bounds (5 standard deviations plus one count); the table is
{0, 1}, the canonical table form with the ``"mean"`` matcher hint, as the
JAX family realizes.  ``random_piecewise_env`` and
``random_adversarial_env`` equal realizing their families.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.channels import AdversarialProcess as JaxAdversarial  # noqa: E402
from repro.core.channels import random_adversarial_env as jax_adversarial  # noqa: E402
from repro_torch.core.channels import (  # noqa: E402
    FORM_TABLE,
    AdversarialProcess,
    PiecewiseProcess,
    make_scenario,
    random_adversarial_env,
    random_piecewise_env,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _within(count, n, p, sigmas=5.0):
    return abs(count - n * p) <= sigmas * math.sqrt(n * p * (1.0 - p)) + 1.0


def test_deterministic_per_seed():
    proc = AdversarialProcess(n_channels=5, horizon=400, flip_prob=0.05)
    a, b = proc.realize(_gen(3), device="cpu"), proc.realize(_gen(3), device="cpu")
    assert torch.equal(a.table, b.table)
    assert not torch.equal(a.table, proc.realize(_gen(4), device="cpu").table)


@pytest.mark.parametrize("flip_prob, good_frac", [(0.002, 0.5), (0.01, 0.5), (0.05, 0.3)])
def test_flip_rate_and_good_share_within_binomial_bounds(flip_prob, good_frac):
    n, horizon, seeds = 8, 4000, 8
    flips = starts_good = 0
    for seed in range(seeds):
        table = AdversarialProcess(n, horizon, flip_prob, good_frac).realize(
            _gen(seed), device="cpu").table
        assert set(torch.unique(table).tolist()) <= {0.0, 1.0}
        flips += int((table[1:] != table[:-1]).sum())
        starts_good += int(table[0].sum())
    assert _within(flips, seeds * n * (horizon - 1), flip_prob)
    # row 0 is the start XOR round 0's flips: Good with prob
    # good_frac (1 - flip_prob) + (1 - good_frac) flip_prob
    p0 = good_frac * (1 - flip_prob) + (1 - good_frac) * flip_prob
    assert _within(starts_good, seeds * n, p0)


def test_table_form_and_mean_hint_as_jax():
    env = AdversarialProcess(n_channels=6, horizon=50).realize(_gen(0), device="cpu")
    jenv = jax_adversarial(jax.random.PRNGKey(0), 6, 50)
    assert env.form == FORM_TABLE == jenv.form
    assert env.score_kind == "mean" == jenv.score_kind
    assert tuple(env.table.shape) == tuple(jenv.table.shape) == (50, 6)
    assert env.table.dtype == torch.float32 and env.n_channels == 6
    assert AdversarialProcess.FAMILY == JaxAdversarial.FAMILY == "adversarial"
    assert AdversarialProcess.TRACED == JaxAdversarial.TRACED
    # {0, 1} means: the draw is the table whatever the uniforms
    u = torch.rand(6, generator=_gen(1))
    assert torch.equal(env.sample(7, u), env.table[7])


def test_registry_and_shims():
    proc = make_scenario("adversarial", n_channels=4, horizon=100, flip_prob=0.02)
    assert isinstance(proc, AdversarialProcess)
    with pytest.raises(ValueError, match="missing required knob"):
        make_scenario("adversarial", n_channels=4)
    shim = random_adversarial_env(_gen(5), 4, 100, flip_prob=0.02, device="cpu")
    assert torch.equal(shim.table, proc.realize(_gen(5), device="cpu").table)
    assert shim.score_kind == "mean"
    pw = random_piecewise_env(_gen(6), 5, 300, 3, device="cpu")
    ref = PiecewiseProcess(n_channels=5, horizon=300, n_breakpoints=3).realize(
        _gen(6), device="cpu")
    assert torch.equal(pw.means, ref.means) and torch.equal(pw.breaks, ref.breaks)
    assert pw.score_kind == "ucb" and tuple(pw.breaks.shape) == (3,)
    np.testing.assert_array_equal(np.diff(pw.breaks.numpy()) > 0, True)
