"""The port's client availability registry (``repro_torch.core.availability``)
against the JAX package's.

The twin of ``tests/test_availability.py``'s cases (registry plumbing,
eager knob checks, each family's state-machine invariants, the knob grid
over a leading axis), plus each family's ``step`` held to JAX's on JAX's
own uniforms: the uniforms behind ``k_avail`` (``split`` into two for
``markov_churn`` and ``straggler``, none for ``always_on``) go to the port,
and the phase, timer and mask must be bitwise.  ``straggler``'s latency
goes through ``log1p``, where XLA and torch may part by an ulp; its
``floor`` could then differ only where the quotient lies within 1e-5
(relative) of an integer, so the test first asserts that none of its draws
does, then holds the step bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import availability as javail  # noqa: E402
from repro.core.bandits.base import stack_params as jax_stack_params  # noqa: E402
from repro_torch.core import availability as tavail  # noqa: E402
from repro_torch.core.availability import (  # noqa: E402
    DROPPED,
    IDLE,
    WORKING,
    AlwaysOn,
    AvailabilityProcess,
    DropoutRejoin,
    MarkovChurn,
    StragglerLatency,
    example_availability,
    init_availability_state,
    make_availability,
    register_availability,
    registered_availabilities,
)
from repro_torch.core.bandits.base import stack_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
N = 32
AVAIL_TAG = 0xA7A1
FAMILIES = ("always_on", "markov_churn", "straggler", "dropout_rejoin")


def jax_avail_uniforms(proc, key, n):
    """The f32 uniforms behind ``proc``'s JAX draws on ``key``."""
    if proc.FAMILY == "always_on":
        return np.zeros((0,), np.float32)
    if proc.FAMILY in ("markov_churn", "straggler"):
        k0, k1 = jax.random.split(key)
        return np.concatenate([np.array(jax.random.uniform(k0, (n,))),
                               np.array(jax.random.uniform(k1, (n,)))])
    return np.array(jax.random.uniform(key, (n,)))


def _state(n=N):
    return init_availability_state(n, "cpu")


def _uniforms(proc, t, n=N, seed=0):
    return torch.from_numpy(np.random.default_rng(seed * 1000 + t).random(
        proc.n_uniforms(n)).astype(np.float32))


def _run(proc, rounds, sched=None):
    """Step ``rounds`` times; returns (final state, (R, N) avail history)."""
    astate = _state()
    grants = torch.zeros(N) if sched is None else sched
    hist = []
    for t in range(rounds):
        astate, avail = proc.step(_uniforms(proc, t), t, astate, grants)
        hist.append(avail)
    return astate, torch.stack(hist)


# ---------------------------------------------------------------------------
# registry plumbing
# ---------------------------------------------------------------------------

def test_registry_enumerates_the_jax_families():
    fams = registered_availabilities()
    assert sorted(fams) == sorted(javail.registered_availabilities())
    for name, cls in fams.items():
        proc = example_availability(name)
        assert isinstance(proc, cls) and isinstance(proc, AvailabilityProcess)
        jproc = javail.example_availability(name)
        assert {f: float(v) for f, v in proc.params("cpu").items()} == pytest.approx(
            {f: float(v) for f, v in jproc.params().items()})


def test_make_availability_validates_eagerly():
    with pytest.raises(ValueError, match="unknown family"):
        make_availability("nope")
    with pytest.raises(ValueError, match="p_drop"):
        make_availability("markov_churn", p_drop=0.1, bogus_knob=3)
    with pytest.raises(ValueError, match="unknown family"):
        example_availability("nope")
    assert make_availability("markov_churn", p_drop=0.1, p_rejoin=0.9).p_drop == 0.1


def test_duplicate_and_unnamed_families_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        register_availability(type("Dup", (AlwaysOn,), {"FAMILY": "always_on"}))
    with pytest.raises(ValueError, match="no FAMILY"):
        register_availability(type("NoName", (AvailabilityProcess,), {"FAMILY": ""}))


# ---------------------------------------------------------------------------
# state-machine invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_families_produce_binary_masks_and_valid_phases(family):
    proc = example_availability(family)
    astate, hist = _run(proc, 12, (torch.arange(N) < 4).to(torch.float32))
    assert bool(((hist == 0.0) | (hist == 1.0)).all())
    assert bool(((astate["phase"] >= IDLE) & (astate["phase"] <= DROPPED)).all())
    assert astate["phase"].dtype == torch.int32
    assert bool((astate["timer"] >= 0.0).all())


def test_always_on_never_blocks():
    _, hist = _run(AlwaysOn(), 8)
    assert bool((hist == 1.0).all())


def test_markov_churn_edge_rates():
    _, hist = _run(MarkovChurn(p_drop=0.0, p_rejoin=0.5), 10)
    assert bool((hist == 1.0).all())
    _, hist = _run(MarkovChurn(p_drop=1.0, p_rejoin=1.0), 4)
    assert bool((hist[0] == 0.0).all()) and bool((hist[1] == 1.0).all())
    assert bool((hist[2] == 0.0).all())


def test_straggler_granted_clients_go_working_then_return():
    proc = StragglerLatency(slow_frac=1.0, slow_latency=3.0)
    grants = (torch.arange(N) < 8).to(torch.float32)
    astate, avail = proc.step(_uniforms(proc, 0), 0, _state(), grants)
    assert bool((avail[:8] == 0.0).all()) and bool((avail[8:] == 1.0).all())
    assert bool((astate["phase"][:8] == WORKING).all())
    for t in range(1, 40):
        astate, avail = proc.step(_uniforms(proc, t), t, astate, torch.zeros(N))
    assert bool((avail == 1.0).all()) and bool((astate["phase"] == IDLE).all())


def test_dropout_rejoin_deterministic_outage_length():
    proc = DropoutRejoin(rate=1.0, rejoin_after=3.0)
    astate, avail = proc.step(_uniforms(proc, 0), 0, _state(), torch.zeros(N))
    assert bool((avail == 0.0).all()) and bool((astate["phase"] == DROPPED).all())
    outage = 0
    for t in range(1, 10):
        astate, avail = proc.step(_uniforms(proc, t), t, astate, torch.zeros(N))
        if bool((avail == 0.0).all()):
            outage += 1
        else:
            break
    assert outage == 2        # rounds 1-2 still out, back at round 3


def test_init_state_shapes_and_uniform_checks():
    st = init_availability_state(7, "cpu")
    assert st["phase"].shape == (7,) and st["phase"].dtype == torch.int32
    assert st["timer"].shape == (7,) and st["timer"].dtype == torch.float32
    assert [example_availability(f).n_uniforms(7) for f in FAMILIES] == [0, 14, 14, 7]
    with pytest.raises(ValueError, match="uniforms"):
        MarkovChurn().step(torch.zeros(7), 0, st, torch.zeros(7))


# ---------------------------------------------------------------------------
# knob grids: the knobs ride a leading axis
# ---------------------------------------------------------------------------

def test_knob_grid_over_a_leading_axis():
    grid = [MarkovChurn(p_drop=0.0, p_rejoin=0.5), MarkovChurn(p_drop=1.0, p_rejoin=1.0)]
    hp = stack_params(grid, "cpu")
    rep = grid[0]
    astates = {k: torch.stack([v, v]) for k, v in _state().items()}
    u = torch.stack([_uniforms(rep, 0), _uniforms(rep, 0)])
    _, avail = rep.step(u, 0, astates, torch.zeros(2, N), params=hp)
    assert bool((avail[0] == 1.0).all()) and bool((avail[1] == 0.0).all())
    _, serial = grid[1].step(u[1], 0, _state(), torch.zeros(N))
    assert torch.equal(avail[1], serial)


# ---------------------------------------------------------------------------
# parity with the JAX package on JAX's own uniforms
# ---------------------------------------------------------------------------

def _parity_procs():
    return [("always_on", {}), ("markov_churn", dict(p_drop=0.3, p_rejoin=0.4)),
            ("straggler", dict(slow_frac=0.5, slow_latency=4.0)),
            ("straggler", dict(slow_frac=0.3, slow_latency=7.5)),
            ("dropout_rejoin", dict(rate=0.2, rejoin_after=3.0))]


@pytest.mark.parametrize("family,knobs", _parity_procs(),
                         ids=lambda x: x if isinstance(x, str) else "-".join(map(str, x.values())))
def test_step_matches_jax_bitwise_on_jax_uniforms(family, knobs):
    n, rounds = 256, 16
    jproc = javail.make_availability(family, **knobs)
    tproc = tavail.make_availability(family, **knobs)
    jstate, tstate = jproc.init_state(n), tavail.init_availability_state(n, "cpu")
    rng = np.random.default_rng(7)
    for t in range(rounds):
        key = jax.random.fold_in(jax.random.fold_in(KEY, AVAIL_TAG), t)
        grants = (rng.random(n) < 0.25).astype(np.float32)
        u = jax_avail_uniforms(jproc, key, n)
        if family == "straggler":
            p = np.float32(1.0) / np.maximum(np.float32(knobs["slow_latency"]) - 1, 1)
            q = np.log1p(-u[n:].astype(np.float64)) / np.log1p(-np.float64(p))
            assert np.all(np.abs(q - np.round(q)) > 1e-5 * np.maximum(np.abs(q), 1.0)), \
                "a straggler draw sits within an ulp of an integer latency"
        jstate, javl = jproc.step(key, jnp.asarray(t), jstate, jnp.asarray(grants))
        tstate, tavl = tproc.step(torch.from_numpy(u), t, tstate, torch.from_numpy(grants))
        for k in ("phase", "timer"):
            np.testing.assert_array_equal(tstate[k].numpy(), np.array(jstate[k]),
                                          err_msg=f"{family} round {t}: {k}")
        np.testing.assert_array_equal(tavl.numpy(), np.array(javl), err_msg=f"round {t}")


def test_knob_grid_matches_jax_vmap():
    grid_j = [javail.StragglerLatency(slow_frac=f, slow_latency=l)
              for f, l in ((0.2, 4.0), (0.9, 2.5), (0.5, 6.0))]
    grid_t = [tavail.StragglerLatency(slow_frac=g.slow_frac, slow_latency=g.slow_latency)
              for g in grid_j]
    n = 64
    key = jax.random.PRNGKey(11)
    grants = (np.arange(n) % 3 == 0).astype(np.float32)
    rep_j = grid_j[0]
    _, javl = jax.vmap(lambda sp: rep_j.step(key, jnp.asarray(0), rep_j.init_state(n),
                                             jnp.asarray(grants), params=sp))(
        jax_stack_params(grid_j))
    u = torch.from_numpy(jax_avail_uniforms(rep_j, key, n)).expand(3, -1)
    st = {k: v.expand(3, -1) for k, v in tavail.init_availability_state(n, "cpu").items()}
    _, tavl = grid_t[0].step(u, 0, st, torch.from_numpy(grants).expand(3, -1),
                             params=stack_params(grid_t, "cpu"))
    np.testing.assert_array_equal(tavl.numpy(), np.array(javl))
