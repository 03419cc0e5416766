"""The regret harness's two routes on the CPU: which runs reach the
one-launch ``regret_scan`` kernel, and how its wrapper packs and unpacks.

There is no card here, so CUDA tensors are faked (``_FakeCuda``: a CPU
tensor that reports a CUDA device) and the kernel's loader is replaced:
by a recorder (which library, symbol and template flags a run reaches),
by a loader that fails or a launch that returns an error (which must raise,
count nothing and reach neither ``glr_step`` nor the per-round loop), and
by a fake launch that fills the output buffers from a CPU run of the
per-round loop (the wrapper's dict and final state must equal that run).
The kernel's own arithmetic is held against the per-round route on the
card (``tests/test_torch_cuda.py::test_regret_scan_matches_rounds``,
``chip_smoke.py`` phases 2, 3 and 6).
"""
import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import regret as regret_mod  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.channels import make_piecewise, reactive_env, table_env  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import glr_scan as glr_scan_mod  # noqa: E402
from repro_torch.kernels import glr_step as glr_step_mod  # noqa: E402
from repro_torch.kernels import regret_scan as rs_mod  # noqa: E402

T = 40
SYMBOL = ("regret_scan", "regret_scan_launch")
REACT_ARG = 44          # the reactive form's (4,) coefficients, after the ints
OUTPUTS = dict(schedule=14, regret_curve=15, var_curve=16, scalars=17, aoi_pi=18, aoi_star=19,
               mu=20, counts=21, tau=22, ring=23, restarts=24, total=25, base=26)


class _FakeCuda:
    """A CPU tensor that reports a CUDA device: the route and the wrapper's
    checks read ``is_cuda``, device, dtype, shape and contiguity, and
    ``new_empty`` allocates beside it (on the CPU)."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def to(self, *a, **k):
        return self

    def contiguous(self):
        return self

    def __getattr__(self, name):
        return getattr(self._t, name)


def _env(n, form="segments", seed=0):
    rng = np.random.default_rng(seed)
    if form == "table":
        return table_env(rng.random((T, n)).astype(np.float32), device="cpu")
    if form == "reactive":
        return reactive_env(rng.random((T, n)).astype(np.float32), 0.8, 0.9, 0.3, 16.0,
                            device="cpu")
    a = rng.random(n).astype(np.float32)
    return make_piecewise(np.stack([a, a[::-1], a]), [10, 25], device="cpu")


def _uniforms(n, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).random((T, 2, n)).astype(np.float32))


def _fake_env(env):
    return dataclasses.replace(env, means=_FakeCuda(env.means), breaks=_FakeCuda(env.breaks),
                               table=_FakeCuda(env.table), react=_FakeCuda(env.react))


def _fake_state(sched):
    st = sched.init("cpu")
    return st._replace(**{f: _FakeCuda(getattr(st, f)) for f in st._fields if f != "hp"},
                       hp={k: _FakeCuda(v) for k, v in st.hp.items()})


@pytest.fixture
def fake_card(monkeypatch):
    """``simulate_aoi_regret`` on faked CUDA tensors: the state is made on
    the CPU and faked; the per-round loop and the standalone GLR kernels
    record that they were reached."""
    reached = []
    monkeypatch.setattr(regret_mod, "init_with_hp", lambda sched, dev, hp: _fake_state(sched))
    monkeypatch.setattr(regret_mod, "_simulate_rounds",
                        lambda *a, **k: reached.append("rounds") or {"route": "rounds"})
    monkeypatch.setattr(ops, "glr_step", lambda *a, **k: reached.append("glr_step"))
    monkeypatch.setattr(ops, "glr_scan", lambda *a, **k: reached.append("glr_scan"))
    monkeypatch.setattr(rs_mod, "_stream", lambda x: 0)

    def run(sched, env, impl=None, **kw):
        return simulate_aoi_regret(sched, _fake_env(env), T,
                                   uniforms=_FakeCuda(_uniforms(env.n_channels)),
                                   device=torch.device("cuda"), impl=impl, **kw)

    run.reached = reached
    return run


@pytest.fixture
def recorded(monkeypatch):
    """Loads that hand back a launch function recording (library, symbol,
    arguments) and returning success."""
    calls = []

    def load(name, symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            calls.append((name, symbol, args))
            return 0

        return launch

    monkeypatch.setattr(_build, "load", load)
    return calls


def _counts():
    return (rs_mod.regret_scan.launches, glr_step_mod.glr_step.launches,
            glr_scan_mod.glr_scan.launches)


# (scheduler, env form) -> the launch's (T, N, M, H, segments, stride, period) and
# template flags (recompute, geometric, form: 0 segments, 1 table, 2 reactive)
SCAN_ROUTES = [
    (dict(n=5, m=2, history=1024, detector_stride=5), "segments", (5, 2, 1024, 3, 5, 0), (0, 0, 0)),
    (dict(n=5, m=2, history=64, split_grid="geometric"), "segments", (5, 2, 64, 3, 1, 0), (0, 1, 0)),
    (dict(n=5, m=2, history=64, split_grid="auto", auto_split_h=32), "segments",
     (5, 2, 64, 3, 1, 0), (0, 1, 0)),
    (dict(n=5, m=3, history=33, detector_impl="recompute"), "table", (5, 3, 33, 1, 1, 0), (1, 0, 1)),
    (dict(n=5, m=2, history=64, alpha=0.2, detector_backend="kernel"), "table",
     (5, 2, 64, 1, 1, 25), (0, 0, 1)),
    (dict(n=30, m=20, history=256), "segments", (30, 20, 256, 3, 1, 0), (0, 0, 0)),
    (dict(n=32, m=32, history=1280), "segments", (32, 32, 1280, 3, 1, 0), (0, 0, 0)),
    (dict(n=5, m=2, history=64, detector_stride=10**9), "segments",
     (5, 2, 64, 3, 10**9, 0), (0, 0, 0)),
    (dict(n=5, m=2, history=8192, detector_impl="recompute"), "segments",
     (5, 2, 8192, 3, 1, 0), (1, 0, 0)),
    (dict(n=5, m=2, history=64, detector_stride=5), "reactive", (5, 2, 64, 1, 5, 0), (0, 0, 2)),
    (dict(n=5, m=3, history=33, detector_impl="recompute"), "reactive", (5, 3, 33, 1, 1, 0),
     (1, 0, 2)),
]


def _sched(cfg):
    cfg = dict(cfg)
    return GLRCUCB(cfg.pop("n"), cfg.pop("m"), **cfg)


@pytest.mark.parametrize("cfg,form,ints,flags", SCAN_ROUTES)
@pytest.mark.parametrize("impl", [None, "scan"])
def test_scan_route_reaches_the_kernel(fake_card, recorded, cfg, form, ints, flags, impl):
    sched = _sched(cfg)
    before = _counts()
    out = fake_card(sched, _env(sched.n_channels, form), impl=impl)
    assert [(n, s) for n, s, _ in recorded] == [SYMBOL]
    args = recorded[0][2]
    assert args[28:35] == (T,) + ints
    assert args[35:38] == flags
    assert args[15] is not None and args[16] is not None       # the curves
    assert (args[REACT_ARG] is not None) == (form == "reactive")
    assert fake_card.reached == []
    assert _counts() == (before[0] + 1,) + before[1:]
    assert out["channels"].shape == (T, sched.n_clients)
    assert out["regret"].shape == (T,)


# runs that stay on the per-round loop with impl=None, and why impl="scan" refuses them
ROUND_ROUTES = [
    (dict(n=33, m=2, history=64), "N=33 channels"),
    (dict(n=5, m=2, history=8193), "shared-memory budget"),
    (dict(n=41, m=2, history=1000), "N=41 channels"),
    (dict(n=5, m=2, history=64, detector_backend="torch"), "plain detector"),
    (dict(n=5, m=6, history=64), "M=6 clients"),
]


@pytest.mark.parametrize("cfg,why", ROUND_ROUTES)
def test_other_runs_stay_on_the_rounds(fake_card, recorded, cfg, why):
    sched = _sched(cfg)
    env = _env(sched.n_channels)
    before = _counts()
    assert fake_card(sched, env) == {"route": "rounds"}
    with pytest.raises(ValueError, match=why):
        fake_card(sched, env, impl="scan")
    assert recorded == []
    assert fake_card.reached == ["rounds"]
    assert _counts() == before


def test_impl_rounds_forces_the_loop(fake_card, recorded):
    assert fake_card(_sched(SCAN_ROUTES[0][0]), _env(5), impl="rounds") == {"route": "rounds"}
    assert recorded == [] and fake_card.reached == ["rounds"]


def test_scan_refuses_cpu_tensors_and_unknown_impls():
    sched, env = GLRCUCB(5, 2, history=16), _env(5)
    with pytest.raises(ValueError, match="on cpu"):
        simulate_aoi_regret(sched, env, T, uniforms=_uniforms(5), device="cpu", impl="scan")
    with pytest.raises(ValueError, match="unknown impl"):
        simulate_aoi_regret(sched, env, T, uniforms=_uniforms(5), device="cpu", impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rs_mod.regret_scan(sched, env, sched.init("cpu"), _uniforms(5))


def test_missing_library_raises(fake_card, monkeypatch):
    """A library that cannot be built raises: no count, no per-round loop,
    no standalone GLR kernel."""
    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    before = _counts()
    for impl in (None, "scan"):
        for cfg in (SCAN_ROUTES[0][0], SCAN_ROUTES[3][0]):
            with pytest.raises(RuntimeError, match="no library"):
                fake_card(_sched(cfg), _env(5), impl=impl)
    assert fake_card.reached == []
    assert _counts() == before


def test_failed_launch_raises(fake_card, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name, symbol, argtypes: lambda *a: 1)
    before = _counts()
    with pytest.raises(RuntimeError, match="regret_scan: kernel launch failed"):
        fake_card(_sched(SCAN_ROUTES[0][0]), _env(5))
    assert fake_card.reached == []
    assert _counts() == before


def _fill(ptr, src):
    src = src.contiguous()
    ctypes.memmove(ptr, src.data_ptr(), src.numel() * src.element_size())


@pytest.mark.parametrize("impl_cfg", [
    dict(history=16, detector_stride=2, delta=0.2, min_samples=4),
    dict(history=16, detector_stride=3, delta=0.2, min_samples=4, detector_impl="recompute"),
])
@pytest.mark.parametrize("collect_curve", [True, False])
def test_wrapper_unpacks_the_kernels_buffers(monkeypatch, impl_cfg, collect_curve):
    """A fake launch writes a CPU per-round run's results into the output
    buffers; the wrapper's dict and final state must be that run's."""
    sched = GLRCUCB(5, 2, **impl_cfg)
    env, u = _env(5), _uniforms(5)
    want = simulate_aoi_regret(sched, env, T, uniforms=u, device="cpu", impl="rounds",
                               collect_curve=collect_curve, return_state=True)
    ws = want["final_sched_state"]
    ring = "hist" if sched.detector_impl == "recompute" else "cum"
    successes = torch.tensor(round(float(want["success_rate"]) * T * 2), dtype=torch.float32)
    sources = dict(schedule=want["channels"], regret_curve=want["regret"],
                   var_curve=want["cum_aoi_var"],
                   scalars=torch.stack([want["final_regret"], want["final_cum_aoi_var"],
                                        want["oracle_cum_aoi_var"], successes]),
                   aoi_pi=want["aoi_pi"], aoi_star=want["aoi_star"], mu=ws.mu_tilde,
                   counts=ws.counts, tau=ws.tau, ring=getattr(ws, ring), restarts=ws.restarts,
                   total=ws.total, base=ws.base)

    def launch(*args):
        for name, i in OUTPUTS.items():
            if args[i] is None:
                assert not collect_curve and name in ("regret_curve", "var_curve")
                continue
            _fill(args[i], sources[name])
        return 0

    monkeypatch.setattr(_build, "load", lambda name, symbol, argtypes: launch)
    monkeypatch.setattr(rs_mod, "_stream", lambda x: 0)
    got = rs_mod.regret_scan(sched, _fake_env(env), _fake_state(sched), _FakeCuda(u),
                             collect_curve=collect_curve, return_state=True)
    assert set(got) == set(want)
    for k in want:
        if k == "final_sched_state":
            continue
        assert torch.equal(got[k], want[k]), k
    gs = got["final_sched_state"]
    for f in ws._fields:
        if f == "hp":
            continue
        g, w = getattr(gs, f), getattr(ws, f)
        assert torch.equal(g._t if isinstance(g, _FakeCuda) else g, w), f
    assert set(gs.hp) == set(ws.hp)


def test_occupancy_refuses_an_unknown_form(monkeypatch):
    """The form is checked before the library is asked."""
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("the library was loaded"))
    with pytest.raises(ValueError, match="form 'adversarial' is not one of"):
        rs_mod.occupancy(GLRCUCB(5, 2, history=16), "adversarial")


def test_ops_regret_scan_on_the_cpu_is_the_per_round_loop():
    sched = GLRCUCB(5, 2, history=16, detector_stride=2, delta=0.2, min_samples=4)
    env, u = _env(5), _uniforms(5)
    want = simulate_aoi_regret(sched, env, T, uniforms=u, device="cpu", return_state=True)
    got = ops.regret_scan(sched, env, sched.init("cpu"), u, return_state=True)
    for k in ("channels", "regret", "cum_aoi_var", "aoi_pi", "aoi_star", "restarts",
              "success_rate"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["final_sched_state"].cum, want["final_sched_state"].cum)
