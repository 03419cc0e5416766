"""Rules of the PyTorch port that hold whatever the numbers.

* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports JAX
  or anything of the JAX package ``repro``.
* Entry points run on CUDA unless the caller passes a device: without
  CUDA and without ``device=``, they raise.
* A CUDA tensor goes to the kernel or raises; nothing falls back to the
  plain version (faked here with a CUDA-looking tensor and a loader that
  finds no built library), for all five kernels; ``attn_core`` on a CUDA
  tensor goes to the kernel at every prompt length.
* ``flash_attention`` picks its route from dtype and head dim: bf16 with
  D % 8 == 0 and D <= 128 reaches the tensor-core kernel's launch function,
  f32 and bf16 at any other D the f32-FMA kernel's; each route moves its
  own counter and the total; a tensor-core library that cannot be loaded
  raises and never reaches the FMA kernel or the plain version.
"""
import ast
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.channels import make_piecewise, make_scenario, make_stationary  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import glr_scan as glr_scan_mod  # noqa: E402
from repro_torch.kernels import glr_step as glr_step_mod  # noqa: E402
from repro_torch.kernels import robust_agg as robust_mod  # noqa: E402
from repro_torch.kernels import weighted_aggregate as wagg_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_covers_every_module():
    assert len(PORT_FILES) > 20


# the JAX modules each slice ports, by their path under src/repro/
SLICE_TWINS = ("core/aggregation.py", "core/faults.py", "core/channels/process.py",
               "core/bandits/glr_cucb.py", "fl/round.py", "kernels/ref.py",
               "kernels/ops.py", "kernels/robust_agg.py", "kernels/glr_scan.py",
               "kernels/glr_step.py", "kernels/weighted_aggregate.py",
               "configs/__init__.py", "configs/base.py", "configs/qwen3_32b.py",
               "configs/qwen2_5_32b.py", "configs/qwen1_5_0_5b.py", "models/__init__.py",
               "models/layers.py", "models/kvcache.py", "models/attention.py",
               "models/transformer.py", "models/model.py", "launch/steps.py",
               "launch/serve.py", "kernels/flash_attention.py", "sim/__init__.py",
               "sim/serve.py", "launch/sched_serve.py", "checkpoint/__init__.py",
               "checkpoint/io.py", "core/matching.py", "core/aoi.py", "core/regret.py",
               "core/bandits/base.py", "core/channels/base.py", "core/channels/families.py",
               "sim/engine.py", "sim/sweep.py", "sim/shard.py")


@pytest.mark.parametrize("rel", SLICE_TWINS)
def test_ported_modules_have_their_twin(rel):
    assert (ROOT / "src" / "repro" / rel).exists(), rel
    assert (ROOT / "src" / "repro_torch" / rel).exists(), rel


def test_every_kernel_has_a_source_and_a_wrapper():
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists(), name
    assert {"robust_trimmed", "glr_scan", "flash_attention"} <= set(_build.KERNELS)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    sched = GLRCUCB(5, 2, history=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_stationary([0.5, 0.2, 0.9, 0.1, 0.3])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_piecewise(np.full((2, 5), 0.5, np.float32), [10])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_scenario("piecewise", n_channels=5, horizon=50, n_breakpoints=2).realize()
    env = make_stationary([0.5, 0.2, 0.9, 0.1, 0.3], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_aoi_regret(sched, env, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncFLTrainer(AsyncFLConfig(n_clients=2, n_channels=5), sched, env, lambda p, x, y: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sched.init()
    # the explicit CPU request works
    out = simulate_aoi_regret(sched, env, 10, generator=torch.Generator(), device="cpu")
    assert out["regret"].device.type == "cpu"


def test_serving_entry_points_default_to_cuda(no_cuda, capsys):
    model = build_model(get_smoke_config("qwen3-32b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-32b", "--smoke", "--tokens", "1"])
    assert capsys.readouterr().out == ""
    params, _ = model.init(torch.Generator(), device="cpu")     # the explicit CPU request
    assert params["embed"].device.type == "cpu"


def test_unported_archs_say_so():
    for arch in ("deepseek-v2-236b", "mamba2-1.3b", "hubert-xlarge"):
        with pytest.raises(KeyError, match="not ported yet"):
            get_config(arch)
    with pytest.raises(KeyError, match="not ported yet"):
        get_smoke_config("mamba2-1.3b")
    import dataclasses
    moe = dataclasses.replace(get_smoke_config("qwen3-32b"), n_experts=4)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(moe)


class _FakeCuda:
    """Stands in for a CUDA tensor: the dispatch routes on ``is_cuda`` and
    the wrappers check device, dtype, shape and contiguity, all of which
    this passes, so a call reaches the kernel loader."""

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


class _State:
    """The detector fields the streaming path reads, on fake CUDA tensors."""

    def __init__(self, cum, total, base):
        self.cum, self.total, self.base = cum, total, base
        self.hp = {}


def _counts():
    return (glr_step_mod.glr_step.launches, wagg_mod.weighted_aggregate.launches,
            robust_mod.robust_trimmed.launches, glr_scan_mod.glr_scan.launches,
            flash_mod.flash_attention.launches)


def test_cuda_tensors_never_fall_back_to_the_plain_version(monkeypatch):
    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    before = _counts()
    called = []
    for name in ("weighted_aggregate", "glr_step", "robust_trimmed", "glr_scan"):
        monkeypatch.setattr(ops.ref, name, lambda *a, **k: called.append(a))
    upd = _FakeCuda(torch.zeros((2, 8)))
    with pytest.raises(RuntimeError, match="no library"):
        ops.weighted_aggregate(upd, _FakeCuda(torch.ones(2)))
    cum = _FakeCuda(torch.zeros((3, 8)))
    z = _FakeCuda(torch.zeros(3))
    counts = _FakeCuda(torch.zeros(3, dtype=torch.int32))
    sched = _FakeCuda(torch.zeros(3, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="no library"):
        ops.glr_step(cum, z, z, counts, z, sched)
    with pytest.raises(RuntimeError, match="no library"):
        GLRCUCB(3, 1, history=8)._detect_streaming(
            _State(cum, z, z), torch.zeros(1, dtype=torch.int64), sched, z, counts, z, True)
    assert not called
    assert _counts() == before


def test_new_kernels_never_fall_back_to_the_plain_version(monkeypatch):
    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    before = _counts()
    called = []
    for name in ("robust_trimmed", "glr_scan"):
        monkeypatch.setattr(ops.ref, name, lambda *a, **k: called.append(a))
    mask = _FakeCuda(torch.ones(4))
    one = _FakeCuda(torch.tensor(4.0))
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(RuntimeError, match="no library"):
            ops.robust_trimmed(_FakeCuda(torch.zeros((4, 8), dtype=dtype)), mask, one, one)
    with pytest.raises(RuntimeError, match="no library"):
        ops.glr_scan(_FakeCuda(torch.zeros((3, 8))), _FakeCuda(torch.zeros(3, dtype=torch.int32)))
    with pytest.raises(ValueError, match="M <= 64"):
        ops.robust_trimmed(_FakeCuda(torch.zeros((65, 8))), _FakeCuda(torch.ones(65)), one, one)
    assert not called
    assert _counts() == before


@pytest.mark.parametrize("s", [1, 3, 300])
def test_flash_attention_never_falls_back_to_the_plain_version(monkeypatch, s):
    """``ops.flash_attention`` and the model's ``attn_core`` (its default
    route and the forced kernel route) reach the kernel's loader for a CUDA
    tensor at every prompt length, in f32 and bf16."""
    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    called = []
    monkeypatch.setattr(ops.ref, "mha_attention", lambda *a, **k: called.append(a))
    monkeypatch.setattr(attn_mod, "_attn_core_plain", lambda *a, **k: called.append(a))
    before = _counts()
    for dtype in (torch.float32, torch.bfloat16):
        q = _FakeCuda(torch.zeros((1, 4, s, 32), dtype=dtype))
        kv = _FakeCuda(torch.zeros((1, 2, s, 32), dtype=dtype))
        with pytest.raises(RuntimeError, match="no library"):
            ops.flash_attention(q, kv, kv)
        for impl in (None, "kernel"):
            with pytest.raises(RuntimeError, match="no library"):
                attn_mod.attn_core(q, kv, kv, causal=True, impl=impl)
    assert not called
    assert _counts() == before


def test_flash_attention_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Shapes, dtypes and layouts outside the kernel are refused before the
    loader, so no launch and no count."""
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the loader"))
    before = _counts()
    f = flash_mod.flash_attention
    z = lambda *shape, dtype=torch.float32: _FakeCuda(torch.zeros(shape, dtype=dtype))
    with pytest.raises(ValueError, match="unsupported shape"):
        f(z(1, 4, 8, 257), z(1, 2, 8, 257), z(1, 2, 8, 257))       # D > 256
    with pytest.raises(ValueError, match="unsupported shape"):
        f(z(1, 3, 8, 32), z(1, 2, 8, 32), z(1, 2, 8, 32))          # Hq % Hkv
    with pytest.raises(ValueError, match="k and v must be"):
        f(z(1, 4, 8, 32), z(1, 2, 9, 32), z(1, 2, 8, 32))
    with pytest.raises(TypeError, match="one dtype"):
        f(z(1, 4, 8, 32), z(1, 2, 8, 32, dtype=torch.bfloat16), z(1, 2, 8, 32))
    with pytest.raises(TypeError, match="one dtype"):
        f(z(1, 4, 8, 32, dtype=torch.float16), z(1, 2, 8, 32, dtype=torch.float16),
          z(1, 2, 8, 32, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        f(_FakeCuda(torch.zeros((1, 8, 4, 32)).transpose(1, 2)), z(1, 2, 8, 32), z(1, 2, 8, 32))
    with pytest.raises(ValueError, match="window"):
        f(z(1, 4, 8, 32), z(1, 2, 8, 32), z(1, 2, 8, 32), window=-1)
    assert _counts() == before


def _flash_counts():
    f = flash_mod.flash_attention
    return f.launches, f.tc_launches, f.fma_launches


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
    monkeypatch.setattr(flash_mod, "_stream", lambda q: 0)
    return calls


def _qkv(d, dtype, s=5):
    q = _FakeCuda(torch.zeros((1, 4, s, d), dtype=dtype))
    kv = _FakeCuda(torch.zeros((1, 2, s, d), dtype=dtype))
    return q, kv


@pytest.mark.parametrize("d", [8, 32, 64, 72, 96, 128])
def test_bf16_reaches_the_tensor_core_kernel(recorded, d):
    q, kv = _qkv(d, torch.bfloat16)
    before = _flash_counts()
    out = flash_mod.flash_attention(q, kv, kv, causal=True, window=3)
    assert [(n, s) for n, s, _ in recorded] == [("flash_attention_tc", "flash_attention_tc_launch")]
    args = recorded[0][2]
    assert args[4:11] == (1, 4, 2, 5, d, 1, 3)            # b, hq, hkv, s, d, causal, window
    assert args[11] == pytest.approx(1.0 / math.sqrt(d))
    assert out.shape == (1, 4, 5, d) and out.dtype == torch.bfloat16
    assert _flash_counts() == (before[0] + 1, before[1] + 1, before[2])


@pytest.mark.parametrize("dtype,d", [(torch.float32, 8), (torch.float32, 64),
                                     (torch.float32, 128), (torch.float32, 256),
                                     (torch.bfloat16, 36), (torch.bfloat16, 200),
                                     (torch.bfloat16, 1)])
def test_other_calls_reach_the_fma_kernel(recorded, dtype, d):
    q, kv = _qkv(d, dtype)
    before = _flash_counts()
    out = flash_mod.flash_attention(q, kv, kv, causal=False)
    assert [(n, s) for n, s, _ in recorded] == [("flash_attention", "flash_attention_launch")]
    assert recorded[0][2][12] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert out.shape == (1, 4, 5, d) and out.dtype == dtype
    assert _flash_counts() == (before[0] + 1, before[1], before[2] + 1)


def test_route_is_picked_from_dtype_and_head_dim():
    assert [d for d in range(1, 257) if flash_mod.tc_route(torch.bfloat16, d)] == \
        list(range(8, 129, 8))
    assert not any(flash_mod.tc_route(torch.float32, d) for d in range(1, 257))


def test_model_attention_takes_the_routes(recorded):
    """``ops.flash_attention`` and the model's ``attn_core`` route like the
    wrapper: qwen3-32b's bf16 head dim of 128 to the tensor cores, f32 to
    the FMA kernel."""
    for dtype, name in ((torch.bfloat16, "flash_attention_tc"), (torch.float32, "flash_attention")):
        q, kv = _qkv(128, dtype, s=3)
        ops.flash_attention(q, kv, kv)
        attn_mod.attn_core(q, kv, kv, causal=True)
        assert [n for n, _, _ in recorded[-2:]] == [name, name]


def test_missing_tensor_core_library_raises(monkeypatch):
    """A bf16 CUDA call whose tensor-core library cannot be built raises; it
    reaches neither the FMA kernel nor the plain version, and counts
    nothing."""
    loaded = []

    def load(name, symbol, argtypes):
        loaded.append(name)
        if name == "flash_attention_tc":
            raise RuntimeError("repro_torch kernel build failed: no tensor-core library")
        return lambda *a: pytest.fail("reached the FMA kernel")

    monkeypatch.setattr(_build, "load", load)
    called = []
    monkeypatch.setattr(ops.ref, "mha_attention", lambda *a, **k: called.append(a))
    monkeypatch.setattr(attn_mod, "_attn_core_plain", lambda *a, **k: called.append(a))
    before = _flash_counts()
    for d in (64, 128):
        q, kv = _qkv(d, torch.bfloat16)
        with pytest.raises(RuntimeError, match="no tensor-core library"):
            flash_mod.flash_attention(q, kv, kv)
        with pytest.raises(RuntimeError, match="no tensor-core library"):
            ops.flash_attention(q, kv, kv)
        with pytest.raises(RuntimeError, match="no tensor-core library"):
            attn_mod.attn_core(q, kv, kv, causal=True)
    assert set(loaded) == {"flash_attention_tc"}
    assert not called
    assert _flash_counts() == before


def test_failed_tensor_core_launch_raises(monkeypatch):
    """A launch that returns a CUDA error raises and counts nothing."""
    monkeypatch.setattr(_build, "load", lambda name, symbol, argtypes: lambda *a: 1)
    monkeypatch.setattr(flash_mod, "_stream", lambda q: 0)
    before = _flash_counts()
    q, kv = _qkv(128, torch.bfloat16)
    with pytest.raises(RuntimeError, match="tensor-core kernel launch failed"):
        flash_mod.flash_attention(q, kv, kv)
    assert _flash_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        wagg_mod.weighted_aggregate(torch.zeros((2, 8)), torch.ones(2))
    z = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        glr_step_mod.glr_step(torch.zeros((3, 8)), z, z, z.int(), z, z.bool())
    with pytest.raises(ValueError, match="CUDA"):
        robust_mod.robust_trimmed(torch.zeros((2, 8)), torch.ones(2), torch.tensor(2.0),
                                  torch.tensor(0.0))
    with pytest.raises(ValueError, match="CUDA"):
        glr_scan_mod.glr_scan(torch.zeros((3, 8)), z.int())
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(torch.zeros((1, 2, 4, 8)), torch.zeros((1, 2, 4, 8)),
                                  torch.zeros((1, 2, 4, 8)))
    assert _counts() == before


def test_robust_trimmed_takes_n_and_k_as_f32_scalars_on_the_device(monkeypatch):
    """The kernel reads n and k through two f32 pointers: anything else is
    refused before the loader, so no launch and no count."""
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the loader"))
    before = _counts()
    upd, mask = _FakeCuda(torch.zeros((4, 8))), _FakeCuda(torch.ones(4))
    one = _FakeCuda(torch.tensor(4.0))
    for bad in (_FakeCuda(torch.tensor(4)), _FakeCuda(torch.tensor([4.0, 1.0])),
                torch.tensor(4.0)):
        with pytest.raises(ValueError, match="one-element f32 tensor"):
            robust_mod.robust_trimmed(upd, mask, bad, one)
        with pytest.raises(ValueError, match="one-element f32 tensor"):
            robust_mod.robust_trimmed(upd, mask, one, bad)
    assert _counts() == before


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["glr_step"])


def test_build_targets_name_the_source_hash():
    a = _build.library_path("glr_step")
    b = _build.library_path("weighted_aggregate")
    assert a.parent == b.parent and a.name != b.name and a.suffix == ".so"
    names = {_build.library_path(k).name for k in _build.KERNELS}
    assert len(names) == len(_build.KERNELS)
    with pytest.raises(ValueError, match="unknown kernel"):
        _build.build(["no_such_kernel"])


def test_build_targets_follow_the_shared_header(monkeypatch, tmp_path):
    """Both detector kernels include ``glr_kl.cuh``: editing it renames
    (so rebuilds) both libraries."""
    import shutil

    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {k: _build.library_path(k).name for k in _build.KERNELS}
    (tmp_path / "glr_kl.cuh").write_text((tmp_path / "glr_kl.cuh").read_text() + "\n// edit\n")
    after = {k: _build.library_path(k).name for k in _build.KERNELS}
    assert after["glr_step"] != before["glr_step"] and after["glr_scan"] != before["glr_scan"]
    for name in ("glr_step", "glr_scan"):
        assert '#include "glr_kl.cuh"' in (tmp_path / f"{name}.cu").read_text()


def test_load_sets_argtypes_once_and_caches_the_function(monkeypatch):
    """``_build.load`` builds and loads a library once, sets the function's
    ``argtypes`` and ``restype`` once, and hands back the same function on
    every later call (a fake library stands in for the ``ctypes.CDLL``)."""
    import ctypes

    sets, opened, built = [], [], []

    class FakeFn:
        def __setattr__(self, name, value):
            sets.append(name)
            object.__setattr__(self, name, value)

    class FakeLib:
        def __init__(self, path):
            opened.append(path)
            self.fns = {}

        def __getattr__(self, symbol):
            return self.fns.setdefault(symbol, FakeFn())

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "build", lambda names: built.append(list(names)) or {})
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    first = _build.load("weighted_aggregate", "weighted_aggregate_launch", argtypes)
    assert sorted(sets) == ["argtypes", "restype"]
    assert first.argtypes == argtypes and first.argtypes is not argtypes
    assert first.restype is ctypes.c_int
    for _ in range(3):
        assert _build.load("weighted_aggregate", "weighted_aggregate_launch", argtypes) is first
    assert sorted(sets) == ["argtypes", "restype"]
    assert built == [["weighted_aggregate"]] and len(opened) == 1
    other = _build.load("weighted_aggregate", "other_launch", argtypes)   # same library
    assert other is not first and len(opened) == 1 and len(built) == 1


@pytest.fixture
def agg_launches(monkeypatch):
    """Loads that hand back a launch function recording (symbol, arguments)
    and returning ``status``; the current stream reads as 4242 + index."""
    calls, status = [], [0]

    def load(name, symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            calls.append((symbol, args))
            return status[0]

        return launch

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "stream", lambda index: 4242 + index)
    return calls, status


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_aggregation_wrappers_launch_on_the_current_stream(agg_launches, dtype, code):
    """Each call launches once, on the stream ``_build.stream`` reads for the
    tensor's device, with (M, P, dtype code); each moves its counter by one."""
    calls, _ = agg_launches
    upd = _FakeCuda(torch.zeros((5, 9), dtype=dtype))
    before = _counts()
    for _ in range(2):
        out = wagg_mod.weighted_aggregate(upd, _FakeCuda(torch.ones(5)))
        assert out.shape == (9,) and out.dtype == torch.float32
    one = _FakeCuda(torch.tensor(5.0))
    out = robust_mod.robust_trimmed(upd, _FakeCuda(torch.ones(5)), one, one)
    assert out.shape == (9,) and out.dtype == torch.float32
    stream = 4242 + upd.get_device()
    assert [s for s, _ in calls] == ["weighted_aggregate_launch"] * 2 + ["robust_trimmed_launch"]
    assert all(args[-1] == stream for _, args in calls)
    assert calls[0][1][3:6] == (5, 9, code) and calls[2][1][5:8] == (5, 9, code)
    after = _counts()
    assert (after[1] - before[1], after[2] - before[2]) == (2, 1)


def test_failed_aggregation_launch_raises_and_counts_nothing(agg_launches):
    _, status = agg_launches
    status[0] = 700
    before = _counts()
    upd, one = _FakeCuda(torch.zeros((4, 8))), _FakeCuda(torch.tensor(4.0))
    with pytest.raises(RuntimeError, match="weighted_aggregate: kernel launch failed"):
        wagg_mod.weighted_aggregate(upd, _FakeCuda(torch.ones(4)))
    with pytest.raises(RuntimeError, match="robust_trimmed: kernel launch failed"):
        robust_mod.robust_trimmed(upd, _FakeCuda(torch.ones(4)), one, one)
    assert _counts() == before


def test_ops_hands_ready_tensors_to_the_wrappers_as_they_are(monkeypatch):
    """``ops`` converts only what the kernel does not take: contiguous f32
    arguments reach the wrappers as the very same objects (torch's
    ``contiguous`` and ``to`` return their tensor when nothing changes),
    and a strided or f64 argument arrives contiguous and f32."""
    class Torchlike(_FakeCuda):
        def to(self, *a, **k):
            t = self._t.to(*a, **k)
            return self if t is self._t else Torchlike(t)

        def contiguous(self):
            t = self._t.contiguous()
            return self if t is self._t else Torchlike(t)

    seen = []
    monkeypatch.setattr(ops._wa, "weighted_aggregate", lambda *a: seen.append(a))
    monkeypatch.setattr(ops._ra, "robust_trimmed", lambda *a: seen.append(a))
    upd, scale = Torchlike(torch.zeros((3, 8))), Torchlike(torch.ones(3))
    n, k = Torchlike(torch.tensor(3.0)), Torchlike(torch.tensor(1.0))
    ops.weighted_aggregate(upd, scale)
    ops.robust_trimmed(upd, scale, n, k)
    assert all(a is b for a, b in zip(seen[0], (upd, scale)))
    assert all(a is b for a, b in zip(seen[1], (upd, scale, n, k)))

    seen.clear()
    strided = Torchlike(torch.zeros((8, 3)).t())
    wide = Torchlike(torch.ones(3, dtype=torch.float64))
    ops.weighted_aggregate(strided, wide)
    ops.robust_trimmed(strided, wide, Torchlike(torch.tensor(3.0, dtype=torch.float64)), k)
    for args in seen:
        assert args[0] is not strided and args[0].is_contiguous()
        assert all(a.dtype == torch.float32 for a in args[1:])


def test_scheduler_service_defaults_to_cuda(no_cuda, capsys):
    from repro_torch.launch import sched_serve
    from repro_torch.sim import SchedServer
    from repro_torch.sim.serve import init_slots

    sched = GLRCUCB(5, 2, history=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        SchedServer(sched)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_slots(sched, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        sched_serve.main(["--tenants", "2", "--slots", "2", "--requests", "4"])
    assert capsys.readouterr().out == ""
    assert SchedServer(sched, device="cpu").device.type == "cpu"     # the explicit CPU request


def _tenant_args(wrap):
    """glr_step_tenants operands: slot state R=3, B=2 rows, N=2, H=8."""
    z = lambda *shape, dtype=torch.float32: wrap(torch.zeros(shape, dtype=dtype))
    return (z(3, 2, 8), z(3, 2), z(3, 2), z(2, dtype=torch.int32), z(2, dtype=torch.bool),
            z(2, dtype=torch.bool), z(2, 2, dtype=torch.int32), z(2, 2),
            z(2, 2, dtype=torch.bool))


def test_glr_step_tenants_never_falls_back_to_the_plain_version(monkeypatch):
    """A CUDA tensor reaches the in-place kernel's loader and raises when
    there is no library; the plain version is never called and nothing
    counts."""
    from repro_torch.kernels import glr_step_tenants as gst_mod

    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    called = []
    for name in ("glr_step_tenants", "glr_tenants_append", "glr_step"):
        monkeypatch.setattr(ops.ref, name, lambda *a, **k: called.append(a))
    before = gst_mod.glr_step_tenants.launches
    for grid in ("all", "geometric"):
        with pytest.raises(RuntimeError, match="no library"):
            ops.glr_step_tenants(*_tenant_args(_FakeCuda), split_grid=grid)
        with pytest.raises(RuntimeError, match="no library"):
            gst_mod.glr_step_tenants(*_tenant_args(_FakeCuda), split_grid=grid)
    assert not called
    assert gst_mod.glr_step_tenants.launches == before


def test_glr_step_tenants_refuses_what_the_kernel_does_not_take(monkeypatch):
    """CPU tensors, wrong dtypes and shapes are refused before the loader."""
    from repro_torch.kernels import glr_step_tenants as gst_mod

    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the loader"))
    f = gst_mod.glr_step_tenants
    before = f.launches
    with pytest.raises(ValueError, match="CUDA"):
        f(*_tenant_args(lambda t: t))
    args = list(_tenant_args(_FakeCuda))
    bad_slots = list(args)
    bad_slots[3] = _FakeCuda(torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="slots"):
        f(*bad_slots)
    bad_total = list(args)
    bad_total[1] = _FakeCuda(torch.zeros(4, 2))
    with pytest.raises(ValueError, match="total"):
        f(*bad_total)
    with pytest.raises(ValueError, match="split_grid"):
        f(*args, split_grid="dense")
    assert f.launches == before
