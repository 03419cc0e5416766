"""Rules of the PyTorch port that hold whatever the numbers.

* No module of ``src/repro_torch/``, not ``chip_smoke.py`` and no example
  under ``examples/torch/`` imports JAX or anything of the JAX package
  ``repro``.
* Entry points run on CUDA unless the caller passes a device: without
  CUDA and without ``device=``, they raise.
* A CUDA tensor goes to the kernel or raises; nothing falls back to the
  plain version (faked here with a CUDA-looking tensor and a loader that
  finds no built library), for all five kernels; ``attn_core`` on a CUDA
  tensor goes to the kernel at every prompt length.
* ``flash_attention`` picks its route from dtype and head dim: bf16 with
  D % 8 == 0 and D <= 256 reaches the tensor-core kernel's launch function,
  f32 and bf16 at any other D the f32-FMA kernel's; each route moves its
  own counter and the total; a tensor-core library that cannot be loaded
  raises and never reaches the FMA kernel or the plain version.
* The attention gradient of a bf16 CUDA call that the tensor-core route
  takes is the backward kernels' (``flash_attention_bwd``) or raises: it
  never reaches the chunked recompute; the wrapper refuses what the
  kernels do not take before the loader, and a failed launch raises.
* Every module of the JAX package has its twin in the port (at the same
  path, or under the name ``RENAMED`` gives), or a reason in ``NO_TWIN``.
* A meta tensor reaches each kernel's meta route, which returns the
  kernel's shapes and dtypes, and never its plain version.
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
from repro_torch.fl import (  # noqa: E402
    AsyncFLConfig,
    AsyncFLTrainer,
    SparseAsyncFLTrainer,
    SparseFLConfig,
)
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
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples" / "torch").glob("*.py"))
              + [ROOT / "tools" / "roofline_report.py"])


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


# JAX modules whose twin has another name in the port
RENAMED = {"utils/jaxpr_cost.py": "utils/cost.py"}     # the port has no jaxpr
# JAX modules with no twin, and why
NO_TWIN = {
    "models/act_sharding.py": "it only constrains GSPMD's sharding propagation; on one eager "
                              "card it is the identity, and the port's model never calls it",
    "utils/hlo.py": "it parses HLO text, which eager PyTorch does not produce; its collective "
                    "bytes are zero on one card and its op counts come from utils/cost.py",
}


def test_port_covers_every_module():
    """Every ``src/repro/**/*.py`` has a twin under ``src/repro_torch/`` at
    the same path or under its ``RENAMED`` name, or a reason in ``NO_TWIN``;
    only the two GSPMD/HLO tools are without one."""
    jax_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel in NO_TWIN:
            continue
        if not (port_root / RENAMED.get(rel, rel)).exists():
            missing.append(rel)
    assert not missing, f"JAX modules without a twin: {missing}"
    assert set(NO_TWIN) == {"models/act_sharding.py", "utils/hlo.py"}
    for rel in list(NO_TWIN) + list(RENAMED):
        assert (jax_root / rel).exists(), rel
        assert not (port_root / rel).exists(), rel


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
               "sim/engine.py", "sim/sweep.py", "sim/shard.py", "sim/fl_batch.py",
               "fl/client.py", "core/contribution.py", "data/pipeline.py", "utils/tree.py",
               "core/availability.py", "fl/sparse.py", "fl/__init__.py", "data/dirichlet.py",
               "optim/__init__.py", "optim/optimizers.py", "launch/train.py",
               "data/synthetic.py", "models/moe.py", "configs/minicpm3_4b.py",
               "configs/deepseek_v2_236b.py", "configs/dbrx_132b.py", "models/ssm.py",
               "models/rglru.py", "configs/mamba2_1_3b.py", "configs/recurrentgemma_2b.py",
               "configs/phi_3_vision_4_2b.py", "configs/hubert_xlarge.py", "launch/mesh.py",
               "launch/shardings.py", "launch/specs.py", "launch/dryrun.py",
               "utils/roofline.py")


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
        SparseAsyncFLTrainer(SparseFLConfig(n_clients=100, n_sched=2, n_channels=5,
                                            batch_size=4), sched, env, lambda p, x, y: 0)
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


def test_training_entry_points_default_to_cuda(no_cuda, capsys):
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_state_init
    from repro_torch.optim import adamw

    model = build_model(get_smoke_config("qwen1.5-0.5b"), remat="none")
    init = make_train_state_init(model, adamw(1e-3), GLRCUCB(8, 4, history=16), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1"])
    assert capsys.readouterr().out == ""
    state = init(torch.Generator(), device="cpu")                # the explicit CPU request
    assert state.params["embed"].device.type == "cpu" and state.fl.aoi.device.type == "cpu"


def test_unported_archs_say_so():
    """No arch is left unported: the registry lists JAX's ids, each config
    builds at full width and gives its parameter specs, and the training
    launcher takes every arch.  The one refusal left is JAX's own: the
    serving launcher does not offer hubert-xlarge (an encoder has no
    decode step), and its model has no decode cache."""
    from repro.configs import list_archs as j_list_archs
    from repro_torch.configs import list_archs
    from repro_torch.launch import train

    assert list_archs() == j_list_archs()
    for arch in list_archs():
        specs, _ = build_model(get_config(arch)).param_specs()
        assert all(v.device.type == "meta" for v in specs.values()), arch
        assert train.parse_args(["--arch", arch]).arch == arch
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-only"):
        build_model(get_smoke_config("hubert-xlarge")).init_cache(1, 4, device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("hubert-base")


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
            flash_mod.flash_attention.launches, flash_mod.flash_attention_bwd.launches)


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


def test_cuda_calls_reach_the_kernel_before_any_cost_accounting(monkeypatch):
    """The CUDA branch of each entry point is the kernel's alone: it never
    asks for a cost walker, so no count and no cost is made there."""
    from repro_torch.utils import cost

    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    monkeypatch.setattr(cost, "active", lambda: pytest.fail("asked for the cost walker"))
    f = lambda *shape, dtype=torch.float32: _FakeCuda(torch.zeros(shape, dtype=dtype))
    i32, b8 = torch.int32, torch.bool
    calls = [
        lambda: ops.glr_step(f(3, 8), f(3), f(3), f(3, dtype=i32), f(3), f(3, dtype=b8)),
        lambda: ops.weighted_aggregate(f(2, 8), f(2)),
        lambda: ops.robust_trimmed(f(4, 8), f(4), f(), f()),
        lambda: ops.glr_scan(f(3, 8), f(3, dtype=i32)),
        lambda: ops.flash_attention(f(1, 2, 8, 16), f(1, 2, 8, 16), f(1, 2, 8, 16)),
        lambda: ops.flash_attention_bwd(*(f(1, 2, 8, 16, dtype=torch.bfloat16),) * 4,
                                        f(1, 2, 8), f(1, 2, 8, 16, dtype=torch.bfloat16)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no library"):
            call()


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


@pytest.mark.parametrize("d", [8, 32, 64, 72, 96, 128, 136, 200, 248, 256])
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
                                     (torch.bfloat16, 36), (torch.bfloat16, 196),
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
        list(range(8, 257, 8))
    assert not any(flash_mod.tc_route(torch.float32, d) for d in range(1, 257))


def test_model_attention_takes_the_routes(recorded):
    """``ops.flash_attention`` and the model's ``attn_core`` route like the
    wrapper: qwen3-32b's bf16 head dim of 128, phi-3-vision's 96 and
    recurrentgemma's 256 (its local attention, window 2048) to the tensor
    cores, f32 to the FMA kernel."""
    for dtype, d, name in ((torch.bfloat16, 128, "flash_attention_tc"),
                           (torch.bfloat16, 96, "flash_attention_tc"),
                           (torch.float32, 128, "flash_attention"),
                           (torch.bfloat16, 256, "flash_attention_tc")):
        q, kv = _qkv(d, dtype, s=3)
        ops.flash_attention(q, kv, kv)
        attn_mod.attn_core(q, kv, kv, causal=True, window=2048)
        assert [n for n, _, _ in recorded[-2:]] == [name, name]
        assert recorded[-1][2][10] == 2048                  # the window reaches the kernel


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


def test_both_tensor_core_attention_kernels_follow_the_hopper_header(monkeypatch, tmp_path):
    """The attention forward and backward on the tensor cores include
    ``hopper.cuh`` (mbarriers, TMA, wgmma): editing it renames (so
    rebuilds) both libraries and no other."""
    import shutil

    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    users = {k for k in _build.KERNELS
             if '#include "hopper.cuh"' in (tmp_path / f"{k}.cu").read_text()}
    assert users == {"flash_attention_tc", "flash_attention_bwd"}
    before = {k: _build.library_path(k).name for k in _build.KERNELS}
    (tmp_path / "hopper.cuh").write_text((tmp_path / "hopper.cuh").read_text() + "\n// edit\n")
    after = {k: _build.library_path(k).name for k in _build.KERNELS}
    assert all(after[k] != before[k] for k in users)


def test_a_build_keeps_its_compiler_report_beside_the_library(monkeypatch, tmp_path):
    """``_build.build`` writes each library's ``-Xptxas -v`` report beside it
    and ``_build.report`` reads it back; a library without its report is
    built again (an ``nvcc`` stand-in writes both here)."""
    import subprocess

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    calls = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            calls.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")

        def communicate(self):
            return "ptxas info    : 0 bytes spill stores, 0 bytes spill loads\n", None

    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    lib = _build.library_path("glr_step")
    assert _build.report_path("glr_step") == lib.with_suffix(".ptxas.txt")
    assert "0 bytes spill stores" in _build.report("glr_step") and len(calls) == 1
    assert _build.report("glr_step") and len(calls) == 1        # current: not rebuilt
    _build.report_path("glr_step").unlink()
    _build.report("glr_step")
    assert len(calls) == 2 and lib.exists()


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


def test_meta_tensors_reach_each_kernels_meta_route(monkeypatch):
    """Every entry point of ``ops`` on meta tensors returns the kernel's
    output shapes and dtypes from its meta route: no loader, no plain
    version, no launch counted; under a cost walker each call is one
    launch of its kernel.  Meta beside CPU operands is refused."""
    from repro_torch.core import regret
    from repro_torch.kernels import glr_step_tenants as gst_mod
    from repro_torch.kernels import regret_scan as rs_mod
    from repro_torch.utils import cost

    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the loader"))
    for name in ("glr_step", "glr_step_tenants", "weighted_aggregate", "robust_trimmed",
                 "glr_scan", "glr_scan_tenants", "mha_attention", "mha_attention_bwd"):
        monkeypatch.setattr(ops.ref, name, lambda *a, **k: pytest.fail("ran the plain version"))
    monkeypatch.setattr(regret, "_simulate_rounds",
                        lambda *a, **k: pytest.fail("ran the plain version"))
    counters = _counts() + (gst_mod.glr_step_tenants.launches, rs_mod.regret_scan.launches,
                            glr_scan_mod.glr_scan_tenants.launches)
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    f32 = torch.float32

    sched = GLRCUCB(3, 2, history=16)
    env = make_stationary(torch.linspace(0.9, 0.3, 3), device="meta")
    sched_state = sched.init("meta")

    def calls():
        out = {}
        out["glr_step"] = ops.glr_step(m(2, 3, 16), m(2, 3), m(2, 3), m(2, 3, dtype=torch.int32),
                                       m(2, 3), m(2, 3, dtype=torch.bool))
        out["glr_step_tenants"] = ops.glr_step_tenants(
            m(5, 3, 16), m(5, 3), m(5, 3), m(4, dtype=torch.int32), m(4, dtype=torch.bool),
            m(4, dtype=torch.bool), m(4, 3, dtype=torch.int32), m(4, 3), m(4, 3, dtype=torch.bool))
        out["weighted_aggregate"] = (ops.weighted_aggregate(m(4, 7, dtype=torch.bfloat16), m(4)),
                                     ops.weighted_aggregate(m(2, 4, 7), m(2, 4)))
        out["robust_trimmed"] = ops.robust_trimmed(m(2, 4, 7), m(2, 4), m(2), m(2))
        out["glr_scan"] = ops.glr_scan(m(3, 16), m(3, dtype=torch.int32))
        out["glr_scan_tenants"] = ops.glr_scan_tenants(m(5, 3, 16), m(4, dtype=torch.int32),
                                                       m(4, dtype=torch.bool),
                                                       m(4, 3, dtype=torch.int32))
        out["regret_scan"] = ops.regret_scan(sched, env, sched_state, m(50, 2, 3))
        out["flash_attention"] = ops.flash_attention(m(1, 4, 9, 32, dtype=torch.bfloat16),
                                                     m(1, 2, 9, 32, dtype=torch.bfloat16),
                                                     m(1, 2, 9, 32, dtype=torch.bfloat16))
        bf = lambda *shape: m(*shape, dtype=torch.bfloat16)
        out["flash_attention_bwd"] = ops.flash_attention_bwd(
            bf(1, 4, 9, 32), bf(1, 2, 9, 32), bf(1, 2, 9, 32), bf(1, 4, 9, 32), m(1, 4, 9),
            bf(1, 4, 9, 32), causal=True)
        return out

    out = calls()
    shapes = lambda t: (tuple(t.shape), t.dtype)
    assert [shapes(t) for t in out["glr_step"]] == [((2, 3, 16), f32)] + [((2, 3), f32)] * 3
    assert shapes(out["glr_step_tenants"]) == ((4, 3), f32)
    assert [shapes(t) for t in out["weighted_aggregate"]] == [((7,), f32), ((2, 7), f32)]
    assert shapes(out["robust_trimmed"]) == ((2, 7), f32)
    assert shapes(out["glr_scan"]) == ((3,), f32)
    assert shapes(out["glr_scan_tenants"]) == ((4, 3), f32)
    rs = out["regret_scan"]
    assert shapes(rs["regret"]) == ((50,), f32) and shapes(rs["channels"]) == ((50, 2), torch.int64)
    assert shapes(rs["aoi_pi"]) == ((2,), f32) and rs["restarts"].dtype == torch.int32
    assert shapes(out["flash_attention"]) == ((1, 4, 9, 32), torch.bfloat16)
    assert [shapes(t) for t in out["flash_attention_bwd"]] == \
        [((1, 4, 9, 32), torch.bfloat16)] + [((1, 2, 9, 32), torch.bfloat16)] * 2
    assert all(t.is_meta for t in [out["glr_scan"], out["flash_attention"], rs["regret"],
                                   *out["flash_attention_bwd"]])
    assert _counts() + (gst_mod.glr_step_tenants.launches, rs_mod.regret_scan.launches,
                        glr_scan_mod.glr_scan_tenants.launches) == counters

    tr = cost.trace(calls)
    assert tr.kernel_launches == {"glr_step": 1, "glr_step_tenants": 1, "weighted_aggregate": 2,
                                  "robust_trimmed": 1, "glr_scan": 1, "glr_scan_tenants": 1,
                                  "regret_scan": 1, "flash_attention": 1,
                                  "flash_attention_bwd": 1}
    assert tr.cost.flops == sum(c.flops for c in tr.kernel_cost.values())
    with pytest.raises(ValueError, match="meta route takes meta tensors"):
        ops.glr_scan(m(3, 16), torch.zeros(3, dtype=torch.int32))


def _bwd_args(d=64, dtype=torch.bfloat16, s=5, hq=4, hkv=2):
    """q, k, v, out, lse, do as fake CUDA tensors."""
    z = lambda *shape, dt=dtype: _FakeCuda(torch.zeros(shape, dtype=dt))
    return (z(1, hq, s, d), z(1, hkv, s, d), z(1, hkv, s, d), z(1, hq, s, d),
            z(1, hq, s, dt=torch.float32), z(1, hq, s, d))


class _Ctx:
    """The autograd context ``_KernelAttention.backward`` reads."""

    def __init__(self, saved, kernel_backward, causal=True, window=0, scale=0.125, chunk=512):
        self.saved_tensors, self.kernel_backward = saved, kernel_backward
        self.args = (causal, window, scale, chunk)


@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_bf16_cuda_backward_never_reaches_the_chunked_path(monkeypatch, d):
    """The model's attention gradient on a bf16 CUDA call of the
    tensor-core route goes to the backward kernels' loader at the five
    training head dims (64, 80, 96, 128, 256); a library that cannot be
    built raises there, and nothing reaches the chunked recompute, the
    plain version, or a counter."""
    def missing(*a, **k):
        raise RuntimeError("repro_torch kernel build failed: no library")

    monkeypatch.setattr(_build, "load", missing)
    monkeypatch.setattr(attn_mod, "_attn_core_plain",
                        lambda *a, **k: pytest.fail("reached the chunked recompute"))
    monkeypatch.setattr(ops.ref, "mha_attention_bwd",
                        lambda *a, **k: pytest.fail("ran the plain version"))
    args = _bwd_args(d)
    assert attn_mod.kernel_backward(args[0])
    before = _counts(), attn_mod._KernelAttention.plain_backward_calls
    with pytest.raises(RuntimeError, match="no library"):
        attn_mod._KernelAttention.backward(_Ctx(args[:5], True), args[5])
    with pytest.raises(RuntimeError, match="no library"):
        ops.flash_attention_bwd(*args)
    assert (_counts(), attn_mod._KernelAttention.plain_backward_calls) == before


def test_f32_cuda_backward_keeps_the_chunked_recompute(monkeypatch):
    """f32 and bf16 with D % 8 != 0 on the card are not the backward
    kernels' inputs: ``kernel_backward`` says so before any launch, and the
    backward recomputes through the chunked path, counted on its own."""
    assert not attn_mod.kernel_backward(_FakeCuda(torch.zeros((1, 2, 3, 64))))
    assert not attn_mod.kernel_backward(_FakeCuda(torch.zeros((1, 2, 3, 36),
                                                              dtype=torch.bfloat16)))
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the loader"))
    q = torch.randn((1, 2, 6, 8), dtype=torch.float64)
    g = torch.randn((1, 2, 6, 8), dtype=torch.float64)
    before = attn_mod._KernelAttention.plain_backward_calls
    grads = attn_mod._KernelAttention.backward(_Ctx((q, q, q), False), g)
    assert attn_mod._KernelAttention.plain_backward_calls == before + 1
    assert [t.shape for t in grads[:3]] == [q.shape] * 3 and grads[3:] == (None,) * 4


def test_flash_attention_bwd_refuses_what_the_kernels_do_not_take(monkeypatch):
    """Inputs outside the backward kernels are refused before the loader:
    f32, bf16 with D % 8 != 0 or D > 256, a mismatched out, dO or
    logsumexp, a non-contiguous tensor, CPU tensors; no launch, no count."""
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the loader"))
    before = _counts()
    f = flash_mod.flash_attention_bwd
    with pytest.raises(ValueError, match="tensor-core forward takes"):
        f(*_bwd_args(64, torch.float32))
    with pytest.raises(ValueError, match="tensor-core forward takes"):
        f(*_bwd_args(36))
    with pytest.raises(ValueError, match="unsupported shape"):
        f(*_bwd_args(264))
    args = list(_bwd_args())
    for i, bad, what in ((3, _FakeCuda(torch.zeros((1, 4, 5, 32), dtype=torch.bfloat16)), "out"),
                         (5, _FakeCuda(torch.zeros((1, 4, 5, 64))), "do"),
                         (4, _FakeCuda(torch.zeros((1, 4, 5), dtype=torch.bfloat16)), "lse"),
                         (4, _FakeCuda(torch.zeros((1, 4, 6))), "lse")):
        with pytest.raises(ValueError, match=f"{what} must be"):
            f(*args[:i], bad, *args[i + 1:])
    strided = _FakeCuda(torch.zeros((1, 5, 4, 64), dtype=torch.bfloat16).transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        f(*args[:5], strided)
    with pytest.raises(ValueError, match="window"):
        f(*args, window=-1)
    with pytest.raises(ValueError, match="CUDA"):
        f(*(t._t for t in args))
    with pytest.raises(ValueError, match="tensor-core route only"):
        flash_mod.flash_attention(*_bwd_args(64, torch.float32)[:3], return_lse=True)
    assert _counts() == before


def test_backward_reaches_its_launch_function(recorded):
    """A bf16 backward call loads ``flash_attention_bwd_launch`` once with
    the shape, mask and scale, counts one call, and returns dq, dk, dv in
    the inputs' shapes; the forward asked for the logsumexp hands the
    tensor-core kernel a pointer for it."""
    args = _bwd_args(96, s=7, hq=6, hkv=2)
    before = _counts()
    dq, dk, dv = flash_mod.flash_attention_bwd(*args, causal=False, window=3)
    assert [(n, s) for n, s, _ in recorded] == [("flash_attention_bwd",
                                                 "flash_attention_bwd_launch")]
    call = recorded[0][2]
    assert call[10:17] == (1, 6, 2, 7, 96, 0, 3)        # b, hq, hkv, s, d, causal, window
    assert call[17] == pytest.approx(1.0 / math.sqrt(96))
    assert [t.shape for t in (dq, dk, dv)] == [(1, 6, 7, 96), (1, 2, 7, 96), (1, 2, 7, 96)]
    assert _counts() == before[:5] + (before[5] + 1,)
    out, lse = flash_mod.flash_attention(*args[:3], return_lse=True)
    assert recorded[-1][1] == "flash_attention_tc_launch" and recorded[-1][2][12] is not None
    assert lse.shape == (1, 6, 7) and lse.dtype == torch.float32


def test_failed_backward_launch_raises(monkeypatch):
    """A backward launch that returns a CUDA error raises and counts
    nothing."""
    monkeypatch.setattr(_build, "load", lambda name, symbol, argtypes: lambda *a: 1)
    monkeypatch.setattr(flash_mod, "_stream", lambda q: 0)
    before = _counts()
    with pytest.raises(RuntimeError, match="flash_attention_bwd: kernel launch failed"):
        flash_mod.flash_attention_bwd(*_bwd_args(128))
    assert _counts() == before
