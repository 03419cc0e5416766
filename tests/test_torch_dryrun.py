"""The launcher's dry run and its cost tools against the JAX package.

* ``launch/shardings.py`` and ``launch/specs.py``: the specs of JAX's own
  cases, of every parameter of every arch at full size on 16 x 16 and
  2 x 16 x 16 meshes under both layouts, and of every decode cache, equal
  to JAX's entry for entry; ``supported`` and ``serve_window`` over every
  arch and JAX's four shapes (38 ok, 2 skipped).
* ``utils/cost.py``: the walker's FLOPs on JAX's three cost cases equal
  JAX's ``step_cost`` (dots exactly; the checkpointed backward bounded as
  JAX's test bounds it); a real CPU step and the same step on meta count
  the same FLOPs and launches.
* each kernel's ``cost`` reproduces the bound PERF.md's kernel table
  states; ``Roofline`` with the card's constants, collective term unknown.
* ``launch/dryrun.py`` at full width and depth on meta: the kernel
  launches a step and the static bytes ``chip_smoke.py`` phase 19 measured
  on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import shardings as j_shard  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.utils.jaxpr_cost import step_cost as j_step_cost  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.core.channels import make_stationary  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import glr_step as gs_mod  # noqa: E402
from repro_torch.kernels import robust_agg as ra_mod  # noqa: E402
from repro_torch.kernels import weighted_aggregate as wa_mod  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings, specs  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    TrainState,
    init_fl_scale_state,
    make_fl_train_step,
    make_train_state_init,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils import cost  # noqa: E402
from repro_torch.utils.roofline import HBM_BW, PEAK_FLOPS_BF16, Roofline  # noqa: E402
from test_torch_train import _chip_smoke  # noqa: E402

MESHES = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}


# ---------------------------------------------------------------------------
# (i) specs against JAX's
# ---------------------------------------------------------------------------

def test_mesh_descriptions():
    m, mp = MESHES["16x16"], MESHES["2x16x16"]
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    assert make_host_mesh().shape == {"data": 1, "model": 1}


def test_logical_and_cache_specs_on_jax_cases():
    """JAX's own cases (``tests/test_analysis_tools.py``), through both."""
    m = MESHES["16x16"]
    for shape, logical in (((1024, 4096), ("embed", "heads")), ((100, 152064), ("heads", "vocab")),
                           ((64, 64), ("heads", "vocab"))):
        got = shardings.logical_to_pspec(shape, logical, m)
        assert got == tuple(j_shard.logical_to_pspec(shape, logical, m))
    assert shardings.logical_to_pspec((1024, 4096), ("embed", "heads"), m) == ("data", "model")
    assert shardings.logical_to_pspec((100, 152064), ("heads", "vocab"), m) == (None, "model")
    assert shardings.logical_to_pspec((64, 64), ("heads", "vocab"), m) == ("model", None)
    for key, shape in (("k", (64, 128, 8, 32768, 128)), ("latent", (60, 1, 4096, 512)),
                       ("pos", ())):
        assert specs.cache_pspec(key, shape, m) == tuple(j_specs.cache_pspec(key, shape, m))
    assert specs.cache_pspec("k", (64, 128, 8, 32768, 128), m) == (
        None, "data", None, "model", None)
    for mesh in MESHES.values():
        for layout in ("tp", "fsdp"):
            assert shardings.batch_pspec(mesh, layout) == tuple(j_shard.batch_pspec(mesh, layout))


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_jax_on_both_meshes_and_layouts(arch):
    """Every parameter of the full-size config: the same shape and logical
    spec as JAX's, and the same mesh spec on 16 x 16 and 2 x 16 x 16 under
    tp and fsdp, entry for entry."""
    params, logical = Model(get_config(arch)).param_specs()
    j_params, j_logical = JModel(j_get_config(arch)).param_specs()
    assert sorted(params) == sorted(j_params)
    for k, v in params.items():
        assert tuple(v.shape) == tuple(j_params[k].shape) and logical[k] == j_logical[k], k
    for mesh in MESHES.values():
        for layout, rules in shardings.LAYOUTS.items():
            shards = shardings.param_shard_shapes(params, logical, mesh, rules)
            for k, v in params.items():
                want = tuple(j_shard.logical_to_pspec(tuple(v.shape), logical[k], mesh,
                                                      j_shard.LAYOUTS[layout]))
                spec = shards[k][1]
                assert spec == want, (k, mesh.sizes, layout)
                assert shards[k][0] == shardings.shard_shape(tuple(v.shape), spec, mesh)


def test_shard_shape_divides_by_the_axes_of_each_entry():
    m = MESHES["2x16x16"]
    assert shardings.shard_shape((64, 4096, 128), (("pod", "data"), "model"), m) == (2, 256, 128)
    assert shardings.shard_shape((8, 8), (), m) == (8, 8)


@pytest.mark.parametrize("arch", [a for a in list_archs() if not get_config(a).is_encoder])
def test_cache_specs_equal_jax(arch):
    """Every decode cache entry at decode_32k and long_500k: JAX's shape,
    dtype and spec, built on meta (nothing allocated)."""
    from jax.sharding import AbstractMesh

    mesh = MESHES["16x16"]
    j_mesh = AbstractMesh((16, 16), ("data", "model"))
    for name in ("decode_32k", "long_500k"):
        shape = specs.SHAPES[name]
        got = specs.cache_specs(Model(get_config(arch)), shape, mesh)
        want = j_specs.cache_specs(JModel(j_get_config(arch)), j_specs.SHAPES[name], j_mesh)
        assert sorted(got) == sorted(want)
        for k in got:
            pairs = ([(kk, got[k][kk], want[k][kk]) for kk in got[k]] if isinstance(got[k], dict)
                     else [(k, got[k], want[k])])
            for key, g, w in pairs:
                assert g.value.is_meta and tuple(g.value.shape) == tuple(w.shape), key
                assert str(g.value.dtype).split(".")[1] == str(w.dtype), key
                assert g.spec == tuple(w.sharding.spec), key


# ---------------------------------------------------------------------------
# (ii) the assignment matrix
# ---------------------------------------------------------------------------

def test_supported_and_serve_window_match_jax_over_every_arch_and_shape():
    n_ok = n_skip = 0
    for arch in list_archs():
        cfg, j_cfg = get_config(arch), j_get_config(arch)
        for name in j_specs.SHAPES:
            assert specs.SHAPES[name] == specs.ALL_SHAPES[name]
            assert dataclasses.astuple(specs.SHAPES[name])[:-1] == dataclasses.astuple(
                j_specs.SHAPES[name])
            ok, reason = specs.supported(cfg, name)
            assert (ok, reason) == j_specs.supported(j_cfg, name)
            assert specs.serve_window(cfg, name) == j_specs.serve_window(j_cfg, name)
            n_ok += ok
            n_skip += not ok
    assert (n_ok, n_skip) == (38, 2)


def test_card_shapes_are_the_smokes_steps():
    assert {k: (v.seq_len, v.global_batch, v.mode) for k, v in specs.CARD_SHAPES.items()} == {
        "card_train": (2048, 8, "train"), "card_train_s1024": (1024, 4, "train"),
        "card_prefill": (2048, 4, "prefill"), "card_decode": (2048, 8, "decode")}
    smoke = _chip_smoke()
    trained = {smoke.card_train_shape(b, s): (s, b) for _, _, b, s, _ in smoke.MLA_MOE_TRAINED}
    trained["card_train"] = (smoke.TRAIN_S, smoke.TRAIN_B)
    assert trained == {k: (v.seq_len, v.global_batch) for k, v in specs.CARD_SHAPES.items()
                       if v.mode == "train"}


def test_training_shapes_carry_their_fl_setup():
    """JAX's shapes carry JAX's dry run's FL half, the card's the launcher's."""
    from repro.launch import dryrun as j_dryrun

    from repro_torch.launch import train

    pod = (j_dryrun.N_CLIENTS, j_dryrun.N_CHANNELS, j_dryrun.SCHED_HISTORY, 8)
    assert all(tuple(v.fl) == pod for v in specs.SHAPES.values())
    args = train.parse_args(["--arch", "qwen1.5-0.5b"])
    run_sched = GLRCUCB(args.channels, args.clients, history=train.SCHED_HISTORY)
    for name in ("card_train", "card_train_s1024"):
        assert tuple(specs.CARD_SHAPES[name].fl) == (
            args.clients, args.channels, run_sched.history, run_sched.detector_stride)


# ---------------------------------------------------------------------------
# (iii) the walker against JAX's step_cost
# ---------------------------------------------------------------------------

def test_walker_counts_every_trip_of_a_loop_as_jax_counts_the_scan():
    def j_f(x, w):
        def body(c, wi):
            return c @ wi, ()
        y, _ = jax.lax.scan(body, x, w)
        return y

    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    want = j_step_cost(j_f, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                       jax.ShapeDtypeStruct((12, 64, 64), jnp.float32)).flops
    got = cost.step_cost(f, torch.empty((64, 64), device="meta"),
                         torch.empty((12, 64, 64), device="meta")).flops
    assert got == want == 12 * 2 * 64 ** 3


def test_walker_counts_the_checkpoints_recompute():
    from torch.utils.checkpoint import checkpoint

    def j_f(x, w):
        def blk(c, wi):
            return jax.checkpoint(lambda a, b: jnp.tanh(a @ b))(c, wi), ()
        y, _ = jax.lax.scan(blk, x, w)
        return jnp.sum(y)

    def f(x, w):
        for i in range(w.shape[0]):
            x = checkpoint(lambda a, b: torch.tanh(a @ b), x, w[i], use_reentrant=False)
        return torch.sum(x)

    def grad_w(x, w):
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            return torch.autograd.grad(f(x, w), w)[0]

    x = torch.empty((64, 64), device="meta")
    w = torch.empty((4, 64, 64), device="meta")
    fwd, bwd = cost.step_cost(f, x, w), cost.step_cost(grad_w, x, w)
    assert bwd.flops > 2.5 * fwd.flops          # JAX's bound: recompute + two transposes
    xs, ws = (jax.ShapeDtypeStruct(s, jnp.float32) for s in ((64, 64), (4, 64, 64)))
    j_fwd, j_bwd = j_step_cost(j_f, xs, ws), j_step_cost(jax.grad(j_f, argnums=1), xs, ws)
    assert j_bwd.flops > 2.5 * j_fwd.flops
    dots = 4 * 2 * 64 ** 3
    assert fwd.flops - dots == j_fwd.flops - dots == 4 * 64 * 64 + 1   # tanh, the sum
    assert bwd.flops >= 3 * dots                  # forward, recompute and two transposes


def test_walker_counts_a_batched_einsum_exactly():
    def f(a, b):
        return torch.einsum("bij,bjk->bik", a, b)

    want = j_step_cost(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                       jax.ShapeDtypeStruct((4, 32, 16), jnp.float32),
                       jax.ShapeDtypeStruct((4, 16, 8), jnp.float32)).flops
    got = cost.step_cost(f, torch.empty((4, 32, 16), device="meta"),
                         torch.empty((4, 16, 8), device="meta"))
    assert got.flops == want == 2 * 4 * 32 * 16 * 8
    assert got.dot_bytes == 4 * (4 * 32 * 16 + 4 * 16 * 8 + 4 * 32 * 8)


def test_walker_tracks_live_bytes_to_the_allocators_block():
    def f(x):
        y = x * 2                  # 4000 bytes -> 4096
        z = y.sum()                # 4 -> 512
        del y
        return z + 1               # 512

    tr = cost.trace(f, torch.empty(1000, device="meta"))
    assert tr.argument_bytes == 4096
    assert tr.peak_bytes == 4096 + 4096 + 512
    assert tr.end_bytes == 4096 + 512
    assert cost.storage_bytes([torch.empty(10, device="meta")] * 2) == 512
    assert cost.storage_bytes(torch.empty(10, device="meta"), rounded=False) == 40


@pytest.mark.parametrize("sizes,free,want", [
    ([4000, 4, 40], (), 4096 + 512 + 512),                  # small pool: each block as requested
    ([3 << 20], (), 3 << 20),                               # split off a new 20 MiB segment
    ([19 << 20], (), 20 << 20),                             # rest 1 MiB: the whole segment
    ([11 << 20, 5 << 20], (), (12 << 20) + (5 << 20)),       # >= 10 MiB: rounded to 2 MiB
    ([3 << 20], [((3 << 20) + (1 << 20), False)], (3 << 20) + (1 << 20)),  # a cached block, whole
    ([3 << 20], [((3 << 20) + (2 << 20), False)], 3 << 20),  # a cached block, split
    ([3 << 20], [(5 << 20, False), (4 << 20, False)], 4 << 20),  # the smallest that fits
    ([600], [(1024, True)], 1024),                          # small pool: rest 0 after 1024
    ([3 << 20], [(1 << 20, True)], 3 << 20),                # another pool's block is no use
])
def test_allocator_model_from_cached_blocks(sizes, free, want):
    assert cost.allocated_bytes(sizes, free) == want


def _train_step(device, attn_impl="kernel"):
    """The smoke config's FL train step with its state and inputs on
    ``device`` (real on the CPU, from param_specs on meta)."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = Model(cfg=cfg, remat="full", attn_impl=attn_impl)
    sched = GLRCUCB(8, 4, history=16, detector_backend="kernel")
    opt = adamw(1e-3)
    env = make_stationary(torch.linspace(0.9, 0.3, 8), device=device)
    if device == "meta":
        params, _ = model.param_specs()
        state = TrainState(params, opt.init(params), init_fl_scale_state(sched, 4, 0.5, "meta"))
        batch = {"tokens": torch.empty((8, 32), dtype=torch.int32, device="meta")}
        u = torch.empty((2, 8), device="meta")
    else:
        gen = torch.Generator().manual_seed(0)
        state = make_train_state_init(model, opt, sched, 4)(gen, device="cpu")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 32), generator=gen,
                                         dtype=torch.int32)}
        u = torch.rand((2, 8), generator=gen)
    return make_fl_train_step(model, opt, sched, env, 4, donate=True), (state, batch, u[0], u[1])


def test_a_real_cpu_step_and_its_meta_twin_count_the_same():
    """(vii): the walker over a real step on the CPU (the kernels' plain
    versions run in their place, uncounted) and over the same step on meta
    (their meta routes): the same FLOPs, bytes and launches."""
    real = cost.trace(*(lambda s, a: (s, *a))(*_train_step("cpu")))
    meta = cost.trace(*(lambda s, a: (s, *a))(*_train_step("meta")))
    assert real.kernel_launches == meta.kernel_launches == {"flash_attention": 4,
                                                            "flash_attention_bwd": 2,
                                                            "glr_step": 1}
    assert real.cost.flops == meta.cost.flops
    assert real.cost.bytes_fused == meta.cost.bytes_fused
    assert real.op_counts == meta.op_counts
    assert np.isfinite(float(real.result[1]["loss"]))


# ---------------------------------------------------------------------------
# (iv) the kernels' bounds, (v) the roofline
# ---------------------------------------------------------------------------

def _pairs_by_loop(s, causal, window):
    total = 0
    for q in range(s):
        lo = max(0, q - window + 1) if window > 0 else 0
        total += (q if causal else s - 1) - lo + 1
    return total


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,window", [(1, 0), (7, 0), (300, 0), (300, 64), (300, 300), (64, 300)])
def test_attention_pairs_closed_form(s, window, causal):
    assert fa_mod.pairs(s, causal, window) == _pairs_by_loop(s, causal, window)


def test_kernel_costs_reproduce_the_bounds_of_the_kernel_table():
    fa = fa_mod.cost((4, 64, 8, 2048, 128), causal=True, dtype=torch.bfloat16)
    assert (round(fa.bound_ms, 4), fa.bound_by) == (0.2781, "operations")
    assert fa.ops == 2 * 4 * 64 * 2048 * 2049 * 128       # 4 D a pair, S (S + 1) / 2 pairs
    wa = wa_mod.cost((64, 2 ** 24), 4)
    assert (round(wa.bound_ms, 4), wa.bound_by) == (1.3021, "bytes")
    rt = ra_mod.cost((64, 2 ** 22 + 3), 4)
    assert (round(rt.bound_ms, 4), rt.bound_by) == (0.5128, "operations")
    gs = gs_mod.cost(5, 1024, splits=0)
    assert (float(f"{gs.bound_ms:.3g}"), gs.bound_by) == (1.23e-05, "bytes")
    assert gs_mod.cost(5, 1024).ops == 32 * 5 * 1023 + 5     # no counts given: full windows
    assert gs_mod.full_window_splits(8, geometric=True) == 5  # s in {1, 2, 4, 6, 7}


def test_reactive_scan_cost_adds_the_table_and_the_reaction():
    from repro_torch.core.channels.base import N_REACT
    from repro_torch.kernels import regret_scan as rs_mod

    n, m, h, t, runs = 5, 2, 1024, 200, 3
    plain = rs_mod.cost(n, m, h, t, runs, splits=1000)
    react = rs_mod.cost(n, m, h, t, runs, splits=1000, reactive=True)
    assert react.ops - plain.ops == runs * rs_mod.REACT_FLOPS * n * t
    assert react.nbytes - plain.nbytes == runs * (t * n * 4 + N_REACT * 4)
    assert plain.ops == 32 * 1000 and plain.rate == react.rate


def test_roofline_with_the_cards_constants():
    r = Roofline(flops=PEAK_FLOPS_BF16, hbm_bytes=HBM_BW / 2, coll_bytes=None,
                 model_flops=PEAK_FLOPS_BF16 * 256, chips=256)
    assert r.bottleneck == "compute" and r.t_collective is None
    assert abs(r.t_compute - 1.0) < 1e-12
    assert abs(r.useful_flop_ratio - 1.0) < 1e-12 and abs(r.mfu_bound - 1.0) < 1e-12
    r2 = Roofline(flops=1e12, hbm_bytes=HBM_BW, coll_bytes=None)
    assert r2.bottleneck == "memory" and r2.step_time_lower_bound == 1.0
    assert r2.to_dict()["t_collective_s"] is None


# ---------------------------------------------------------------------------
# (vi) the dry run at full width and depth against the card
# ---------------------------------------------------------------------------

# chip_smoke.py phase 19 on an NVIDIA H100 80GB HBM3 at 700.00 W: the
# launches a step of each kernel on the card, and the static GiB (the
# weights and AdamW state a training step is handed, the weights and
# prompts of a prefill, the weights, cache and tokens of a decode step) as
# the card's memory_allocated counted them after a setup that starts from
# an emptied cache, as chip_smoke.py's does
CARD = {
    ("qwen1.5-0.5b", None, "card_train"): ({"flash_attention": 48, "flash_attention_bwd": 24,
                                            "glr_step": 1}, 4.3222),
    ("hubert-xlarge", None, "card_train"): ({"flash_attention": 96, "flash_attention_bwd": 48,
                                             "glr_step": 1}, 8.8051),
    ("mamba2-1.3b", None, "card_train"): ({"glr_step": 1}, 13.4717),
    ("recurrentgemma-2b", None, "card_train"): ({"flash_attention": 16, "flash_attention_bwd": 8,
                                                 "glr_step": 1}, 31.3345),
    ("phi-3-vision-4.2b", None, "card_train"): ({"flash_attention": 64, "flash_attention_bwd": 32,
                                                 "glr_step": 1}, 35.5878),
    ("minicpm3-4b", None, "card_train"): ({"glr_step": 1}, 39.7062),
    ("deepseek-v2-236b", 2, "card_train_s1024"): ({"glr_step": 1}, 48.3733),
    ("dbrx-132b", 1, "card_train"): ({"flash_attention": 2, "flash_attention_bwd": 1,
                                      "glr_step": 1}, 41.837),
    ("qwen3-32b", None, "card_prefill"): ({"flash_attention": 64}, 61.0247),
    ("qwen3-32b", None, "card_decode"): ({}, 65.0247),
    ("minicpm3-4b", None, "card_prefill"): ({}, 7.9427),
    ("minicpm3-4b", None, "card_decode"): ({}, 8.4875),
    ("deepseek-v2-236b", 8, "card_prefill"): ({}, 54.0711),
    ("deepseek-v2-236b", 8, "card_decode"): ({}, 54.2117),
    ("dbrx-132b", 8, "card_prefill"): ({"flash_attention": 8}, 50.8611),
    ("dbrx-132b", 8, "card_decode"): ({}, 51.361),
    ("mamba2-1.3b", None, "card_prefill"): ({}, 2.6944),
    ("mamba2-1.3b", None, "card_decode"): ({}, 3.4538),
    ("recurrentgemma-2b", None, "card_prefill"): ({"flash_attention": 8}, 6.242),
    ("recurrentgemma-2b", None, "card_decode"): ({}, 6.3704),
    ("phi-3-vision-4.2b", None, "card_prefill"): ({"flash_attention": 32}, 7.1209),
    ("phi-3-vision-4.2b", None, "card_decode"): ({}, 13.1176),
}


@pytest.mark.parametrize("arch,n_layers,shape", list(CARD), ids=lambda x: str(x))
def test_dry_run_reproduces_the_cards_launches_and_static_bytes(arch, n_layers, shape):
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rec = dryrun.run_one(cfg, shape, ce_chunk=512 if shape.startswith("card_train") else 0,
                         verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    launches, static_gib = CARD[(arch, n_layers, shape)]
    assert rec["kernel_launches"] == launches
    assert abs(rec["memory"]["static_allocated"] / 2 ** 30 - static_gib) <= 0.01
    assert rec["mesh"] == "1" and rec["memory"]["fits"]
    assert rec["roofline"]["collective_bytes_per_device"] is None


def test_dry_run_records_jax_shapes_per_device_and_refuses_seq_shard(tmp_path, capsys):
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", "2x16x16", str(tmp_path), verbose=False)
    assert rec["status"] == "ok" and rec["roofline"]["chips"] == 512
    per = rec["memory"]["per_device"]
    params, _ = Model(get_config("qwen1.5-0.5b")).param_specs()
    total = sum(v.numel() * v.element_size() for v in params.values())
    assert total / 512 <= per["params_bytes"] < total and per["adamw_bytes"] == 0
    assert (tmp_path / "qwen1.5-0.5b__decode_32k__2x16x16.json").exists()
    skip = dryrun.run_one("hubert-xlarge", "decode_32k", verbose=False)
    assert skip["status"] == "skipped"
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "card_decode", "--seq-shard"])
    assert "GSPMD" in capsys.readouterr().err
