"""Dry run: what a production step holds, computes and launches, without running it.

Twin of ``repro/launch/dryrun.py``.  For each (architecture x input shape)
it builds the production step on the meta device, where no tensor has
storage and no op computes: the FL train round (``make_train_state_init``'s
state and ``make_fl_train_step(donate=True)``, as the launcher steps), the
prefill forward (``make_prefill_step``) or the one-token serve step
(``make_serve_step(window)``), and runs it once under the cost walker
(``utils/cost.py``).  It records

  * memory: the arguments' bytes, the step's state (``static_bytes``: the
    weights and AdamW state a training step is given, the weights and
    prompts of a prefill, the weights, cache and tokens of a decode step),
    the peak and the temporaries, each storage rounded to the caching
    allocator's 512-byte block; the state's bytes as requested
    (``static_bytes_exact``) and as the allocator counts them when it
    allocates the state in order from empty (``static_allocated``: a large
    block is not split for a remainder of 1 MiB or less), and each
    argument's storage sizes in order (``static_sizes``: for a model of an
    allocator that holds cached blocks);
  * ``cost_logical``: FLOPs and bytes, as the walker counts them;
  * ``roofline``: the card's terms (``utils/roofline.py``), with the FLOPs
    and bytes divided by the mesh's devices as JAX's dry run does;
    collective bytes are ``None`` (a mesh description has no partitioner
    to count them);
  * ``kernel_launches``: the port's kernels a step launches on the card;
  * ``status``: ok, skipped (an encoder has no decode step) or error.

JAX's four shapes assume a multi-device mesh: for them it also reports
each device's parameter and AdamW bytes under ``--layout tp|fsdp`` on the
named mesh (``launch/shardings.py`` ``param_shard_shapes``).  The four
card shapes (``launch/specs.py`` ``CARD_SHAPES``) are ``chip_smoke.py``'s
own steps on one card: their records say whether the peak fits the card's
80 GiB, and ``chip_smoke.py`` phase 19 holds them against the card.  A
training step's FL setup is its shape's (``ShapeSpec.fl``): the card's is
the launcher's (a batch of 8 does not split over 16 clients), JAX's
shapes JAX's dry run's 16 clients, 32 channels, history 256 and detector
stride 8.

The scheduler half of the FL step (the GLR-CUCB state, the matcher, the
channel draw: a few KB) runs on meta beside the model: none of it reads a
value on the host (no ``.item()``, no boolean mask), so it needs no way
out.  The streaming detector takes its kernel route on meta, as it does on
the card.

Usage (on the host; no card is needed):
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh 16x16 --out DIR
  python -m repro_torch.launch.dryrun --arch hubert-xlarge --shape card_train --ce-chunk 512

``--shape all`` takes JAX's four and the card's four.  ``main`` returns
1 when any record has status ``error``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bandits import GLRCUCB
from repro_torch.core.channels import make_stationary
from repro_torch.launch.mesh import MeshShape, make_host_mesh, make_production_mesh
from repro_torch.launch.shardings import LAYOUTS, param_shard_shapes
from repro_torch.launch.specs import (
    ALL_SHAPES,
    CARD_SHAPES,
    batch_specs,
    cache_specs,
    decode_token_specs,
    serve_window,
    supported,
    values,
)
from repro_torch.launch.steps import (
    TrainState,
    init_fl_scale_state,
    make_fl_train_step,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.utils import cost as cost_mod
from repro_torch.utils.roofline import (
    CARD_MEMORY,
    Roofline,
    model_flops_forward,
    model_flops_train,
)

MESHES = {"1": lambda: make_host_mesh(),
          "16x16": lambda: make_production_mesh(),
          "2x16x16": lambda: make_production_mesh(multi_pod=True)}


def _cfg(arch_or_cfg: Union[str, ModelConfig]) -> ModelConfig:
    return get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg


def build_step_and_specs(arch_or_cfg, shape_name: str, mesh, remat: str = "full",
                         layout: str = "tp", ce_chunk: int = 0, microbatch: int = 1):
    """Returns (step, args, static, params, specs, model_flops): the step
    function, its meta arguments, the ones that are the step's state
    (``static``, a tuple), the meta parameters with their logical specs,
    and 6 N D (train) or 2 N D model FLOPs."""
    cfg = _cfg(arch_or_cfg)
    shape = ALL_SHAPES[shape_name]
    model = Model(cfg=cfg, remat=remat, ce_chunk=ce_chunk)
    params, specs = model.param_specs()
    batch = values(batch_specs(cfg, shape, mesh, layout))

    if shape.mode == "train":
        clients, channels, history, stride = shape.fl
        scheduler = GLRCUCB(channels, clients, history=history, detector_stride=stride)
        env = make_stationary(torch.linspace(0.9, 0.3, channels), device="meta")
        optimizer = adamw(3e-4)
        state = TrainState(params, optimizer.init(params),
                           init_fl_scale_state(scheduler, clients, 0.5, "meta"))
        step = make_fl_train_step(model, optimizer, scheduler, env, clients,
                                  microbatches=microbatch, donate=True)
        u = torch.empty((2, channels), device="meta")
        tokens = shape.global_batch * shape.seq_len
        mflops = model_flops_train(cfg.active_param_count(), tokens)
        return step, (state, batch, u[0], u[1]), (state,), params, specs, mflops

    if shape.mode == "prefill":
        tokens = shape.global_batch * (
            shape.seq_len + (cfg.frontend_tokens if cfg.arch_type == "vlm" else 0))
        mflops = model_flops_forward(cfg.active_param_count(), tokens)
        args = (params, batch)
        return make_prefill_step(model), args, args, params, specs, mflops

    window = serve_window(cfg, shape_name)
    cache = values(cache_specs(model, shape, mesh))
    tok = decode_token_specs(cfg, shape, mesh).value
    mflops = model_flops_forward(cfg.active_param_count(), shape.global_batch)
    args = (params, cache, tok)
    return make_serve_step(model, window=window), args, args, params, specs, mflops


def per_device_bytes(params, specs, mesh, layout: str, train: bool) -> Dict[str, int]:
    """Each device's parameter bytes, and AdamW's two f32 moments for a
    training step, under ``layout`` on ``mesh``."""
    shards = param_shard_shapes(params, specs, mesh, LAYOUTS[layout])
    out = {"params_bytes": 0, "adamw_bytes": 0}
    for k, (shape, _) in shards.items():
        n = 1
        for d in shape:
            n *= d
        out["params_bytes"] += n * params[k].element_size()
        if train:
            out["adamw_bytes"] += 2 * n * 4
    return out


def run_one(arch_or_cfg, shape_name: str, mesh_name: str = "16x16", out_dir: Optional[str] = None,
            remat: str = "full", layout: str = "tp", ce_chunk: int = 0,
            microbatch: int = 1, verbose: bool = True) -> Dict[str, Any]:
    """One dry run; returns its record (and writes it under ``out_dir``)."""
    cfg = _cfg(arch_or_cfg)
    ok, reason = supported(cfg, shape_name)
    mode = ALL_SHAPES[shape_name].mode
    if mode == "decode":
        layout = "tp"                # decode wants the tensor axis (latency + cache)
    card = shape_name in CARD_SHAPES
    if card:
        mesh_name = "1"              # the card's shapes run on the one card
    rec: Dict[str, Any] = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "shape": shape_name, "mesh": mesh_name,
        "remat": remat, "layout": layout, "ce_chunk": ce_chunk, "microbatch": microbatch,
    }
    say = print if verbose else (lambda *a, **k: None)
    if not ok:
        rec.update(status="skipped", reason=reason)
        say(f"[dryrun] {cfg.name} x {shape_name} x {mesh_name}: SKIP ({reason})")
        return _write(rec, out_dir)

    t0 = time.perf_counter()
    try:
        mesh: MeshShape = MESHES[mesh_name]()
        step, args, static, params, specs, mflops = build_step_and_specs(
            cfg, shape_name, mesh, remat, layout, ce_chunk, microbatch)
        tr = cost_mod.trace(step, *args)
        trace_s = time.perf_counter() - t0
        chips = mesh.size
        roof = Roofline(flops=tr.cost.flops / chips, hbm_bytes=tr.cost.bytes_fused / chips,
                        coll_bytes=None, model_flops=mflops, chips=chips,
                        attn_score_bytes=tr.cost.attn_score_bytes / chips)
        memory = {
            "argument_bytes": tr.argument_bytes,
            "static_bytes": cost_mod.storage_bytes(static),
            "static_bytes_exact": cost_mod.storage_bytes(static, rounded=False),
            "static_allocated": cost_mod.allocated_bytes(cost_mod.storages(static).values()),
            "static_storages": len(cost_mod.storages(static)),
            "static_sizes": [list(cost_mod.storages(part).values()) for part in static],
            "temp_bytes": tr.temp_bytes,
            "peak_bytes": tr.peak_bytes,
            "output_bytes": tr.end_bytes,
        }
        if card:
            memory["card_bytes"] = CARD_MEMORY
            memory["fits"] = tr.peak_bytes <= CARD_MEMORY
        else:
            memory["per_device"] = per_device_bytes(params, specs, mesh, layout, mode == "train")
        rec.update(status="ok", trace_s=round(trace_s, 2), memory=memory,
                   cost_logical=tr.cost.to_dict(), kernel_launches=tr.kernel_launches,
                   kernel_cost={k: v.to_dict() for k, v in tr.kernel_cost.items()},
                   ops=tr.op_counts, roofline=roof.to_dict())
        say(f"[dryrun] {cfg.name} x {shape_name} x {mesh_name}: OK (trace {trace_s:.1f}s) "
            f"bottleneck={roof.bottleneck} t=({roof.t_compute:.3e}, {roof.t_memory:.3e})s "
            f"peak {tr.peak_bytes / 2 ** 30:.2f} GiB, kernels {tr.kernel_launches}")
    except Exception as e:  # noqa: BLE001 — a failure here IS the finding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        say(f"[dryrun] {cfg.name} x {shape_name} x {mesh_name}: FAIL {type(e).__name__}: {e}")
    return _write(rec, out_dir)


def _write(rec: Dict[str, Any], out_dir: Optional[str]) -> Dict[str, Any]:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        variant = ""
        if rec.get("layout", "tp") != "tp":
            variant += f"__{rec['layout']}"
        if rec.get("ce_chunk"):
            variant += f"__ce{rec['ce_chunk']}"
        if rec.get("microbatch", 1) > 1:
            variant += f"__mb{rec['microbatch']}"
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{variant}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", help=f"one of {list(ALL_SHAPES)} or all")
    ap.add_argument("--mesh", default="16x16", choices=list(MESHES))
    ap.add_argument("--remat", default="full", choices=["full", "none", "dots"])
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--seq-shard", action="store_true",
                    help="refused: it steers only GSPMD's partitioner, which the port has not")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.seq_shard:
        ap.error("--seq-shard steers only GSPMD's sharding propagation (JAX); on one card "
                 "it is the identity and this dry run has no partitioner to steer")

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(ALL_SHAPES) if args.shape == "all" else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, args.mesh, args.out, args.remat, args.layout,
                          args.ce_chunk, args.microbatch)
            failures += rec["status"] == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
