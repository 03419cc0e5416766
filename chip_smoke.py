#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--paths]

Phases, each printing its own lines; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (all
   ``nvcc`` processes started together), with its seconds;
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes and larger ones, with the stated tolerances, and their
   times beside the plain version's, the bound and a library call; the
   card's floor per launch, from an empty kernel launched back to back;
   ``weighted_aggregate`` bitwise against the row-order sum at every load
   width, and ``robust_trimmed``'s median bitwise on rows of NaN, +-inf,
   +-0 and ties; for both, kernel and library call timed back to back in
   one window each and again in interleaved turns, device time from a
   trace, and at the Fig. 3 shape the host split of one call (checks, load, allocation, stream lookup, ``ctypes``
   call); ``robust_trimmed``'s bound at 1 instruction an ordered pair,
   the older 4-op bound beside it;
   ``glr_step_tenants`` (the scheduler service's detector step, in place
   on the slot state) against its plain version at the serving shapes
   (R = 257 / B = 64, N = 16, H = 256; R = 10001 / B = 64, H = 64), all
   rows live and detecting at (256, 16, 1024) beside the old functional
   ``glr_step`` kernel, and at H = 33 and 130, with both bounds (bytes;
   the FMA count or the split term's MUFU instructions, whose count a
   split is a constant below), device time and, at the serving shape, the
   host split of a call;
   and ``regret_scan`` (the whole regret harness in one launch) against the
   per-round route with the plain detector on nine short edge runs (a table
   env, S=1, alpha=0.2, the geometric grid, H=33 with restarts, N=30 M=20
   stride 1, N=32, stride 1e9, the recompute detector), and its batch form
   (one launch, one block a run) against the batched per-round route at
   B = 24 (own envs and uniforms) and B = 133 (one shared env and stream, a
   per-run gamma x delta grid, the recompute detector); ``glr_scan`` on
   real-valued histories inside ``ref.glr_scan_bounds``, the split term's
   derived forward error;
3. the Fig. 2 AoI-regret path: GLR-CUCB (history 1024, detector stride 5)
   on a piecewise env with N=5, M=2 and 5 breakpoints, T=20000 rounds, on
   both routes in turns (scan, rounds, scan): the scan route must launch
   ``regret_scan`` once and no ``glr_step``, the per-round route
   (``impl="rounds"``) ``glr_step`` T/5 times, and the two must agree bit
   for bit (schedule, restarts, regret curve, AoI, success rate, final
   state; the variance sums at rtol 1e-6); both routes' ms/round are
   printed.  A 5000-round run of the scan route is first held against the
   same run on the CPU (plain versions);
4. the Fig. 3 asynchronous-FL path: N=30 channels, M=20 clients, a skewed
   piecewise env, the MLP 48->96->10, E=3, B=16, lr 0.15, GLR-CUCB
   (history 256) with adaptive matching, 150 rounds; ``glr_step`` and
   ``weighted_aggregate`` must launch 150 times each.  Three rounds are
   first held against the same rounds on the CPU;
5. the Fig. 3 path under Byzantine client faults with the robust
   aggregators, phase 4's setup unchanged, 150 rounds a run, the chaos
   suite's attacks x defenses (``benchmarks/run.py:1160-1168``,
   ``:1245-1251``): sign_flip x {mean, trimmed_mean, coordinate_median},
   inner_product x norm_clip, burst(sign_flip) x coordinate_median;
   ``robust_trimmed`` must launch 150 times in each order-statistic run,
   ``weighted_aggregate`` 150 times in the others.  Three rounds of two
   runs are first held against the same rounds on the CPU;
6. the Fig. 2 path with ``detector_impl="recompute"`` on phase 3's env and
   uniforms, on both routes as in phase 3 (``glr_scan`` T/5 times on the
   rounds); the recompute scan must equal phase 3's streaming scan bit for
   bit;
7. the model zoo's serving path on qwen3-32b at full width: (a) 2 layers
   in f32, the prefill of one 2048-token prompt through the kernel route
   against the plain chunked route, then 12 teacher-forced decode steps
   against ``apply``'s logits; (b) all 64 layers in bf16 (61.0 GiB of
   weights drawn on the card): ``make_prefill_step`` on 4 prompts of 2048
   tokens (``flash_attention`` must launch 64 times a prefill), then the
   ``launch/serve.py`` loop, batch 8, context 2048, 32 tokens;
8. the multi-tenant scheduler service at the JAX ``serve_suite``'s sizes
   (``benchmarks/run.py:1380-1456``): GLR-CUCB N=16, M=4, H=256, stride 5;
   (a) one tenant served 1000 rounds of ``offline_round_stream`` equals the
   scan route of ``simulate_aoi_regret`` and the CPU run bit for bit, with
   ``glr_step_tenants`` launched once a serve step; (b)
   256 tenants, slot batch 64: the first 3 steps equal the CPU run bit for
   bit; synchronous, serial (slots=1) and pipelined decisions a second
   (best of 2), a Poisson episode at 80 % of the synchronous rate with
   churn (p50/p99/p999 ms), the launches against the steps, one step under
   ``set_sync_debug_mode("error")`` and a profiled 10-step window; (c) a
   10^4-tenant server (H=64) whose first 64 requests equal the CPU run,
   and its saturated rate; (d) ``run_served`` on phase 4's setup, 10
   rounds equal to ``run()`` bit for bit;
9. the paper's baseline rows at their widths: (a) Fig. 2a's fifteen
   (``benchmarks/run.py:182-224``, N=5, M=2): nine policies on a piecewise
   env with 5 breakpoints, six on the adversarial table (flip_prob 0.002);
   the three ``regret_scan`` takes (piecewise glr-cucb and cucb-static,
   adversarial glr-cucb) at T=20000 on the scan route, the other twelve on
   the per-round route at T=2000 (the cut: that route is host-bound), each
   with regret, sublinearity index, growth exponent, ms/round, route and
   counters, and its first 500 rounds held against the CPU run (bitwise;
   channel-aware and M-Exp3 rows may fork only at a near-tie); (b) Fig.
   3/4's ten rows (``:744-786``), 150 rounds, one seed each (the cut):
   random, channel-aware and Lyapunov on phase 4's problem, those and
   M-Exp3 with and without matching on an adversarial N=6, M=4 problem,
   each with accuracy, cumulative AoI variance and s/round, three rounds
   held against the CPU run as in phase 4;
10. the batched engine (``repro_torch.sim``) at the JAX benchmark's sizes:
   (a) fig2c on GLR-CUCB (N=5, M=2, H=1024, stride 5), 24 seeds at
   T=20000, each its own piecewise env with 5 breakpoints and its own
   uniforms, as one ``regret_scan`` launch, each run equal to its
   single-run scan bit for bit; (b) the hp_grid, 16 gamma x delta points,
   as one ``sweep`` bucket and one launch, each point equal to its serial
   run; (c) the fill of the card: B = 1, 8, 132, 264, 528 runs on one
   shared env, ms a launch and a run-round beside the bound and the latency
   chain, and the occupancy the runtime reports; (d) fig2c on M-Exp3, N in
   {4, 5, 6, 7}, 24 seeds with their own adversarial tables (flip_prob
   0.002) and one shared stream (as the JAX benchmark), on the batched
   per-round route cut to T=2000, seeds 0 and 23 equal to their serial runs
   over 500 rounds; (e) Fig. 2a's fifteen rows x 4 seeds at T=2000 as one
   ``sweep`` (15 buckets), each row's seed 0 equal to phase 9's run; (f) a
   recompute-detector bucket of 8 seeds at T=20000 on the scan; (g)
   ``sweep(shard=True)`` equal to ``sweep()`` for a bucket of 5.

Phase 2 releases its tensors and the allocator's cache before phase 3, so
the paths start from the same device memory state with or without it.
Phase 2 also holds ``flash_attention`` against ``ref.mha_attention`` at the
JAX package's five test shapes and at qwen3-32b's (4, 64/8, 2048, 128), in
f32 (the FMA route) and bf16 (the tensor-core route for D % 8 == 0 and
D <= 128, the FMA route otherwise), and times both routes, the plain
version and SDPA at the model shape in one call.
``--paths`` builds the kernels and runs phases 3-10 only (no kernel line):
the paths' own times, for comparing two checkouts (``tools/ab_smoke.py``).

Every path runs at the paper's sizes, uncut but for phase 9's two cuts
and phase 10's per-round cut (T=2000), which they print.  Weights, envs and randomness
are made on the card from ``--seed``; the Fig. 3 data is the benchmark's
synthetic problem, made on the host from seeds offset by ``--seed`` (seed
0 gives the benchmark's own data).  The last line is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches (summed over the paths, each counted from zero), error
and times.  Without CUDA, or beside
no ``src/repro_torch`` package, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
F32_LANE_OPS = F32_FLOPS / 2   # FP32 lane instructions a second (an FMA counts 2 flops)
KL_SPLIT_FLOPS = 32            # f32 operations per evaluated GLR split
H100_SMS = 132
MUFU_PER_SM_CLOCK = 16         # special-function (MUFU) results a clock on each SM
LANES_PER_SM_CLOCK = 128       # lane instructions issued a clock on each SM (4 x 32)
# one GLR split term of csrc/glr_kl.cuh, loads and store included, counted once in
# its sm_90a SASS (cuobjdump -sass; PERF.md gives the count's run), and the H100
# SXM's maximum SM clock (nvidia-smi --query-gpu=clocks.max.sm, the same run)
SPLIT_SASS = 336
SPLIT_MUFU = 8
SM_CLOCK_HZ = 1980e6
RANK_PAIR_OPS = 1              # lane instructions per ordered pair: the least a rank count issues
OLD_RANK_PAIR_OPS = 4          # the bound stated before: two compares, a select, an add
HOST_SPLIT_CALLS = 10_000      # calls averaged in each host-split piece
FIG2_ROUNDS = 20000            # the paper's Fig. 2 horizon (benchmarks/run.py:175)
FIG2_REF_ROUNDS = 5000         # the card-vs-CPU reference run of Fig. 2
SCAN_EDGE_ROUNDS = 1500        # each edge run of regret_scan against the rounds route (phase 2)
FIG3_ROUNDS = 150              # the paper's Fig. 3 large-scale rounds (benchmarks/run.py:744-760)
FIG3_REF_ROUNDS = 3            # the card-vs-CPU reference rounds of Fig. 3
FIG3_REF_MAX_ROUNDS = 12       # ... extended, under attack, until a corrupted row is aggregated
BF16_TC_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense (NVIDIA data sheet)
SERVE_ARCH = "qwen3-32b"       # the most demanding dense GQA config of the zoo
SERVE_PROMPT = 2048            # prefill prompt length
SERVE_PREFILL_BATCH = 4        # prompts a prefill
SERVE_BATCH, SERVE_CONTEXT, SERVE_TOKENS = 8, 2048, 32   # the serve loop
SERVE_LAYERS = 64              # qwen3-32b's full depth: 61.0 GiB of bf16 weights
SERVE_REF_LAYERS = 2           # depth of the f32 reference model (full width)
DECODE_REF_STEPS = 12          # teacher-forced decode steps against the prefill
SCHED_CAPACITY, SCHED_SLOTS = 256, 64   # the serve suite's server (benchmarks/run.py:1380)
SCHED_N, SCHED_M, SCHED_H = 16, 4, 256  # GLR-CUCB served (benchmarks/run.py:1384-1385)
SCHED_PARITY_ROUNDS = 1000             # the single-tenant parity replay (:1381)
SCHED_REQUESTS = 12 * SCHED_CAPACITY   # saturated and Poisson requests (:1382)
SCHED_SERIAL_REQUESTS = 8 * SCHED_SLOTS   # the serial (slots=1) baseline's (:1383)
SCHED_BIG_CAPACITY, SCHED_BIG_H = 10_000, 64   # the 10^4-tenant server (:1451-1455)
SCHED_FL_ROUNDS = 10                   # run_served rounds on the Fig. 3 setup
FIG2A_ROUNDS_CUT = 2000        # Fig. 2a rows on the per-round route (phase 9): T, cut from 20000
FIG2A_REF_ROUNDS = 500         # their card-vs-CPU rounds
FORKING_ROWS = ("channel-aware", "m-exp3", "aa-m-exp3")   # draws through log/exp: may fork
FIG2C_SEEDS = 24               # fig2c's seeds per N (benchmarks/run.py:262)
HP_GAMMAS = (0.5, 0.75, 1.0, 1.25)      # the hp_grid's 16 points (benchmarks/run.py:440-442)
HP_DELTAS = (1e-4, 1e-3, 1e-2, 1e-1)
FILL_BATCHES = (1, 8, 132, 264, 528)    # runs a regret_scan launch in phase 10 (c)
FIG2A_SEEDS = 4                # seeds a Fig. 2a row in phase 10's sweep (e)
RECOMPUTE_SEEDS = 8            # the recompute bucket of phase 10 (f)
SHARD_BATCH = 5                # the uneven bucket of phase 10 (g)
FORK_REL_TIE = 1e-5            # ... only at a near-tie this close, relative
KERNEL_NAMES = ("glr_step", "weighted_aggregate", "robust_trimmed", "glr_scan",
                "flash_attention", "regret_scan", "glr_step_tenants")
FLASH_ROUTES = ("flash_attention_tc", "flash_attention_fma")   # its two routes' counters
COUNTERS = KERNEL_NAMES + FLASH_ROUTES


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def line(*parts):
    print(*parts, flush=True)


def kernel_wrappers():
    """Each kernel's wrapper, by name: the ``.launches`` counters."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.glr_scan import glr_scan
    from repro_torch.kernels.glr_step import glr_step
    from repro_torch.kernels.glr_step_tenants import glr_step_tenants
    from repro_torch.kernels.regret_scan import regret_scan
    from repro_torch.kernels.robust_agg import robust_trimmed
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate

    return dict(glr_step=glr_step, weighted_aggregate=weighted_aggregate,
                robust_trimmed=robust_trimmed, glr_scan=glr_scan,
                flash_attention=flash_attention, regret_scan=regret_scan,
                glr_step_tenants=glr_step_tenants)


def reset_launches():
    for w in kernel_wrappers().values():
        w.launches = 0
    fa = kernel_wrappers()["flash_attention"]
    fa.tc_launches = fa.fma_launches = 0


def read_launches():
    """Every counter of ``COUNTERS``: each wrapper's, and ``flash_attention``'s
    per route."""
    out = {k: w.launches for k, w in kernel_wrappers().items()}
    fa = kernel_wrappers()["flash_attention"]
    out.update(flash_attention_tc=fa.tc_launches, flash_attention_fma=fa.fma_launches)
    return out


def two_way_bound(nbytes, ops, rate):
    """The least time for the work: bytes over HBM bandwidth or operations
    over ``rate``, whichever is larger, in ms, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, by CUDA events after a warm-up (host launch cost included)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace_kernels(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: (the device kernels of the
    exported trace, the wall time in us)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e], wall_us


def device_ms(torch, fn, calls):
    """Device time a call of ``fn``: the kernel intervals of ``calls``
    back-to-back calls in a ``torch.profiler`` trace, summed, over
    ``calls`` (every kernel a call launches counts).  None when the trace
    holds no kernel."""
    fn()
    kernels, _ = trace_kernels(torch, lambda: [fn() for _ in range(calls)])
    return sum(float(e["dur"]) for e in kernels) / calls / 1e3 if kernels else None


def host_split(torch, label, pieces, whole, calls=HOST_SPLIT_CALLS, chunk=500):
    """Mean host microseconds a call of each piece of a wrapper and of the
    whole wrapper call, by ``time.perf_counter`` over ``calls`` calls in
    chunks of ``chunk``; the device catches up between chunks (untimed), so
    the launch queue never fills and the host never waits for the device.
    Prints one line; returns {piece: us}."""
    def per_call(fn):
        fn()
        total = 0.0
        for _ in range(calls // chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(chunk):
                fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total / (calls // chunk * chunk) * 1e6

    split = {name: per_call(fn) for name, fn in pieces.items()}
    split["whole call"] = per_call(whole)
    parts = sum(v for k, v in split.items() if k != "whole call")
    line(f"  {label} host split, mean of {calls} calls: "
         + ", ".join(f"{k} {v:.3f} us" for k, v in split.items() if k != "whole call")
         + f"; pieces {parts:.3f} us, whole call {split['whole call']:.3f} us "
         f"(the rest: data_ptr reads, the counter, the error test)")
    return split


def turns_ms(torch, fns, iters, turns=3):
    """``time_ms`` of each of ``fns`` ({label: fn}), taken in turns
    (a, b, a, b, ...) ``turns`` times: {label: [ms of each turn]}.  A host-
    bound call moves by tens of percent between back-to-back windows; the
    turns show that spread beside the single window of ``time_ms``."""
    out = {k: [] for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            out[k].append(time_ms(torch, fn, iters))
    return out


def profile_window(torch, label, fn, rounds):
    """Trace ``fn`` (``rounds`` rounds of a loop) with ``torch.profiler`` and
    print the device's busy share of the wall time, kernels launched per
    round and the kernels that take the most device time.  Returns the
    device time by kernel name in us ({} when the trace has none)."""
    kernels, wall_us = trace_kernels(torch, fn)
    if not kernels:
        line(f"  profile {label}: no device kernels in the trace; device busy share not measured")
        return {}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                      # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    line(f"  profile {label}: {rounds} rounds, wall {wall_us / rounds / 1e3:.4f} ms/round, "
         f"device busy {100 * busy / wall_us:.1f}% (idle {100 - 100 * busy / wall_us:.1f}%), "
         f"{len(kernels) / rounds:.1f} kernels/round, {busy / rounds:.1f} us device time/round")
    for name, dur in top:
        line(f"    {dur / rounds:8.2f} us/round  {100 * dur / busy:5.1f}%  {name[:90]}")
    return by_name


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def launch_floor(torch):
    """The card's floor per kernel launch: an empty kernel launched
    back to back (a) 1000 times from one C loop, the device's own floor,
    and (b) once per ``ctypes`` call, as the port's wrappers call a kernel
    (host call cost included).  Milliseconds per launch."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load("launch_floor", "launch_floor_launch", [ctypes.c_int, ctypes.c_void_p])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(n):
        check(fn(n, stream) == 0, "launch_floor: empty kernel failed to launch")

    device_ms = time_ms(torch, lambda: launch(1000), 20) / 1000
    call_ms = time_ms(torch, lambda: launch(1), 5000)
    line(f"  launch floor: empty kernel {device_ms:.5f} ms per launch from a C loop, "
         f"{call_ms:.5f} ms per ctypes call")
    return device_ms, call_ms


def glr_inputs(torch, shape, gen, binary):
    """A prefix state across ring wraparound: counts in [0, 3H) with rows
    before, at and past the wrap; a mixed ``sched`` mask."""
    h, rows = shape[-1], shape[:-1]
    dev = "cuda"
    counts = torch.randint(0, 3 * h, rows, generator=gen, device=dev).to(torch.float32)
    flat = counts.view(-1)
    flat[:3] = torch.tensor([0.0, h - 1.0, float(h)], device=dev)[: flat.numel()]
    if binary:
        cum = torch.randint(0, 2 * h, shape, generator=gen, device=dev).to(torch.float32)
        total = torch.randint(0, 3 * h, rows, generator=gen, device=dev).to(torch.float32)
        base = torch.randint(0, h, rows, generator=gen, device=dev).to(torch.float32)
        r_vec = torch.randint(0, 2, rows, generator=gen, device=dev).to(torch.float32)
    else:
        cum = torch.sort(torch.rand(shape, generator=gen, device=dev), dim=-1).values * h
        total = torch.rand(rows, generator=gen, device=dev) * 3 * h
        base = torch.rand(rows, generator=gen, device=dev)
        r_vec = torch.rand(rows, generator=gen, device=dev)
    sched = torch.rand(rows, generator=gen, device=dev) < 0.7
    sched.view(-1)[0] = False                      # an empty window: stat -inf
    return cum, total, base, counts, r_vec, sched


def glr_split_count(torch, counts, sched, h, geometric):
    """GLR splits the kernel evaluates on these inputs (1 <= s <= n-1)."""
    n = torch.clamp(counts.to(torch.int64) + sched.to(torch.int64), max=h).view(-1, 1)
    s = torch.arange(1, h, device=counts.device).view(1, -1)
    valid = s <= n - 1
    if geometric:
        pow2 = lambda x: (x > 0) & ((x & (x - 1)) == 0)
        valid &= pow2(s) | pow2(n - s)
    return int(valid.sum())


def glr_bound_ms(torch, args, h, geometric):
    cum, total, base, counts, r_vec, sched = args
    rows = cum.numel() // h
    nbytes = 2 * cum.numel() * 4 + rows * (4 * 4 + 1) + rows * 3 * 4
    flops = KL_SPLIT_FLOPS * glr_split_count(torch, counts, sched, h, geometric) + rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_glr_step(torch, gen, floor_ms):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.glr_step import glr_step as kernel

    max_err = 0.0
    shapes = [(5, 1024), (30, 256), (1000, 1000), (256, 16, 1024)]
    for shape in shapes:
        for grid in ("all", "geometric"):
            for binary in (True, False):
                args = glr_inputs(torch, shape, gen, binary)
                h = shape[-1]
                got = ops.glr_step(*args, split_grid=grid)
                want = ref.glr_step(*(a.reshape(-1, h) if a.dim() == len(shape) else
                                      a.reshape(-1) for a in args), split_grid=grid)
                torch.cuda.synchronize()
                for g, w, name in zip(got[:3], want[:3], ("cum", "total", "base")):
                    g = g.reshape(w.shape)
                    if binary:
                        check(torch.equal(g, w), f"glr_step {shape} {grid}: {name} not bitwise")
                    else:
                        check(torch.allclose(g, w, rtol=1e-6, atol=0),
                              f"glr_step {shape} {grid}: {name} beyond rtol 1e-6")
                gs, ws = got[3].reshape(-1), want[3]
                check(torch.equal(torch.isneginf(gs), torch.isneginf(ws)),
                      f"glr_step {shape} {grid}: -inf at other places")
                fin = torch.isfinite(ws)
                check(torch.equal(fin, torch.isfinite(gs)), f"glr_step {shape} {grid}: non-finite stat")
                err = float((gs[fin] - ws[fin]).abs().max()) if bool(fin.any()) else 0.0
                check(torch.allclose(gs[fin], ws[fin], rtol=1e-5, atol=1e-5),
                      f"glr_step {shape} {grid}: stat beyond rtol/atol 1e-5 (max err {err})")
                max_err = max(max_err, err)
                line(f"  glr_step {shape} grid={grid} rewards={'{0,1}' if binary else 'U[0,1]'}: "
                     f"state {'bitwise' if binary else 'rtol 1e-6'}, stat max_abs_err={err:.3e} ok")

    timings = {}
    for shape, label in (((5, 1024), "fig2"), ((30, 256), "fig3")):
        h = shape[-1]
        args = glr_inputs(torch, shape, gen, True)
        cum, total, base, counts, r_vec, sched = args
        counts_i = counts.to(torch.int32)
        ms = time_ms(torch, lambda: kernel(cum, total, base, counts_i, r_vec, sched), 2000)
        plain_ms = time_ms(torch, lambda: ref.glr_step(*args), 200)
        bound, bound_by = glr_bound_ms(torch, args, h, geometric=False)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        line(f"  glr_step time {label} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"bound {bound:.2e} ms ({bound_by}), launch floor {floor_ms:.5f} ms, "
             f"per call back to back")

    return max_err, timings


def tenants_inputs(torch, r, b, n, h, frac_detect, pad, gen, binary=True):
    """A serve step's operands: slot state (R, N, H) across ring wraparound,
    B distinct slots of which the last ``pad`` are padding rows on the
    scratch slot R - 1 (not live), ``frac_detect`` of the live rows on a
    detection round (at least one), a mixed ``sched``."""
    dev = "cuda"
    if binary:
        cum = torch.randint(0, 2 * h, (r, n, h), generator=gen, device=dev).to(torch.float32)
        total = torch.randint(0, 3 * h, (r, n), generator=gen, device=dev).to(torch.float32)
        base = torch.randint(0, h, (r, n), generator=gen, device=dev).to(torch.float32)
        r_vec = torch.randint(0, 2, (b, n), generator=gen, device=dev).to(torch.float32)
    else:
        cum = torch.sort(torch.rand((r, n, h), generator=gen, device=dev), dim=-1).values * h
        total = torch.rand((r, n), generator=gen, device=dev) * 3 * h
        base = torch.rand((r, n), generator=gen, device=dev)
        r_vec = torch.rand((b, n), generator=gen, device=dev)
    counts = torch.randint(0, 3 * h, (b, n), generator=gen, device=dev).to(torch.float32)
    counts.view(-1)[:3] = torch.tensor([0.0, h - 1.0, float(h)], device=dev)[: counts.numel()]
    slots = torch.randperm(r - 1 if r > b else r, generator=gen, device=dev)[:b].to(torch.int32)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    if pad:
        slots[-pad:] = r - 1
        live[-pad:] = False
    detect = (torch.rand(b, generator=gen, device=dev) < frac_detect) & live
    detect[0] = True
    sched = torch.rand((b, n), generator=gen, device=dev) < 0.7
    return cum, total, base, slots, live, detect, counts, r_vec, sched


def tenants_bound_ms(torch, args, geometric):
    """The least time of one step on these inputs, in place: bytes
    (detecting rows' rings read once, every live row's 17 bytes a channel,
    6 bytes a row) over HBM, or operations, the larger of the FMA count
    (32 a split) over the f32 rate and the split term's MUFU instructions
    over 16 a clock on each of 132 SMs.  Returns (bound ms, bound_by, the
    split count, {bytes, fma, mufu ms})."""
    cum, total, base, slots, live, detect, counts, r_vec, sched = args
    n, h = cum.shape[1:]
    det = detect & live
    splits = glr_split_count(torch, counts[det], sched[det], h, geometric)
    nbytes = int(det.sum()) * n * h * 4 + int(live.sum()) * n * (16 + 1) + slots.numel() * 6
    parts = dict(bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                 fma=KL_SPLIT_FLOPS * splits / F32_FLOPS * 1e3,
                 mufu=splits * SPLIT_MUFU / (MUFU_PER_SM_CLOCK * H100_SMS * SM_CLOCK_HZ) * 1e3)
    bound = max(parts.values())
    return bound, "bytes" if parts["bytes"] >= bound else "operations", splits, parts


def check_glr_step_tenants(torch, gen, floor_ms):
    """The in-place serving kernel against ``ref.glr_step_tenants`` on the
    same inputs: the slot state bitwise on {0, 1} rewards (rtol 1e-6 on
    U[0, 1]), rows not live untouched, the statistic at rtol/atol 1e-5 with
    -inf at the same places, both grids, at the serving shapes
    (R = 257 / B = 64, N = 16, H = 256 and R = 10001 / B = 64, H = 64, a
    fifth of the rows detecting, padding rows), all rows live and detecting
    at (256, 16, 1024), and at H = 33 and H = 130 (scalar loads).  Times per
    call back to back, device time from a trace, the old functional kernel
    beside it at (256, 16, 1024), the plain version, both bounds; the split
    term's issue time; at the serving shape the host split of a call."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import glr_step_tenants as gst_mod
    from repro_torch.kernels.glr_step import glr_step as old_kernel

    kernel = gst_mod.glr_step_tenants
    cases = {"full": (256, 256, 16, 1024, 1.0, 0), "serve": (257, 64, 16, 256, 0.2, 5),
             "big": (10001, 64, 16, 64, 0.2, 3), "h33": (20, 12, 5, 33, 0.6, 2),
             "h130": (20, 12, 5, 130, 0.6, 2)}
    max_err = 0.0
    for label, (r, b, n, h, frac, pad) in cases.items():
        for grid in ("all", "geometric"):
            for binary in (True, False):
                args = tenants_inputs(torch, r, b, n, h, frac, pad, gen, binary)
                got_state = [x.clone() for x in args[:3]]
                want_state = [x.clone() for x in args[:3]]
                got = ops.glr_step_tenants(*got_state, *args[3:], split_grid=grid)
                want = ref.glr_step_tenants(*want_state, *args[3:], split_grid=grid)
                torch.cuda.synchronize()
                where = f"glr_step_tenants ({r}, {b}, {n}, {h}) {grid}"
                for g, w, name in zip(got_state, want_state, ("cum", "total", "base")):
                    if binary:
                        check(torch.equal(g, w), f"{where}: {name} not bitwise")
                    else:
                        check(torch.allclose(g, w, rtol=1e-6, atol=0), f"{where}: {name} beyond rtol 1e-6")
                untouched = torch.ones(r, dtype=torch.bool, device="cuda")
                untouched[args[3][args[4]].long()] = False
                for g, x, name in zip(got_state, args[:3], ("cum", "total", "base")):
                    check(torch.equal(g[untouched], x[untouched]), f"{where}: {name} of a row not live changed")
                check(torch.equal(torch.isneginf(got), torch.isneginf(want)), f"{where}: -inf at other places")
                fin = torch.isfinite(want)
                check(torch.equal(fin, torch.isfinite(got)), f"{where}: non-finite stat")
                err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
                check(torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5),
                      f"{where}: stat beyond rtol/atol 1e-5 (max err {err})")
                max_err = max(max_err, err)
                line(f"  {where} rewards={'{0,1}' if binary else 'U[0,1]'}: "
                     f"{int(args[5].sum())}/{b} rows detecting, state "
                     f"{'bitwise' if binary else 'rtol 1e-6'}, rows not live untouched, "
                     f"stat max_abs_err={err:.3e} ok")

    timings = {}
    for label in ("full", "serve", "big"):
        r, b, n, h, frac, pad = cases[label]
        args = tenants_inputs(torch, r, b, n, h, frac, 0, gen, True)
        cum, total, base, slots, live, detect, counts, r_vec, sched = args
        counts_i = counts.to(torch.int32)
        call = lambda: kernel(cum, total, base, slots, live, detect, counts_i, r_vec, sched)
        small = label != "full"
        t = dict(ms=time_ms(torch, call, 2000 if small else 500),
                 plain_ms=time_ms(torch, lambda: ref.glr_step_tenants(*args), 50),
                 device_ms=device_ms(torch, call, 100), library_ms=None)
        bound, bound_by, splits, parts = tenants_bound_ms(torch, args, False)
        issue_ms = splits * SPLIT_SASS / (LANES_PER_SM_CLOCK * H100_SMS * SM_CLOCK_HZ) * 1e3
        t.update(bound_ms=bound, bound_by=bound_by, splits=splits,
                 detecting_rows=int(detect.sum()))
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        old = ""
        if label == "full":
            cum_o, total_o, base_o = cum.clone(), total.clone(), base.clone()
            t["old_ms"] = time_ms(torch, lambda: old_kernel(cum_o, total_o, base_o, counts_i, r_vec,
                                                           sched), 500)
            old = f", old functional glr_step kernel {t['old_ms']:.4f} ms"
        line(f"  glr_step_tenants time {label} ({r}, {b}, {n}, {h}), {t['detecting_rows']}/{b} "
             f"rows detecting: kernel {t['ms']:.4f} ms{old}, plain {t['plain_ms']:.4f} ms, per "
             f"call back to back, one window each; device time {fmt(t['device_ms'])}; bound "
             f"{bound:.5f} ms ({bound_by}; bytes {parts['bytes']:.5f}, FMA {parts['fma']:.5f}, "
             f"MUFU {parts['mufu']:.5f} ms over {splits} splits, {SPLIT_MUFU} MUFU a split); "
             f"issue at {SPLIT_SASS} SASS instructions a split {issue_ms:.5f} ms (SM clock "
             f"{SM_CLOCK_HZ / 1e6:.0f} MHz); launch floor {floor_ms:.5f} ms")
        if label == "serve":
            dev = cum.get_device()
            fn = _build.load("glr_step_tenants", "glr_step_tenants_launch", gst_mod._ARGTYPES)
            out = torch.empty((b, n), device="cuda")
            ptrs = (cum.data_ptr(), total.data_ptr(), base.data_ptr(), slots.data_ptr(),
                    live.data_ptr(), detect.data_ptr(), counts_i.data_ptr(), r_vec.data_ptr(),
                    sched.data_ptr(), out.data_ptr(), b, n, r, h, 0, _build.stream(dev))
            t["host_split_us"] = host_split(torch, f"glr_step_tenants ({r}, {b}, {n}, {h})", {
                "checks": lambda: gst_mod._checked(cum, total, base, slots, live, detect,
                                                   counts_i, r_vec, sched, "all"),
                "load": lambda: _build.load("glr_step_tenants", "glr_step_tenants_launch",
                                            gst_mod._ARGTYPES),
                "output allocation": lambda: counts_i.new_empty((b, n), dtype=torch.float32),
                "stream lookup": lambda: _build.stream(dev),
                "ctypes call + launch": lambda: fn(*ptrs),
            }, call)
        timings[label] = t
        del args, cum
    return max_err, timings


def scale_like_main_path(torch, m, gen):
    """Eq. 7 scales as the main path makes them: mask * zeta * M / |S_t|."""
    mask = (torch.rand(m, generator=gen, device="cuda") < 0.6).to(torch.float32)
    mask[0] = 1.0
    zeta = torch.rand(m, generator=gen, device="cuda") + 0.5
    zeta = zeta / zeta.sum()
    return mask * zeta * (m / mask.sum())


def row_order_sum(torch, upd, scale):
    """``acc = acc + scale[r] * x[r]``, r = 0..M-1, one rounded product and
    one rounded add a row: the kernel's own order and rounding."""
    acc = torch.zeros(upd.shape[1], device=upd.device)
    for r in range(upd.shape[0]):
        acc = acc + scale[r] * upd[r].float()
    return acc


def check_weighted_aggregate(torch, gen, floor_ms):
    """Kernel against plain (rtol 1e-5 / atol 1e-6: torch's ``sum`` may add
    in another order) and bitwise against the row-order sum, at every load
    width: (20, 5674) and (64, 2^24 + 2) 8-byte f32 rows, (64, 2^24) 16-byte,
    (64, 2^24 + 3) 4-byte.  Times at the Fig. 3 shape and both large ones:
    per call back to back (host included), device time from a trace, the
    plain version, ``scale @ updates``; the host split of one call."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import weighted_aggregate as wa_mod

    kernel = wa_mod.weighted_aggregate
    shapes = {"fig3": (20, 5674), "large": (64, 2 ** 24), "large_ragged": (64, 2 ** 24 + 2)}
    max_err = 0.0
    for m, p in (shapes["fig3"], (64, 2 ** 24 + 3), shapes["large"], shapes["large_ragged"]):
        for dtype in (torch.float32, torch.bfloat16):
            upd = torch.randn((m, p), generator=gen, device="cuda").to(dtype)
            scale = scale_like_main_path(torch, m, gen)
            got = ops.weighted_aggregate(upd, scale)
            want = ref.weighted_aggregate(upd, scale)
            rows = row_order_sum(torch, upd, scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(got.dtype == torch.float32 and got.shape == (p,),
                  "weighted_aggregate: shape/dtype")
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"weighted_aggregate ({m}, {p}) {dtype}: beyond rtol 1e-5 / atol 1e-6 ({err})")
            check(torch.equal(got, rows),
                  f"weighted_aggregate ({m}, {p}) {dtype}: not bitwise equal to the row-order sum")
            max_err = max(max_err, err)
            line(f"  weighted_aggregate ({m}, {p}) {str(dtype).split('.')[-1]}: "
                 f"max_abs_err={err:.3e} vs plain, bitwise equal to the row-order sum ok")
            del upd, got, want, rows

    timings = {}
    for label, (m, p) in shapes.items():
        upd = torch.randn((m, p), generator=gen, device="cuda")
        scale = scale_like_main_path(torch, m, gen)
        small = p < 10 ** 6
        iters = 2000 if small else 20
        call, library = lambda: kernel(upd, scale), lambda: scale @ upd
        t = dict(ms=time_ms(torch, call, iters),
                 plain_ms=time_ms(torch, lambda: ref.weighted_aggregate(upd, scale), iters),
                 library_ms=time_ms(torch, library, iters))
        turns = turns_ms(torch, {"kernel": call, "library": library}, iters)
        t.update(turns_ms=turns["kernel"], library_turns_ms=turns["library"],
                 device_ms=device_ms(torch, call, 100 if small else 10),
                 library_device_ms=device_ms(torch, library, 100 if small else 10))
        nbytes = m * p * 4 + m * 4 + p * 4
        t["bound_ms"], t["bound_by"] = two_way_bound(nbytes, 2 * m * p, F32_FLOPS)
        timings[label] = t
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        each = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
        line(f"  weighted_aggregate time {label} ({m}, {p}) f32: kernel {t['ms']:.4f} ms, "
             f"plain {t['plain_ms']:.4f} ms, library (scale @ updates) {t['library_ms']:.4f} ms, "
             f"per call back to back, one window each; interleaved turns: kernel "
             f"{each(t['turns_ms'])}, library {each(t['library_turns_ms'])}; device time: "
             f"kernel {fmt(t['device_ms'])}, library {fmt(t['library_device_ms'])}; bound "
             f"{t['bound_ms']:.4f} ms ({t['bound_by']}), launch floor {floor_ms:.5f} ms, "
             f"{nbytes / (t['ms'] * 1e-3) / 1e9:.1f} GB/s")
        if label == "fig3":
            dev = upd.get_device()
            fn = _build.load("weighted_aggregate", "weighted_aggregate_launch", wa_mod._ARGTYPES)
            out = torch.empty(p, device="cuda")
            args = (upd.data_ptr(), scale.data_ptr(), out.data_ptr(), m, p, 0, _build.stream(dev))
            t["host_split_us"] = host_split(torch, f"weighted_aggregate ({m}, {p}) f32", {
                "checks": lambda: wa_mod._checked(upd, scale),
                "load": lambda: _build.load("weighted_aggregate", "weighted_aggregate_launch",
                                            wa_mod._ARGTYPES),
                "output allocation": lambda: upd.new_empty(p, dtype=torch.float32),
                "stream lookup": lambda: _build.stream(dev),
                "ctypes call + launch": lambda: fn(*args),
            }, lambda: kernel(upd, scale))
        del upd
    return max_err, timings


def trim_inputs(torch, m, p, dtype, mask_kind, gen):
    """Updates on a grid of 1/2 (so that ties really occur) and a mask that
    is random (about 60 % participate), full or empty."""
    x = (torch.round(torch.randn((m, p), generator=gen, device="cuda") * 3.0) * 0.5).to(dtype)
    if mask_kind == "empty":
        mask = torch.zeros(m, device="cuda")
    elif mask_kind == "full":
        mask = torch.ones(m, device="cuda")
    else:
        mask = (torch.rand(m, generator=gen, device="cuda") < 0.6).to(torch.float32)
    return x, mask


def special_trim_inputs(torch, m, p, dtype, mask_kind, gen):
    """Values drawn from NaN, +-inf, +-0 and ties; every row holds each of
    them in its first columns; the mask random (about 60 %) or full."""
    table = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1.0, -1.0,
                          0.5, 0.5, 2.5], device="cuda")
    idx = torch.randint(0, len(table), (m, p), generator=gen, device="cuda")
    idx[:, :len(table)] = (torch.arange(m, device="cuda")[:, None]
                           + torch.arange(len(table), device="cuda")) % len(table)
    mask = torch.ones(m, device="cuda") if mask_kind == "full" else \
        (torch.rand(m, generator=gen, device="cuda") < 0.6).to(torch.float32)
    return table[idx].to(dtype), mask


def same_bits(torch, a, b):
    """Equal bit for bit, NaN where the other has NaN (any payload) and the
    sign of every zero included."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and \
        bool(torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def check_robust_trimmed(torch, gen, floor_ms):
    """Kernel against plain: the median (k = floor((n-1)/2), at most two
    kept values) bitwise; the trimmed mean (k = 0 and k between) within
    M * 2**-24 * max|x|, the rounding of any order of at most M adds
    divided by their count; on rows of NaN, +-inf, +-0 and ties the median
    bitwise, sign of zero and NaN included.  Times at the Fig. 3 shape and
    64 x (2^22 + 3): per call back to back, device time from a trace, the
    plain version, ``torch.sort`` + kept-slice mean; the host split; the
    bound at ``RANK_PAIR_OPS`` with the older ``OLD_RANK_PAIR_OPS`` beside."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import robust_agg as rt_mod

    kernel = rt_mod.robust_trimmed
    max_err = 0.0
    for m, p in ((20, 5674), (64, 2 ** 22 + 3)):
        for dtype in (torch.float32, torch.bfloat16):
            for mask_kind in ("random", "full", "empty"):
                x, mask = trim_inputs(torch, m, p, dtype, mask_kind, gen)
                n = mask.sum()
                n_int = int(n)
                med = max(n_int - 1, 0) // 2
                tol = m * 2.0 ** -24 * float(x.float().abs().max())
                errs = []
                for k in sorted({0, med // 2, med}):
                    kt = torch.tensor(float(k), device="cuda")
                    got = ops.robust_trimmed(x, mask, n, kt)
                    want = ref.robust_trimmed(x, mask, n, kt)
                    torch.cuda.synchronize()
                    check(got.dtype == torch.float32 and got.shape == (p,),
                          "robust_trimmed: shape/dtype")
                    err = float((got - want).abs().max())
                    if k == med:
                        check(same_bits(torch, got, want),
                              f"robust_trimmed ({m}, {p}) {dtype} {mask_kind}: median not bitwise")
                    else:
                        check(err <= tol, f"robust_trimmed ({m}, {p}) {dtype} {mask_kind} k={k}: "
                                          f"error {err} above {tol}")
                    if n_int == 0:
                        check(not bool(got.any()), "robust_trimmed: empty mask gave non-zeros")
                    errs.append(f"k={k}: {err:.1e}")
                    max_err = max(max_err, err)
                    del got, want
                line(f"  robust_trimmed ({m}, {p}) {str(dtype).split('.')[-1]} mask={mask_kind} "
                     f"n={n_int}: median bitwise, max_abs_err {', '.join(errs)} "
                     f"(bound {tol:.1e}) ok")
                del x
    for m, p in ((20, 5674), (9, 4099), (33, 4099), (64, 4099)):
        for dtype in (torch.float32, torch.bfloat16):
            for mask_kind in ("random", "full"):
                x, mask = special_trim_inputs(torch, m, p, dtype, mask_kind, gen)
                n = mask.sum()
                kt = torch.floor((n - 1.0) / 2.0).clamp_min(0.0)
                got, want = ops.robust_trimmed(x, mask, n, kt), ref.robust_trimmed(x, mask, n, kt)
                check(same_bits(torch, got, want), f"robust_trimmed special values ({m}, {p}) "
                                                   f"{dtype} {mask_kind}: median not bitwise")
                line(f"  robust_trimmed special values ({m}, {p}) {str(dtype).split('.')[-1]} "
                     f"mask={mask_kind} n={int(n)}: NaN, +-inf, +-0 and ties, median bitwise "
                     f"({int(torch.isnan(want).sum())} NaN and {int((want == 0).sum())} zeros "
                     f"in the output) ok")

    timings = {}
    for m, p, label in ((20, 5674, "fig3"), (64, 2 ** 22 + 3, "large")):
        x, mask = trim_inputs(torch, m, p, torch.float32, "full", gen)
        n = mask.sum()
        k = torch.floor((n - 1.0) / 2.0)              # the median, as on the main path
        lo, hi = (m - 1) // 2, m - (m - 1) // 2
        small = p < 10 ** 6
        call = lambda: kernel(x, mask, n, k)
        library = lambda: torch.sort(x, dim=0).values[lo:hi].mean(dim=0)
        t = dict(ms=time_ms(torch, call, 2000 if small else 20),
                 plain_ms=time_ms(torch, lambda: ref.robust_trimmed(x, mask, n, k),
                                  200 if small else 3),
                 library_ms=time_ms(torch, library, 2000 if small else 10))
        turns = turns_ms(torch, {"kernel": call, "library": library}, 2000 if small else 10)
        t.update(turns_ms=turns["kernel"], library_turns_ms=turns["library"],
                 device_ms=device_ms(torch, call, 100 if small else 10),
                 library_device_ms=device_ms(torch, library, 100 if small else 10))
        same = bool(torch.equal(library(), kernel(x, mask, n, k)))
        nbytes = m * p * 4 + m * 4 + 8 + p * 4
        pairs = m * m * p                              # every row participates
        t["bound_ms"], t["bound_by"] = two_way_bound(nbytes, RANK_PAIR_OPS * pairs, F32_LANE_OPS)
        old_bound, _ = two_way_bound(nbytes, OLD_RANK_PAIR_OPS * pairs, F32_LANE_OPS)
        timings[label] = t
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        each = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
        line(f"  robust_trimmed time {label} ({m}, {p}) f32 median: kernel {t['ms']:.4f} ms, "
             f"plain {t['plain_ms']:.4f} ms, library (sort + kept-slice mean) "
             f"{t['library_ms']:.4f} ms (equal to the kernel: {same}), per call back to back, "
             f"one window each; interleaved turns: kernel {each(t['turns_ms'])}, library "
             f"{each(t['library_turns_ms'])}; "
             f"device time: kernel {fmt(t['device_ms'])}, library {fmt(t['library_device_ms'])}; "
             f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {pairs:.3e} ordered pairs x "
             f"{RANK_PAIR_OPS} instruction / {F32_LANE_OPS:.3g} lane instructions/s; bytes "
             f"{nbytes / HBM_BYTES_PER_S * 1e3:.2e} ms), the older {OLD_RANK_PAIR_OPS}-op bound "
             f"{old_bound:.4f} ms, launch floor {floor_ms:.5f} ms, "
             f"{pairs / (t['ms'] * 1e-3) / 1e12:.2f} T pairs/s")
        if label == "fig3":
            dev = x.get_device()
            fn = _build.load("robust_trimmed", "robust_trimmed_launch", rt_mod._ARGTYPES)
            out = torch.empty(p, device="cuda")
            args = (x.data_ptr(), mask.data_ptr(), n.data_ptr(), k.data_ptr(), out.data_ptr(),
                    m, p, 0, _build.stream(dev))
            t["host_split_us"] = host_split(torch, f"robust_trimmed ({m}, {p}) f32", {
                "checks": lambda: rt_mod._checked(x, mask, n, k),
                "load": lambda: _build.load("robust_trimmed", "robust_trimmed_launch",
                                            rt_mod._ARGTYPES),
                "output allocation": lambda: x.new_empty(p, dtype=torch.float32),
                "stream lookup": lambda: _build.stream(dev),
                "ctypes call + launch": lambda: fn(*args),
            }, lambda: kernel(x, mask, n, k))
        del x
    return max_err, timings


def check_glr_scan(torch, gen, floor_ms):
    """Kernel against plain: bitwise on {0, 1} histories (exact integer
    prefixes).  On real-valued ones the kernel rounds each prefix and the
    window total once from an f64 scan, and its statistic must land inside
    ``ref.glr_scan_bounds``: the split term's derived forward error around
    the exact statistic (per row, the max over splits of value +- bound)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.glr_scan import glr_scan as kernel

    def inputs(n, h, binary, full=False):
        hist = (torch.randint(0, 2, (n, h), generator=gen, device="cuda").to(torch.float32)
                if binary else torch.rand((n, h), generator=gen, device="cuda"))
        if full:
            return hist, torch.full((n,), h, dtype=torch.int32, device="cuda")
        counts = torch.randint(0, h + 1, (n,), generator=gen, device="cuda").to(torch.int32)
        counts[:3] = torch.tensor([0, 1, h], device="cuda")[:n]
        return hist, counts

    max_err = 0.0
    for n, h in ((5, 1024), (30, 256), (1000, 1000)):
        for binary in (True, False):
            hist, counts = inputs(n, h, binary)
            got, want = ops.glr_scan(hist, counts), ref.glr_scan(hist, counts)
            torch.cuda.synchronize()
            check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
                  f"glr_scan ({n}, {h}): -inf at other places")
            fin = torch.isfinite(want)
            check(torch.equal(fin, torch.isfinite(got)), f"glr_scan ({n}, {h}): non-finite stat")
            err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
            if binary:
                check(torch.equal(got, want), f"glr_scan ({n}, {h}) {{0,1}}: not bitwise ({err})")
                how = "bitwise"
            else:
                exact = ref.glr_scan(hist.double(), counts)[fin].cpu()
                lo, hi = (b[fin.cpu()] for b in ref.glr_scan_bounds(hist.cpu(), counts.cpu()))
                k64 = got[fin].double().cpu()
                inside = (k64 >= lo) & (k64 <= hi)
                half = (hi - lo) / 2
                share = float(((k64 - exact).abs() / half).max())
                check(bool(inside.all()), f"glr_scan ({n}, {h}) real: {int((~inside).sum())} rows "
                                          f"outside the derived bound ({share:.3f} of its half-width)")
                e_plain = float((want[fin].double().cpu() - exact).abs().max())
                how = (f"inside the derived bound (kernel's error vs f64 at most {share:.3f} of the "
                       f"bound's half-width, max half-width {float(half.max()):.3e}; plain f32's "
                       f"error {e_plain:.3e})")
            max_err = max(max_err, err)
            line(f"  glr_scan ({n}, {h}) history={'{0,1}' if binary else 'U[0,1]'}: "
                 f"{how}, max_abs_err={err:.3e} ok")

    timings = {}
    for (n, h), label in (((5, 1024), "fig2"), ((30, 256), "fig3")):
        hist, counts = inputs(n, h, True, full=True)   # the steady state: full windows
        ms = time_ms(torch, lambda: kernel(hist, counts), 2000)
        plain_ms = time_ms(torch, lambda: ref.glr_scan(hist, counts), 200)
        splits = n * (h - 1)
        nbytes = n * h * 4 + n * 4 + n * 4
        bound, bound_by = two_way_bound(nbytes, KL_SPLIT_FLOPS * splits + 2 * n * h, F32_FLOPS)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        line(f"  glr_scan time {label} ({n}, {h}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"bound {bound:.2e} ms ({bound_by}), launch floor {floor_ms:.5f} ms, "
             f"per call back to back")
    return max_err, timings


def attn_pairs(s, causal, window):
    """(query, key) pairs the mask lets through: the work of a prefill."""
    total = 0
    for q in range(s):
        lo = max(0, q - window + 1) if window > 0 else 0
        total += (q if causal else s - 1) - lo + 1
    return total


def attn_bound_ms(shape, causal, window, dtype_bytes, rate):
    """The least time of one attention call: 4 D flops a visible pair (q.k
    and p.v) over ``rate``, or q, k, v read and the output written once over
    HBM bandwidth, whichever is larger."""
    b, hq, hkv, s, d = shape
    flops = 4 * b * hq * d * attn_pairs(s, causal, window)
    nbytes = (2 * b * hq + 2 * b * hkv) * s * d * dtype_bytes
    return two_way_bound(nbytes, flops, rate)


def check_flash_attention(torch, gen, floor_ms):
    """Kernel against plain: f32 within rtol/atol 1e-4 of the f32 plain
    version (another order of the D-term sums, an online softmax); bf16
    within rtol 2**-8 / atol 1e-4 of the plain version on the same inputs in
    f32 (the output's one rounding to bf16 is at most 2**-9 relative; the
    tensor-core route splits P into two bf16 terms to stay inside it).
    Every case checks which route launched.  Times at the JAX package's
    test shapes (f32) and at qwen3-32b's prefill shape: bf16 on both routes,
    f32, the plain version and SDPA."""
    from torch.nn import functional as F

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops, ref

    kernel = fa_mod.flash_attention

    def inputs(shape, dtype):
        b, hq, hkv, s, d = shape
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda") * 0.5
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda") * 0.5
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        return q.to(dtype), k.to(dtype), v.to(dtype)

    jax_shapes = [((1, 2, 2, 128, 64), True, 0), ((2, 4, 2, 257, 72), True, 0),
                  ((1, 4, 1, 200, 128), False, 0), ((1, 2, 2, 300, 64), True, 64),
                  ((2, 8, 4, 64, 96), True, 16)]       # tests/test_kernels.py:155-159
    model = (4, 64, 8, SERVE_PROMPT, 128)              # qwen3-32b, 4 prompts of 2048
    cases = [(s, c, w, dt) for dt in (torch.float32, torch.bfloat16) for s, c, w in jax_shapes] + [
        (model, True, 0, torch.bfloat16), (model, True, 0, torch.float32),
        ((1, 64, 8, SERVE_PROMPT, 128), True, 1024, torch.bfloat16),   # a window
        ((1, 8, 2, 300, 128), True, 8, torch.float32),  # windows inside one tile
        ((1, 8, 2, 300, 128), True, 8, torch.bfloat16),
        ((1, 8, 2, 300, 32), True, 16, torch.bfloat16),
        ((1, 64, 8, SERVE_PROMPT, 128), False, 0, torch.float32),      # encoder-style
        ((1, 4, 2, 300, 200), True, 0, torch.bfloat16),                # bf16 on the FMA route
        ((1, 4, 2, 300, 128), False, 40, torch.bfloat16),   # non-causal window, tensor cores
    ] + [((1, 4, 2, 300, 64), True, 0, dt, sc)   # a scale of either sign, and 0
         for dt in (torch.bfloat16, torch.float32) for sc in (-0.1, 0.0)]
    max_err = 0.0
    for shape, causal, window, dtype, *opt in cases:
        scale = opt[0] if opt else None
        q, k, v = inputs(shape, dtype)
        tc = fa_mod.tc_route(dtype, shape[4])
        before = (kernel.tc_launches, kernel.fma_launches)
        got = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        want = ref.mha_attention(q.float(), k.float(), v.float(), causal=causal, window=window,
                                 scale=scale)
        torch.cuda.synchronize()
        check((kernel.tc_launches, kernel.fma_launches) == (before[0] + tc, before[1] + (not tc)),
              f"flash_attention {shape} {dtype}: not on the {'tensor-core' if tc else 'FMA'} route")
        check(got.dtype == dtype and got.shape == q.shape, f"flash_attention {shape}: shape/dtype")
        err = float((got.float() - want).abs().max())
        if dtype == torch.float32:
            ok, tol = torch.allclose(got, want, rtol=1e-4, atol=1e-4), "rtol/atol 1e-4 vs f32 plain"
        else:
            ok = torch.allclose(got.float(), want, rtol=2.0 ** -8, atol=1e-4)
            tol = "rtol 2^-8 atol 1e-4 vs f32 plain"
        at = f"causal={causal} window={window}" + (f" scale={scale}" if opt else "")
        check(ok, f"flash_attention {shape} {at} {dtype}: beyond {tol} (max err {err:.3e})")
        max_err = max(max_err, err)
        line(f"  flash_attention (B, Hq, Hkv, S, D)={shape} {at} "
             f"{str(dtype).split('.')[-1]} {'tensor-core' if tc else 'FMA'} route: "
             f"max_abs_err={err:.3e} ({tol}) ok")
        del q, k, v, got, want

    timings = {"jax_shapes": []}
    for shape, causal, window in jax_shapes:
        q, k, v = inputs(shape, torch.float32)
        ms = time_ms(torch, lambda: kernel(q, k, v, causal=causal, window=window), 200)
        plain_ms = time_ms(torch, lambda: ref.mha_attention(q, k, v, causal=causal,
                                                            window=window), 50)
        bound, bound_by = attn_bound_ms(shape, causal, window, 4, F32_FLOPS)
        timings["jax_shapes"].append(dict(shape=list(shape), causal=causal, window=window,
                                          ms=ms, plain_ms=plain_ms, bound_ms=bound))
        line(f"  flash_attention time {shape} f32 causal={causal} window={window}: "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.2e} ms ({bound_by}, "
             f"f32 rate), launch floor {floor_ms:.5f} ms")
    flops = 4 * model[0] * model[1] * model[4] * attn_pairs(model[3], True, 0)
    scale = 1.0 / model[4] ** 0.5
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(model, dtype)
        rate = BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound, bound_by = attn_bound_ms(model, True, 0, q.element_size(), rate)
        t = dict(bound_ms=bound, bound_by=bound_by)
        if dtype == torch.bfloat16:      # both routes, in turns: tc, fma, tc
            tc_fn = lambda: fa_mod._launch("tensor-core", q, k, v, True, 0, scale)
            t["ms"] = time_ms(torch, tc_fn, 50)
            t["fma_ms"] = time_ms(torch, lambda: fa_mod._launch("FMA", q, k, v, True, 0,
                                                                   scale), 10)
            t["ms_again"] = time_ms(torch, tc_fn, 50)
        else:
            t["ms"] = time_ms(torch, lambda: kernel(q, k, v, causal=True), 10)
        t["plain_ms"] = time_ms(torch, lambda: ref.mha_attention(q, k, v, causal=True), 3)
        t["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
        label = "model" if dtype == torch.bfloat16 else "model_f32"
        timings[label] = t
        if dtype == torch.bfloat16:
            split_ms = 1.5 * flops / BF16_TC_FLOPS * 1e3
            line(f"  flash_attention time qwen3-32b prefill {model} causal bf16: tensor-core "
                 f"route {t['ms']:.4f} / {t['ms_again']:.4f} ms ({flops / t['ms'] / 1e9:.1f} "
                 f"TFLOP/s of attention), FMA route "
                 f"{t['fma_ms']:.4f} ms ({flops / t['fma_ms'] / 1e9:.1f} TFLOP/s), plain "
                 f"{t['plain_ms']:.4f} ms, library (SDPA, enable_gqa) {t['library_ms']:.4f} ms, "
                 f"bound {bound:.4f} ms ({bound_by} at {rate / 1e12:.0f} TFLOP/s), split-P "
                 f"ceiling {split_ms:.4f} ms (1.5x the products)")
        else:
            line(f"  flash_attention time qwen3-32b prefill {model} causal f32: FMA route "
                 f"{t['ms']:.4f} ms ({flops / t['ms'] / 1e9:.1f} TFLOP/s), plain "
                 f"{t['plain_ms']:.4f} ms, library (SDPA, enable_gqa) {t['library_ms']:.4f} ms, "
                 f"bound {bound:.4f} ms ({bound_by} at {rate / 1e12:.0f} TFLOP/s)")
        del q, k, v
    return max_err, timings


# ---------------------------------------------------------------------------
# the Fig. 2 harness's two routes: one regret_scan launch against the rounds
# ---------------------------------------------------------------------------

STATE_FIELDS = ("mu_tilde", "counts", "tau", "hist", "restarts", "cum", "total", "base")
BITWISE_OUT = ("channels", "restarts", "regret", "final_regret", "aoi_pi", "aoi_star",
               "success_rate")
VAR_OUT = ("cum_aoi_var", "final_cum_aoi_var", "oracle_cum_aoi_var")


def compare_routes(torch, a, b, label):
    """Two runs of the harness: schedule, restarts, regret, AoI, success rate
    and the final GLR-CUCB state bit for bit; the variance sums at rtol 1e-6
    (the kernel adds the M squared deviations in another order than torch's
    reduction: equal bits for M <= 2).  Returns the variance sums' largest
    absolute difference."""
    for k in BITWISE_OUT:
        check(torch.equal(a[k], b[k]), f"{label}: {k} not bitwise equal")
    sa, sb = a["final_sched_state"], b["final_sched_state"]
    for f in STATE_FIELDS:
        check(torch.equal(getattr(sa, f), getattr(sb, f)), f"{label}: final state {f} differs")
    for k in VAR_OUT:
        check(torch.allclose(a[k], b[k], rtol=1e-6, atol=0), f"{label}: {k} beyond rtol 1e-6")
    return max(float((a[k] - b[k]).abs().max()) for k in VAR_OUT)


def scan_edge_cases(seed, device, rounds):
    """Short runs at the kernel's edges: (label, GLRCUCB, env, rounds).  The
    envs alternate each channel's mean between two values every 250 rounds,
    so the detectors restart several times."""
    import numpy as np

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_piecewise, make_stationary, table_env

    rng = np.random.default_rng(seed)

    def flipping(n):
        a = rng.random(n).astype(np.float32)
        segs = -(-rounds // 250)
        means = np.stack([a if s % 2 == 0 else 1.0 - a for s in range(segs)])
        return make_piecewise(means, [250 * s for s in range(1, segs)], device=device)

    table = np.repeat(flipping(5).means.cpu().numpy(), 250, axis=0)[:rounds]
    table = table + rng.uniform(-0.05, 0.05, table.shape).astype(np.float32)
    fast = dict(delta=0.1, min_samples=4)
    return [
        ("table", GLRCUCB(5, 2, history=64, detector_stride=5, **fast),
         table_env(table.clip(0.0, 1.0), device=device)),
        ("stationary S=1", GLRCUCB(5, 2, history=1024, detector_stride=5),
         make_stationary(rng.random(5).astype(np.float32), device=device)),
        ("alpha=0.2", GLRCUCB(5, 2, history=64, detector_stride=5, alpha=0.2, **fast), flipping(5)),
        ("geometric", GLRCUCB(5, 2, history=256, split_grid="geometric", **fast), flipping(5)),
        ("H=33 restarts", GLRCUCB(5, 2, history=33, **fast), flipping(5)),
        ("N=30 M=20 H=256 stride 1", GLRCUCB(30, 20, history=256, **fast), flipping(30)),
        ("N=32 M=8 H=1024", GLRCUCB(32, 8, history=1024, detector_stride=5, **fast), flipping(32)),
        ("stride 1e9 (cucb-static)", GLRCUCB(5, 2, history=64, detector_stride=10**9), flipping(5)),
        ("recompute H=33", GLRCUCB(5, 2, history=33, detector_impl="recompute", **fast),
         flipping(5)),
    ]


def check_regret_scan(torch, seed):
    """Phase 2: the scan kernel against the per-round route on short edge
    runs; the streaming rounds with ``detector_backend="torch"`` (every op a
    plain one on the card), the recompute rounds through ``glr_scan``."""
    import dataclasses

    from repro_torch.core.regret import simulate_aoi_regret
    from repro_torch.kernels.regret_scan import regret_scan

    rounds = SCAN_EDGE_ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for label, sched, env in scan_edge_cases(seed, "cuda", rounds):
        u = torch.rand((rounds, 2, sched.n_channels), generator=gen, device="cuda")
        before = regret_scan.launches
        scan = simulate_aoi_regret(sched, env, rounds, uniforms=u, return_state=True, impl="scan")
        check(regret_scan.launches == before + 1, f"regret_scan {label}: no launch")
        plain = sched if sched.detector_impl == "recompute" else \
            dataclasses.replace(sched, detector_backend="torch")
        rounds_out = simulate_aoi_regret(plain, env, rounds, uniforms=u, return_state=True,
                                         impl="rounds")
        check(regret_scan.launches == before + 1,
              f"regret_scan {label}: the rounds route launched it")
        torch.cuda.synchronize()
        compare_routes(torch, scan, rounds_out, f"regret_scan {label}")
        line(f"  regret_scan {label}: T={rounds} restarts={int(scan['restarts'])} "
             f"regret={float(scan['final_regret']):.0f}, equal to the rounds route ok")


def flipping_env(rng, n, rounds, device):
    """A piecewise env whose channel means alternate between two draws every
    250 rounds (the detectors restart several times)."""
    from repro_torch.core.channels import make_piecewise

    import numpy as np

    a = rng.random(n).astype(np.float32)
    segs = -(-rounds // 250)
    means = np.stack([a if s % 2 == 0 else 1.0 - a for s in range(segs)])
    return make_piecewise(means, [250 * s for s in range(1, segs)], device=device)


def check_regret_scan_batch(torch, seed):
    """Phase 2: the scan with a run axis against its plain version, the
    batched per-round loop, at two batches: B = 24 runs of their own envs
    and uniforms (streaming; the plain detector on the rounds), and B = 133
    runs (more than one wave of the card's blocks) sharing one env and one
    stream with a per-run gamma x delta grid (recompute).  Returns the
    variance sums' largest absolute difference."""
    import dataclasses

    import numpy as np

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.bandits.base import stack_params
    from repro_torch.core.channels import stack_envs
    from repro_torch.kernels.regret_scan import regret_scan
    from repro_torch.sim import simulate_aoi_regret_batch

    rounds, err = SCAN_EDGE_ROUNDS, 0.0
    rng = np.random.default_rng(seed + 33)
    gen = torch.Generator(device="cuda").manual_seed(seed + 33)
    fast = dict(delta=0.1, min_samples=4)
    for label, b, shared, impl in (("B=24 own envs", 24, False, "streaming"),
                                   ("B=133 shared env, hp grid", 133, True, "recompute")):
        sched = GLRCUCB(5, 2, history=64, detector_stride=5, detector_impl=impl, **fast)
        if shared:
            grid = [sched.replace_traced(gamma=float(g), delta=float(d))
                    for g, d in zip(rng.uniform(0.3, 1.5, b), rng.uniform(1e-3, 0.2, b))]
            kw = dict(envs=flipping_env(rng, 5, rounds, "cuda"), env_axis=None,
                      uniforms=torch.rand((rounds, 2, 5), generator=gen, device="cuda"),
                      uniforms_axis=None, hparams=stack_params(grid, "cuda"), hp_axis=0)
        else:
            kw = dict(envs=stack_envs([flipping_env(rng, 5, rounds, "cuda") for _ in range(b)]),
                      uniforms=torch.rand((b, rounds, 2, 5), generator=gen, device="cuda"))
        before = regret_scan.launches
        scan = simulate_aoi_regret_batch(sched, horizon=rounds, return_state=True, impl="scan",
                                         **kw)
        check(regret_scan.launches == before + 1, f"regret_scan batch {label}: not one launch")
        plain = sched if impl == "recompute" else dataclasses.replace(sched,
                                                                      detector_backend="torch")
        rounds_out = simulate_aoi_regret_batch(plain, horizon=rounds, return_state=True,
                                               impl="rounds", **kw)
        check(regret_scan.launches == before + 1,
              f"regret_scan batch {label}: the rounds route launched it")
        torch.cuda.synchronize()
        err = max(err, compare_routes(torch, scan, rounds_out, f"regret_scan batch {label}"))
        line(f"  regret_scan batch {label} ({impl}): T={rounds}, one launch, restarts "
             f"{int(scan['restarts'].sum())} over the runs, equal to the batched rounds route ok")
    return err


def timed_run(torch, fn):
    """(output, seconds) of one run that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def scan_bound_ms(sched, rounds, splits):
    """The least time of a scan run: the GLR splits it evaluated at
    ``KL_SPLIT_FLOPS`` each, against its bytes (uniforms in, schedule and
    curves out, the state in and out)."""
    n, m, h = sched.n_channels, sched.n_clients, sched.history
    nbytes = rounds * 2 * n * 4 + rounds * m * 8 + 2 * rounds * 4 + 2 * (n * h * 4 + 4 * n * 4 + 8)
    return two_way_bound(nbytes, KL_SPLIT_FLOPS * splits, F32_FLOPS)


def fig2_routes(torch, label, sched, env, uniforms):
    """The T = FIG2_ROUNDS run on both routes, in turns scan, rounds, scan:
    launch counts, bit-for-bit equality and each route's ms/round.  Returns
    (the scan's output, summed launches, the scan's kernel-line fields)."""
    from repro_torch.core.regret import simulate_aoi_regret
    from repro_torch.kernels.regret_scan import regret_scan

    rounds = uniforms.shape[0]
    kernel = "glr_scan" if sched.detector_impl == "recompute" else "glr_step"
    run = lambda impl: simulate_aoi_regret(sched, env, rounds, uniforms=uniforms,
                                           return_state=True, impl=impl)
    reset_launches()
    scan, secs_scan = timed_run(torch, lambda: run(None))
    scan_launches = read_launches()
    splits = int(regret_scan.splits.sum())
    check(scan_launches["regret_scan"] == 1 and scan_launches[kernel] == 0
          and scan_launches["glr_step"] + scan_launches["glr_scan"] == 0,
          f"{label} scan: launches {scan_launches}, expected regret_scan once and no {kernel}")
    reset_launches()
    rounds_out, secs_rounds = timed_run(torch, lambda: run("rounds"))
    rounds_launches = read_launches()
    check(rounds_launches[kernel] == rounds // sched.detector_stride
          and rounds_launches["regret_scan"] == 0,
          f"{label} rounds: {kernel} launched {rounds_launches[kernel]} times, expected "
          f"{rounds // sched.detector_stride}, regret_scan {rounds_launches['regret_scan']}")
    _, secs_scan_again = timed_run(torch, lambda: run(None))
    err = compare_routes(torch, scan, rounds_out, f"{label} scan vs rounds")
    bound, bound_by = scan_bound_ms(sched, rounds, splits)
    ms_scan, ms_scan_again, ms_rounds = secs_scan * 1e3, secs_scan_again * 1e3, secs_rounds * 1e3
    line(f"  {label} scan route: T={rounds} {ms_scan:.3f} ms a run ({ms_scan / rounds:.6f} "
         f"ms/round), again {ms_scan_again:.3f} ms; regret_scan.launches="
         f"{scan_launches['regret_scan']}, {splits} GLR splits, bound {bound:.2e} ms ({bound_by})")
    line(f"  {label} rounds route: T={rounds} {ms_rounds:.1f} ms a run ({ms_rounds / rounds:.4f} "
         f"ms/round), {ms_rounds / ms_scan:.0f}x the scan's; {kernel}.launches="
         f"{rounds_launches[kernel]}")
    line(f"  {label}: schedule, restarts={int(scan['restarts'])}, regret, AoI, success rate and "
         f"final state of the two routes bitwise equal, variance sums within rtol 1e-6")
    launches = {k: scan_launches[k] + rounds_launches[k] for k in COUNTERS}
    fields = dict(scan_source="src/repro_torch/kernels/csrc/regret_scan.cu",
                  scan_launches=scan_launches["regret_scan"], scan_rounds=rounds,
                  scan_ms=ms_scan, scan_ms_again=ms_scan_again, scan_ms_per_round=ms_scan / rounds,
                  scan_plain_ms=ms_rounds, scan_bound_ms=bound, scan_bound_by=bound_by,
                  scan_splits=splits, scan_max_abs_err=err)
    return scan, launches, fields


def scan_chain_cost(torch, sched, env, uniforms, ms_stride):
    """What a scan round costs without and with detection: the same run at
    detector stride 1e9 (a detection at round 0 only: the per-round
    dependency chain of warp 0 alone) and 1 (a detection every round),
    beside the run's own stride.  Per-round chain = t(1e9) / T; per
    detection round = (t(1) - t(1e9)) / (T - 1)."""
    import dataclasses

    from repro_torch.core.regret import simulate_aoi_regret

    rounds = uniforms.shape[0]
    ms = {}
    for stride in (10**9, 1):
        s = dataclasses.replace(sched, detector_stride=stride)
        _, secs = timed_run(torch, lambda: simulate_aoi_regret(s, env, rounds, uniforms=uniforms))
        ms[stride] = secs * 1e3
    chain_us = ms[10**9] / rounds * 1e3
    detect_us = (ms[1] - ms[10**9]) / (rounds - 1) * 1e3
    line(f"  fig2 scan chain: T={rounds} stride 1e9 {ms[10**9]:.3f} ms, stride "
         f"{sched.detector_stride} {ms_stride:.3f} ms, stride 1 {ms[1]:.3f} ms: the per-round "
         f"chain {chain_us:.3f} us a round, a detection round {detect_us:.3f} us more")
    return chain_us


def scan_call_cost(torch, sched, env, uniforms, ms_per_round, rounds=500, calls=20):
    """The scan route's fixed cost a call on the host: ``calls`` runs of
    ``rounds`` rounds (the profile window's length), each ending in a
    synchronize, against ``rounds`` x the full run's time a round."""
    from repro_torch.core.regret import simulate_aoi_regret

    u = uniforms[:rounds].contiguous()
    run = lambda: simulate_aoi_regret(sched, env, rounds, uniforms=u, collect_curve=False)
    timed_run(torch, run)
    ms_call = sum(timed_run(torch, run)[1] for _ in range(calls)) / calls * 1e3
    kernel_ms = rounds * ms_per_round
    line(f"  fig2 scan call: {rounds} rounds {ms_call:.4f} ms a call (mean of {calls}, each "
         f"synchronized), {rounds} x {ms_per_round:.6f} ms = {kernel_ms:.4f} ms of rounds: "
         f"{ms_call - kernel_ms:.4f} ms fixed a call (state init, checks, allocation, launch)")


# ---------------------------------------------------------------------------
# phase 3: Fig. 2 AoI-regret path
# ---------------------------------------------------------------------------

def fig2(torch, seed):
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_scenario
    from repro_torch.core.regret import simulate_aoi_regret, sublinearity_index
    from repro_torch.kernels.regret_scan import regret_scan

    n, m = 5, 2
    sched = GLRCUCB(n, m, history=1024, detector_stride=5)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rounds = FIG2_ROUNDS
    env = make_scenario("piecewise", n_channels=n, horizon=rounds, n_breakpoints=5).realize(gen)
    # the env, for tools/fig2_reference.py --env (the JAX reference on it)
    line("  fig2 env: " + json.dumps({"means": env.means.cpu().tolist(),
                                      "breaks": env.breaks.cpu().tolist()}))

    # reference: a shorter run on the card (the scan kernel) equals the same
    # run on the CPU (the plain per-round loop) on the same uniforms
    t_ref = FIG2_REF_ROUNDS             # typically passes a breakpoint and a restart
    u = torch.rand((t_ref, 2, n), generator=gen, device="cuda")
    before = regret_scan.launches
    card = simulate_aoi_regret(sched, env, t_ref, uniforms=u)
    check(regret_scan.launches == before + 1, "fig2 reference: the card run did not take the scan")
    cpu = simulate_aoi_regret(sched, env.to("cpu"), t_ref, uniforms=u.cpu(), device="cpu")
    check(torch.equal(card["channels"].cpu(), cpu["channels"]), "fig2: card schedule != CPU schedule")
    check(int(card["restarts"]) == int(cpu["restarts"]), "fig2: card restarts != CPU restarts")
    check(torch.equal(card["regret"].cpu(), cpu["regret"]), "fig2: card regret != CPU regret")
    line(f"  fig2 reference: {t_ref} rounds of the scan route on the card equal the CPU run "
         f"(schedule, restarts={int(cpu['restarts'])}, regret={float(cpu['final_regret']):.0f})")

    # drawn as simulate_aoi_regret would draw them from gen; kept for phase 6
    uniforms = torch.rand((rounds, 2, n), generator=gen, device="cuda")
    out, launches, scan_fields = fig2_routes(torch, "fig2", sched, env, uniforms)
    regret = out["regret"]
    check(regret.shape == (rounds,) and bool(torch.isfinite(regret).all()), "fig2: regret not finite")
    chain_us = scan_chain_cost(torch, sched, env, uniforms, scan_fields["scan_ms"])
    scan_call_cost(torch, sched, env, uniforms, scan_fields["scan_ms_per_round"])
    profile_window(torch, "fig2 rounds route", lambda: simulate_aoi_regret(
        sched, env, 500, generator=gen, collect_curve=False, impl="rounds"), 500)
    profile_window(torch, "fig2 scan route", lambda: simulate_aoi_regret(
        sched, env, 500, generator=gen, collect_curve=False), 500)
    profile_window(torch, "fig2 scan route", lambda: simulate_aoi_regret(
        sched, env, rounds, uniforms=uniforms), rounds)
    sub = float(sublinearity_index(regret))
    line(f"  fig2: T={rounds} final_regret={float(out['final_regret']):.1f} "
         f"restarts={int(out['restarts'])} sublinearity_index={sub:.4f} "
         f"success_rate={float(out['success_rate']):.4f}")
    return launches, dict(env=env, uniforms=uniforms, out=out, n=n, m=m, scan=scan_fields,
                          chain_us=chain_us)


# ---------------------------------------------------------------------------
# phase 6: Fig. 2 with the recompute detector
# ---------------------------------------------------------------------------

def fig2_recompute(torch, f2):
    """Phase 3's run again with ``detector_impl="recompute"`` on the same
    env and uniforms, on both routes: every decision must equal the
    streaming scan's, bit for bit."""
    from repro_torch.core.bandits import GLRCUCB

    sched = GLRCUCB(f2["n"], f2["m"], history=1024, detector_stride=5, detector_impl="recompute")
    out, launches, scan_fields = fig2_routes(torch, "fig2 recompute", sched, f2["env"],
                                             f2["uniforms"])
    ref = f2["out"]
    for k in BITWISE_OUT + VAR_OUT:
        check(torch.equal(out[k], ref[k]), f"fig2 recompute: {k} differs from the streaming scan")
    for f in ("mu_tilde", "counts", "tau", "restarts"):
        check(torch.equal(getattr(out["final_sched_state"], f),
                          getattr(ref["final_sched_state"], f)),
              f"fig2 recompute: final {f} differs from the streaming scan")
    line(f"  fig2 recompute: schedule, restarts={int(out['restarts'])}, regret "
         f"{float(out['final_regret']):.1f}, AoI and variances bitwise equal to the streaming scan")
    return launches, scan_fields


# ---------------------------------------------------------------------------
# phase 4: Fig. 3 asynchronous-FL path
# ---------------------------------------------------------------------------

def fig3_setup(torch, seed, n=30, m=20, adversarial=False):
    """The Fig. 3 problem at the paper's size: data, the 5,674-param MLP,
    the skewed piecewise env, the config, GLR-CUCB and the uniforms.  With
    ``adversarial`` the env is the extremely non-stationary regime's
    (``random_adversarial_env``, flip_prob 0.01, at the paper's small scale
    N = 6, M = 4: ``benchmarks/run.py:770-776``); the draws before the env
    are those of the default."""
    import numpy as np
    from torch import nn
    from torch.nn import functional as F

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_piecewise, random_adversarial_env
    from repro_torch.data import FederatedLoader, SyntheticClassification, dirichlet_partition
    from repro_torch.fl import AsyncFLConfig

    dim, hidden, classes, spc = 48, 96, 10, 192
    rounds = FIG3_ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    # data: the benchmark's Fig. 3 problem (Dirichlet alpha 0.1, 192 samples a
    # client; its seeds 3 and 4 at --seed 0)
    ds = SyntheticClassification(m * spc * 2, n_classes=classes, dim=dim, noise=1.0, seed=3 + seed)
    (trx, try_), (tex, tey) = ds.split(0.9)
    parts = dirichlet_partition(try_, m, 0.1, seed=3 + seed, min_per_client=spc)
    cx = np.stack([trx[np.resize(p, spc)] for p in parts])
    cy = np.stack([try_[np.resize(p, spc)] for p in parts])
    bx, by = FederatedLoader(cx, cy, batch_size=16, local_epochs=3, seed=4 + seed).next_rounds(rounds)
    bx, by = torch.from_numpy(bx).cuda(), torch.from_numpy(by).to(torch.int64).cuda()
    tex, tey = torch.from_numpy(tex).cuda(), torch.from_numpy(tey).to(torch.int64).cuda()

    class MLP(nn.Module):
        """48 -> 96 -> 10, weights in the JAX package's (in, out) layout."""

        def __init__(self):
            super().__init__()
            self.w1 = nn.Parameter(torch.randn((dim, hidden), generator=gen, device="cuda") * 0.1)
            self.b1 = nn.Parameter(torch.zeros(hidden, device="cuda"))
            self.w2 = nn.Parameter(torch.randn((hidden, classes), generator=gen, device="cuda") * 0.1)
            self.b2 = nn.Parameter(torch.zeros(classes, device="cuda"))

        def forward(self, x):
            return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2

    model = MLP()
    params = {k: v.detach() for k, v in model.named_parameters()}
    n_params = sum(v.numel() for v in params.values())
    check(n_params == 5674, f"fig3: MLP has {n_params} params, expected 5674")

    def loss_fn(p, x, y):
        return F.cross_entropy(torch.func.functional_call(model, p, (x,)), y)

    def accuracy(state):
        with torch.no_grad():
            logits = torch.relu(tex @ state.params["w1"] + state.params["b1"]) \
                @ state.params["w2"] + state.params["b2"]
            return float((logits.argmax(1) == tey).float().mean())

    if adversarial:
        env = random_adversarial_env(gen, n, rounds, flip_prob=0.01)
    else:
        # the skewed piecewise env: Good channels are rare (means ~ u^4)
        means = 0.03 + (0.95 - 0.03) * torch.rand((5, n), generator=gen, device="cuda") ** 4.0
        breaks = torch.linspace(0, rounds, 6, device="cuda")[1:-1].to(torch.int64)
        env = make_piecewise(means, breaks)
    return dict(
        n=n, m=m, rounds=rounds, bx=bx, by=by, params=params, loss_fn=loss_fn,
        accuracy=accuracy, env=env,
        cfg=AsyncFLConfig(n_clients=m, n_channels=n, local_epochs=3, client_lr=0.15,
                          server_lr=0.15, use_matching=True, use_zeta=True),
        sched=GLRCUCB(n, m, history=256),
        uniforms=torch.rand((rounds, 2, n), generator=gen, device="cuda"))


def fig3_reference(torch, S, label, fault_uniforms=None, burst_on=False, **kw):
    """Rounds on the card equal the same rounds on the CPU, on the same
    uniforms: n_success and mean AoI bitwise, the rest at rtol 1e-4.  ``kw``
    (faults, aggregator) goes to both trainers.  With faults the CPU run is
    also held, round by round, against the same run without them: their
    params must part, so a corrupted row reached the aggregate within the
    compared rounds (``FIG3_REF_ROUNDS``, or up to ``FIG3_REF_MAX_ROUNDS``
    until that happens).  ``burst_on`` starts a burst schedule bursting."""
    from repro_torch.fl import AsyncFLTrainer

    faults = kw.get("faults")

    def start(tr):
        state = tr.init(S["params"])
        return state._replace(fault_state=torch.ones((), device=tr.device)) if burst_on else state

    def one_round(tr, state, r, fu):
        sl = slice(r, r + 1)
        return tr.run(state, S["bx"][sl].to(tr.device), S["by"][sl].to(tr.device),
                      uniforms=S["uniforms"][sl].to(tr.device),
                      fault_uniforms=None if fu is None else fu[sl].to(tr.device))

    cpu_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], device="cpu", **kw)
    s_cpu, mets, hit, r = start(cpu_tr), [], None, 0
    if faults is not None:
        clean_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], device="cpu",
                                  aggregator=kw.get("aggregator"))
        s_clean = clean_tr.init(S["params"])
    while r < FIG3_REF_ROUNDS or (faults is not None and hit is None and r < FIG3_REF_MAX_ROUNDS):
        s_cpu, m = one_round(cpu_tr, s_cpu, r, fault_uniforms)
        mets.append(m)
        if faults is not None and hit is None:
            s_clean, _ = one_round(clean_tr, s_clean, r, None)
            if any(not torch.equal(s_cpu.params[k], s_clean.params[k]) for k in S["params"]):
                hit = r + 1
        r += 1
    check(faults is None or hit is not None,
          f"{label}: no corrupted row reached the aggregate in {r} rounds")
    m_cpu = {k: torch.cat([m[k] for m in mets]) for k in mets[0]}

    card_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], **kw)
    s_card, m_card = card_tr.run(start(card_tr), S["bx"][:r], S["by"][:r],
                                 uniforms=S["uniforms"][:r],
                                 fault_uniforms=None if fault_uniforms is None else fault_uniforms[:r])
    for k in ("n_success", "mean_aoi"):
        check(torch.equal(m_card[k].cpu(), m_cpu[k]), f"{label}: card {k} != CPU {k}")
    for k in ("local_loss", "aoi_var", "zeta_max"):
        check(torch.allclose(m_card[k].cpu(), m_cpu[k], rtol=1e-4, atol=1e-5),
              f"{label}: card {k} not close to CPU {k}")
    for k in S["params"]:
        check(torch.allclose(s_card.params[k].cpu(), s_cpu.params[k], rtol=1e-4, atol=1e-5),
              f"{label}: card params {k} not close to CPU")
    hit_note = "" if faults is None else f"; an attacked row first reached the aggregate in round {hit}"
    line(f"  {label} reference: {r} rounds on the card match the CPU run "
         f"(n_success {m_cpu['n_success'].tolist()}, local_loss rtol 1e-4{hit_note})")


def fig3(torch, S):
    import numpy as np

    from repro_torch.fl import AsyncFLTrainer

    rounds = S["rounds"]
    fig3_reference(torch, S, "fig3")
    card_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mets = card_tr.run(card_tr.init(S["params"]), S["bx"], S["by"], uniforms=S["uniforms"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    profile_window(torch, "fig3", lambda: card_tr.run(
        state, S["bx"][:10], S["by"][:10], uniforms=S["uniforms"][:10]), 10)
    acc = S["accuracy"](state)
    loss = mets["local_loss"]
    check(bool(torch.isfinite(loss).all()) and np.isfinite(acc), "fig3: loss or accuracy not finite")
    check(launches["weighted_aggregate"] == rounds,
          f"fig3: weighted_aggregate launched {launches['weighted_aggregate']} times, expected {rounds}")
    check(launches["glr_step"] == rounds,
          f"fig3: glr_step launched {launches['glr_step']} times, expected {rounds}")
    check(acc > 0.2, f"fig3: test accuracy {acc:.3f} is not above chance")
    line(f"  fig3: rounds={rounds} local_loss first={float(loss[0]):.4f} last={float(loss[-1]):.4f} "
         f"n_success total={float(mets['n_success'].sum()):.0f} "
         f"mean_aoi last={float(mets['mean_aoi'][-1]):.3f} test_acc={acc:.4f} "
         f"seconds/round={secs / rounds:.6f} glr_step.launches={launches['glr_step']} "
         f"weighted_aggregate.launches={launches['weighted_aggregate']}")
    return launches, acc


# ---------------------------------------------------------------------------
# phase 5: the Fig. 3 path under Byzantine faults, robust aggregation
# ---------------------------------------------------------------------------

def fig3_robust(torch, S, seed, clean_acc):
    """The chaos suite's attack x defense runs on phase 4's setup."""
    import numpy as np

    from repro_torch.core.aggregation import make_aggregator
    from repro_torch.core.faults import make_fault
    from repro_torch.fl import AsyncFLTrainer

    rounds = S["rounds"]
    sign_flip = make_fault("sign_flip", rate=0.2, scale=8.0)
    trimmed = make_aggregator("trimmed_mean", trim_frac=0.34)
    median = make_aggregator("coordinate_median")
    burst = make_fault("burst", base=make_fault("sign_flip", rate=0.3, scale=6.0),
                       p_on=0.15, p_off=0.35)
    runs = [
        ("sign_flip+mean", sign_flip, make_aggregator("mean")),
        ("sign_flip+trimmed_mean", sign_flip, trimmed),
        ("sign_flip+coordinate_median", sign_flip, median),
        ("inner_product+norm_clip", make_fault("inner_product", rate=0.2, strength=8.0),
         make_aggregator("norm_clip", clip_norm=1.0)),
        ("burst+coordinate_median", burst, median),
    ]
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    fault_u = {name: torch.rand((rounds, f.n_uniforms(S["m"])), generator=gen, device="cuda")
               for name, f, _ in runs}
    fig3_reference(torch, S, "fig3 sign_flip+coordinate_median", faults=sign_flip,
                   aggregator=median, fault_uniforms=fault_u["sign_flip+coordinate_median"])
    fig3_reference(torch, S, "fig3 burst+trimmed_mean", faults=burst, aggregator=trimmed,
                   fault_uniforms=fault_u["burst+coordinate_median"],   # the same family
                   burst_on=True)

    totals = dict.fromkeys(COUNTERS, 0)
    for name, fault, agg in runs:
        tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], faults=fault,
                            aggregator=agg)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = tr.run(tr.init(S["params"]), S["bx"], S["by"], uniforms=S["uniforms"],
                             fault_uniforms=fault_u[name])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        order_stat = agg.FAMILY in ("trimmed_mean", "coordinate_median")
        want = dict(robust_trimmed=rounds if order_stat else 0,
                    weighted_aggregate=0 if order_stat else rounds, glr_step=rounds)
        for k, v in want.items():
            check(launches[k] == v, f"fig3 {name}: {k} launched {launches[k]} times, expected {v}")
        acc = S["accuracy"](state)
        loss = mets["local_loss"]
        check(bool(torch.isfinite(loss).all()) and np.isfinite(acc)
              and all(bool(torch.isfinite(v).all()) for v in state.params.values()),
              f"fig3 {name}: loss, params or accuracy not finite")
        line(f"  fig3 {name}: rounds={rounds} test_acc={acc:.4f} (clean {clean_acc:.4f}) "
             f"local_loss last={float(loss[-1]):.4f} "
             f"n_success total={float(mets['n_success'].sum()):.0f} "
             f"seconds/round={secs / rounds:.6f} launches={launches}")
        for k in COUNTERS:
            totals[k] += launches[k]
        if name == "sign_flip+coordinate_median":
            profile_window(torch, f"fig3 {name}", lambda: tr.run(
                state, S["bx"][:10], S["by"][:10], uniforms=S["uniforms"][:10],
                fault_uniforms=fault_u[name][:10]), 10)
    return totals


# ---------------------------------------------------------------------------
# phase 7: the model zoo's serving path (prefill and greedy decode)
# ---------------------------------------------------------------------------

def release(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_reference(torch, seed):
    """qwen3-32b at full width, 2 layers, f32: the kernel route's prefill
    against the plain chunked route (rtol/atol 2e-3, the JAX package's
    kernel-vs-XLA tolerance), then decode against prefill (rtol/atol 2e-3,
    the twin of ``tests/test_arch_smoke.py::test_decode_matches_prefill_f32``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_REF_LAYERS, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    model, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params, _ = model.init(gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT), generator=gen, device="cuda",
                         dtype=torch.int32)
    before, before_fma = kernel.launches, kernel.fma_launches
    got = make_prefill_step(model)(params, {"tokens": toks})
    check(kernel.launches == before + SERVE_REF_LAYERS
          and kernel.fma_launches == before_fma + SERVE_REF_LAYERS,
          f"serve f32: the kernel route launched {kernel.launches - before} kernels, "
          f"{kernel.fma_launches - before_fma} on the FMA route")
    want = make_prefill_step(plain)(params, {"tokens": toks})
    check(kernel.launches == before + SERVE_REF_LAYERS, "serve f32: the plain route ran the kernel")
    err = float((got - want).abs().max())
    check(got.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          f"serve f32: prefill logits {tuple(got.shape)} not finite or of the wrong shape")
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
          f"serve f32: kernel-route prefill beyond rtol/atol 2e-3 of the plain route ({err:.3e})")
    line(f"  serve {cfg.name} width {cfg.d_model}, {cfg.n_layers} layers, f32: prefill of "
         f"{SERVE_PROMPT} tokens, kernel route vs plain chunked route max_abs_err={err:.3e} "
         f"(max |logit| {float(want.abs().max()):.3f}; rtol/atol 2e-3) ok")

    full, _ = model.apply(params, {"tokens": toks})
    cache = model.init_cache(1, SERVE_PROMPT, dtype=torch.float32, device="cuda")
    dec_err = 0.0
    for t in range(DECODE_REF_STEPS):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        ref_t = full[:, t].float()
        dec_err = max(dec_err, float((lg - ref_t).abs().max()))
        check(torch.allclose(lg, ref_t, rtol=2e-3, atol=2e-3),
              f"serve f32: decode step {t} beyond rtol/atol 2e-3 of apply's logits ({dec_err:.3e})")
    line(f"  serve {cfg.name} f32: {DECODE_REF_STEPS} teacher-forced decode steps match apply's "
         f"logits (kernel-route prefill), max_abs_err={dec_err:.3e} (rtol/atol 2e-3) ok")
    del params, got, want, full, cache, lg
    release(torch)


def serve_path(torch, seed, n_layers):
    """qwen3-32b at full width and ``n_layers`` depth in bf16: prefill steps
    and the serve loop, the main path whose launches are counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=n_layers)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    t0 = time.perf_counter()
    params, _ = model.init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    norms = n_layers * (2 * cfg.d_model + 2 * cfg.resolved_head_dim * cfg.qk_norm) + cfg.d_model
    check(n_params == cfg.param_count() + norms,      # param_count leaves out the norm gains
          f"serve: {n_params} params, config says {cfg.param_count()} + {norms} norm gains")
    weights_gib = sum(v.numel() * v.element_size() for v in params.values()) / 2 ** 30
    line(f"  serve {cfg.name}: {n_layers} layers, width {cfg.d_model}, bf16, {n_params / 1e9:.2f} B "
         f"params ({weights_gib:.2f} GiB) drawn on the card in {init_s:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_PREFILL_BATCH, SERVE_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    prefill = make_prefill_step(model)

    reset_launches()
    prefill_ms = []
    for _ in range(3):                    # the first one is the warm-up
        before, before_tc = kernel.launches, kernel.tc_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        check(kernel.launches == before + n_layers and kernel.tc_launches == before_tc + n_layers,
              f"serve: flash_attention launched {kernel.launches - before} times in a prefill, "
              f"{kernel.tc_launches - before_tc} on the tensor-core route, expected {n_layers}")
        check(logits.shape == (SERVE_PREFILL_BATCH, 1, cfg.vocab_size)
              and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
              f"serve: prefill logits {tuple(logits.shape)} {logits.dtype} not finite or misshapen")
    release(torch)
    tok, cache, secs = serve_loop(model, params, SERVE_BATCH, SERVE_CONTEXT, SERVE_TOKENS,
                                  device="cuda")
    launches = read_launches()
    check(int(cache["pos"]) == SERVE_TOKENS, f"serve: cache pos {int(cache['pos'])}")
    check(tok.shape == (SERVE_BATCH,) and tok.dtype == torch.int32
          and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()), "serve: decoded tokens invalid")
    step_ms = secs / SERVE_TOKENS * 1e3
    line(f"  serve {cfg.name}: prefill {SERVE_PREFILL_BATCH} x {SERVE_PROMPT} tokens "
         f"{prefill_ms[1]:.1f} / {prefill_ms[2]:.1f} ms (warm-up {prefill_ms[0]:.1f} ms), "
         f"{SERVE_PREFILL_BATCH * SERVE_PROMPT / (prefill_ms[1] / 1e3):.0f} prompt tok/s; "
         f"flash_attention.launches={launches['flash_attention']} "
         f"({launches['flash_attention'] // 3} a prefill, "
         f"{launches['flash_attention_tc'] // 3} of them on the tensor-core route)")
    line(f"  [serve] {cfg.name}: {SERVE_TOKENS} tokens x {SERVE_BATCH} seqs in {secs:.2f}s "
         f"({SERVE_BATCH * SERVE_TOKENS / secs:.1f} tok/s, {step_ms:.2f} ms a decode step, "
         f"context {SERVE_CONTEXT}), cache pos={int(cache['pos'])}")

    # not counted: the plain route's prefill for comparison, and traces
    got = logits.float()
    want = make_prefill_step(build_model(cfg, attn_impl="plain"))(params, batch).float()
    rel = float((got - want).abs().max() / want.abs().max())
    line(f"  serve {cfg.name}: bf16 prefill logits, kernel route vs plain chunked route: "
         f"max |diff| / max |logit| = {rel:.3e} (printed, not gated)")
    del got, want
    release(torch)
    by_name = profile_window(torch, f"serve prefill {SERVE_PREFILL_BATCH}x{SERVE_PROMPT}",
                             lambda: prefill(params, batch), 1)
    total = sum(by_name.values())
    attn_us = sum(v for k, v in by_name.items() if "flash_fwd" in k)
    if total:
        line(f"  serve prefill: flash_attention {attn_us / 1e3:.2f} ms of {total / 1e3:.2f} ms "
             f"device time ({100 * attn_us / total:.1f} %)")
    steps = 4
    out = {}

    def decode():
        tk = tok
        c = cache
        for _ in range(steps):
            lg, c = model.decode_step(params, c, tk)
            tk = lg.argmax(-1).to(torch.int32)
        out["logits"] = lg

    profile_window(torch, f"serve decode batch {SERVE_BATCH}", decode, steps)
    lg = out["logits"]
    check(lg.shape == (SERVE_BATCH, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
          "serve: decode logits not finite or misshapen")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line(f"  serve {cfg.name}: decode logits finite, peak device memory {peak:.2f} GiB")
    del params, logits, cache, lg, out
    release(torch)
    return launches, dict(prefill_ms=prefill_ms[1:], decode_step_ms=step_ms,
                          tok_s=SERVE_BATCH * SERVE_TOKENS / secs)


# ---------------------------------------------------------------------------
# phase 8: the multi-tenant scheduler service
# ---------------------------------------------------------------------------

def same_tree(torch, a, b):
    """Every tensor leaf of two equal NamedTuple/dict structures bitwise
    equal (compared on the CPU)."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return all(same_tree(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return all(same_tree(torch, a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def sched_parity(torch, sched, server, seed):
    """(a) One tenant served 1000 rounds on ``offline_round_stream`` of a
    piecewise env (N = 16, 3 breakpoints) equals ``simulate_aoi_regret``'s
    scan route on the card and the same rounds served on the CPU, bit for
    bit.  Returns the launches of the served run."""
    from repro_torch.core.channels import make_scenario
    from repro_torch.core.regret import offline_round_stream, simulate_aoi_regret
    from repro_torch.kernels.regret_scan import regret_scan
    from repro_torch.sim import SchedServer, ServeRequest

    n, rounds = sched.n_channels, SCHED_PARITY_ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    env = make_scenario("piecewise", n_channels=n, horizon=rounds, n_breakpoints=3).realize(gen)
    u = torch.rand((rounds, 2, n), generator=gen, device="cuda")
    before = regret_scan.launches
    off = simulate_aoi_regret(sched, env, rounds, uniforms=u, collect_curve=False,
                              return_state=True)
    check(regret_scan.launches == before + 1, "sched-serve parity: the offline run did not scan")
    u_sel, states = (x.cpu().numpy() for x in offline_round_stream(env, u, rounds))
    reqs = [ServeRequest("parity", states[t], u_sel[t]) for t in range(rounds)]
    server.join("parity")
    steps0 = server.stats()["steps"]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rq in reqs:
        server.serve([rq])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    steps = server.stats()["steps"] - steps0
    row = server.tenant_state("parity")
    cpu = SchedServer(sched, capacity=4, slots=1, device="cpu")
    cpu.join("parity")
    for rq in reqs:
        cpu.serve([rq])
    cpu_row = cpu.tenant_state("parity")
    check(same_tree(torch, off["final_sched_state"], row.sched_state),
          "sched-serve parity: served state != the scan route's final state")
    check(torch.equal(off["aoi_pi"].cpu(), row.aoi.cpu()), "sched-serve parity: AoI != the scan's")
    check(same_tree(torch, row, cpu_row), "sched-serve parity: card row != the CPU run's row")
    check(launches["glr_step_tenants"] == steps == rounds and launches["glr_step"] == 0,
          f"sched-serve parity: launches {launches} over {steps} steps")
    line(f"  sched-serve parity: {rounds} rounds of one tenant (slot batch {server.slots}) equal "
         f"the scan route and the CPU run bit for bit (every state leaf, AoI, restarts="
         f"{int(row.sched_state.restarts)}); glr_step_tenants launched "
         f"{launches['glr_step_tenants']} times over {steps} steps, glr_step "
         f"{launches['glr_step']} ({secs / rounds * 1e3:.4f} ms/step)")
    server.leave("parity")
    return launches


def sched_serve(torch, seed):
    """Phase 8: the JAX benchmark's ``serve_suite`` configuration
    (``benchmarks/run.py:1380-1456``) at its sizes.  Returns the launches of
    the served runs (each counted from zero) and the metrics."""
    from collections import deque

    import numpy as np

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.fl import AsyncFLTrainer
    from repro_torch.launch.sched_serve import (make_traffic, pipelined_poisson_episode,
                                                pipelined_throughput, saturated_throughput)
    from repro_torch.sim import SchedServer, ServeRequest

    c, b, n, m = SCHED_CAPACITY, SCHED_SLOTS, SCHED_N, SCHED_M
    sched = GLRCUCB(n, m, history=SCHED_H, detector_stride=5, split_grid="auto")
    server = SchedServer(sched, capacity=c, slots=b)
    serial = SchedServer(sched, capacity=c, slots=1)
    paths = [sched_parity(torch, sched, server, seed)]

    # (b) the 256-tenant server: per-tenant gamma, the benchmark's traffic
    n_req, n_serial = SCHED_REQUESTS, SCHED_SERIAL_REQUESTS
    ids = [f"job-{i}" for i in range(c)]
    cpu = SchedServer(sched, capacity=c, slots=b, device="cpu")
    for i, tid in enumerate(ids):
        hp = {"gamma": 0.8 + 0.4 * i / c}
        server.join(tid, hp=hp)
        cpu.join(tid, hp=hp)
        serial.join(tid)
    states, uniforms = make_traffic(c, n, max(n_req, n_serial), seed=seed)
    req = lambda j: ServeRequest(ids[j % c], states[(j // c) % states.shape[0], j % c],
                                 uniforms[j])
    first = [req(j) for j in range(3 * b)]
    got, want = server.serve(first), cpu.serve(first)
    check(all(np.array_equal(x, y) for x, y in zip(got, want)),
          "sched-serve 256: assignments of the first 3 steps != the CPU run's")
    check(same_tree(torch, server._state, cpu._state),
          "sched-serve 256: slot state after 3 steps != the CPU run's")
    line(f"  sched-serve {c} tenants: the first 3 steps ({3 * b} requests) equal the CPU run bit "
         f"for bit (assignments, every slot leaf)")
    del cpu

    st0, ser0 = server.stats(), serial.stats()
    reset_launches()
    rate = max(saturated_throughput(server, ids, states, uniforms, n_req) for _ in range(2))
    serial_rate = max(saturated_throughput(serial, ids, states, uniforms, n_serial)
                      for _ in range(2))
    pipe_rate = max(pipelined_throughput(server, ids, states, uniforms, n_req) for _ in range(2))
    server.warm()
    lam = 0.8 * rate
    arrivals = np.cumsum(np.random.default_rng(seed).exponential(1.0 / lam, size=n_req))
    lat, wall, churn, depths = pipelined_poisson_episode(server, ids, states, uniforms, arrivals,
                                                         churn_stride=8)
    launches = read_launches()
    paths.append(launches)
    st1, ser1 = server.stats(), serial.stats()
    steps = st1["steps"] - st0["steps"] + ser1["steps"] - ser0["steps"]
    occupancy = (st1["served"] - st0["served"]) / max(st1["rows_dispatched"]
                                                      - st0["rows_dispatched"], 1)
    p50, p99, p999 = (float(x) * 1e3 for x in np.percentile(lat, [50, 99, 99.9]))
    check(launches["glr_step_tenants"] == steps and launches["glr_step"] == 0,
          f"sched-serve: glr_step_tenants launched {launches['glr_step_tenants']} times over "
          f"{steps} steps; glr_step {launches['glr_step']}")
    check(np.isfinite(lat).all() and (lat > 0).all(), "sched-serve: a latency is not positive")
    line(f"  sched-serve saturated: sync {rate:.1f} decisions/s, serial (slots=1) "
         f"{serial_rate:.1f} decisions/s, pipelined {pipe_rate:.1f} decisions/s (best of 2 "
         f"each; pipelined/sync {pipe_rate / rate:.3f}x, sync/serial {rate / serial_rate:.2f}x) "
         f"({b / rate * 1e3:.4f} ms/step)")
    line(f"  sched-serve Poisson load 80% ({lam:.1f} req/s): served {n_req} requests in "
         f"{wall:.3f} s ({n_req / wall:.1f} decisions/s), latency p50={p50:.3f} ms "
         f"p99={p99:.3f} ms p999={p999:.3f} ms, queue depth mean={depths.mean():.2f} "
         f"max={depths.max()}, batch_occupancy={occupancy:.3f}, churn_events={churn}, "
         f"sizes_used={st1['sizes_used']}")
    line(f"  sched-serve launches: glr_step_tenants {launches['glr_step_tenants']} over {steps} "
         f"steps, glr_step {launches['glr_step']}")

    # one steady step may not wait on the device
    pending = deque(enumerate(req(j) for j in range(b)))
    batch = server._take_batch(pending, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inflight = server._dispatch(batch, b, False)
    except RuntimeError as exc:
        raise SmokeFailure(f"sched-serve: a serve step synchronized with the device: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    server._retire(inflight)
    line("  sched-serve: a steady step ran under torch.cuda.set_sync_debug_mode('error') with "
         "no host sync ok")
    window = [req(j) for j in range(10 * b)]
    profile_window(torch, f"sched-serve {c}-tenant step (slot batch {b})",
                   lambda: server.serve(window), 10)

    # (c) 10^4 tenants, H = 64, unsharded
    c2, n_req2 = SCHED_BIG_CAPACITY, 8 * b
    sched2 = GLRCUCB(n, m, history=SCHED_BIG_H, detector_stride=5, split_grid="auto")
    big = SchedServer(sched2, capacity=c2, slots=b)
    big_cpu = SchedServer(sched2, capacity=c2, slots=b, device="cpu")
    for i in range(c2):
        big.join(i)
        big_cpu.join(i)
    rng = np.random.default_rng(seed + 3)
    states2 = (rng.random((4, c2, n)) < 0.6).astype(np.float32)
    uniforms2 = rng.random((n_req2, n)).astype(np.float32)
    reqs2 = [ServeRequest(j % c2, states2[(j // c2) % 4, j % c2], uniforms2[j]) for j in range(b)]
    reset_launches()
    got = big.serve(reqs2)
    want = big_cpu.serve(reqs2)
    check(all(np.array_equal(x, y) for x, y in zip(got, want))
          and same_tree(torch, big._state, big_cpu._state),
          "sched-serve 10^4: the first 64 requests != the CPU run")
    del big_cpu
    big_rate = saturated_throughput(big, list(range(c2)), states2, uniforms2, n_req2)
    paths.append(read_launches())
    check(paths[-1]["glr_step_tenants"] == big.stats()["steps"] and paths[-1]["glr_step"] == 0,
          f"sched-serve 10^4: launches {paths[-1]} over {big.stats()['steps']} steps")
    line(f"  sched-serve {c2} tenants (H={SCHED_BIG_H}, unsharded): the first {b} requests equal "
         f"the CPU run bit for bit; saturated {big_rate:.1f} decisions/s")
    del big

    # (d) run_served on phase 4's Fig. 3 setup
    S = fig3_setup(torch, seed)
    r = SCHED_FL_ROUNDS
    tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"])
    ref_state, ref_m = tr.run(tr.init(S["params"]), S["bx"][:r], S["by"][:r],
                              uniforms=S["uniforms"][:r])
    fl_server = SchedServer(S["sched"], capacity=4, slots=4, use_matching=True,
                            matcher_beta=S["cfg"].matcher_beta)
    fl_server.join("fig3")
    reset_launches()
    state, mets = tr.run_served(tr.init(S["params"]), S["bx"][:r], S["by"][:r], fl_server, "fig3",
                                uniforms=S["uniforms"][:r])
    paths.append(read_launches())
    check(paths[-1]["glr_step_tenants"] == fl_server.stats()["steps"] == r
          and paths[-1]["glr_step"] == 0,
          f"sched-serve fig3: launches {paths[-1]} over {fl_server.stats()['steps']} steps")
    for f in ref_state._fields:
        if f != "sched_state":
            check(same_tree(torch, getattr(ref_state, f), getattr(state, f)),
                  f"sched-serve fig3: run_served {f} != run()'s")
    check(same_tree(torch, ref_state.sched_state, fl_server.tenant_state("fig3").sched_state),
          "sched-serve fig3: the server's tenant state != run()'s sched_state")
    check(all(torch.equal(ref_m[k], mets[k]) for k in ref_m), "sched-serve fig3: metrics differ")
    line(f"  sched-serve fig3 run_served: {r} rounds (N={S['n']}, M={S['m']}, matching) equal "
         f"run() bit for bit (every state leaf, the server's tenant state, metrics); "
         f"glr_step_tenants launched {paths[-1]['glr_step_tenants']} times, once a step")
    del S
    launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
    return launches, dict(rate=rate, serial_rate=serial_rate, pipe_rate=pipe_rate, p50_ms=p50,
                          p99_ms=p99, p999_ms=p999, big_rate=big_rate)


# ---------------------------------------------------------------------------
# phase 9: the paper's baseline rows (Fig. 2a, Fig. 3/4)
# ---------------------------------------------------------------------------

def fig2a_policies(n, m, adversarial):
    """Fig. 2a's rows, (name, scheduler), as ``benchmarks/run.py:182-207``:
    nine on the piecewise env, six on the adversarial one (M-Exp3 with the
    Exp3.S sharing term there)."""
    from repro_torch.core.bandits import (GLRCUCB, AoIAware, ChannelAwareAsync, LyapunovSched,
                                          MExp3, RandomScheduler, RoundRobinScheduler)

    def glr(stride=5):
        return GLRCUCB(n, m, history=1024, detector_stride=stride)

    if not adversarial:
        return [("random", RandomScheduler(n, m)), ("round-robin", RoundRobinScheduler(n, m)),
                ("channel-aware", ChannelAwareAsync(n, m)), ("lyapunov", LyapunovSched(n, m)),
                ("glr-cucb", glr()), ("cucb-static", glr(10 ** 9)),
                ("aa-glr-cucb", AoIAware(glr())), ("m-exp3", MExp3(n, m, gamma=0.5)),
                ("aa-m-exp3", AoIAware(MExp3(n, m, gamma=0.5)))]
    return [("random", RandomScheduler(n, m)), ("channel-aware", ChannelAwareAsync(n, m)),
            ("lyapunov", LyapunovSched(n, m)),
            ("m-exp3", MExp3(n, m, gamma=0.5, share_alpha=1e-3)),
            ("aa-m-exp3", AoIAware(MExp3(n, m, gamma=0.5, share_alpha=1e-3))),
            ("glr-cucb", glr())]


def baseline_near_tie(torch, sched, state, t, u, aoi, rel=FORK_REL_TIE):
    """Whether round ``t``'s selection from ``state`` sits on a near-tie
    (``rel`` relative) where the card's and the CPU's ``log``/``exp`` may
    decide apart: channel-aware's perturbed scores, M-Exp3's draw against a
    CDF boundary, AoI-Aware's threshold (then its base's)."""
    from repro_torch.core.bandits import AoIAware, ChannelAwareAsync, MExp3

    def close(a, b):
        return abs(float(a) - float(b)) <= rel * max(abs(float(a)), abs(float(b)))

    if isinstance(sched, AoIAware):
        mu_hat = state.mu_sum / state.pulls.clamp_min(1.0)
        h_t = state.hp["threshold_scale"] / mu_hat.max().clamp_min(1e-6)
        return close(aoi.max(), h_t) or baseline_near_tie(torch, sched.base, state.base, t, u,
                                                          aoi, rel)
    if isinstance(sched, ChannelAwareAsync):
        g = -torch.log(-torch.log((u * (1.0 - 1e-12) + 1e-12).clamp_min(1e-12)))
        top = torch.sort(torch.log(sched._weights(state)) + g, descending=True).values
        return any(close(top[i], top[i + 1]) for i in range(sched.n_clients))
    if isinstance(sched, MExp3):
        cdf = torch.cumsum(sched._probs(state), 0)
        r = cdf[-1] * (1.0 - u[0])
        return bool(((cdf - r).abs() <= rel * r.abs()).any())
    return False


def fig2a_reference(torch, label, name, sched, env, u):
    """The first ``FIG2A_REF_ROUNDS`` rounds of a Fig. 2a row on the card
    (its route) against the CPU run on the same uniforms: schedule, AoI,
    regret and counters bit for bit; only a row whose draw goes through
    ``log``/``exp`` (``FORKING_ROWS``) may fork, and only at a near-tie, with
    everything equal before it.  Returns (what held, the card's output)."""
    from repro_torch.core.regret import policy_round, simulate_aoi_regret

    r = FIG2A_REF_ROUNDS
    card = simulate_aoi_regret(sched, env, r, uniforms=u[:r], return_state=True)
    cpu_env, cpu_u = env.to("cpu"), u[:r].cpu()
    cpu = simulate_aoi_regret(sched, cpu_env, r, uniforms=cpu_u, device="cpu")
    differ = (card["channels"].cpu() != cpu["channels"]).any(1).nonzero()
    if differ.numel() == 0:
        for k in ("regret", "aoi_pi", "aoi_star", "restarts", "exploit_rounds"):
            if k in cpu:
                check(torch.equal(card[k].cpu(), cpu[k]), f"{label}: card {k} != CPU {k}")
        return "equal the CPU run (schedule, AoI, regret, counters)", card
    t0 = int(differ[0])
    check(name in FORKING_ROWS, f"{label}: the card's schedule forks from the CPU run's at "
          f"round {t0}; only a draw through log/exp may fork")
    check(torch.equal(card["regret"][:t0].cpu(), cpu["regret"][:t0]),
          f"{label}: the regret differs before the fork at round {t0}")
    state, aoi = sched.init("cpu"), torch.ones(sched.n_clients)
    for t in range(t0):
        state, aoi, _, _ = policy_round(sched, state, aoi, t, cpu_u[t, 1],
                                        cpu_env.sample(t, cpu_u[t, 0]))
    check(baseline_near_tie(torch, sched, state, t0, cpu_u[t0, 1], aoi),
          f"{label}: the schedule forks at round {t0} without a near-tie "
          f"({FORK_REL_TIE} relative)")
    return (f"equal the CPU run up to round {t0}, where they fork at a near-tie within "
            f"{FORK_REL_TIE} relative"), card


def fig2a_rows(torch, seed):
    """Phase 9 (a): Fig. 2a's fifteen rows at N = 5, M = 2.  The rows the
    scan takes run at the paper's T; the others the per-round route at
    ``FIG2A_ROUNDS_CUT`` on envs realized at that horizon.  Returns the
    launches of the timed runs and, by row label, the run at the cut (its
    env, uniforms, output and ms a round) for phase 10."""
    from repro_torch.core.bandits import GLRCUCB, AoIAware
    from repro_torch.core.bandits.base import init_with_hp
    from repro_torch.core.channels import random_adversarial_env, random_piecewise_env
    from repro_torch.core.regret import (regret_growth_exponent, simulate_aoi_regret,
                                         sublinearity_index)
    from repro_torch.kernels.regret_scan import refusal

    n, m, cut = 5, 2, FIG2A_ROUNDS_CUT
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    envs = {}
    for horizon in (FIG2_ROUNDS, cut):
        envs["piecewise", horizon] = random_piecewise_env(gen, n, horizon, 5)
        envs["adversarial", horizon] = random_adversarial_env(gen, n, horizon, flip_prob=0.002)
    line(f"  fig2a cut: the rows regret_scan does not take run the per-round route at T={cut} "
         f"of the paper's {FIG2_ROUNDS}, on envs realized at T={cut} (piecewise: 5 breakpoints; "
         f"adversarial: flip_prob 0.002 a round): that route is host-bound at ~1-2 ms a round, "
         f"12 x {FIG2_ROUNDS} rounds would take ~6 min")
    counted, refs = [], {}
    for kind in ("piecewise", "adversarial"):
        for name, sched in fig2a_policies(n, m, kind == "adversarial"):
            u_full = torch.rand((FIG2_ROUNDS, 2, n), generator=gen, device="cuda")
            why = refusal(sched, envs[kind, FIG2_ROUNDS], init_with_hp(sched, "cuda", None),
                          u_full)
            rounds = FIG2_ROUNDS if why is None else cut
            env, u = envs[kind, rounds], u_full[:rounds].contiguous()
            label = f"fig2a {kind}/{name}"
            how, card_ref = fig2a_reference(torch, label, name, sched, env, u)
            reset_launches()
            out, secs = timed_run(torch, lambda: simulate_aoi_regret(sched, env, rounds,
                                                                    uniforms=u))
            counted.append(read_launches())
            route = "scan" if why is None else "rounds"
            check(counted[-1]["regret_scan"] == (why is None),
                  f"{label}: regret_scan launched {counted[-1]['regret_scan']} times on the "
                  f"{route} route")
            detect = (isinstance(sched, AoIAware) and isinstance(sched.base, GLRCUCB))
            check(counted[-1]["glr_step"] == (rounds // 5 if detect else 0),
                  f"{label}: glr_step launched {counted[-1]['glr_step']} times")
            check(torch.equal(out["channels"][:FIG2A_REF_ROUNDS], card_ref["channels"]),
                  f"{label}: the timed run's first rounds differ from the reference run's")
            regret = out["regret"]
            check(regret.shape == (rounds,) and bool(torch.isfinite(regret).all()),
                  f"{label}: regret not finite")
            counters = " ".join(f"{k}={int(out[k])}" for k in ("restarts", "exploit_rounds")
                                if k in out)
            line(f"  {label}: route={route} T={rounds} final_regret="
                 f"{float(out['final_regret']):.1f} sublinearity_index="
                 f"{float(sublinearity_index(regret)):.4f} growth_exp="
                 f"{regret_growth_exponent(regret):.4f} ({secs / rounds * 1e3:.6f} ms/round) "
                 f"{counters}; its first {FIG2A_REF_ROUNDS} rounds {how}")
            if why is None:
                # the same policy at the cut, for comparing with the per-round rows
                at_cut = simulate_aoi_regret(sched, envs[kind, cut], cut,
                                             uniforms=u_full[:cut].contiguous())
                line(f"    {label} at the cut: T={cut} final_regret="
                     f"{float(at_cut['final_regret']):.1f} restarts={int(at_cut['restarts'])}")
            else:
                at_cut = out
                line(f"    {label}: the scan does not take it ({why})")
            refs[label] = dict(env=envs[kind, cut], u=u_full[:cut].contiguous(), out=at_cut,
                               ms_round=secs / rounds * 1e3, route=route)
            if (kind, name) == ("adversarial", "m-exp3"):
                profile_window(torch, f"{label} rounds route", lambda: simulate_aoi_regret(
                    sched, env, 200, uniforms=u[:200], collect_curve=False), 200)
    return {k: sum(p[k] for p in counted) for k in COUNTERS}, refs


def fig34_rows(torch, seed):
    """Phase 9 (b): the Fig. 3/4 baseline rows (``benchmarks/run.py:744-786``),
    ``FIG3_ROUNDS`` rounds and one seed a row: random, channel-aware and
    Lyapunov on phase 4's N = 30, M = 20 problem; those and M-Exp3 with and
    without matching on the adversarial N = 6, M = 4 problem.  Returns the
    launches of the timed runs."""
    import dataclasses

    import numpy as np

    from repro_torch.core.bandits import ChannelAwareAsync, LyapunovSched, MExp3, RandomScheduler
    from repro_torch.fl import AsyncFLTrainer

    line(f"  fig3/4 cut: one seed a row, {FIG3_ROUNDS} rounds (the JAX benchmark runs 8 seeds "
         f"through the batched FL engine, which the port does not have yet)")
    counted = []
    for kind in ("piecewise", "adversarial"):
        S = (fig3_setup(torch, seed) if kind == "piecewise"
             else fig3_setup(torch, seed, n=6, m=4, adversarial=True))
        n, m, rounds = S["n"], S["m"], S["rounds"]
        rows = [("random", RandomScheduler(n, m), False),
                ("channel-aware", ChannelAwareAsync(n, m), False),
                ("lyapunov", LyapunovSched(n, m), False)]
        if kind == "adversarial":
            rows += [("m-exp3", MExp3(n, m, share_alpha=1e-3), False),
                     ("m-exp3+aware", MExp3(n, m, share_alpha=1e-3), True)]
        for name, sched, match in rows:
            label = f"fig3 {kind}/{name}"
            R = dict(S, sched=sched, cfg=dataclasses.replace(S["cfg"], use_matching=match,
                                                             use_zeta=match))
            fig3_reference(torch, R, label)
            tr = AsyncFLTrainer(R["cfg"], sched, R["env"], R["loss_fn"])
            reset_launches()
            (state, mets), secs = timed_run(torch, lambda: tr.run(
                tr.init(R["params"]), R["bx"], R["by"], uniforms=R["uniforms"]))
            counted.append(read_launches())
            check(counted[-1]["weighted_aggregate"] == rounds and counted[-1]["glr_step"] == 0,
                  f"{label}: launches {counted[-1]}, expected weighted_aggregate {rounds} times")
            acc = R["accuracy"](state)
            var = float(mets["aoi_var"].sum())
            check(bool(torch.isfinite(mets["local_loss"]).all()) and np.isfinite(acc)
                  and np.isfinite(var), f"{label}: loss, accuracy or AoI variance not finite")
            line(f"  {label}: N={n} M={m} matching={match} rounds={rounds} test_acc={acc:.4f} "
                 f"cum_aoi_var={var:.2f} seconds/round={secs / rounds:.6f} "
                 f"weighted_aggregate.launches={counted[-1]['weighted_aggregate']}")
            if name == "m-exp3+aware":     # from round 0: the table ends at round 150
                profile_window(torch, label, lambda: tr.run(
                    tr.init(R["params"]), R["bx"][:10], R["by"][:10],
                    uniforms=R["uniforms"][:10]), 10)
        del S
    return {k: sum(p[k] for p in counted) for k in COUNTERS}


def baselines(torch, seed):
    """Phase 9: the paper's baseline rows on the card.  Returns the launches
    of the timed runs (every kernel of the slice must show one) and Fig.
    2a's runs at the cut, by row."""
    t0 = time.perf_counter()
    fig2a_launches, refs = fig2a_rows(torch, seed)
    paths = (fig2a_launches, fig34_rows(torch, seed))
    launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
    check(all(launches[k] > 0 for k in ("regret_scan", "glr_step", "weighted_aggregate")),
          f"phase 9: a kernel of the slice never launched: {launches}")
    line(f"  phase 9 launches: regret_scan {launches['regret_scan']}, glr_step "
         f"{launches['glr_step']}, weighted_aggregate {launches['weighted_aggregate']}; "
         f"wall {time.perf_counter() - t0:.1f} s")
    return launches, refs


# ---------------------------------------------------------------------------
# phase 10: the batched engine at the figures' sizes
# ---------------------------------------------------------------------------

def run_of(out, i):
    """Run ``i`` of a batched result: its tensors and final state."""
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: x[i] if hasattr(x, "dim") and x.dim() else x, out)


def same_run(torch, got, want, label, rounds=None):
    """Every output of two runs bit for bit (the variance sums too), the
    final policy state where both have it; with ``rounds`` only the first
    rounds of the schedule and the curves."""
    keys = [k for k, v in want.items() if hasattr(v, "dim") and k in got]
    if rounds is not None:
        keys = [k for k in ("channels", "regret", "cum_aoi_var") if k in want]
    for k in keys:
        a, b = got[k], want[k]
        if rounds is not None:
            a, b = a[:rounds], b[:rounds]
        check(torch.equal(a, b), f"{label}: {k} differs")
    if rounds is None and "final_sched_state" in want and "final_sched_state" in got:
        for f in want["final_sched_state"]._fields:
            a, b = getattr(got["final_sched_state"], f), getattr(want["final_sched_state"], f)
            if hasattr(b, "dim"):
                check(torch.equal(a, b), f"{label}: final state {f} differs")


def batched_engine(torch, seed, chain_us, fig2a_refs):
    """Phase 10: the batched engine (``repro_torch.sim``) driven as the JAX
    benchmark's figures drive theirs (``benchmarks/run.py``), every batch
    against its serial runs.  Returns the launches of the batched runs (the
    serial comparisons excluded) and the kernels line's batch fields."""
    import math

    from repro_torch.core.bandits import GLRCUCB, MExp3
    from repro_torch.core.channels import (random_adversarial_env, random_piecewise_env,
                                           stack_envs)
    from repro_torch.core.regret import simulate_aoi_regret
    from repro_torch.kernels.regret_scan import occupancy, regret_scan
    from repro_torch.sim import SweepCase, simulate_aoi_regret_batch, sweep

    t_start = time.perf_counter()
    n, m, T = 5, 2, FIG2_ROUNDS
    sched = GLRCUCB(n, m, history=1024, detector_stride=5)
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    counted = []

    def counted_run(fn):
        reset_launches()
        out, secs = timed_run(torch, fn)
        counted.append(read_launches())
        return out, secs, counted[-1]

    def serial(s, env, rounds, u):
        return timed_run(torch, lambda: simulate_aoi_regret(s, env, rounds, uniforms=u,
                                                            return_state=True))

    # (a) fig2c on the scan route's policy: 24 seeds, each its own env and uniforms
    b = FIG2C_SEEDS
    envs = [random_piecewise_env(gen, n, T, 5) for _ in range(b)]
    u = torch.rand((b, T, 2, n), generator=gen, device="cuda")
    out, secs, got = counted_run(lambda: simulate_aoi_regret_batch(
        sched, stack_envs(envs), T, uniforms=u, return_state=True))
    check(out["route"] == "scan" and got["regret_scan"] == 1 and got["glr_step"] == 0,
          f"phase 10 (a): route {out['route']}, launches {got}; expected one regret_scan")
    serial_s = 0.0
    for i in range(b):
        want, s_i = serial(sched, envs[i], T, u[i])
        serial_s += s_i
        same_run(torch, run_of(out, i), want, f"phase 10 (a) seed {i}")
    fig2c = dict(b=b, ms=secs * 1e3, serial_ms=serial_s * 1e3)
    line(f"  (a) fig2c glr-cucb: {b} seeds x T={T} in one regret_scan launch, "
         f"{secs * 1e3:.3f} ms ({secs * 1e3 / (b * T):.3e} ms a run-round) against {b} "
         f"single-run launches {serial_s * 1e3:.3f} ms ({serial_s / secs:.1f}x); restarts "
         f"{out['restarts'].tolist()}; each run equals its single-run scan bit for bit ok")

    # (b) hp_grid: the 16-point gamma x delta grid as one sweep bucket
    env = random_piecewise_env(gen, n, T, 5)
    cases = [SweepCase(f"g{g}/d{d}", sched.replace_traced(gamma=g, delta=d), env, seed, T)
             for g in HP_GAMMAS for d in HP_DELTAS]
    (results, report), secs, got = counted_run(lambda: sweep(cases, collect_curve=False))
    check(len(report) == 1 and report[0].route == "scan" and got["regret_scan"] == 1,
          f"phase 10 (b): {len(report)} buckets, launches {got}; expected one regret_scan")
    for c in cases:
        want = simulate_aoi_regret(c.scheduler, env, T, uniforms=c.draw_uniforms("cuda"),
                                   collect_curve=False)
        same_run(torch, results[c.name], want, f"phase 10 (b) {c.name}")
    best = min(cases, key=lambda c: float(results[c.name]["final_regret"]))
    line(f"  (b) hp_grid: {len(cases)} points gamma x delta, T={T}, one bucket, one regret_scan "
         f"launch, {secs * 1e3:.3f} ms (bucket wall {report[0].wall_s * 1e3:.3f} ms, kernels "
         f"built {report[0].compile_s:.3f} s); best {best.name} regret "
         f"{float(results[best.name]['final_regret']):.0f}; every point equals its serial run ok")

    # (c) the fill of the card: B runs on one shared env
    occ = occupancy(sched, table=False)
    in_flight = occ * torch.cuda.get_device_properties(0).multi_processor_count
    u_all = torch.rand((max(FILL_BATCHES), T, 2, n), generator=gen, device="cuda")
    fill = []
    for bb in FILL_BATCHES:
        ub = u_all[:bb]
        out, secs, got = counted_run(lambda: simulate_aoi_regret_batch(
            sched, env, T, uniforms=ub, env_axis=None, collect_curve=False))
        check(out["route"] == "scan" and got["regret_scan"] == 1,
              f"phase 10 (c) B={bb}: launches {got}")
        splits = int(regret_scan.splits.sum())
        for i in sorted({0, bb - 1}):
            want, _ = serial(sched, env, T, ub[i])
            for k in ("final_regret", "final_cum_aoi_var", "restarts", "aoi_pi"):
                check(torch.equal(out[k][i], want[k]), f"phase 10 (c) B={bb} run {i}: {k}")
        nbytes = bb * (T * 2 * n * 4 + T * m * 8 + 2 * (n * 1024 * 4 + 4 * n * 4 + 8) + 4 * 4)
        bound, bound_by = two_way_bound(nbytes, KL_SPLIT_FLOPS * splits, F32_FLOPS)
        chain = math.ceil(bb / in_flight) * T * chain_us / 1e3
        fill.append(dict(b=bb, ms=secs * 1e3, ms_per_run_round=secs * 1e3 / (bb * T),
                         bound_ms=bound, bound_by=bound_by, chain_ms=chain, splits=splits))
        line(f"  (c) fill B={bb}: {secs * 1e3:.3f} ms a launch, {secs * 1e3 / (bb * T):.3e} ms a "
             f"run-round; bound {bound:.3e} ms ({bound_by}: {splits} splits), latency chain "
             f"ceil({bb}/{in_flight}) x {T} x {chain_us:.3f} us = {chain:.3f} ms; runs 0 and "
             f"{bb - 1} equal their single-run scans ok")
    line(f"  (c) occupancy: {occ} block(s) of {1024} threads an SM for N={n}, H=1024 "
         f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), {in_flight} in flight: a batch past "
         f"{in_flight} runs in waves")
    del u_all

    # (d) fig2c for M-Exp3 on the batched per-round route
    cut, m_ms = FIG2A_ROUNDS_CUT, {}
    for nn in (4, 5, 6, 7):
        s = MExp3(nn, m, gamma=0.5)
        envs = [random_adversarial_env(gen, nn, cut, flip_prob=0.002) for _ in range(b)]
        u = torch.rand((cut, 2, nn), generator=gen, device="cuda")      # one stream, as JAX's
        out, secs, got = counted_run(lambda: simulate_aoi_regret_batch(
            s, stack_envs(envs), cut, uniforms=u, uniforms_axis=None))
        check(out["route"] == "rounds" and got["regret_scan"] == 0,
              f"phase 10 (d) N={nn}: route {out['route']}")
        for i in (0, b - 1):
            want, _ = serial(s, envs[i], FIG2A_REF_ROUNDS, u[:FIG2A_REF_ROUNDS])
            same_run(torch, run_of(out, i), want, f"phase 10 (d) N={nn} seed {i}",
                     rounds=FIG2A_REF_ROUNDS)
        m_ms[nn] = secs * 1e3 / cut
        line(f"  (d) fig2c m-exp3 N={nn} |C|={s.n_super_arms}: {b} seeds x T={cut} (cut) on the "
             f"batched per-round route, {m_ms[nn]:.4f} ms a round for the batch; regret "
             f"{float(out['final_regret'].mean()):.0f} +- {float(out['final_regret'].std()):.0f}; "
             f"seeds 0 and {b - 1} equal their serial runs over {FIG2A_REF_ROUNDS} rounds ok")
    line(f"  (d) against phase 9's serial m-exp3 rows (N=5, M=2, T={cut}, one run): piecewise "
         f"{fig2a_refs['fig2a piecewise/m-exp3']['ms_round']:.4f}, adversarial (share 1e-3) "
         f"{fig2a_refs['fig2a adversarial/m-exp3']['ms_round']:.4f} ms a round")

    # (e) fig2a as one sweep: fifteen rows x 4 seeds at the cut; seed 0 is phase 9's run
    cases = []
    for label, ref_row in fig2a_refs.items():
        kind, name = label.split(" ")[1].split("/")
        s = dict(fig2a_policies(n, m, kind == "adversarial"))[name]
        cases.append(SweepCase(f"{label}#0", s, ref_row["env"], 0, cut, uniforms=ref_row["u"]))
        for j in range(1, FIG2A_SEEDS):
            e = (random_piecewise_env(gen, n, cut, 5) if kind == "piecewise"
                 else random_adversarial_env(gen, n, cut, flip_prob=0.002))
            cases.append(SweepCase(f"{label}#{j}", s, e, seed * 100 + j, cut))
    (results, report), secs, got = counted_run(lambda: sweep(cases))
    for label, ref_row in fig2a_refs.items():
        want = ref_row["out"]
        got_row = results[f"{label}#0"]
        for k in ("channels", "regret", "aoi_pi", "aoi_star", "restarts", "exploit_rounds"):
            if k in want:
                check(torch.equal(got_row[k], want[k]), f"phase 10 (e) {label}: {k} differs "
                      "from phase 9's run")
    for r in report:
        line(f"  (e) bucket {r.names[0].rsplit('#', 1)[0]}: {r.batch} cases, route {r.route}, "
             f"wall {r.wall_s * 1e3:.1f} ms ({r.wall_s * 1e3 / cut:.4f} ms a round)")
    check(len(report) == 15 and got["regret_scan"] == 3,
          f"phase 10 (e): {len(report)} buckets, launches {got}")
    line(f"  (e) fig2a sweep: {len(cases)} cases in {len(report)} buckets, {secs:.1f} s; "
         f"launches regret_scan {got['regret_scan']}, glr_step {got['glr_step']}; every row's "
         f"seed 0 equals phase 9's run ok")

    # (f) a recompute-detector bucket of 8 seeds on the scan
    rec = GLRCUCB(n, m, history=1024, detector_stride=5, detector_impl="recompute")
    cases = [SweepCase(f"r{i}", rec, random_piecewise_env(gen, n, T, 5), seed * 100 + 50 + i, T)
             for i in range(RECOMPUTE_SEEDS)]
    (results, report), secs, got = counted_run(lambda: sweep(cases))
    check(len(report) == 1 and report[0].route == "scan" and got["regret_scan"] == 1
          and got["glr_scan"] == 0, f"phase 10 (f): launches {got}")
    for c in cases:
        want, _ = serial(rec, c.env, T, c.draw_uniforms("cuda"))
        same_run(torch, results[c.name], {k: v for k, v in want.items()
                                          if k != "final_sched_state"}, f"phase 10 (f) {c.name}")
    line(f"  (f) recompute bucket: {len(cases)} seeds x T={T}, one regret_scan launch, "
         f"{secs * 1e3:.3f} ms; each run equals its serial run ok")

    # (g) sweep(shard=True) on the one card equals sweep(), an uneven bucket of 5
    cases = [SweepCase(f"s{i}", sched.replace_traced(delta=d), env, seed + i, cut)
             for i, d in enumerate((1e-4, 1e-3, 1e-2, 5e-2, 1e-1))]
    plain, _ = sweep(cases)
    (sharded, report), _, got = counted_run(lambda: sweep(cases, shard=True))
    check(report[0].sharded and report[0].batch == SHARD_BATCH, "phase 10 (g): not sharded")
    for c in cases:
        same_run(torch, sharded[c.name], plain[c.name], f"phase 10 (g) {c.name}")
    line(f"  (g) sweep(shard=True) on a 1-device mesh: a bucket of {SHARD_BATCH} equals sweep() "
         f"bit for bit ok")

    launches = {k: sum(c[k] for c in counted) for k in COUNTERS}
    check(launches["regret_scan"] > 0 and launches["glr_step"] > 0,
          f"phase 10: a kernel of the slice never launched: {launches}")
    line(f"  phase 10 launches: regret_scan {launches['regret_scan']}, glr_step "
         f"{launches['glr_step']}; wall {time.perf_counter() - t_start:.1f} s")
    return launches, dict(fig2c=fig2c, fill=fill, occupancy=occ, in_flight=in_flight,
                          chain_us=chain_us, mexp3_ms_per_round=m_ms,
                          launches=launches["regret_scan"])


def kernel_line(launches, glr_err, glr_t, wa_err, wa_t, rt_err, rt_t, gs_err, gs_t, fa_err,
                fa_t, fig2_scan, recompute_scan, gst_err, gst_t, batch_scan):
    """The entries of the kernels line: launches from the paths, the rest
    from phase 2; ``glr_step`` and ``glr_scan`` also carry their scan route
    (``regret_scan``, one launch a Fig. 2 run) from phases 3 and 6, and
    ``glr_step`` the scan's batch form (phase 10's launches, phase 2's error
    against the batched per-round loop, the fill of the card)."""
    def entry(name, replaces, err, t, source=None, **extra):
        source = source or f"src/repro_torch/kernels/csrc/{name}.cu"
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches[name], max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t.get("library_ms"), **extra)

    at = lambda t, shape: dict(shape_r_b_n_h=shape, **{k: t[k] for k in (
        "ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "splits", "detecting_rows")
        + (("old_ms",) if "old_ms" in t else ())})
    serve = gst_t["serve"]
    return [
        entry("glr_step", "src/repro/kernels/glr_step.py:163", glr_err, glr_t["fig2"],
              batch_scan=batch_scan, **fig2_scan),
        entry("glr_step_tenants", "src/repro/kernels/glr_step.py:210", gst_err, serve,
              shape_r_b_n_h=[257, 64, 16, 256], device_ms=serve["device_ms"],
              detecting_rows=serve["detecting_rows"], splits=serve["splits"],
              host_split_us=serve["host_split_us"],
              full=at(gst_t["full"], [256, 256, 16, 1024]),
              big=at(gst_t["big"], [10001, 64, 16, 64])),
        entry("weighted_aggregate", "src/repro/kernels/weighted_aggregate.py:47", wa_err,
              wa_t["fig3"], shape=[20, 5674], turns_ms=wa_t["fig3"]["turns_ms"],
              library_turns_ms=wa_t["fig3"]["library_turns_ms"],
              device_ms=wa_t["fig3"]["device_ms"],
              library_device_ms=wa_t["fig3"]["library_device_ms"],
              host_split_us=wa_t["fig3"]["host_split_us"],
              large=dict(shape=[64, 2 ** 24], **wa_t["large"]),
              large_ragged=dict(shape=[64, 2 ** 24 + 2], **wa_t["large_ragged"])),
        entry("robust_trimmed", "src/repro/kernels/robust_agg.py:73", rt_err, rt_t["fig3"],
              shape=[20, 5674], turns_ms=rt_t["fig3"]["turns_ms"],
              library_turns_ms=rt_t["fig3"]["library_turns_ms"],
              device_ms=rt_t["fig3"]["device_ms"],
              library_device_ms=rt_t["fig3"]["library_device_ms"],
              host_split_us=rt_t["fig3"]["host_split_us"],
              large=dict(shape=[64, 2 ** 22 + 3], **rt_t["large"])),
        entry("glr_scan", "src/repro/kernels/glr_scan.py:70", gs_err, gs_t["fig2"],
              **recompute_scan),
        entry("flash_attention", "src/repro/kernels/flash_attention.py:123", fa_err,
              fa_t["model"], source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
              shape_b_hq_hkv_s_d=[4, 64, 8, SERVE_PROMPT, 128], causal=True,
              dtype="bfloat16", tc_launches=launches["flash_attention_tc"],
              fma_launches=launches["flash_attention_fma"],
              fma_source="src/repro_torch/kernels/csrc/flash_attention.cu",
              fma_ms=fa_t["model"]["fma_ms"], tc_ms_again=fa_t["model"]["ms_again"],
              f32_ms=fa_t["model_f32"]["ms"],
              f32_plain_ms=fa_t["model_f32"]["plain_ms"],
              f32_library_ms=fa_t["model_f32"]["library_ms"],
              f32_bound_ms=fa_t["model_f32"]["bound_ms"], jax_test_shapes=fa_t["jax_shapes"]),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", action="store_true",
                    help="build the kernels and run the paths (phases 3-10) only")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch package beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # full-f32 products on the card, so the CPU references compare like with like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    try:
        line("[1] card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        line(f"  python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        reports = _build.build(_build.KERNELS + _build.PROBES)
        line(f"  built {sorted(reports) or 'nothing (current builds present)'} "
             f"in {time.perf_counter() - t0:.1f} s")
        for name, rep in sorted(reports.items()):
            for ln in rep.strip().splitlines():
                if any(w in ln for w in ("registers", "spill", "arning", "C75",
                                         "Performance Loss")):
                    line(f"    {name}: {ln.strip()}")

        if not args.paths:
            line("[2] kernels against their plain versions on the card")
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            floor_ms, _ = launch_floor(torch)
            glr_err, glr_t = check_glr_step(torch, gen, floor_ms)
            # its own generator: the checks after it keep the draws they had before it
            gst_gen = torch.Generator(device="cuda").manual_seed(args.seed + 17)
            gst_err, gst_t = check_glr_step_tenants(torch, gst_gen, floor_ms)
            wa_err, wa_t = check_weighted_aggregate(torch, gen, floor_ms)
            rt_err, rt_t = check_robust_trimmed(torch, gen, floor_ms)
            gs_err, gs_t = check_glr_scan(torch, gen, floor_ms)
            check_regret_scan(torch, args.seed)
            batch_err = check_regret_scan_batch(torch, args.seed)
            fa_err, fa_t = check_flash_attention(torch, gen, floor_ms)
            # the checks' gigabytes go back to the driver before the timed paths
            peak = torch.cuda.max_memory_reserved() / 2 ** 30
            release(torch)
            line(f"  released the checks' memory: {peak:.2f} GiB reserved at peak, "
                 f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB now")

        line("[3] Fig. 2 AoI-regret path")
        fig2_launches, f2 = fig2(torch, args.seed)
        line("[4] Fig. 3 asynchronous-FL path")
        S = fig3_setup(torch, args.seed)
        fig3_launches, clean_acc = fig3(torch, S)
        line("[5] Fig. 3 path under Byzantine faults, robust aggregation")
        robust_launches = fig3_robust(torch, S, args.seed, clean_acc)
        line("[6] Fig. 2 path, recompute detector")
        recompute_launches, recompute_scan = fig2_recompute(torch, f2)
        fig2_scan, chain_us = f2["scan"], f2["chain_us"]
        del f2, S
        release(torch)
        line("[7] serving path: qwen3-32b prefill and greedy decode")
        serve_reference(torch, args.seed)
        serve_launches, _ = serve_path(torch, args.seed, SERVE_LAYERS)
        line("[8] the multi-tenant scheduler service")
        sched_launches, _ = sched_serve(torch, args.seed)
        line("[9] the paper's baseline rows: Fig. 2a and Fig. 3/4")
        baseline_launches, fig2a_refs = baselines(torch, args.seed)
        line("[10] the batched engine: fig2c, hp_grid, the card's fill, fig2a as one sweep")
        batch_launches, batch_fields = batched_engine(torch, args.seed, chain_us, fig2a_refs)
        paths = (fig2_launches, fig3_launches, robust_launches, recompute_launches,
                 serve_launches, sched_launches, baseline_launches, batch_launches)
        launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
        check(all(launches[k] > 0 for k in KERNEL_NAMES + ("flash_attention_tc",)),
              f"a kernel never launched: {launches}")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1

    line(f"  launches on the main paths: {launches}")
    line(f"  total seconds {time.perf_counter() - t_start:.1f}")
    line(smi)
    if not args.paths:
        line(json.dumps({"kernels": kernel_line(launches, glr_err, glr_t, wa_err, wa_t, rt_err,
                                                rt_t, gs_err, gs_t, fa_err, fa_t, fig2_scan,
                                                recompute_scan, gst_err, gst_t,
                                                dict(batch_fields, max_abs_err=batch_err))}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
