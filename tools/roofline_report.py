"""The dry run's table: one row per record of ``repro_torch.launch.dryrun``.

Twin of ``benchmarks/roofline_report.py``, for the port's records (the
card's constants: NVIDIA H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s; no
collective term is counted, so its column is "-").

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --out DIR
    python tools/roofline_report.py --dir DIR          # markdown
    python tools/roofline_report.py --dir DIR --csv    # CSV

Memory in GiB: the step's peak as the walker counts it (the whole step,
not divided over the mesh) and, on a card shape, whether it fits the
card's 80 GiB; on JAX's shapes, each device's parameters and AdamW
moments under the record's layout.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

COLUMNS = ("arch", "layers", "shape", "mesh", "variant", "status", "peak GiB", "fits",
           "params+adamw GiB/dev",
           "t_comp s", "t_mem s", "t_mem(flash) s", "t_coll s", "bottleneck", "6ND/FLOPs",
           "MFU bound", "kernels")


def fmt_gib(b):
    return "-" if b is None else f"{b / 2 ** 30:.2f}"


def fmt_t(t):
    if t is None:
        return "-"
    return f"{t:.2f}" if t >= 0.01 else f"{t:.2e}"


def load(dir_):
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def variant(r):
    parts = []
    if r.get("layout", "tp") != "tp":
        parts.append(r["layout"])
    if r.get("microbatch", 1) > 1:
        parts.append(f"mb{r['microbatch']}")
    if r.get("ce_chunk"):
        parts.append(f"ce{r['ce_chunk']}")
    if r.get("remat", "full") != "full":
        parts.append(f"remat-{r['remat']}")
    return "+".join(parts) or "baseline"


def row(r):
    head = [r["arch"], r.get("n_layers", "-"), r["shape"], r["mesh"], variant(r)]
    if r["status"] != "ok":
        why = r.get("reason") or r.get("error") or ""
        return head + [f"{r['status']}:{why[:40]}"] + ["-"] * (len(COLUMNS) - 6)
    rf, mem = r["roofline"], r["memory"]
    ratio, mfu = rf.get("useful_flop_ratio"), rf.get("mfu_bound")
    kernels = ";".join(f"{k}={v}" for k, v in sorted(r.get("kernel_launches", {}).items()))
    return head + [
        "ok", fmt_gib(mem["peak_bytes"]), str(mem["fits"]) if "fits" in mem else "-",
        fmt_gib(sum(mem["per_device"].values())) if "per_device" in mem else "-",
        fmt_t(rf["t_compute_s"]), fmt_t(rf["t_memory_s"]), fmt_t(rf.get("t_memory_flash_s")),
        fmt_t(rf.get("t_collective_s")), rf["bottleneck"],
        f"{ratio:.2f}" if ratio else "-", f"{mfu:.3f}" if mfu else "-", kernels or "-",
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = [row(r) for r in load(args.dir)]
    if args.csv:
        print(",".join(c.replace(" ", "_") for c in COLUMNS))
        for line in rows:
            print(",".join(str(x) for x in line))
        return 0
    print("| " + " | ".join(COLUMNS) + " |")
    print("|" + "---|" * len(COLUMNS))
    for line in rows:
        print("| " + " | ".join(str(x) for x in line) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
