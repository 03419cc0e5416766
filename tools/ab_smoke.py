#!/usr/bin/env python3
"""Run ``chip_smoke.py`` from two checkouts in turns on one card, A B B A,
and print each path's time a round side by side.

    python3 tools/ab_smoke.py A_DIR B_DIR [--out DIR] [--paths]

A_DIR and B_DIR each hold a checkout (e.g. ``git archive`` of two commits
unpacked into a git-ignored directory).  Each run builds its own kernels
from its own sources and must exit 0; its whole output goes to
``DIR/<label>.log`` (default ``build/ab``, git-ignored).  The table lists, for
every path both runs report, the milliseconds a round (host clock around a
run that ends in a synchronize), then each run's total seconds; below it,
for every phase-2 kernel time line both runs print ("<kernel> time <shape>:
kernel X ms, ..., library (<call>) Y ms"), the kernel's and the library
call's milliseconds a call back to back, so two checkouts' kernels are
compared on one card, each beside the library call of its own run.

``--paths`` passes ``--paths`` to both smokes, which then run their Fig. 2
and Fig. 3 paths only, none of the kernel checks before them; both
checkouts must know the flag.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

# chip_smoke.py's path lines: "  fig2 scan route: T=20000 ... (0.0020 ms/round)" and
# "  fig3 ...: ... seconds/round=0.0152"; a run that yields none is an error
_MS = re.compile(r"^  ((?:fig[23]|sched-serve)[^:]*): .*\((\d+\.\d+) ms/(?:round|step)\)")
_S = re.compile(r"^  (fig3[^:]*): .*seconds/round=(\d+\.\d+)")
_TOTAL = re.compile(r"^  total seconds (\d+\.\d+)")
# phase 2's "  weighted_aggregate time fig3 (20, 5674) f32: kernel 0.0228 ms, ..."
_KERNEL = re.compile(r"^  (\w+ time [^:]*): kernel (\d+\.\d+) ms")
_LIBRARY = re.compile(r"library \([^)]*\) (\d+\.\d+) ms")


def parse(text):
    """{path: ms a round}, the total seconds and {kernel time line: ms a
    call} of one smoke run."""
    rows, total, kernels = {}, None, {}
    for ln in text.splitlines():
        if m := _MS.match(ln):
            rows[m.group(1)] = float(m.group(2))
        elif m := _S.match(ln):
            rows[m.group(1)] = float(m.group(2)) * 1e3
        elif m := _TOTAL.match(ln):
            total = float(m.group(1))
        elif m := _KERNEL.match(ln):
            kernels[m.group(1)] = float(m.group(2))
            if lib := _LIBRARY.search(ln):
                kernels[m.group(1) + ", library"] = float(lib.group(1))
    return rows, total, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default="build/ab")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args(argv)
    cmd = [sys.executable, "chip_smoke.py"] + (["--paths"] if args.paths else [])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    order = [("A1", args.a), ("B1", args.b), ("B2", args.b), ("A2", args.a)]
    results = {}
    for label, tree in order:
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
        (out / f"{label}.log").write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        lines = proc.stdout.strip().splitlines()
        print(f"{label} ({tree}): exit {proc.returncode}; last line {lines[-1] if lines else ''}",
              flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        results[label] = parse(proc.stdout)
        if not results[label][0]:
            print(f"{label}: no path times in the smoke's output (see {out / label}.log)",
                  file=sys.stderr)
            return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("card:", card)
    paths = [p for p in results["A1"][0] if all(p in r[0] for r in results.values())]
    print("path | " + " | ".join(f"{lb} ms/round" for lb, _ in order))
    for p in paths:
        print(f"{p} | " + " | ".join(f"{results[lb][0][p]:.3f}" for lb, _ in order))
    print("B only | " + ", ".join(sorted(set(results["B1"][0]) - set(paths))))
    print("total seconds | " + " | ".join(f"{results[lb][1]}" for lb, _ in order))
    lines = [k for k in results["A1"][2] if all(k in r[2] for r in results.values())]
    if lines:
        print("kernel | " + " | ".join(f"{lb} ms a call" for lb, _ in order))
        for k in lines:
            print(f"{k} | " + " | ".join(f"{results[lb][2][k]:.4f}" for lb, _ in order))
    return 0


if __name__ == "__main__":
    sys.exit(main())
