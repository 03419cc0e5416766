#!/usr/bin/env python3
"""Time the ``glr_scan`` kernel of two checkouts in turns on one card,
A B B A, and print its device time a call side by side.

    python3 tools/glr_scan_ab.py A_DIR B_DIR

A_DIR and B_DIR each hold a checkout (e.g. ``git archive`` of two commits
unpacked into a git-ignored directory).  Each turn is a process of its
own that imports ``repro_torch`` from that checkout's ``src``, so it builds
and loads that checkout's ``csrc/glr_scan.cu``.  At each shape (N rows,
H slots; full windows of {0, 1} rewards, phase 2's timing inputs) a turn
measures the device time a call (the kernel intervals of a
``torch.profiler`` trace of 200 back-to-back calls, over 200) and the
call time back to back (CUDA events over 2000 calls, host included).
The table gives each turn's numbers, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((5, 1024), (30, 256), (1000, 1000))


def turn(src: str) -> None:
    """One checkout's times, printed as one JSON line."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    from chip_smoke import device_ms, time_ms
    from repro_torch.kernels.glr_scan import glr_scan

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n, h in SHAPES:
        hist = torch.randint(0, 2, (n, h), generator=gen, device="cuda").to(torch.float32)
        counts = torch.full((n,), h, dtype=torch.int32, device="cuda")
        call = lambda: glr_scan(hist, counts)
        out[f"{n}x{h}"] = dict(device_ms=device_ms(torch, call, 200),
                               ms=time_ms(torch, call, 2000))
    print(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        turn(args.turn)
        return 0
    if not (args.a and args.b):
        ap.error("give A_DIR and B_DIR")
    results = []
    for label, d in (("A1", args.a), ("B1", args.b), ("B2", args.b), ("A2", args.a)):
        src = str((Path(d) / "src").resolve())
        run = subprocess.run([sys.executable, __file__, "--turn", src], capture_output=True,
                             text=True)
        if run.returncode != 0:
            print(f"{label} ({d}) failed:\n{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
            return 1
        results.append((label, json.loads(run.stdout.strip().splitlines()[-1])))
    print("glr_scan device ms / call ms a call back to back, turns " +
          " ".join(label for label, _ in results))
    fmt = lambda v: "not measured" if v is None else f"{v:.5f}"
    for shape in (f"{n}x{h}" for n, h in SHAPES):
        cells = [f"{label} {fmt(r[shape]['device_ms'])} / {r[shape]['ms']:.5f}"
                 for label, r in results]
        print(f"  ({shape.replace('x', ', ')}): " + "; ".join(cells))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
