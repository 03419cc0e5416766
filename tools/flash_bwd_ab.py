#!/usr/bin/env python3
"""Time the attention backward kernels of two source trees on one card, in
turns A B B A, at the five training shapes.

    python3 tools/flash_bwd_ab.py PARENT_DIR [--out FILE]

B is this checkout's ``flash_attention_bwd``; A is PARENT_DIR's
``csrc/flash_attention_bwd.cu`` (e.g. ``git archive`` of the parent commit
unpacked into a git-ignored directory), built by PARENT_DIR's own
``kernels/_build.py`` and launched through this tree's ``_launch_bwd`` (the
same C entry, this tree's scratch).  Every turn is ``chip_smoke.py``'s
``attention_bwd_at`` on the same seeded inputs, so both trees pass the
smoke's card check (logsumexp, f32 plain version, two calls bitwise, the
chunked route) and are timed beside SDPA's backward and the bound.  Prints
the card's name and power limit, the smoke's line for each turn and a table
of the kernel's ms a call; writes the turns' entries as JSON to ``--out``
(default ``build/flash_bwd_ab.json``, git-ignored).  Needs the card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (model, (B, Hq, Hkv, S, D), causal, window) of each training step's attention
SHAPES = [
    ("qwen1.5-0.5b", (8, 16, 16, 2048, 64), True, 0),
    ("hubert-xlarge", (8, 16, 16, 2048, 80), False, 0),
    ("recurrentgemma-2b", (8, 10, 1, 2048, 256), True, 2048),
    ("phi-3-vision-4.2b", (8, 32, 32, 2192, 96), True, 0),
    ("dbrx-132b", (8, 48, 8, 2048, 128), True, 0),
]


def parent_kernel(parent: Path):
    """PARENT_DIR's backward kernels, called as ``flash_attention_bwd``."""
    from repro_torch.kernels import flash_attention as fa

    path = parent / "src" / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("parent_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    fn = build.load("flash_attention_bwd", "flash_attention_bwd_launch", fa._BWD_ARGTYPES)
    return lambda q, k, v, out, lse, do, causal, window, scale: fa._launch_bwd(
        fn, q, k, v, out, lse, do, causal, window, scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "flash_bwd_ab.json")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    kernels = {"A": parent_kernel(args.parent.resolve()), "B": None}
    rows = []
    for i, (name, shape, causal, window) in enumerate(SHAPES):
        turns = [(tree, chip_smoke.attention_bwd_at(torch, 1000 + i, shape, causal, window,
                                                    f"{tree} {name}", kernel=kernels[tree]))
                 for tree in "ABBA"]
        rows.append(dict(name=name, turns=[dict(tree=tree, **t) for tree, t in turns]))
    print("model | A ms | B ms | B ms | A ms | B/A (best of each) | SDPA backward ms | bound ms")
    for row in rows:
        ms = {tree: [t["ms"] for t in row["turns"] if t["tree"] == tree] for tree in "AB"}
        t = row["turns"]
        print(f"{row['name']} | " + " | ".join(f"{x['ms']:.4f}" for x in t)
              + f" | {min(ms['B']) / min(ms['A']):.3f} | "
              + " / ".join(f"{x['library_ms']:.4f}" for x in t) + f" | {t[0]['bound_ms']:.4f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
