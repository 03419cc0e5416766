"""Checkpointing of nested state: an npz payload and a JSON manifest.

Takes the port's state pytrees, nested ``NamedTuple``s and dicts of
tensors, and flattens them with '/'-joined paths (a field name, a dict
key); dicts go in sorted key order.  Writes are atomic (a temporary file,
then ``os.replace``), so an interrupted save never corrupts the latest
checkpoint.  bf16 leaves are widened to f32 on disk (lossless; npz has no
bf16).  Twin of ``repro/checkpoint/io.py``.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in a fixed order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(path or "_root", tree)]
    out = []
    for name, sub in items:
        out.extend(_leaves(sub, f"{path}/{name}" if path else name))
    return out


def _rebuild(like: Any, arrays: Dict[str, np.ndarray], path: str = "") -> Any:
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(getattr(like, f), arrays, f"{path}/{f}" if path else f)
                            for f in like._fields])
    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, f"{path}/{k}" if path else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, arrays, f"{path}/{i}" if path else str(i))
                          for i, x in enumerate(like))
    arr = arrays[path or "_root"]
    if isinstance(like, torch.Tensor):
        # torch.tensor copies: the restored leaf owns fresh memory with the
        # exact dtype and device of `like`
        return torch.tensor(arr, device=like.device).to(like.dtype)
    return arr


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)            # lossless widening; npz-portable
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``step_{step}.npz`` plus ``step_{step}.json``
    (paths, dtypes) in ``directory``; returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _leaves(tree)}
    path = os.path.join(directory, f"step_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    manifest = {"step": step, "keys": sorted(flat),
                "dtypes": {k: str(v.dtype) for k, v in flat.items()}}
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(directory, f"step_{step}.json"))
    return path


def restore_checkpoint(directory: str, step: Optional[int] = None, like: Any = None):
    """Load a checkpoint (the latest when ``step`` is None).  Without
    ``like``, returns ``({path: np.ndarray}, step)``; with it, the arrays
    rebuilt into ``like``'s structure, each tensor leaf with the dtype and
    device of its counterpart in ``like``.  Raises ``FileNotFoundError``
    when the directory holds no checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, f"step_{step}.npz")) as data:
        flat = {k: data[k] for k in data.files}
    if like is None:
        return flat, step
    return _rebuild(like, flat), step


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory) if (m := _STEP_RE.search(f))]
    return max(steps) if steps else None
