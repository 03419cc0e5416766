"""Input shapes of the production steps, as meta tensors with their specs.

Twin of ``repro/launch/specs.py``.  JAX's four shapes (the assignment
matrix's columns), which assume a multi-device mesh:

    train_4k      seq=4096    global_batch=256   train step
    prefill_32k   seq=32768   global_batch=32    prefill (forward, last-token
                                                 logits; the encoder forward
                                                 for hubert)
    decode_32k    seq=32768   global_batch=128   serve step (1 token, full KV)
    long_500k     seq=524288  global_batch=1     serve step (1 token; ring or
                                                 recurrent state)

and the four shapes ``chip_smoke.py`` runs on one card, each the card's
(the dry run holds itself against the card's measurements at them):

    card_train    seq=2048    global_batch=8     the training step of phases
                                                 14 and 18 (launch/train.py)
    card_train_s1024 seq=1024 global_batch=4     phase 18's deepseek-v2
                                                 training step (2 layers; one
                                                 sequence a client)
    card_prefill  seq=2048    global_batch=4     the prefill of phases 7, 16, 17
    card_decode   seq=2048    global_batch=8     a decode step of their serve
                                                 loop (context 2048)

A training shape carries the FL half of its step (``FLSetup``): JAX's
shapes JAX's dry run's (16 clients, 32 channels, GLR-CUCB's history 256
and detector stride 8), the card's the launcher's (``launch/train.py``).

``batch_specs``, ``cache_specs`` and ``decode_token_specs`` return meta
tensors (no storage) paired with their specs on a mesh description.
Full-attention archs serve long_500k through the sliding-window ring cache
(window 4096); hubert-xlarge is encoder-only and skips the decode shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train
from repro_torch.launch.shardings import batch_pspec
from repro_torch.models.model import Model

LONG_CTX_WINDOW = 4096  # ring-cache window for full-attention archs at 500k


class FLSetup(NamedTuple):
    """The FL half of a training step: clients, channels, and GLR-CUCB's
    ring length and detector stride."""
    clients: int
    channels: int
    history: int
    detector_stride: int


POD_FL = FLSetup(16, 32, 256, 8)   # JAX's dry run: the data-parallel groups of one pod
LAUNCHER_FL = FLSetup(train.CLIENTS, train.CHANNELS, train.SCHED_HISTORY, train.DETECTOR_STRIDE)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode
    fl: FLSetup = POD_FL   # a training step's FL half


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# the card's shapes: chip_smoke.py's training steps, prefill and decode step
CARD_SHAPES: Dict[str, ShapeSpec] = {
    "card_train": ShapeSpec("card_train", 2048, 8, "train", LAUNCHER_FL),
    "card_train_s1024": ShapeSpec("card_train_s1024", 1024, 4, "train", LAUNCHER_FL),
    "card_prefill": ShapeSpec("card_prefill", 2048, 4, "prefill"),
    "card_decode": ShapeSpec("card_decode", 2048, 8, "decode"),
}

ALL_SHAPES: Dict[str, ShapeSpec] = {**SHAPES, **CARD_SHAPES}


class Sharded(NamedTuple):
    """A meta tensor and its spec (a tuple of mesh-axis entries)."""
    value: torch.Tensor
    spec: Tuple[object, ...]


def supported(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    shape = ALL_SHAPES[shape_name]
    if shape.mode == "decode" and cfg.is_encoder:
        return False, "encoder-only: no autoregressive decode step"
    return True, ""


def serve_window(cfg: ModelConfig, shape_name: str) -> int:
    """Ring window used for this (arch, shape): 0 = full cache."""
    if shape_name != "long_500k":
        return 0
    if cfg.arch_type in ("ssm",):
        return 0                       # no attention cache at all
    if cfg.local_attn_window:
        return 0                       # hybrid: its own local window applies
    return LONG_CTX_WINDOW             # dense/MoE/VLM: sliding-window serve


def _meta(shape, dtype, spec) -> Sharded:
    return Sharded(torch.empty(shape, dtype=dtype, device="meta"), tuple(spec))


def _data_size(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, layout: str = "tp"
                ) -> Dict[str, Sharded]:
    """Meta tensors and specs for one forward/train batch."""
    bp = batch_pspec(mesh, layout)
    b, s = shape.global_batch, shape.seq_len
    bspec = bp if b % _data_size(mesh) == 0 else ()
    if cfg.arch_type == "audio":
        frame_tail = (None, "model") if layout == "tp" else (None, None)
        return {
            "frames": _meta((b, s, cfg.d_model), torch.bfloat16, bspec + frame_tail),
            "labels": _meta((b, s), torch.int32, bspec + (None,)),
            "mask": _meta((b, s), torch.bool, bspec + (None,)),
        }
    out = {"tokens": _meta((b, s), torch.int32, bspec + (None,))}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = _meta((b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16,
                                     bspec + (None, None))
    return out


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

_CACHE_RULES = {
    # key-name -> logical axes per rank (batch axis resolved separately)
    "k": {5: (None, "batch", None, "seq", None), 4: ("batch", None, "seq", None)},
    "v": {5: (None, "batch", None, "seq", None), 4: ("batch", None, "seq", None)},
    "latent": {4: (None, "batch", "seq", None), 3: ("batch", "seq", None)},
    "k_rope": {4: (None, "batch", "seq", None), 3: ("batch", "seq", None)},
    "ssm_state": {5: (None, "batch", "model_dim", None, None), 4: ("batch", "model_dim", None, None)},
    "conv_x": {4: (None, "batch", None, "model_dim"), 3: ("batch", None, "model_dim")},
    "conv_b": {4: (None, "batch", None, None), 3: ("batch", None, None)},
    "conv_c": {4: (None, "batch", None, None), 3: ("batch", None, None)},
    "conv": {4: (None, "batch", None, "model_dim"), 3: ("batch", None, "model_dim")},
    "h": {3: (None, "batch", "model_dim"), 2: ("batch", "model_dim")},
    "pos": {0: ()},
}

_LOGICAL_CACHE = {"seq": "model", "model_dim": "model"}


def cache_pspec(key: str, shape: Tuple[int, ...], mesh) -> Tuple[object, ...]:
    """Spec of one cache entry.  KV sequence -> 'model' (distributed
    flash-decode); recurrent state channels -> 'model'; batch -> data axes;
    any non-dividing axis degrades to replication."""
    base = key.split("/")[-1]
    logical = _CACHE_RULES.get(base, {}).get(len(shape))
    if logical is None:
        return ()
    bp = batch_pspec(mesh)
    out, used = [], set()
    for dim, name in zip(shape, logical):
        if name == "batch":
            axes = bp[0] if isinstance(bp[0], tuple) else (bp[0],)
            total = 1
            for a in axes:
                total *= mesh.shape[a]
            if dim % total == 0 and not used.intersection(axes):
                out.append(bp[0])
                used.update(axes)
            else:
                out.append(None)
        elif name in _LOGICAL_CACHE:
            axis = _LOGICAL_CACHE[name]
            if axis not in used and dim % mesh.shape[axis] == 0:
                out.append(axis)
                used.add(axis)
            else:
                out.append(None)
        else:
            out.append(None)
    return tuple(out)


def cache_specs(model: Model, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """The serve cache at this shape as meta tensors (``init_cache`` on the
    meta device: nothing is allocated), each with its spec."""
    window = serve_window(model.cfg, shape.name)
    cache = model.init_cache(shape.global_batch, shape.seq_len, window=window, device="meta")
    out: Dict[str, Any] = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = {kk: Sharded(vv, cache_pspec(kk, tuple(vv.shape), mesh))
                      for kk, vv in v.items()}
        else:
            out[k] = Sharded(v, cache_pspec(k, tuple(v.shape), mesh))
    return out


def decode_token_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Sharded:
    bp = batch_pspec(mesh)
    b = shape.global_batch
    bspec = bp if b % _data_size(mesh) == 0 else ()
    return _meta((b,), torch.int32, bspec)


def values(tree):
    """The meta tensors of a tree of ``Sharded`` (dicts kept)."""
    if isinstance(tree, Sharded):
        return tree.value
    return {k: values(v) for k, v in tree.items()}
