"""CUDA kernel wrapper: the scheduler service's streaming GLR detector step,
over the tenant slots, in place.

Replaces the Pallas TPU kernel ``glr_step_tenants`` of
``src/repro/kernels/glr_step.py:183`` (``pallas_call`` at ``:210``): per
(tenant, channel) row, the masked append into the prefix ring and the sup
of the two-sided Bernoulli-KL GLR statistic.  Source:
``csrc/glr_step_tenants.cu``; semantics of record:
``ref.glr_step_tenants``.

What bounds it on the H100, and the design: the JAX serve step gathers
the named tenants' rings, runs the functional kernel and scatters them
back, so a step moves the rings some six times and evaluates every row.
Here the rings stay in the server's slot tensors and the kernel updates
them in place, by slot index (one float a scheduled channel), reads a
ring only on its tenant's detection round, and never touches a row that
is not live; on detecting rows the split term's special functions, not
bytes, set the floor.  One warp per row, 16-byte loads, a warp-shuffle
max (see the source's note).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.glr_step import full_window_splits
from repro_torch.utils.roofline import MUFU_RATE, KernelCost

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"glr_step_tenants: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"glr_step_tenants: {name} has dtype {x.dtype}, the kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"glr_step_tenants: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"glr_step_tenants: {name} must be contiguous")


def _checked(cum, total, base, slots, live, detect, counts, r_vec, sched, split_grid):
    """The wrapper's checks: raises on what the kernel does not take, else
    returns (R, N, H, B)."""
    if split_grid not in ("all", "geometric"):
        raise ValueError(f"glr_step_tenants: unknown split_grid {split_grid!r}")
    if not cum.is_cuda:
        raise ValueError(f"glr_step_tenants: the kernel takes CUDA tensors, got {cum.device}")
    if cum.dim() != 3 or counts.dim() != 2:
        raise ValueError(f"glr_step_tenants: cum must be (R, N, H) and counts (B, N), got "
                         f"{tuple(cum.shape)} and {tuple(counts.shape)}")
    dev = cum.device
    n_slots, n_chan, h = cum.shape
    b = counts.shape[0]
    _check("cum", cum, torch.float32, cum.shape, dev)
    _check("total", total, torch.float32, (n_slots, n_chan), dev)
    _check("base", base, torch.float32, (n_slots, n_chan), dev)
    _check("slots", slots, torch.int32, (b,), dev)
    _check("live", live, torch.bool, (b,), dev)
    _check("detect", detect, torch.bool, (b,), dev)
    _check("counts", counts, torch.int32, (b, n_chan), dev)
    _check("r_vec", r_vec, torch.float32, (b, n_chan), dev)
    _check("sched", sched, torch.bool, (b, n_chan), dev)
    if b == 0 or n_chan == 0 or h == 0 or n_slots == 0 or b * n_chan >= 2**31:
        raise ValueError(f"glr_step_tenants: unsupported shape {tuple(cum.shape)}, B={b}")
    return n_slots, n_chan, h, b


def glr_step_tenants(cum, total, base, slots, live, detect, counts, r_vec, sched,
                     split_grid: str = "all"):
    """Launch the kernel on CUDA tensors.  The slot state ``cum`` (R, N, H),
    ``total``/``base`` (R, N) f32 is updated in place for the rows
    ``slots`` (B,) int32 where ``live`` (B,) bool; ``detect`` (B,) bool
    marks the rows whose statistic is evaluated; ``counts`` (B, N) int32
    (before the append), ``r_vec`` (B, N) f32, ``sched`` (B, N) bool.
    Live slots must be unique.  Returns ``stats`` (B, N) f32, -inf where a
    row does not detect or n < 2."""
    n_slots, n_chan, h, b = _checked(cum, total, base, slots, live, detect, counts, r_vec,
                                     sched, split_grid)
    fn = _build.load("glr_step_tenants", "glr_step_tenants_launch", _ARGTYPES)
    stats = counts.new_empty((b, n_chan), dtype=torch.float32)
    err = fn(cum.data_ptr(), total.data_ptr(), base.data_ptr(), slots.data_ptr(),
             live.data_ptr(), detect.data_ptr(), counts.data_ptr(), r_vec.data_ptr(),
             sched.data_ptr(), stats.data_ptr(), b, n_chan, n_slots, h,
             int(split_grid == "geometric"), _build.stream(cum.get_device()))
    if err != 0:
        raise RuntimeError(f"glr_step_tenants: kernel launch failed (cudaError {err})")
    glr_step_tenants.launches += 1
    return stats


glr_step_tenants.launches = 0
# the split term's special-function (MUFU) instructions, counted once in its sm_90a SASS
# (csrc/glr_kl.cuh); the card's MUFU rate is utils/roofline.py's
SPLIT_MUFU = 8


def cost(n_chan: int, h: int, b: int, detecting=None, live=None, splits=None,
         geometric: bool = False) -> KernelCost:
    """One step's work over ``b`` rows of ``n_chan`` rings of ``h``, in
    place: the ``detecting`` rows' rings read once, every ``live`` row's
    total, base, count, reward and flag (17 bytes a channel), 6 bytes a row
    of slot and flags; the split term's MUFU instructions (``SPLIT_MUFU``
    a split, which outweighs its 32 FMA-pipe flops) at ``MUFU_RATE``.
    ``None`` counts every row live and detecting with a full window (the
    most: what a step on meta tensors is charged)."""
    detecting = b if detecting is None else detecting
    live = b if live is None else live
    if splits is None:
        splits = detecting * n_chan * full_window_splits(h, geometric)
    nbytes = detecting * n_chan * h * 4 + live * n_chan * (16 + 1) + b * 6
    return KernelCost(SPLIT_MUFU * splits, nbytes, MUFU_RATE)


def meta(cum, total, base, slots, live, detect, counts, r_vec, sched):
    """The kernel's output on meta tensors: the (B, N) f32 statistics (the
    slot state it updates in place has no values on meta)."""
    return counts.new_empty(counts.shape, dtype=torch.float32)
