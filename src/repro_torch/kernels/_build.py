"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exports one plain C launch function; it is
compiled by ``nvcc`` into its own shared library and loaded with
``ctypes`` (pointers and the stream pass as ``c_void_p``).  Builds happen
at first use, from the sources in this package only, into
``<repo>/build/repro_torch/`` (listed in ``.gitignore``).  The library's
file name carries a hash of its source, the shared headers of ``csrc/``
(``*.cuh``) and the flags, so an edited kernel is rebuilt and a stale one
is never loaded.  A failed build raises.

The launch path is the host cost of every kernel call: ``load`` hands back
a cached function whose ``argtypes`` were set once, when its library was
loaded, and ``stream`` reads PyTorch's current stream as a raw pointer
without building a ``torch.cuda.Stream`` object.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("glr_step", "weighted_aggregate", "robust_trimmed", "glr_scan", "flash_attention",
           "flash_attention_tc", "regret_scan", "glr_step_tenants")
PROBES = ("launch_floor",)     # measurement only: an empty kernel's launch floor
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}      # by symbol: loaded, argtypes set


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        f"repro_torch kernels: nvcc not found on PATH or at {DEFAULT_NVCC}; "
        "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives (hash of source, headers
    and flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that has no current build, all ``nvcc``
    processes started together.  Returns ``{name: compiler output}`` (the
    ``-Xptxas -v`` register/shared-memory report) for the ones built."""
    t0 = time.perf_counter()
    names = list(names)
    for name in names:
        if name not in KERNELS + PROBES:
            raise ValueError(f"unknown kernel {name!r}; known: {KERNELS + PROBES}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs: List[tuple] = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    reports, failures = {}, []
    for name, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            os.unlink(tmp)
            continue
        os.replace(tmp, target)
        reports[name] = out
    if jobs:
        build.seconds += time.perf_counter() - t0
    if failures:
        raise RuntimeError("repro_torch kernel build failed:\n" + "\n".join(failures))
    return reports


build.seconds = 0.0   # wall seconds spent compiling in this process


def load(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C launch function ``symbol`` of kernel ``name``, ready to call.
    The first call builds the library if needed, loads it and sets the
    function's ``argtypes`` and ``restype``; every later call returns the
    same function from a cache.  Every launch function returns the
    ``cudaGetLastError()`` code after its launch (0 = success)."""
    fn = _FNS.get(symbol)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def stream(device_index: int) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on CUDA device
    ``device_index``, as an int: the stream a ``torch.cuda.stream(s)``
    context has set, else the default stream, read afresh on every call."""
    return torch._C._cuda_getCurrentRawStream(device_index)
