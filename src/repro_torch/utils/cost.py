"""FLOPs, bytes, live memory and kernel launches of one step, counted as it runs.

Twin of ``repro/utils/jaxpr_cost.py`` (renamed: the port has no jaxpr).
``CostWalker`` is a ``TorchDispatchMode`` under which the step runs
eagerly, on meta tensors (nothing is allocated or computed) or on real
ones.  Every ATen op the step dispatches, its backward's and a
checkpoint's recompute included, passes through it once, so loops are
counted as they run: there is no trip count to multiply and no dynamic
``while`` to flag.  The accounting is JAX's:

  * ``mm``, ``bmm``, ``addmm``, ``baddbmm``: 2 * batch * M * N * K flops;
    their operands and result in ``bytes``, ``bytes_fused`` and
    ``dot_bytes``, and the score/probability traffic in
    ``attn_score_bytes`` by the (M, N, K) rule of ``_attn_score_bytes``;
  * ``convolution``: 2 * output elements * the kernel's spatial size times
    its input channels;
  * the ops that materialize (gathers, scatters, index ops, sorts, top-k,
    concatenation, cumulative sums, padding): ``bytes_fused``;
  * views, reshapes, casts, copies and factories: ``bytes`` only;
  * everything else: one flop an output element, in ``transcendentals``
    too for the exponentials, logarithms, roots and the like.

``bytes`` is the un-fused upper bound (every op's I/O); ``bytes_fused``
counts only what must reach memory, the roofline's memory term.

A kernel of the port is counted where ``kernels/ops.py`` dispatches it
on meta and CPU tensors, with the kernel's own count (its wrapper's
``cost``: operations, bytes, one launch): on meta that is all that runs;
on the CPU the plain version runs in the kernel's place and its ops are
not counted.  So a step counts the launches the card would make, and the
same flops on meta as on real CPU tensors.  A CUDA call goes straight to
its kernel, uncounted: the walker is for the host.

The walker also tracks live memory: each storage the step creates counts,
rounded up to the caching allocator's 512-byte block, from the op that
makes it until a weakref finalizer on the storage sees it freed; the
arguments' storages count from the start.  ``peak_bytes`` is the most
held at the end of an op; allocations inside a single op (a library's
workspace) are not seen.  The per-op counts stand in for
``repro/utils/hlo.py``'s ``count_ops``.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

BLOCK = 512          # the CUDA caching allocator rounds every block up to this
_MIB = 1 << 20
SMALL_SIZE = _MIB    # requests up to this take the small pool's 2 MiB segments

_TRANSCENDENTAL = {
    "exp", "log", "log1p", "expm1", "tanh", "sigmoid", "erf", "erfc", "sin", "cos", "pow",
    "rsqrt", "sqrt", "exp2", "log2", "_softmax", "_log_softmax", "logsumexp", "silu",
    "gelu", "softplus",
}

_DOTS = {"mm", "bmm", "addmm", "baddbmm"}

_CONVS = {"convolution", "convolution_backward"}

# data movement that materializes (cannot fuse into a consumer)
_MATERIALIZING = {
    "index_select", "index_add", "index_copy", "index", "index_put", "_index_put_impl",
    "gather", "scatter", "scatter_add", "scatter_reduce", "sort", "argsort", "topk", "cat",
    "stack", "cumsum", "cumprod", "cummax", "logcumsumexp", "constant_pad_nd", "pad",
    "embedding", "embedding_dense_backward", "masked_scatter", "take", "slice_scatter",
    "select_scatter", "as_strided_scatter", "roll", "flip", "repeat", "index_fill",
    "nonzero", "unique", "searchsorted",
}

# casts, copies and factories: bytes only (views are found from the schema)
_FREE = {
    "_to_copy", "clone", "copy", "_copy_from", "contiguous", "empty", "new_empty",
    "empty_strided", "new_empty_strided", "empty_like", "zeros", "zeros_like", "new_zeros",
    "ones", "ones_like", "new_ones", "full", "full_like", "new_full", "fill", "zero",
    "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy", "detach",
    "_local_scalar_dense", "resize", "set",
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0          # un-fused upper bound: every op's I/O
    bytes_fused: float = 0.0    # only materialization points (dots, convs, gathers,
                                # scatters, sorts, kernels): the roofline memory term
    dot_bytes: float = 0.0      # the part of bytes_fused from dots
    attn_score_bytes: float = 0.0  # score/probs traffic (``_attn_score_bytes``): what
                                   # a flash kernel keeps on chip

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.transcendentals += o.transcendentals
        self.bytes += o.bytes
        self.bytes_fused += o.bytes_fused
        self.dot_bytes += o.dot_bytes
        self.attn_score_bytes += o.attn_score_bytes
        return self

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _tensors(tree):
    return [x for x in _pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _op_tensors(*parts):
    """The tensors of an op's arguments or results: tensors, and lists or
    tuples of them, one level deep (what an ATen schema takes)."""
    out = []
    for part in parts:
        for x in part:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _block(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def storages(tree) -> Dict[int, int]:
    """{storage id: bytes} of ``tree``'s tensors (meta tensors included),
    each storage once."""
    return {id(s): s.nbytes() for s in (t.untyped_storage() for t in _tensors(tree))}


def storage_bytes(tree, rounded: bool = True) -> int:
    """The bytes of ``tree``'s tensors' storages, each counted once and, if
    ``rounded``, rounded up to the allocator's block."""
    return sum(_block(n) if rounded else n for n in storages(tree).values())


def allocated_bytes(sizes, free=()) -> int:
    """What the CUDA caching allocator's ``memory_allocated`` counts for
    allocations of ``sizes`` bytes made in this order, none freed, from an
    allocator whose cached free blocks are ``free`` ((bytes, small pool)
    pairs, as ``torch.cuda.memory_snapshot`` lists them; none: an emptied
    allocator): each request rounded up to 512 bytes takes the smallest
    free block of its pool that fits, else a new segment (2 MiB for
    requests up to 1 MiB; 20 MiB up to 10 MiB; above, rounded up to 2 MiB),
    and the block is split only where the remainder is at least 512 bytes
    (small pool) or more than 1 MiB (large pool): otherwise the request is
    handed, and counted as, the whole block."""
    pools = {True: [], False: []}     # the pools' free blocks by size (small pool: True)
    for n, small in free:
        pools[bool(small)].append(n)
    for pool in pools.values():
        pool.sort()
    total = 0
    for n in sizes:
        if n <= 0:
            continue
        r = max(BLOCK, _block(n))
        small = r <= SMALL_SIZE
        pool = pools[small]
        i = bisect.bisect_left(pool, r)
        if i < len(pool):
            blk = pool.pop(i)
        elif small:
            blk = 2 * _MIB
        else:
            blk = 20 * _MIB if r < 10 * _MIB else -(-r // (2 * _MIB)) * 2 * _MIB
        rest = blk - r
        if rest >= BLOCK if small else rest > SMALL_SIZE:
            bisect.insort(pool, rest)
            total += r
        else:
            total += blk
    return total


def _prod(xs) -> float:
    out = 1.0
    for x in xs:
        out *= x
    return out


def _dot_mnk(name: str, args):
    """(batch, M, N, K) of a dot, and its two operands."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    if a.dim() == 3:
        return a.shape[0], a.shape[1], b.shape[2], a.shape[2], a, b
    return 1, a.shape[0], b.shape[1], a.shape[1], a, b


def _attn_score_bytes(m: float, n: float, k: float, lhs: torch.Tensor,
                      out: torch.Tensor) -> float:
    """Bytes of score/probs tensors touched by this dot, else 0.

    Over (M, N, K) of the contraction:
      * score dot  q @ k^T : K <= 256 (head dim), M >= 512, N >= 512
        -> the OUTPUT is the score matrix
      * pv dot  probs @ v  : K >= 512 (kv length), M >= 512, N <= 256
        -> the LHS operand is the probs matrix
    Weight matmuls never match (their contraction dim is d_model/d_ff with
    a small free dim, or the other way round)."""
    if k <= 256 and m >= 512 and n >= 512:
        return _nbytes(out)
    if k >= 512 and m >= 512 and n <= 256:
        return _nbytes(lhs)
    return 0.0


def _conv_flops(args, outs) -> float:
    """2 * output elements * (kernel spatial size x input channels a group);
    the backward counts one such product for each gradient it makes."""
    if len(outs) == 1:                   # convolution(input, weight, ...)
        return 2.0 * outs[0].numel() * _prod(args[1].shape[1:])
    grad_out, weight, mask = args[0], args[2], args[-1]   # (grad_output, input, weight, ...)
    return 2.0 * grad_out.numel() * _prod(weight.shape[1:]) * sum(bool(x) for x in mask[:2])


@functools.lru_cache(maxsize=None)
def _kind(func) -> str:
    """How an ATen op is counted: dot, conv, materializing, free or
    elementwise (transcendental or not)."""
    name = func.overloadpacket.__name__.rstrip("_")
    if name in _DOTS:
        return "dot"
    if name in _CONVS:
        return "conv"
    if name in _MATERIALIZING:
        return "materializing"
    if func.is_view or name in _FREE:
        return "free"
    return "transcendental" if name in _TRANSCENDENTAL else "elementwise"


def _op_cost(func, args, kwargs, outs) -> Cost:
    kind = _kind(func)
    ins = _op_tensors(args, kwargs.values())
    io = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    if kind == "dot":
        batch, m, n, k, lhs, _ = _dot_mnk(func.overloadpacket.__name__.rstrip("_"), args)
        return Cost(flops=2.0 * batch * m * n * k, bytes=io, bytes_fused=io, dot_bytes=io,
                    attn_score_bytes=_attn_score_bytes(m, n, k, lhs, outs[0]))
    if kind == "conv":
        return Cost(flops=_conv_flops(args, outs), bytes=io, bytes_fused=io)
    if kind == "materializing":
        return Cost(bytes=io, bytes_fused=io)
    if kind == "free":
        return Cost(bytes=io)
    elems = float(sum(t.numel() for t in outs))
    return Cost(flops=elems, bytes=io,
                transcendentals=elems if kind == "transcendental" else 0.0)


class CostWalker(TorchDispatchMode):
    """Counts what runs under it: ``cost`` (a ``Cost``), ``op_counts`` (ATen
    op -> calls), ``kernel_launches`` and ``kernel_cost`` (the port's
    kernels, by name) and live memory (``argument_bytes``, ``peak_bytes``,
    ``live_bytes``).  Use ``trace`` or ``step_cost``; ``track`` registers a
    step's arguments before it runs."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.op_counts: Dict[Any, int] = collections.Counter()   # by ATen op packet
        self.kernel_launches: Dict[str, int] = collections.Counter()
        self.kernel_cost: Dict[str, Cost] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._live: Dict[int, tuple] = {}    # storage id -> (bytes, weakref to it)
        self._quiet = 0

    # ------------------------------------------------------------- memory
    def _freed(self, key: int):
        self.live_bytes -= self._live.pop(key, (0,))[0]

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` as live (once each) until they
        are freed; returns the bytes added."""
        added = 0
        for t in tensors:
            s = t.untyped_storage()
            key = id(s)
            if key in self._live:
                continue
            n = _block(s.nbytes())
            self._live[key] = (n, weakref.ref(s, lambda _, key=key: self._freed(key)))
            added += n
        self.live_bytes += added
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    # ------------------------------------------------------------- kernels
    @contextlib.contextmanager
    def kernel(self, name: str, kcost):
        """One launch of the port's kernel ``name`` with its ``KernelCost``;
        the ops run inside (the plain version on the CPU) are not counted."""
        c = Cost(flops=kcost.ops, bytes=kcost.nbytes, bytes_fused=kcost.nbytes)
        if not self._quiet:
            self.kernel_launches[name] += 1
            self.kernel_cost.setdefault(name, Cost()).__iadd__(c)
            self.cost += c
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # ------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not self._quiet:
            self.op_counts[func.overloadpacket] += 1
            self.cost += _op_cost(func, args, kwargs, outs)
        self.track(outs)
        return out


def active() -> Optional[CostWalker]:
    """The innermost active ``CostWalker``, or None (cheap when no dispatch
    mode is active: the kernels' entry points ask on every call)."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostWalker):
            return mode
    return None


@dataclasses.dataclass
class Trace:
    result: Any
    cost: Cost
    op_counts: Dict[str, int]
    kernel_launches: Dict[str, int]
    kernel_cost: Dict[str, Cost]
    argument_bytes: int       # the arguments' storages, block-rounded
    peak_bytes: int           # the most held at once, the arguments included
    end_bytes: int            # held when the step returns

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes


def trace(fn, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` under a ``CostWalker``."""
    walker = CostWalker()
    walker.argument_bytes = walker.track(_tensors((args, kwargs)))
    with walker:
        result = fn(*args, **kwargs)
    return Trace(result, walker.cost, {str(k): v for k, v in walker.op_counts.items()},
                 dict(walker.kernel_launches), walker.kernel_cost, walker.argument_bytes,
                 walker.peak_bytes, walker.live_bytes)


def step_cost(fn, *args) -> Cost:
    """Logical (global) cost of ``fn`` at the given (meta or real) tensors."""
    return trace(fn, *args).cost
