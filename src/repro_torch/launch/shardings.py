"""Logical-axis -> mesh-axis resolution, on a mesh description.

Twin of ``repro/launch/shardings.py``.  Models annotate every parameter
with logical axes ("embed", "heads", "vocab", "expert", "layers"); this
module maps them onto the mesh's axes:

    heads / vocab / expert -> "model"   (tensor parallelism)
    embed                  -> "data"    (FSDP / ZeRO-3)
    layers / None          -> replicated

Activations: batch -> all data axes (("pod", "data") on the multi-pod
mesh).  The functions are pure: they take a ``MeshShape``
(``launch/mesh.py``) or any object with ``axis_names`` and a ``shape``
dict, and return a spec as a tuple of entries (``None``, an axis name, or
a tuple of names) where JAX returns a ``PartitionSpec``.  Nothing is
placed: ``shard_shape`` gives the per-device shape a spec implies, which
is what the dry run counts.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

DEFAULT_RULES: Dict[str, Optional[str]] = {
    "heads": "model",
    "vocab": "model",
    "expert": "model",
    "embed": "data",
    "layers": None,
}

# Pure-FSDP layout: weights sharded over both axes on the embed dim, no
# tensor parallelism.
FSDP_RULES: Dict[str, object] = {
    "heads": None,
    "vocab": None,
    "expert": None,
    "embed": ("data", "model"),
    "layers": None,
}

LAYOUTS: Dict[str, Dict[str, object]] = {"tp": DEFAULT_RULES, "fsdp": FSDP_RULES}

Spec = Tuple[object, ...]


def _axes_tuple(axis) -> tuple:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def _divisible(dim: int, mesh, axis) -> bool:
    axes = _axes_tuple(axis)
    if not axes or any(a not in mesh.axis_names for a in axes):
        return False
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return dim % total == 0


def logical_to_pspec(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...], mesh,
                     rules: Optional[Dict[str, object]] = None) -> Spec:
    """Resolve one param's logical spec, dropping any axis that doesn't divide."""
    rules = rules or DEFAULT_RULES
    out = []
    used = set()
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name else None
        axes = _axes_tuple(axis)
        if used.intersection(axes) or not _divisible(dim, mesh, axis):
            out.append(None)
        else:
            out.append(axis)
            used.update(axes)
    return tuple(out)


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` laid out by ``spec`` on ``mesh``
    (entries past the spec's length are replicated; a non-dividing axis
    rounds up, as a padded shard would)."""
    out = []
    for i, dim in enumerate(shape):
        n = 1
        for a in _axes_tuple(spec[i] if i < len(spec) else None):
            n *= mesh.shape[a]
        out.append(-(-dim // n))
    return tuple(out)


def param_shard_shapes(params: Dict[str, object], specs: Dict[str, Tuple[Optional[str], ...]],
                       mesh, rules: Optional[Dict[str, object]] = None
                       ) -> Dict[str, Tuple[Tuple[int, ...], Spec]]:
    """{path: (per-device shape, spec)} for a flat parameter dict (tensors or
    anything with a ``shape``): the twin of JAX's ``param_shardings``."""
    out = {}
    for k, v in params.items():
        shape = tuple(v.shape)
        spec = logical_to_pspec(shape, specs[k], mesh, rules)
        out[k] = (shard_shape(shape, spec, mesh), spec)
    return out


def batch_pspec(mesh, layout: str = "tp") -> Spec:
    """Batch-dim spec covering every data-parallel axis of the mesh.

    'tp': (pod, data).  'fsdp': (data, model): no tensor axis exists, so
    the batch spreads across the whole pod."""
    names = ("pod", "data") if layout == "tp" else ("data", "model")
    axes = tuple(a for a in names if a in mesh.axis_names)
    return (axes if len(axes) > 1 else axes[0],)


def replicated(mesh) -> Spec:
    return ()
