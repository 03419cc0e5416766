"""Production mesh, as a description.

Twin of ``repro/launch/mesh.py``.  Single pod: 16 x 16 = 256 devices, axes
(data, model).  Multi-pod: 2 x 16 x 16 = 512, axes (pod, data, model);
the pod axis carries pure data parallelism, as the paper's FL clients map
onto silos.

The port runs on one card, so a mesh here is a description and not a
device mesh: nothing is placed on it and no collective runs over it.  The
dry run (``launch/dryrun.py``) uses it only to resolve the per-device
shards of its accounting (``launch/shardings.py`` ``shard_shape``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes; ``shape`` maps a name to its size, as a JAX
    mesh's does."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"MeshShape: {self.axis_names} against sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """The one card: a (1, 1) mesh (JAX's clamps its ``data`` and ``model``
    sizes to the devices present; here there is one)."""
    return MeshShape(("data", "model"), (1, 1))


def data_axis_names(mesh) -> tuple:
    """Axes that carry batch/data parallelism for this mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
