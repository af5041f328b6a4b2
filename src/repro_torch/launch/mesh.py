"""The production and debug meshes, as layouts.

Counterpart of ``repro/launch/mesh.py``.  The port's layout functions read
a mesh only for its axis names and extents (``spmd.axis_names``,
``spmd.axis_size``), so these return a :class:`LayoutMesh`, which holds
nothing else: no process group, no device.  The dry run
(:mod:`repro_torch.launch.dryrun`) lays each cell's arguments out on them.
"""
from __future__ import annotations

from typing import Sequence, Tuple


class LayoutMesh:
    """Axis names and extents only: all the port's layout functions read."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(names)}")
        self.mesh_dim_names: Tuple[str, ...] = tuple(names)
        self.shape: Tuple[int, ...] = tuple(shape)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def __repr__(self) -> str:
        return f"LayoutMesh({self.shape}, {self.mesh_dim_names})"


def _axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> LayoutMesh:
    """The (16, 16) ("data", "model") layout; (2, 16, 16) with "pod" first
    when ``multi_pod``."""
    return LayoutMesh((2, 16, 16) if multi_pod else (16, 16), _axes(multi_pod))


def make_debug_mesh(*, multi_pod: bool = False) -> LayoutMesh:
    """The same axis names at (2, 2), or (2, 2, 2) when ``multi_pod``."""
    return LayoutMesh((2, 2, 2) if multi_pod else (2, 2), _axes(multi_pod))
