"""The production and debug meshes: as layouts, and as device meshes over
torch's fake process group.

Counterpart of ``repro/launch/mesh.py``, whose meshes hold 256 or 512
placeholder devices.  The port's layout functions read a mesh only for its
axis names and extents (``spmd.axis_names``, ``spmd.axis_size``), so
:func:`make_production_mesh` and :func:`make_debug_mesh` return a
:class:`LayoutMesh`, which holds nothing else: no process group, no device.

:func:`fake_mesh` gives the same shape and dim names as a real
:class:`~torch.distributed.device_mesh.DeviceMesh`, this process rank 0 of
torch's fake process group: every collective returns at once with its
output's shape and moves nothing, so one process runs rank 0's program at
the production size (on meta tensors) with the collectives it would run.
The fake group's store lives in ``torch.testing._internal``; this module is
the one place of the port that imports it.  The dry run
(:mod:`repro_torch.launch.dryrun`) partitions each cell's step on it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence, Tuple

import torch.distributed as dist


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


@contextlib.contextmanager
def fake_mesh(layout: LayoutMesh, *, device_type: str = "cuda") -> Iterator:
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` of ``layout``'s
    shape and dim names, this process rank 0 of a fake default process group
    of that many ranks, joined on entry and destroyed on exit (so one
    process may count at 256 ranks, then at 512).  Raises if the process
    already has a default group; it never falls back to the layout.
    ``device_type="cpu"`` gives the mesh of gloo ranks instead of cards
    (DTensor gathers where it would send all-to-all)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process without a default process group; "
                           f"this one has a {dist.get_backend()!r} group")
    ranks = math.prod(layout.shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)
    try:
        # a mesh of cards: DTensor moves a split from one dim to another by
        # all-to-all there (on a "cpu" mesh it gathers the whole instead, as
        # gloo has no all-to-all); nothing touches a card
        yield DeviceMesh(device_type, torch.arange(ranks).reshape(layout.shape),
                         mesh_dim_names=layout.mesh_dim_names)
    finally:
        dist.destroy_process_group()
