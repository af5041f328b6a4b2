"""Meshes and named-axis collectives on ``torch.distributed``.

The reference runs its multi-device code under ``shard_map`` on a jax mesh
whose axes are named ``"pod"``, ``"data"`` and ``"model"``.  The port runs
the same programs SPMD, multi-controller: one process per rank, every rank
making the same call with the same host inputs, each holding only its own
blocks.  A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with
those dim names, and the jax collectives map onto its dim groups:

* ``jax.lax.axis_index(a)``   -> :func:`axis_index`
* ``jax.lax.psum(x, axes)``   -> :func:`psum` (``all_reduce(SUM)``)
* ``jax.lax.pmax(x, axes)``   -> :func:`pmax` (``all_reduce(MAX)``)
* ``jax.lax.all_gather(x, axes)`` -> :func:`all_gather`

An axis tuple such as ``("pod", "data")`` is gathered and reduced in one
collective on the group of the axes flattened (``DeviceMesh._flatten``),
in the row-major (pod-major) order of ``shard_map``'s flattened axes, as
XLA runs it: one all-reduce of its input's size for a psum over both data
axes on (2, 2, 2).

The backend is the caller's choice, never a fallback: ``nccl`` with one rank
per card (rank r on ``cuda:r``), ``gloo`` otherwise, including several ranks
sharing one card (NCCL refuses two ranks on one device; CUDA tensors then
cross through host copies, :func:`reduce_in_group` and
:func:`gather_in_group` make them).  A failed collective raises.

:class:`CollectiveLog` records what each collective moved and how long it
took, for the measurements of the multi-rank phase; it synchronises the
card around every collective, so it is for measuring, not for serving.
:class:`CollectiveBytes` is the counterpart of the reference's
``collective_bytes``: the result bytes of every collective a count sees
dispatched, by the reference's kinds (the count of
``repro_torch.roofline.analysis`` keeps one).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")
Axes = Union[str, Sequence[str], None]
# the collective timeout of the default group, which init_mesh gives the
# dim groups too (a new group would otherwise wait 30 minutes)
_timeout = datetime.timedelta(seconds=300)


def init_process_group(backend: str, init_method: str, world_size: int, rank: int,
                       *, timeout_s: float = 300.0) -> None:
    """Join the default process group from an explicit ``backend``
    (``"gloo"`` or ``"nccl"``; nccl puts rank r on ``cuda:r``),
    ``init_method`` (``tcp://host:port`` or ``file://path``), ``world_size``
    and ``rank``.  Collectives that wait longer than ``timeout_s`` raise."""
    global _timeout
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    _timeout = datetime.timedelta(seconds=timeout_s)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=_timeout, **kwargs)


def init_mesh(shape: Sequence[int], names: Sequence[str], **group_kwargs):
    """A :class:`DeviceMesh` of ``shape`` with dim ``names`` over the
    default process group, which :func:`init_process_group` first joins
    from ``group_kwargs`` when it is not yet.  Each call makes new dim
    groups, so one process may hold meshes of several shapes over the same
    ranks (every rank must make the same calls in the same order)."""
    from torch.distributed.device_mesh import init_device_mesh

    unknown = set(names) - set(AXES)
    if unknown or len(names) != len(shape):
        raise ValueError(f"mesh dims must be named from {AXES}, got {tuple(names)}")
    if not dist.is_initialized():
        init_process_group(**group_kwargs)
    backend = dist.get_backend()
    if backend == "nccl":
        options, device_type = dist.ProcessGroupNCCL.Options(), "cuda"
    else:
        options, device_type = dist.ProcessGroupGloo._Options(), "cpu"
    options._timeout = _timeout
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names),
                            backend_override={name: (backend, options) for name in names})


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's dim names; raises ValueError for anything but a
    ``DeviceMesh`` with named dims."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError(f"expected a DeviceMesh with named dims, got {type(mesh).__name__}")
    return tuple(names)


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    """Product of the extents of ``axes`` (1 for none)."""
    size = 1
    for name in _axes(axes):
        size *= mesh.size(axis_names(mesh).index(name))
    return size


def axis_index(mesh, axes: Axes) -> int:
    """This rank's row-major coordinate over ``axes``."""
    coord = mesh.get_coordinate()
    names = axis_names(mesh)
    index = 0
    for name in _axes(axes):
        dim = names.index(name)
        index = index * mesh.size(dim) + int(coord[dim])
    return index


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveLog:
    """Per-name totals of the collectives run while it is installed
    (:func:`recording`): calls, bytes this rank sent, and host ms around
    each one (the card synchronised before and after)."""

    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes_sent: Dict[str, int] = dataclasses.field(default_factory=dict)
    ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, name: str, nbytes: int, ms: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes_sent[name] = self.bytes_sent.get(name, 0) + int(nbytes)
        self.ms[name] = self.ms.get(name, 0.0) + ms


_LOG: Optional[CollectiveLog] = None


@contextlib.contextmanager
def recording(log: CollectiveLog):
    """Install ``log`` for the collectives of the ``with`` body."""
    global _LOG
    prev, _LOG = _LOG, log
    try:
        yield log
    finally:
        _LOG = prev


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def timed(name: Optional[str], t: torch.Tensor, nbytes: int, fn):
    """``fn()``, recorded under ``name`` as ``nbytes`` sent when a
    :class:`CollectiveLog` is installed (``t`` names the device to
    synchronise)."""
    if _LOG is None or name is None:
        return fn()
    _sync(t)
    t0 = time.perf_counter()
    out = fn()
    _sync(t)
    _LOG.add(name, nbytes, (time.perf_counter() - t0) * 1e3)
    return out


def _staged(t: torch.Tensor, group) -> bool:
    """gloo moves CUDA tensors through the host: the copies are made here,
    explicitly, so every collective gloo runs is a CPU one."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def reduce_in_group(x: torch.Tensor, group, op=dist.ReduceOp.SUM, *,
                    name: Optional[str] = None) -> torch.Tensor:
    """All-reduce ``x`` in place over the ranks of ``group``; returns it.
    A :class:`CollectiveLog` times the host copies with the collective."""
    def run():
        if not _staged(x, group):
            dist.all_reduce(x, op=op, group=group)
            return
        buf = x.cpu()
        dist.all_reduce(buf, op=op, group=group)
        x.copy_(buf)

    timed(name, x, x.numel() * x.element_size(), run)
    return x


def gather_in_group(x: torch.Tensor, group, *, name: Optional[str] = None) -> List[torch.Tensor]:
    """Every rank's ``x`` over ``group``, in group rank order."""
    x = x.contiguous()

    def run():
        buf = x.cpu() if _staged(x, group) else x
        parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, buf, group=group)
        return [part.to(x.device) for part in parts] if buf is not x else parts

    return timed(name, x, x.numel() * x.element_size(), run)


# ---------------------------------------------------------------------------
# collective bytes by kind
# ---------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
# the dispatched collective ops by name: c10d's (which the port's own
# collectives run) and _c10d_functional's (which DTensor's redistributions run)
_KIND_OF = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
# ops of those namespaces that move nothing
_NOT_MOVING = frozenset(("wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier"))
_NAMESPACES = frozenset(("c10d", "_c10d_functional", "_c10d_functional_autograd"))


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a dispatched op (an ``OpOverload``), or None
    for an op that is no collective.  A collective op of no known kind
    raises: the count would miss its bytes."""
    if func.namespace not in _NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    if name in _NOT_MOVING:
        return None
    if name not in _KIND_OF:
        raise ValueError(f"collective {func} has no kind in the count")
    return _KIND_OF[name]


@dataclasses.dataclass
class CollectiveBytes:
    """Per kind, the result-buffer bytes per device and the calls of every
    collective added, as the reference parses them from the partitioned HLO
    (the result of an all-gather is the whole gathered tensor, of an
    all-reduce the tensor)."""

    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, out) -> int:
        """Count one collective of ``kind`` whose outputs are ``out`` (a
        tensor or a nest of lists and tuples of them); returns its bytes."""
        nbytes = sum(t.numel() * t.element_size() for t in _flat_tensors(out))
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        self.calls[kind] = self.calls.get(kind, 0) + 1
        return nbytes

    def record(self) -> Dict[str, float]:
        """The reference's keys: ``<kind>_bytes``, ``<kind>_count`` and
        ``total_bytes``."""
        out: Dict[str, float] = {f"{k}_bytes": float(self.bytes.get(k, 0))
                                 for k in COLLECTIVE_KINDS}
        out.update({f"{k}_count": int(self.calls.get(k, 0)) for k in COLLECTIVE_KINDS})
        out["total_bytes"] = float(sum(self.bytes.values()))
        return out


def _flat_tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for part in out for t in _flat_tensors(part)]
    return []


def _spread(mesh, axes: Axes) -> List[str]:
    """The axes of ``axes`` with more than one rank."""
    names = axis_names(mesh)
    return [a for a in _axes(axes) if mesh.size(names.index(a)) > 1]


def _reduce(x: torch.Tensor, mesh, axes: Axes, op, name: Optional[str]) -> torch.Tensor:
    out = x.clone()
    spread = _spread(mesh, axes)
    if spread:
        reduce_in_group(out, flat_group(mesh, spread), op, name=name)
    return out


def psum(x: torch.Tensor, mesh, axes: Axes, *, name: Optional[str] = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes`` (a new tensor)."""
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM, name)


def pmax(x: torch.Tensor, mesh, axes: Axes, *, name: Optional[str] = None) -> torch.Tensor:
    """Maximum of ``x`` over the ranks of ``axes`` (a new tensor)."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MAX, name)


def all_gather(x: torch.Tensor, mesh, axes: Axes, *, dim: int = 0,
               name: Optional[str] = None) -> torch.Tensor:
    """The blocks of every rank of ``axes``, concatenated along ``dim`` in
    row-major rank order (``jax.lax.all_gather(x, axes, tiled=True)``): one
    collective, on the axes' flattened group where more than one has ranks
    to gather (:func:`flat_group`)."""
    spread = _spread(mesh, axes)
    if not spread:
        return x.contiguous()
    return torch.cat(gather_in_group(x, flat_group(mesh, spread), name=name), dim=dim)


def flat_group(mesh, axes: Sequence[str]):
    """The process group of ``axes`` taken as one dim, its ranks in row-major
    order: the dim's own group for one axis, else the group of the mesh's
    dims flattened (made once a mesh and kept, every rank in the same call;
    the axes must come in the mesh's order)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = axis_names(mesh)
    if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    flat = "_".join(axes)
    cache = mesh.__dict__.setdefault("_spmd_flat_groups", {})
    if flat not in cache:
        override = None
        if dist.get_backend() == "gloo":
            options = dist.ProcessGroupGloo._Options()
            options._timeout = _timeout
            override = ("gloo", options)
        cache[flat] = mesh[axes]._flatten(flat, backend_override=override).get_group()
    return cache[flat]
