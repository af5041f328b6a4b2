"""Roofline terms, and the count of a step's work per device that feeds them.

Counterpart of ``repro/roofline/analysis.py``.  The reference reads a
compiled program's FLOPs and bytes from XLA's cost analysis and its
collectives from the partitioned HLO text.  PyTorch has no HLO, so the port
counts what a step dispatches: :func:`count` runs the step on meta tensors
(shapes and dtypes, no storage, no device) under one
``TorchDispatchMode`` and returns a :class:`Count`:

* ``flops``: the matmul-type operations, by ``torch.utils.flop_counter``'s
  formulas, plus those of the kernels whose work is products
  (``pruned_topk``, ``pruned_matmul``); ``recompute_flops`` the part a
  checkpointed forward runs again in the backward;
* ``bytes_accessed``: every dispatched op's tensor inputs and outputs (views
  and allocations move none) plus each kernel's bytes: the eager
  counterpart of XLA's "bytes accessed";
* ``least_bytes``: the step's arguments read once and its outputs written
  once (as far as the step reads and writes them), the bound
  :func:`roofline_terms` takes;
* ``temp``: the peak of the bytes live beyond the arguments (every storage
  the step allocates, from its allocation until it is freed; outputs
  included), XLA's ``temp`` with the outputs in it;
* ``collectives``: every collective's result bytes and calls by the
  reference's kinds (``spmd.CollectiveBytes``), and ``collective_log`` the
  port's own by name, as a rank logs them (``spmd.CollectiveLog``);
* ``redistributions``: per aten op (or kernel), the bytes and calls of the
  collectives DTensor ran to move that op's inputs;
* ``op_histogram``: the aten ops dispatched, by name;
* ``kernels``: per hand-written kernel its calls, operations and bytes by
  the formula beside its wrapper (``kernels/*.py``, ``cost``).

On one device the step's arguments are plain tensors.  Partitioned on a
mesh (:mod:`repro_torch.launch.dryrun`), they are either this rank's blocks
and the step takes the mesh (the owner-compute cells: their collectives are
the port's own), or DTensors laid out by the cell's specs, whose ops
DTensor's sharding propagation partitions.  The dispatch mode declines a
DTensor op (``NotImplemented``): DTensor then runs its redistributions and
the local op on this rank's blocks, and those are what the mode counts, so
every number is one device's, as the reference's compiled SPMD program is.
The fake tensors of the propagation itself are not counted.

A kernel's wrapper sees the installed count (:func:`counting`), records its
formula and returns outputs of the right shape without running its plain
version, so no plain op is counted in its place.  On meta there are no
ranks or indices to read, so each formula counts the most the shapes allow
(every rank at ``k``, every index distinct) and its record says ``dense``.
A kernel has no sharding rule: given DTensors, it runs on their replicas
(``repro_torch.launch.partition``), as XLA runs a custom call it cannot
partition, and the gathers show under its name in ``redistributions``
(:func:`caused_by`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import flop_counter
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.roofline import hw

# ---------------------------------------------------------------------------
# the work of a kernel
# ---------------------------------------------------------------------------


def above(r: torch.Tensor, k: int) -> torch.Tensor:
    """#{rows with rank > t} for t = 0..k-1 (float64)."""
    counts = torch.bincount(r.long().flatten().cpu(), minlength=k + 1).double()
    return counts.flip(0).cumsum(0).flip(0)[1:]


def pair_flops(r_u: torch.Tensor, r_i: torch.Tensor, k: int) -> float:
    """Multiply-adds of every (u, i) pair's sum cut at ``min(r_u, r_i)``, as
    FLOPs (2 each)."""
    return 2.0 * float((above(r_u, k) * above(r_i, k)).sum())


def factor_bytes(r_u: torch.Tensor, r_i: torch.Tensor, itemsize: int) -> float:
    """Factor bytes the pruned product needs: each row's prefix up to its own
    rank, cut at the other side's largest rank, and the ranks (int32)."""
    need_u = torch.clamp(r_u, max=int(r_i.max())).double().sum()
    need_i = torch.clamp(r_i, max=int(r_u.max())).double().sum()
    return itemsize * float(need_u + need_i) + 4.0 * (r_u.numel() + r_i.numel())


def has_values(*tensors: torch.Tensor) -> bool:
    """True when every tensor holds values a formula can read (not meta)."""
    return all(t.device.type != "meta" for t in tensors)


def pair_work(m: int, n: int, k: int, r_u=None, r_i=None,
              itemsize: int = 4) -> Tuple[float, float, bool]:
    """``(flops, bytes, dense)`` of a pruned all-pairs product of ``m`` by
    ``n`` rows of width ``k``: :func:`pair_flops` and :func:`factor_bytes`
    of the ranks, or with no ranks to read (None, or meta) every rank at
    ``k`` (``dense``)."""
    if r_u is not None and r_i is not None and has_values(r_u, r_i):
        return pair_flops(r_u, r_i, k), factor_bytes(r_u, r_i, itemsize), False
    return 2.0 * m * n * k, itemsize * (m + n) * k + 4.0 * (m + n), True


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One launch's operations and least bytes (each input read once, each
    output written once).  ``products``: the operations are multiply-adds
    of a matrix product, counted in :attr:`Count.flops`.  ``dense``: the
    formula had no values to read and counted the most the shapes allow."""

    flops: float
    bytes: float
    products: bool = False
    dense: bool = False


def bound(flops: float, nbytes: float, peak: float = hw.PEAK_FP32_FLOPS) -> Tuple[float, str]:
    """The least ms the card takes for ``flops`` at ``peak`` and ``nbytes``
    at :data:`hw.HBM_BANDWIDTH`, and which of the two binds
    (``"operations"`` or ``"bytes"``)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / hw.HBM_BANDWIDTH * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# the count of a step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Count:
    """What one call dispatched: see the module's docstring."""

    flops: float = 0.0
    recompute_flops: float = 0.0
    bytes_accessed: float = 0.0
    least_bytes: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp: float = 0.0
    op_histogram: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    collectives: spmd.CollectiveBytes = dataclasses.field(default_factory=spmd.CollectiveBytes)
    collective_log: spmd.CollectiveLog = dataclasses.field(default_factory=spmd.CollectiveLog)
    redistributions: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # per argument storage: its bytes, and the bytes read from and written
    # into it (each capped at its size for least_bytes)
    _size: Dict[Any, float] = dataclasses.field(default_factory=dict, repr=False)
    _read: Dict[Any, float] = dataclasses.field(default_factory=dict, repr=False)
    _written: Dict[Any, float] = dataclasses.field(default_factory=dict, repr=False)
    # storages the step allocated and still holds: id -> (weak ref, bytes)
    _live: Dict[int, Any] = dataclasses.field(default_factory=dict, repr=False)
    _live_bytes: float = dataclasses.field(default=0.0, repr=False)
    # the op whose inputs DTensor moves next
    _cause: str = dataclasses.field(default="", repr=False)

    def _allocated(self, t: torch.Tensor) -> None:
        """Follow ``t``'s storage from now until it is freed, unless it is an
        argument's or already followed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live or _storage(t) in self._size:
            return
        nbytes = float(st.nbytes())

        def freed(_ref, key=key, nbytes=nbytes, rec=weakref.ref(self)):
            owner = rec()
            if owner is not None and owner._live.pop(key, None) is not None:
                owner._live_bytes -= nbytes

        self._live[key] = weakref.ref(st, freed)
        self._live_bytes += nbytes
        self.temp = max(self.temp, self._live_bytes)

    def _on_argument(self, t: torch.Tensor, read: float, written: float) -> None:
        key = _storage(t)
        if key in self._size:
            self._read[key] = self._read.get(key, 0.0) + read
            self._written[key] = self._written.get(key, 0.0) + written

    def _touch(self, t: torch.Tensor, read: float, written: float = 0.0) -> None:
        """``read`` bytes read from ``t`` and ``written`` into it."""
        self.bytes_accessed += read + written
        self._on_argument(t, read, written)

    def kernel(self, name: str, cost: KernelCost,
               touches: Sequence[Tuple[torch.Tensor, float, float]] = ()) -> None:
        """Record one launch of kernel ``name``: ``cost``, and its
        ``(tensor, bytes read, bytes written)`` on the step's arguments
        (:func:`reads`), which ``least_bytes`` caps at each argument's size."""
        rec = self.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "dense": False})
        rec["calls"] += 1
        rec["flops"] += cost.flops
        rec["bytes"] += cost.bytes
        rec["dense"] = rec["dense"] or cost.dense
        self.bytes_accessed += cost.bytes
        for t, read, written in touches:
            self._on_argument(t, read, written)
        if cost.products:
            self.flops += cost.flops


_COUNT: Optional[Count] = None


def counting() -> Optional[Count]:
    """The :class:`Count` being taken, or None: a kernel's wrapper records
    its formula there in place of a launch."""
    return _COUNT


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def reads(*tensors: Optional[torch.Tensor]) -> List[Tuple[torch.Tensor, float, float]]:
    """Each tensor read whole: the ``touches`` of :meth:`Count.kernel`."""
    return [(t, _nbytes(t), 0.0) for t in tensors if t is not None]


def _storage(t: torch.Tensor):
    return StorageWeakRef(t.untyped_storage())


# ops that allocate or alias and so move no bytes
_NO_BYTES = frozenset(("empty", "empty_strided", "empty_like", "lift_fresh"))
# reads of rows of their first argument: as many bytes as they return
_GATHERS = frozenset(("index", "index_select", "embedding", "gather", "take"))
# in-place writes of rows of ``self``: as many bytes as the rows they add
_SCATTERS = frozenset(("index_put_", "_index_put_impl_", "index_add_", "index_copy_",
                       "scatter_", "scatter_add_", "scatter_reduce_"))


@functools.lru_cache(maxsize=None)
def _subclasses() -> Tuple[type, type]:
    """DTensor and FakeTensor (imported on first use)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    return DTensor, FakeTensor


def _propagating() -> bool:
    """True while DTensor's sharding propagation runs its fake tensors."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec: Count):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor, fake = _subclasses()
        if _propagating() or any(issubclass(t, fake) for t in types):
            return func(*args, **kwargs)
        rec = self.rec
        if any(issubclass(t, dtensor) for t in types):
            # DTensor moves this op's inputs, then runs it on the local blocks
            rec._cause = func._overloadpacket.__name__
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        rec.op_histogram[name] = rec.op_histogram.get(name, 0) + 1
        kind = spmd.collective_kind(func)
        if kind is not None:
            nbytes = rec.collectives.add(kind, out)
            if func.namespace != "c10d":  # DTensor's: a redistribution
                moved = rec.redistributions.setdefault(rec._cause or "?",
                                                       {"bytes": 0.0, "count": 0})
                moved["bytes"] += nbytes
                moved["count"] += 1
            for t in _tensors(out):
                rec._allocated(t)
            return out
        if not func.is_view:
            for t in _tensors(out):
                rec._allocated(t)
        if packet in flop_counter.flop_registry:
            flops = float(flop_counter.flop_registry[packet](*args, **kwargs, out_val=out))
            rec.flops += flops
            # the forward a checkpoint runs again inside the backward
            if torch.is_grad_enabled() and torch._C._current_graph_task_id() != -1:
                rec.recompute_flops += flops
        if func.is_view or name in _NO_BYTES:
            return out
        schema = func._schema.arguments
        given = list(args) + [kwargs.get(a.name) for a in schema[len(args):]]
        written = {id(v) for a, v in zip(schema, given) if isinstance(v, torch.Tensor)
                   and a.alias_info is not None and a.alias_info.is_write}
        ins = _tensors((args, kwargs))
        if name in _GATHERS:
            rec._touch(ins[0], min(_nbytes(ins[0]), sum(_nbytes(o) for o in _tensors(out))))
            ins = ins[1:]
        elif name in _SCATTERS:
            rows = min(_nbytes(ins[0]), _nbytes(ins[-1]))  # the source rows come last
            rec._touch(ins[0], rows, rows)
            ins = ins[1:]
        for t in ins:
            rec._touch(t, _nbytes(t), _nbytes(t) if id(t) in written else 0.0)
        if not func._schema.is_mutable:
            for t in _tensors(out):
                rec._touch(t, 0.0, _nbytes(t))
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank, or the tensor itself."""
    return t._local_tensor if shd.is_dtensor(t) else t


def _to_meta(x):
    if shd.is_dtensor(x):
        if x.device.type == "meta":
            return x
        return type(x).from_local(x.to_local().to("meta"), x.device_mesh, x.placements,
                                  shape=x.shape, stride=x.stride())
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return x.to("meta")
    return x


@contextlib.contextmanager
def _recording(rec: Count):
    global _COUNT
    prev, _COUNT = _COUNT, rec
    try:
        with spmd.recording(rec.collective_log), _Dispatch(rec):
            yield rec
    finally:
        _COUNT = prev


@contextlib.contextmanager
def caused_by(name: str):
    """Attribute to ``name`` the redistributions of the ``with`` body (an
    explicit ``redistribute``, which no aten op causes)."""
    rec = _COUNT
    if rec is None:
        yield
        return
    prev, rec._cause = rec._cause, name
    try:
        yield
    finally:
        rec._cause = prev


def count(fn: Callable, *args, **kwargs) -> Count:
    """Run ``fn(*args, **kwargs)`` once on meta copies of its tensors (meta
    tensors are taken as they are) and count what it dispatches, per device:
    a DTensor argument is its block on this rank (see the module's
    docstring).  ``least_bytes`` counts each argument's storage read at most
    once and written at most once (as far as the step reads and writes it:
    a gather reads the rows it returns) and each new output written once."""
    args, kwargs = tree_map(_to_meta, (args, kwargs))
    arguments = [_local(t) for t in _tensors((args, kwargs))]
    rec = Count(argument_bytes=sum(_nbytes(t) for t in arguments))
    for t in arguments:
        rec._size[_storage(t)] = float(t.untyped_storage().nbytes())
    with _recording(rec):
        out = fn(*args, **kwargs)
    fresh = {}
    for t in map(_local, _tensors(out)):
        rec.output_bytes += _nbytes(t)
        if _storage(t) not in rec._size:
            fresh[_storage(t)] = _nbytes(t)
    rec.least_bytes = sum(fresh.values()) + sum(
        min(size, rec._read.get(key, 0.0)) + min(size, rec._written.get(key, 0.0))
        for key, size in rec._size.items())
    return rec


# ---------------------------------------------------------------------------
# the reference's arithmetic on the H100's peaks
# ---------------------------------------------------------------------------


def roofline_terms(
    flops: float,
    bytes_accessed: float,
    coll_bytes: float,
    chips: int,
    *,
    model_flops: Optional[float] = None,
) -> Dict[str, float]:
    """The compute, memory and collective terms of a step in seconds, the
    dominant one and the bound (their largest).  ``flops``,
    ``bytes_accessed`` and ``coll_bytes`` are the ``chips`` devices' sum, or
    one device's with ``chips=1``.  The collective term takes the counted
    collective result bytes at :data:`hw.LINK_BANDWIDTH`, one direction of
    one H100's NVLink 4: a 16 x 16 mesh of H100s spans 32 nodes of 8, and
    traffic between nodes runs on slower network links, so that term is a
    lower bound."""
    compute_s = flops / (chips * hw.PEAK_BF16_FLOPS)
    memory_s = bytes_accessed / (chips * hw.HBM_BANDWIDTH)
    collective_s = coll_bytes / (chips * hw.LINK_BANDWIDTH)
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    out = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flop_fraction"] = model_flops / max(flops, 1.0)
        # the time the useful math would take at peak, over the time the
        # dominant term costs
        out["roofline_fraction"] = (
            model_flops / (chips * hw.PEAK_BF16_FLOPS)
        ) / max(out["bound_s"], 1e-30)
    return out


def extrapolate_depth(calib1: Dict, calib2: Dict, scan_layers: int) -> Dict[str, float]:
    """Per-step cost at ``scan_layers`` layers from the depth-1 and depth-2
    counts: with homogeneous layers, cost(d) = entry + d * body, so

        body  = c2 - c1
        entry = 2*c1 - c2
        total(L) = entry + L * body

    Applied to flops, bytes_accessed and the collective bytes (records laid
    out as the reference's: ``cost.flops``, ``cost.bytes_accessed``,
    ``collectives.total_bytes``)."""

    def get(rec, *keys):
        node = rec
        for key in keys:
            node = node.get(key, 0.0) if isinstance(node, dict) else 0.0
        return float(node or 0.0)

    out: Dict[str, float] = {}
    for field, keys in (
        ("flops", ("cost", "flops")),
        ("bytes_accessed", ("cost", "bytes_accessed")),
        ("collective_bytes", ("collectives", "total_bytes")),
    ):
        c1 = get(calib1, *keys)
        c2 = get(calib2, *keys)
        body = c2 - c1
        entry = 2 * c1 - c2
        out[field] = max(entry + scan_layers * body, 0.0)
    return out


def lm_model_flops(param_count: int, active_param_count: int, tokens: int,
                   kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for forward-only (N = active
    params for MoE)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_param_count * tokens
