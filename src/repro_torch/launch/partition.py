"""The dry run's rules for the ops that DTensor's sharding propagation
cannot partition as the port writes them.

The dry run (:mod:`repro_torch.launch.dryrun`) runs a cell's step on
DTensors and lets DTensor's propagation partition it, as XLA's SPMD
partitioner partitions the reference's.  It stops at a few functions of
the port: a hand-written kernel (no sharding strategy), a chunked or
in-place write into a sharded tensor, a backward that fills in place, an
optimizer that cuts a leaf into blocks.  :func:`installed` swaps each of
them, in every module of the port that binds it, for a wrapper that takes
its rule below when an argument is a DTensor and the function itself
otherwise; it swaps them back on exit.  No card path runs under it, and no
module of the port knows of it.

The rules, in ``_RULES``:

* ``pruned_matmul`` runs on each rank's block of its second operand's
  rows, its output split so (:func:`_by_columns`): XLA moves none of the
  candidates' rows;
* any other hand-written kernel, and an op with no strategy (the segment max's
  ``scatter_reduce``, the GAT's messages, the dense MoE layer), runs on
  the replicas of its inputs (:func:`_on_replicas`): each DTensor
  redistributed to ``Replicate``, as XLA runs a custom call it cannot
  partition; the gathers show under the function's name in the count's
  ``redistributions``.  ``add_rows`` writes its table so and copies it
  back;
* ``gather_rows`` gathers as XLA partitions a gather: each rank from its
  block of a table split by rows, the rows summed across those ranks,
  else from the table's replica, the rows laid out as the indices (which
  move as int32);
* ``effective_ranks`` ranks each rank's block of rows, their factor dim
  whole, and DLRM's pairs above the diagonal are each rank's rows';
* the decode step's cache write writes the position into the rank that
  holds it;
* a view that splits a projection into heads makes that dim whole first
  where its ranks do not divide them, and the heads are merged back on
  each rank's block, whole there;
* an attention runs on each rank's blocks of its sequences and heads;
* the gold logit of logits split over the vocabulary is each rank's
  masked gather, partial over those ranks;
* ``rms_norm_lean`` takes its variance as a sum of squares (the backward
  of ``vector_norm`` fills in place, which DTensor refuses on a gradient
  still partial over ranks);
* ``Adam.apply`` updates each rank's block, the gradient first laid out as
  its weight (the data-parallel reduction);
* ``moe_ffn`` reads its mesh from its DTensor input (the reference's
  ambient one) and runs ``moe_ffn_shard_map`` on the blocks
  (:func:`_moe_ffn`).
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import math
import sys
from typing import Any, Callable, Iterator, List, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.roofline import analysis


def _dtensors(*xs) -> List[Any]:
    return [x for x in tree_flatten(xs)[0] if shd.is_dtensor(x)]


def _whole(mesh) -> List[Any]:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _as_dtensor(x, mesh):
    """A plain tensor as every rank's alike (replicated); a DTensor and
    anything else as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, torch.Tensor) or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, _whole(mesh), run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient goes back contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _to_local(t, placements, grad_placements=None) -> torch.Tensor:
    """This rank's block of DTensor ``t`` laid out by ``placements``, for a
    local computation under autograd: the block's gradient goes back
    contiguous, as DTensor takes a block's strides to follow its own
    (contiguous) ones; ``grad_placements`` as ``DTensor.to_local``'s."""
    block = t.redistribute(t.device_mesh, placements).to_local(grad_placements=grad_placements)
    return _ContiguousGrad.apply(block) if block.requires_grad else block


def _from_local(x: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` whose block on this rank is ``x``
    under ``placements`` (the shape is given: blocks of a dim that does not
    divide evenly differ in size), both contiguous."""
    from torch.distributed.tensor import DTensor

    shape, x = torch.Size(shape), x.contiguous()
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * max(shape[i + 1], 1)
    return DTensor.from_local(x, mesh, placements, run_check=False, shape=shape,
                              stride=tuple(stride))


# ---------------------------------------------------------------------------
# the rules: each takes the function it stands for, then its arguments
# ---------------------------------------------------------------------------


def _on_replicas(fn: Callable, *args, **kwargs):
    """``fn`` on the replicas of its DTensor arguments (the gathers counted
    under ``fn``'s name), each tensor it returns a replicated DTensor."""
    mesh = _dtensors(args, kwargs)[0].device_mesh
    whole = _whole(mesh)

    def local(x):
        return x.redistribute(mesh, whole).to_local() if shd.is_dtensor(x) else x

    with analysis.caused_by(fn.__name__):
        args, kwargs = tree_map(local, (args, kwargs))
    out = fn(*args, **kwargs)
    if isinstance(out, tuple) and hasattr(out, "_fields"):  # a NamedTuple
        return type(out)(*(_as_dtensor(x, mesh) for x in out))
    return tree_map(lambda x: _as_dtensor(x, mesh), out)


def _on_replicas_in_place(fn: Callable, target, *args, **kwargs):
    """:func:`_on_replicas` of ``fn(target, ...)``, which writes ``target``:
    the replica it wrote copied back into ``target``'s layout (no
    collective: every rank holds the whole)."""
    target.copy_(_on_replicas(fn, target, *args, **kwargs))
    return target


def _gather_rows(fn: Callable, table, idx, *, keep=None):
    """``table[idx]`` as XLA partitions a gather from a table split by rows:
    on each mesh dim that splits the rows every rank takes all the indices,
    gathers the ones in its own block (zeros elsewhere) and the rows are
    summed across those ranks; on every other mesh dim the table is whole
    and the rows are laid out as the indices.  The table's gradient is its
    block's on the first dims, partial over the indices' shards on the
    others."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = _dtensors(table, idx, keep)[0].device_mesh
    table, idx = _as_dtensor(table, mesh), _as_dtensor(idx, mesh)
    if any(p.is_partial() for p in idx.placements):
        raise ValueError("gather_rows: indices cannot be partial")
    split = [p == Shard(0) for p in table.placements]
    ids = [Replicate() if s else p for s, p in zip(split, idx.placements)]
    lay = [Shard(0) if s else Replicate() for s in split]
    # indices move as int32 where the table's rows allow, as the reference's do
    narrow = idx.to(torch.int32) if table.shape[0] < 2 ** 31 else idx
    with analysis.caused_by(fn.__name__):
        t = _to_local(table, lay, [Shard(0) if s else Partial() if p.is_shard() else Replicate()
                                   for s, p in zip(split, ids)])
        at = narrow.redistribute(mesh, ids).to_local().long()
        if keep is not None:
            keep = _as_dtensor(keep, mesh).redistribute(mesh, ids).to_local()
    if any(split):
        shape, offset = compute_local_shape_and_global_offset(table.shape, mesh, lay)
        at = at - offset[0]
        inside = (at >= 0) & (at < shape[0])
        keep = inside if keep is None else keep & inside
        at = at.clamp(0, max(shape[0] - 1, 0))
    rows = _from_local(fn(t, at, keep=keep), mesh,
                       [Partial() if s else p for s, p in zip(split, ids)],
                       tuple(idx.shape) + tuple(table.shape[1:]))
    with analysis.caused_by(fn.__name__):
        return rows.redistribute(mesh, idx.placements)


def _by_columns(fn: Callable, p, q, *args, **kwargs):
    """``pruned_matmul(p, q, ...)`` on each rank's block of ``q``'s rows:
    an output column is one row of ``q`` cut at its own rank, so the
    product splits as ``q``'s rows do, as XLA partitions the reference's
    ``einsum``; ``p``'s rows keep their split on the other mesh dims and
    are whole on those.  The output comes back split so (its columns as
    ``q``'s rows, its rows as ``p``'s), with no gather of ``q``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _dtensors(p, q)[0].device_mesh
    p, q = _as_dtensor(p, mesh), _as_dtensor(q, mesh)
    cols = [Shard(0) if lay == Shard(0) else Replicate() for lay in q.placements]
    rows = [Shard(0) if lay == Shard(0) and c != Shard(0) else Replicate()
            for lay, c in zip(p.placements, cols)]
    with analysis.caused_by(fn.__name__):
        p_blk = p.redistribute(mesh, rows).to_local()
        q_blk = q.redistribute(mesh, cols).to_local()
        args, kwargs = tree_map(lambda x: x.full_tensor() if shd.is_dtensor(x) else x,
                                (args, kwargs))
    out = fn(p_blk, q_blk, *args, **kwargs)
    return _from_local(out, mesh, [Shard(1) if c == Shard(0) else r for r, c in zip(rows, cols)],
                       (p.shape[0], q.shape[0]))


def _per_row(fn: Callable, rows, *args, **kwargs):
    """A function of each row (dim 0) of ``rows`` alone on this rank's
    block of rows, its other dims whole; the result's rows laid out so."""
    from torch.distributed.tensor import Replicate, Shard

    lay = [p if p == Shard(0) else Replicate() for p in rows.placements]
    with analysis.caused_by(fn.__name__):
        block = _to_local(rows, lay)
    out = fn(block, *args, **kwargs)
    return _from_local(out, rows.device_mesh, lay, rows.shape[:1] + out.shape[1:])


def _ranks(fn: Callable, rows, threshold):
    """``effective_ranks`` on this rank's block of rows, their last dim
    whole (a partial sum summed), the threshold whole; the ranks laid out
    as the rows' leading dims."""
    from torch.distributed.tensor import Replicate

    mesh, last = rows.device_mesh, rows.ndim - 1
    lay = [Replicate() if p.is_partial() or (p.is_shard() and p.dim % rows.ndim == last) else p
           for p in rows.placements]
    with analysis.caused_by(fn.__name__):
        block = rows.redistribute(mesh, lay).to_local()
        if shd.is_dtensor(threshold):
            threshold = threshold.full_tensor()
    return _from_local(fn(block, threshold), mesh, lay, rows.shape[:-1])


def _write_position(fn: Callable, cache, new, length) -> None:
    """``cache[:, length] = new[:, 0]`` on a DTensor cache: each rank writes
    the position if it falls in its own block of the sequence dim and keeps
    its other rows (``new`` laid out as the cache, whole along that dim)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    whole = [Replicate() if p.is_partial() or (p.is_shard() and p.dim == 1) else p
             for p in cache.placements]
    with analysis.caused_by("cache write"):
        rows = _as_dtensor(new.to(cache.dtype), mesh).redistribute(mesh, whole).to_local()
        if shd.is_dtensor(length):
            length = length.full_tensor()
    local = cache.to_local()
    at = length.reshape(1).long().clamp(0, cache.shape[1] - 1) - offset[1]
    inside = ((at >= 0) & (at < shape[1])).reshape([-1 if i == 1 else 1
                                                    for i in range(local.ndim)])
    at = at.clamp(0, max(shape[1] - 1, 0))
    local.index_copy_(1, at, torch.where(inside, rows, local.index_select(1, at)))


def _gold_logit(fn: Callable, logits, safe):
    """The gold logit of logits split over the vocabulary (partial sums
    reduce-scattered so first): each rank gathers the labels that fall in
    its block (0 elsewhere), partial over the vocabulary's ranks.  (DTensor's
    own rule for the gather, a masked partial, fails to reduce-scatter.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, last = logits.device_mesh, logits.ndim - 1
    lay = [Shard(last) if p.is_partial() else p for p in logits.placements]
    vocab = [p.is_shard() and p.dim % logits.ndim == last for p in lay]
    if not any(vocab):
        return fn(logits, safe)
    rows = [Replicate() if v else p for p, v in zip(lay, vocab)]
    shape, offset = compute_local_shape_and_global_offset(logits.shape, mesh, lay)
    with analysis.caused_by(fn.__name__):
        block = _to_local(logits, lay)
        at = _as_dtensor(safe, mesh).redistribute(mesh, rows).to_local() - offset[last]
    inside = (at >= 0) & (at < shape[last])
    gold = torch.where(inside, torch.gather(block, -1, at.clamp(0, max(shape[last] - 1, 0))),
                       torch.zeros((), dtype=block.dtype))[..., 0]
    return _from_local(gold, mesh, [Partial() if v else p for p, v in zip(rows, vocab)],
                       logits.shape[:-1])


def _split_heads(fn: Callable, t, n: int, d: int):
    """A projection viewed as ``n`` heads: its last dim made whole first on
    the mesh dims that split it, where their ranks do not divide ``n`` (20
    heads over 16: DTensor lays out no uneven split of a dim a view makes)."""
    from torch.distributed.tensor import Replicate

    last = t.ndim - 1
    split = [i for i, p in enumerate(t.placements) if p.is_shard() and p.dim % t.ndim == last]
    if n % math.prod(t.device_mesh.size(i) for i in split):
        with analysis.caused_by("split heads"):
            t = t.redistribute(t.device_mesh, [Replicate() if i in split else p
                                               for i, p in enumerate(t.placements)])
    return fn(t, n, d)


def _merge_heads(fn: Callable, t):
    """The heads merged on each rank's block: split where they divide over
    the ranks that split them (the merged dim then split alike), else
    whole, and their width whole; the gradient comes back so (DTensor fails
    the view that splits a gradient over ranks that do not divide the
    heads)."""
    from torch.distributed.tensor import Replicate

    heads = t.ndim - 2
    split = [i for i, p in enumerate(t.placements) if p.is_shard() and p.dim % t.ndim == heads]
    even = t.shape[-2] % math.prod(t.device_mesh.size(i) for i in split) == 0
    lay = [p if not p.is_shard() or p.dim % t.ndim < heads or (i in split and even)
           else Replicate() for i, p in enumerate(t.placements)]
    with analysis.caused_by(fn.__name__):
        block = _to_local(t, lay)
    return _from_local(fn(block), t.device_mesh, lay, t.shape[:-2] + (t.shape[-2] * t.shape[-1],))


def _attention(fn: Callable, q, k, v, *rest, **kwargs):
    """An attention on each rank's blocks: it is independent per sequence
    and per group of query heads that share a KV head, so ``q``, ``k`` and
    ``v`` are laid out with the batch split as ``q``'s is and the heads
    split where ``q``'s are and the KV heads divide over those ranks (else
    whole), the sequence and the head width whole; the output comes back
    laid out so.  (Op by op, DTensor fails the views that group the heads.)
    A cache split along the sequence (decode at 500k) is left to DTensor,
    the query heads whole where the KV heads do not divide."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    heads = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    even = k.shape[2] % math.prod(mesh.size(i) for i in heads) == 0
    lay = [Shard(0) if p == Shard(0) else Shard(2) if p == Shard(2) and even else Replicate()
           for p in q.placements]
    if any(p.is_shard() and p.dim % k.ndim == 1 for p in getattr(k, "placements", ())):
        with analysis.caused_by(fn.__name__):
            q = q.redistribute(mesh, [p if p == Shard(0) or i not in heads else lay[i]
                                      for i, p in enumerate(q.placements)])
        return fn(q, k, v, *rest, **kwargs)
    with analysis.caused_by(fn.__name__):
        blocks = [_to_local(_as_dtensor(t, mesh), lay) for t in (q, k, v)]
        rest = [t.full_tensor() if shd.is_dtensor(t) else t for t in rest]
    out = fn(*blocks, *rest, **kwargs)
    return _from_local(out, mesh, lay, tuple(q.shape[:-1]) + (v.shape[-1],))


def _rms_norm_lean(fn: Callable, x, scale, eps: float = 1e-6):
    """``rms_norm_lean`` with its variance a sum of squares."""
    var = torch.sum(torch.square(x), dim=-1, dtype=torch.float32) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def _adam_apply(fn: Callable, opt, params, state, grads, lr_scale=1.0):
    """``Adam.apply`` on every rank's blocks, each gradient first laid out as
    its weight; the step count stays replicated."""
    from repro_torch import tree as tree_lib

    def laid_out(p, g):
        if not shd.is_dtensor(p):
            return g
        with analysis.caused_by("adam"):
            return _as_dtensor(g, p.device_mesh).redistribute(p.device_mesh, p.placements)

    def local(x):
        return x.to_local() if shd.is_dtensor(x) else x

    grads = tree_lib.map_leaves(laid_out, params, grads)
    t = state["t"]
    blocks = dict(state, t=local(t), m=tree_lib.map_leaves(local, state["m"]),
                  v=tree_lib.map_leaves(local, state["v"]))
    fn(opt, tree_lib.map_leaves(local, params), blocks, tree_lib.map_leaves(local, grads),
       lr_scale)
    state["t"] = _as_dtensor(blocks["t"], t.device_mesh) if shd.is_dtensor(t) else blocks["t"]
    return params, state


def _moe_ffn(fn: Callable, x, params, cfg, *, activation: str = "swiglu",
             use_shard_map: bool = False, mesh=None):
    """The MoE layer on the mesh of its DTensor input, through
    ``moe_ffn_shard_map`` where ``"model"`` divides the experts (else the
    dense layer on replicas): ``wg``/``wi``/``wo`` split over ``"model"``,
    the router and the shared experts whole, and the tokens' rows over the
    data axes when ``use_shard_map`` (the reference's ``shard_map`` layout;
    capacity each data shard's) and they divide over them, else whole on
    every rank (the reference's XLA path as its partitioner splits it, the
    experts over ``"model"``: every rank routes the whole batch at the
    batch's capacity).  The output comes back laid out as the tokens, the
    aux loss whole; a weight's gradient is partial over the data axes the
    tokens are split over."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.models import moe

    mesh = x.device_mesh
    names = spmd.axis_names(mesh)
    if "model" not in names or cfg.num_experts % spmd.axis_size(mesh, "model"):
        return _on_replicas(moe.moe_ffn_xla, x, params, cfg, activation=activation)
    dp = shd.data_axes(mesh)
    split = use_shard_map and bool(dp) and x.shape[0] % spmd.axis_size(mesh, dp) == 0
    tokens = shd.placements(shd.P(dp if split else None, None), mesh)
    summed = [Partial() if p.is_shard() else Replicate() for p in tokens]

    def block(w, slab):
        lay = shd.placements(shd.P("model") if slab else shd.P(), mesh)
        grads = [g if p == Replicate() else p for p, g in zip(lay, summed)]
        return _to_local(_as_dtensor(w, mesh), lay, grads)

    with analysis.caused_by("moe_ffn_shard_map" if use_shard_map else "moe_ffn_xla"):
        x_blk = _to_local(_as_dtensor(x, mesh), tokens)
        p_blk = {name: ({k: block(v, False) for k, v in w.items()} if isinstance(w, dict)
                        else block(w, name in ("wg", "wi", "wo")))
                 for name, w in params.items()}
    out, aux = moe.moe_ffn_shard_map(x_blk, p_blk, cfg, activation=activation, mesh=mesh,
                                     split_tokens=split)
    return _from_local(out, mesh, tokens, x.shape), _from_local(aux, mesh, _whole(mesh), ())


# (module, name in it, rule)
_RULES: Tuple[Tuple[str, str, Callable], ...] = (
    ("repro_torch.kernels.ops", "pruned_matmul", _by_columns),
    ("repro_torch.kernels.ops", "pruned_topk", _on_replicas),
    ("repro_torch.kernels.ops", "fused_mf_sgd", _on_replicas),
    ("repro_torch.kernels.scatter", "add_rows", _on_replicas_in_place),
    ("repro_torch.kernels.scatter", "gather_rows", _gather_rows),
    ("repro_torch.kernels.scatter", "segment_sum", _on_replicas),
    ("repro_torch.models.gnn", "_segment_max", _on_replicas),
    ("repro_torch.models.gnn", "_edge_messages", _on_replicas),
    ("repro_torch.models.recsys", "_upper_pairs", _per_row),
    ("repro_torch.core.ranks", "effective_ranks", _ranks),
    ("repro_torch.models.attention", "_write_position", _write_position),
    ("repro_torch.models.attention", "_split_heads", _split_heads),
    ("repro_torch.models.attention", "_merge_heads", _merge_heads),
    ("repro_torch.models.attention", "causal_attention", _attention),
    ("repro_torch.models.attention", "decode_attention", _attention),
    ("repro_torch.models.transformer", "_gold_logit", _gold_logit),
    ("repro_torch.models.layers", "rms_norm_lean", _rms_norm_lean),
    ("repro_torch.optim.optimizers", "Adam.apply", _adam_apply),
    ("repro_torch.models.moe", "moe_ffn", _moe_ffn),
)


def _wrapped(fn: Callable, rule: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _dtensors(args, kwargs):
            return rule(fn, *args, **kwargs)
        return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def installed() -> Iterator[None]:
    """Every rule of ``_RULES`` in place for the ``with`` body: a module's
    function wherever a module of the port binds it (its own module, and a
    ``from ... import`` of it), a method on its class."""
    swapped = []
    try:
        for module, name, rule in _RULES:
            owner = importlib.import_module(module)
            *path, attr = name.split(".")
            for part in path:
                owner = getattr(owner, part)
            fn = owner.__dict__[attr]
            where = [(owner, attr)]
            if not path:
                ours = [m for m in list(sys.modules.values()) if m is not owner
                        and getattr(m, "__name__", "").startswith("repro_torch.")]
                where += [(m, n) for m in ours for n, v in list(vars(m).items()) if v is fn]
            wrapper = _wrapped(fn, rule)
            for obj, n in where:
                swapped.append((obj, n, fn))
                setattr(obj, n, wrapper)
        yield
    finally:
        for obj, n, fn in reversed(swapped):
            setattr(obj, n, fn)
