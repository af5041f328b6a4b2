"""How the MF tables, batches and serving operands, the transformers'
parameters, batches and KV caches, and the recsys models' and the GAT's
parameters and batches, map onto a mesh.

Counterpart of the MF, transformer, recsys and GNN parts of
``repro/distributed/sharding.py``.  Axes: ``"data"`` (and ``"pod"`` when
present) carry the user rows and the batch, ``"model"`` carries the item
rows: a rating batch sharded over the data axes meets its item rows across
``"model"``, the MF analogue of DP x TP.

A layout is a :func:`P` spec as in jax, one entry a dim: ``None``
(replicated) or a tuple of axis names whose ranks split that dim into
equal contiguous blocks, in row-major order of the named axes.  Where the
reference hands a global array and a ``PartitionSpec`` to ``device_put`` or
``shard_map``, a rank of the port holds only its block: :func:`block` cuts
a rank's block out of a full table (numpy or torch), :func:`assemble`
all-gathers the blocks back into the full table on every rank, and
:func:`shard_tree` / :func:`assemble_tree` do both over a whole state tree
with :func:`mf_spec_fn`'s layout or a given tree of layouts (such as
:func:`recsys_spec_fn`'s, through :func:`tree_shardings`).

Where the reference returns a ``NamedSharding`` (:func:`ns`,
:func:`replicated`, :func:`tree_shardings`), the port returns the bare
``Spec``: a mesh is needed only to read its axis names and extents, through
``spmd.axis_names`` and ``spmd.axis_size``, so the layout functions take a
``DeviceMesh`` or any object with ``mesh_dim_names`` and ``size(dim)``.

The dry run (``repro_torch.launch.dryrun``) lays a cell's arguments out as
DTensors (:func:`placements`, :func:`distribute_tree`) and lets DTensor's
sharding propagation partition the step, as XLA's partitioner does the
reference's.  Where it cannot partition an op as the port writes it, the
dry run's own rules take over (``repro_torch.launch.partition``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import spmd
from repro_torch.tree import map_leaves as tree_map_leaves
from repro_torch.tree import map_with_path as _map_tree

Spec = Tuple[Optional[Tuple[str, ...]], ...]


def P(*entries) -> Spec:
    """A layout: each entry None, an axis name or a tuple of axis names."""
    out = []
    for entry in entries:
        if entry is None or entry == ():
            out.append(None)
        else:
            out.append((entry,) if isinstance(entry, str) else tuple(entry))
    return tuple(out)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, ``("pod", "data")`` where present."""
    names = spmd.axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def all_axes(mesh) -> Tuple[str, ...]:
    """Every axis of the mesh, in ``("pod", "data", "model")`` order."""
    names = spmd.axis_names(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in names)


def ns(mesh, *spec) -> Spec:
    """The layout ``P(*spec)`` (the reference's ``NamedSharding``; the port
    keeps no mesh beside a layout)."""
    del mesh
    return P(*spec)


def replicated(mesh) -> Spec:
    """The layout of a tensor whole on every rank, ``P()``."""
    del mesh
    return P()


def tree_shardings(params: Any, spec_fn: Callable, mesh) -> Any:
    """``spec_fn(path_parts, leaf)`` over every leaf of a tree."""
    del mesh
    return _map_tree(params, spec_fn)


def sanitize_shardings(shardings: Any, avals: Any, mesh) -> Any:
    """Each layout of ``shardings`` with every sharded dim whose size does
    not divide over its mesh extent turned replicated, as the reference's
    (published dims owe the mesh no divisibility).  ``avals`` is the tree of
    tensors (meta tensors serve) the layouts are for; the spec is padded with
    None to the tensor's rank, and entries past it are dropped."""

    def fix(aval, spec):
        shape = tuple(getattr(aval, "shape", ()))
        spec = tuple(spec) + (None,) * max(len(shape) - len(spec), 0)
        out = []
        for dim, entry in zip(shape, spec):
            extent = spmd.axis_size(mesh, entry)
            out.append(entry if extent == 1 or dim % extent == 0 else None)
        return P(*out)

    return tree_map_leaves(fix, avals, shardings)


def placements(spec: Spec, mesh) -> List[Any]:
    """``spec`` as DTensor placements, one a mesh dim: a mesh axis named in
    dim ``d``'s entry becomes ``Shard(d)``, every other ``Replicate()``.
    Several axes on one dim shard it in the mesh's row-major order, which
    is the spec's only when the entry names them in the mesh's order: an
    entry in another order (or an axis named twice) raises, naming the
    spec, since no plain ``Shard``s lay it out."""
    from torch.distributed.tensor import Replicate, Shard

    names = spmd.axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        at = [names.index(axis) for axis in entry]
        if at != sorted(at) or any(not isinstance(out[i], Replicate) for i in at):
            raise ValueError(f"spec {spec}: entry {entry} is not in the mesh's order {names} "
                             "(or repeats an axis); plain Shard placements cannot lay it out")
        for i in at:
            out[i] = Shard(dim)
    return out


def distribute_tree(tree: Any, layouts: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` (a
    ``DeviceMesh``) laid out by its spec of ``layouts`` after
    :func:`sanitize_shardings`.  Each rank cuts its own block out of the
    leaf it holds (no collective: every rank must hold the same full
    leaves, as SPMD ranks do); meta leaves give meta blocks."""
    from torch.distributed.tensor import distribute_tensor

    layouts = sanitize_shardings(layouts, tree, mesh)

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, placements(spec, mesh), src_data_rank=None)

    return tree_map_leaves(one, tree, layouts)


def is_dtensor(x) -> bool:
    """True for a DTensor (the dry run's partitioned steps; no card path
    makes one), told by its type's name, so no card path imports DTensor."""
    return type(x).__name__ == "DTensor" and isinstance(x, torch.Tensor)


def _span(mesh, axes, rows: int) -> Tuple[int, int]:
    parts = spmd.axis_size(mesh, axes)
    if rows % parts:
        raise ValueError(f"{rows} rows do not divide over {parts} shards of {axes}")
    size = rows // parts
    lo = spmd.axis_index(mesh, axes) * size
    return lo, lo + size


def block(x, spec: Spec, mesh, *, pad_rows: Optional[int] = None, fill=0):
    """This rank's block of the full table ``x`` under ``spec``.

    ``pad_rows`` treats dim 0 as padded with ``fill`` to that many rows
    first (the serving slabs): only this rank's rows are made, a view where
    they lie inside ``x``."""
    out = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        rows = out.shape[dim] if dim or pad_rows is None else pad_rows
        lo, hi = _span(mesh, axes, rows)
        start = min(lo, out.shape[dim])
        real = min(hi, out.shape[dim]) - start
        piece = out.narrow(dim, start, real) if isinstance(out, torch.Tensor) else \
            np.take(out, np.arange(start, start + real), axis=dim)
        if real < hi - lo:
            shape = list(out.shape)
            shape[dim] = hi - lo - real
            if isinstance(out, torch.Tensor):
                pad = torch.full(shape, fill, dtype=out.dtype, device=out.device)
                piece = torch.cat([piece, pad], dim=dim)
            else:
                piece = np.concatenate([piece, np.full(shape, fill, out.dtype)], axis=dim)
        out = piece
    return out


def assemble(x_blk: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full table from every rank's block under ``spec`` (one
    all-gather per sharded dim; every rank gets the whole table), always a
    new tensor: a block that is already whole is cloned."""
    out = x_blk
    for dim, axes in enumerate(spec):
        if axes is not None:
            out = spmd.all_gather(out, mesh, axes, dim=dim)
    return out.clone() if out is x_blk else out


# ---------------------------------------------------------------------------
# Transformers
# ---------------------------------------------------------------------------


def transformer_spec(parts, leaf) -> Spec:
    """The layout of one transformer parameter from its path: ``embed`` rows
    and ``lm_head`` columns over ``"model"``, the projections' output dims
    (``wq``, ``wk``, ``wv``, MLA's ``wk_b``, ``wv_b``, the MLP's ``wg``, ``wi``)
    and their biases over ``"model"``, the ``wo``s' input dims over
    ``"model"``, MoE experts over ``"model"`` (expert parallelism); MLA's
    ``wkv_a``, the router, norms and scalars replicated.  A stacked layer
    (under ``layers``) gets a leading None."""
    tp = "model"
    stacked = bool(parts) and parts[0] == "layers"
    name = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if name == "embed":
        spec = (tp, None)
    elif name == "lm_head":
        spec = (None, tp)
    elif name in ("wq", "wk", "wv", "wkv_a", "wk_b", "wv_b"):
        # wkv_a is small (d x (lora + rope)); splitting its output would
        # split the latent every head needs
        spec = (None, None) if name == "wkv_a" else (None, tp)
    elif name in ("bq", "bk", "bv"):
        spec = (tp,)
    elif name == "wo" and parent in ("attn", "mlp", "shared"):
        spec = (tp, None)
    elif parent == "moe" and name in ("wg", "wi", "wo"):
        spec = (tp, None, None)
    elif name in ("wg", "wi"):
        spec = (None, tp)
    elif name == "router":
        spec = (None, None)
    else:  # norms, scalars, biases of small layers
        spec = (None,) * len(getattr(leaf, "shape", ()))
    if stacked:
        spec = (None,) + tuple(spec)
    return P(*spec)


def transformer_param_shardings(params: Any, mesh) -> Any:
    """:func:`transformer_spec` over every leaf of a parameter tree."""
    return tree_shardings(params, transformer_spec, mesh)


def lm_batch_shardings(mesh) -> Dict[str, Spec]:
    """Layouts of an LM batch: tokens and labels, rows over the data axes."""
    dp = data_axes(mesh)
    return {"tokens": ns(mesh, dp, None), "labels": ns(mesh, dp, None)}


def decode_state_spec_fn(mesh, *, shard_seq: bool) -> Callable:
    """``spec_fn(parts, leaf)`` of a decode state's KV caches: batch over the
    data axes and KV heads over ``"model"``; with ``shard_seq`` (the batch-1
    long-context cells) the sequence over the data axes instead of the batch
    (SP decode).  Where the KV-head count does not divide over ``"model"``
    (qwen1.5's 20 heads on 16 ranks), the sequence is split over
    ``"model"`` (and the data axes with ``shard_seq``) instead of the heads:
    flash-decoding's split-S, not a replicated 107 GB cache.  Lengths and
    scalars replicated; the stacked caches have a leading None, the leading
    dense layers' (under ``first_caches``) not."""
    dp = data_axes(mesh)
    n_model = spmd.axis_size(mesh, "model")

    def spec_fn(parts, leaf) -> Spec:
        name = parts[-1]
        ndim = len(getattr(leaf, "shape", ()))
        if name == "length" or ndim == 0:
            return P()
        lead = () if "first_caches" in parts else (None,)
        body_ndim = ndim - len(lead)
        if body_ndim == 4:  # (B, S, KH, hd)
            if leaf.shape[-2] % n_model == 0:
                spec = (None, dp, "model", None) if shard_seq else (dp, None, "model", None)
            else:
                seq_axes = (dp + ("model",)) if shard_seq else ("model",)
                spec = (None, seq_axes, None, None) if shard_seq else (dp, seq_axes, None, None)
        elif body_ndim == 3:  # (B, S, lora or rope): MLA's latent, no head axis
            spec = (None, dp, None) if shard_seq else (dp, None, None)
        else:
            spec = (None,) * body_ndim
        return P(*(lead + tuple(spec)))

    return spec_fn


# ---------------------------------------------------------------------------
# MF (the paper's model)
# ---------------------------------------------------------------------------

_USER_FIELDS = ("p", "user_bias")
_ITEM_FIELDS = ("q", "item_bias", "implicit")


def mf_spec_fn(mesh) -> Callable:
    """``spec_fn(parts, leaf)``: user tables (and their optimizer state)
    over the data axes, item tables over ``"model"``, the rest replicated.
    ``parts`` is the leaf's path; its first MF field name decides.  The
    error-feedback residuals take the layouts of the sharded step's
    operands: ``ef_psum`` ``P(dp, "model")``, ``ef_gather`` ``P("model",
    dp)``."""
    dp = data_axes(mesh)

    def spec_fn(parts, leaf) -> Spec:
        ndim = len(getattr(leaf, "shape", ()))
        if parts and parts[-1] == "ef_psum":
            return P(dp, "model")
        if parts and parts[-1] == "ef_gather":
            return P("model", dp)
        field = next((x for x in parts if x in _USER_FIELDS + _ITEM_FIELDS), None)
        if field in _USER_FIELDS:
            return P(dp, None) if ndim == 2 else P(dp)
        if field in _ITEM_FIELDS:
            return P("model", None) if ndim == 2 else P("model")
        return P(*(None,) * ndim)

    return spec_fn


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

_REPLICATE_BELOW_ROWS = 8192  # small tables are cheaper replicated


def recsys_spec_fn(mesh) -> Callable:
    """``spec_fn(parts, leaf)`` of the recsys models: embedding tables
    (``tables/*``, ``item_embed``, FM's ``v``) of 8192 rows or more split
    their rows over every axis of the mesh, smaller ones replicated; FM's
    1-D linear ``w`` over the same rows as ``v``; everything else (MLPs,
    norms, blocks, 2-D ``w``s) replicated.  The reference's rules, quirks
    included."""
    flat = all_axes(mesh)

    def spec_fn(parts, leaf) -> Spec:
        ndim = len(getattr(leaf, "shape", ()))
        if "tables" in parts or parts[-1] in ("item_embed", "v"):
            if leaf.shape[0] >= _REPLICATE_BELOW_ROWS:
                return P(flat, None) if ndim == 2 else P(flat)
            return P(*(None,) * ndim)
        if parts[-1] == "w" and ndim == 1 and leaf.shape[0] >= _REPLICATE_BELOW_ROWS:
            return P(flat)  # FM linear term over the same rows as `v`
        return P(*(None,) * ndim)

    return spec_fn


def recsys_batch_shardings(mesh, batch: Dict[str, Any]) -> Dict[str, Spec]:
    """Layouts of a recsys batch: every column's rows over the data axes,
    scalars replicated."""
    dp = data_axes(mesh)

    def spec(arr) -> Spec:
        nd = len(getattr(arr, "shape", ()))
        return P() if nd == 0 else P(dp, *([None] * (nd - 1)))

    return {name: spec(arr) for name, arr in batch.items()}


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------


def gnn_spec_fn(mesh) -> Callable:
    """``spec_fn(parts, leaf)`` of the GAT: every weight replicated (they are
    tiny)."""
    del mesh

    def spec_fn(parts, leaf) -> Spec:
        return P(*(None,) * len(getattr(leaf, "shape", ())))

    return spec_fn


def gnn_batch_shardings(mesh) -> Dict[str, Spec]:
    """Layouts of a graph batch: nodes (features, labels) over the data axes,
    edges and their mask over every axis of the mesh."""
    flat = all_axes(mesh)
    dp = data_axes(mesh)
    return {
        "features": ns(mesh, dp, None),
        "edges": ns(mesh, flat, None),
        "edge_mask": ns(mesh, flat),
        "labels": ns(mesh, dp),
    }


def shard_tree(tree: Any, mesh, *, device=None, layouts: Any = None) -> Any:
    """This rank's blocks of every leaf of ``tree`` (full tables, numpy or
    torch) under ``layouts`` (a tree of specs shaped like ``tree``, such as
    a cell's ``in_shardings(mesh)``; default :func:`mf_spec_fn`'s), as new
    torch tensors on ``device`` (default: the leaf's own device; numpy on
    the CPU).  The port's counterpart of ``device_put`` with those
    shardings."""
    if layouts is None:
        layouts = tree_shardings(tree, mf_spec_fn(mesh), mesh)

    def one(leaf, spec):
        if not hasattr(leaf, "shape"):
            return leaf
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        blk = block(leaf, spec, mesh)
        if isinstance(blk, np.ndarray):
            blk = torch.from_numpy(np.array(blk))
        return blk.to(device if device is not None else blk.device, copy=True).contiguous()

    return tree_map_leaves(one, tree, layouts)


def assemble_tree(tree: Any, mesh, *, layouts: Any = None) -> Any:
    """The full tables of every leaf of a tree of blocks (the inverse of
    :func:`shard_tree`; every rank gets them).  Pass the ``layouts`` the
    blocks were cut with (default :func:`mf_spec_fn`'s, which reads no
    sizes): layouts computed from the blocks would see a block's rows."""
    if layouts is None:
        layouts = tree_shardings(tree, mf_spec_fn(mesh), mesh)

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return assemble(leaf, spec, mesh)

    return tree_map_leaves(one, tree, layouts)


def serving_row_multiple(mesh) -> int:
    """Batch sizes fed to the sharded serving program must be a multiple of
    the user-axis extent (each data shard takes an equal user slab)."""
    return spmd.axis_size(mesh, data_axes(mesh))


def serving_topk_specs(mesh):
    """``(in_specs, out_specs)`` of the sharded top-k over streaming tiles:
    user rows over the data axes (replicated on a mesh without them),
    catalog tiles over ``"model"``; outputs are (B, topk) rows sharded like
    the users (the model axis is reduced by the merge)."""
    dp = data_axes(mesh)
    user_spec = P(dp or None, None)
    in_specs = (user_spec, P("model", None, None), P("model", None), P("model"))
    return in_specs, (user_spec, user_spec)


def serving_topk_kernel_specs(mesh):
    """``(in_specs, out_specs)`` of the kernel-path sharded top-k: the raw
    user factor block, the replicated ``t_p``, and the padded catalog's
    ``q``, ``r_i`` and bias slabs, row-sharded over ``"model"``."""
    dp = data_axes(mesh)
    user_spec = P(dp or None, None)
    in_specs = (user_spec, P(), P("model", None), P("model", None), P("model", None))
    return in_specs, (user_spec, user_spec)


def mf_batch_shardings(mesh, has_hist: bool = False) -> Dict[str, Spec]:
    """Layouts of a rating batch: every column over the data axes."""
    dp = data_axes(mesh)
    out = {"user": P(dp), "item": P(dp), "rating": P(dp)}
    if has_hist:
        out["hist"] = P(dp, None)
    return out


def route_batch_to_owner_shards(
    users,
    items,
    ratings,
    *,
    num_users: int,
    n_dp: int,
    weight=None,
    pad_to_pow2: bool = False,
):
    """Reorder a rating batch to satisfy the owner-compute contract.

    ``mf.train_step_shard_map`` splits the batch positionally into ``n_dp``
    contiguous chunks and requires chunk ``s`` to hold only users owned by
    data shard ``s`` (``u // m_loc == s``).  This host-side router buckets
    the rows by owner and pads every bucket to a common length with
    weight-0 rows (user = the shard's first owned row, item 0, rating 0),
    inert under the step's weight gate.  ``pad_to_pow2`` rounds the
    per-shard length up to a power of two.  Returns a numpy batch dict with
    ``"weight"``; bitwise the reference's.
    """
    if num_users % n_dp:
        raise ValueError(
            f"num_users ({num_users}) must divide over {n_dp} data shards"
        )
    users = np.asarray(users, np.int32)
    items = np.asarray(items, np.int32)
    ratings = np.asarray(ratings, np.float32)
    if users.size and (users.min() < 0 or users.max() >= num_users):
        raise ValueError(
            f"user ids must lie in [0, {num_users}) — grow the tables first "
            f"(got range [{users.min()}, {users.max()}])"
        )
    m_loc = num_users // n_dp
    owner = users // m_loc
    buckets = [np.nonzero(owner == s)[0] for s in range(n_dp)]
    length = max(1, max(len(b) for b in buckets))
    if pad_to_pow2:
        length = 1 << (length - 1).bit_length()
    out = {
        "user": np.empty(n_dp * length, np.int32),
        "item": np.zeros(n_dp * length, np.int32),
        "rating": np.zeros(n_dp * length, np.float32),
        "weight": np.zeros(n_dp * length, np.float32),
    }
    for s, idx in enumerate(buckets):
        base = s * length
        out["user"][base : base + length] = s * m_loc  # inert padding rows
        out["user"][base : base + len(idx)] = users[idx]
        out["item"][base : base + len(idx)] = items[idx]
        out["rating"][base : base + len(idx)] = ratings[idx]
        out["weight"][base : base + len(idx)] = (
            1.0 if weight is None else np.asarray(weight, np.float32)[idx]
        )
    return out
