"""Cell machinery: an (architecture x input shape) cell bundles the step
function, its abstract arguments and the layout of each argument on a mesh.

Counterpart of ``repro/configs/base.py`` for the dpmf, LM (dense
transformers), recsys and GNN cells.  Three choices differ from the
reference, each forced by PyTorch:

* **Abstract arguments are meta tensors.**  The reference's
  ``jax.eval_shape`` becomes :func:`abstract_like`, which calls a model's
  ``init_*`` with ``device="meta"``: the tree, shapes and dtypes of the
  reference (int32 ids stay int32), no storage, so the full DLRM cell
  (96 GB of tables) builds in milliseconds.
* **Layouts are ``Spec`` trees.**  ``in_shardings(mesh)`` returns, where the
  reference returns ``NamedSharding`` trees, the same trees of ``Spec``
  tuples (``repro_torch.distributed.sharding``); the mesh is read only for
  its axis names and extents.
* **Steps update in place and run on the device of their arguments.**  A
  train cell's step writes its parameters (and optimizer state) in place
  under ``torch.no_grad()``, and a decode cell's step its KV caches (the
  port's counterpart of ``donate_argnums``).
  Serve cells that rank a catalog go through the ``pruned_topk`` kernel on
  CUDA and never build the (batch, catalog) score matrix the reference
  builds: :func:`streaming_topk_scores`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import microbatch_grads, value_and_grad
from repro_torch.kernels import ops as kops
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import Adam, Sgd

Tree = Any


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape_id: str
    kind: str  # train | prefill | decode | serve | retrieval
    step_fn: Callable
    abstract_args: Tuple
    in_shardings: Callable[[Any], Tuple]
    donate_argnums: Tuple[int, ...] = ()
    note: str = ""
    # arguments that a step which takes its mesh is given whole, not as
    # this rank's blocks (a batch it cuts its own chunk of)
    whole_args: Tuple[int, ...] = ()

    @property
    def cell_id(self) -> str:
        return f"{self.arch}::{self.shape_id}"


def abstract_like(fn: Callable, *args, **kwargs) -> Tree:
    """The tree ``fn`` makes, as meta tensors: ``fn(*args, device="meta",
    **kwargs)`` (the reference's ``jax.eval_shape``)."""
    return fn(*args, device="meta", **kwargs)


def abstract(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# LM transformer cells
# ---------------------------------------------------------------------------


def lm_train_cell(
    arch: str,
    shape_id: str,
    cfg: tfm.TransformerConfig,
    *,
    global_batch: int,
    seq_len: int,
    n_micro: int = 1,
    lr: float = 3e-4,
) -> CellSpec:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    next-token loss and its gradient over ``n_micro`` microbatches, then one
    Adam step written into ``params`` and ``opt_state`` in place."""
    optimizer = Adam(lr=lr)

    def loss_fn(params, batch):
        return tfm.lm_loss(params, batch, cfg)

    def step(params, opt_state, batch):
        loss, grads = microbatch_grads(loss_fn, params, batch, n_micro)
        params, opt_state = optimizer.apply(params, opt_state, grads)
        return params, opt_state, loss

    a_params = abstract_like(tfm.init_params, torch.Generator(), cfg)
    a_opt = optimizer.init(a_params)
    a_batch = {"tokens": abstract((global_batch, seq_len), torch.int32),
               "labels": abstract((global_batch, seq_len), torch.int32)}

    def in_shardings(mesh):
        p_sh = shd.transformer_param_shardings(a_params, mesh)
        o_sh = {"m": p_sh, "v": p_sh, "t": shd.replicated(mesh)}
        return (p_sh, o_sh, shd.lm_batch_shardings(mesh))

    return CellSpec(
        arch=arch,
        shape_id=shape_id,
        kind="train",
        step_fn=step,
        abstract_args=(a_params, a_opt, a_batch),
        in_shardings=in_shardings,
        donate_argnums=(0, 1),
    )


def lm_prefill_cell(
    arch: str,
    shape_id: str,
    cfg: tfm.TransformerConfig,
    *,
    global_batch: int,
    seq_len: int,
) -> CellSpec:
    """``step(params, tokens) -> (B, V)`` logits of the last position
    (``transformer.prefill``), without autograd."""

    def step(params, tokens):
        with torch.no_grad():
            return tfm.prefill(params, tokens, cfg)

    a_params = abstract_like(tfm.init_params, torch.Generator(), cfg)

    def in_shardings(mesh):
        return (shd.transformer_param_shardings(a_params, mesh),
                shd.ns(mesh, shd.data_axes(mesh), None))

    return CellSpec(
        arch=arch,
        shape_id=shape_id,
        kind="prefill",
        step_fn=step,
        abstract_args=(a_params, abstract((global_batch, seq_len), torch.int32)),
        in_shardings=in_shardings,
    )


def lm_decode_cell(
    arch: str,
    shape_id: str,
    cfg: tfm.TransformerConfig,
    *,
    global_batch: int,
    kv_len: int,
    shard_seq: bool = False,
    note: str = "",
) -> CellSpec:
    """``step(params, state, tokens) -> (logits (B, V), state)``: one token a
    sequence against a ``kv_len`` cache (the abstract state holds ``kv_len -
    1`` positions), the caches written in place.  ``shard_seq`` lays the KV
    sequence axis over the data axes instead of the batch (the batch-1
    long-context cells)."""

    def step(params, state, tokens):
        return tfm.decode_step(params, tokens, state, cfg)

    a_params = abstract_like(tfm.init_params, torch.Generator(), cfg)
    a_state = abstract_like(tfm.init_decode_state, cfg, global_batch, kv_len,
                            length=kv_len - 1)

    def in_shardings(mesh):
        state_sh = shd.tree_shardings(
            a_state, shd.decode_state_spec_fn(mesh, shard_seq=shard_seq), mesh)
        tokens_sh = shd.ns(mesh, None, None) if shard_seq else shd.ns(
            mesh, shd.data_axes(mesh), None)
        return (shd.transformer_param_shardings(a_params, mesh), state_sh, tokens_sh)

    return CellSpec(
        arch=arch,
        shape_id=shape_id,
        kind="decode",
        step_fn=step,
        abstract_args=(a_params, a_state, abstract((global_batch, 1), torch.int32)),
        in_shardings=in_shardings,
        donate_argnums=(1,),
        note=note,
    )


LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def lm_cells(arch: str, cfg: tfm.TransformerConfig) -> Dict[str, Callable[[], CellSpec]]:
    return {
        "train_4k": lambda: lm_train_cell(arch, "train_4k", cfg, global_batch=256, seq_len=4096),
        "prefill_32k": lambda: lm_prefill_cell(arch, "prefill_32k", cfg, global_batch=32,
                                               seq_len=32768),
        "decode_32k": lambda: lm_decode_cell(arch, "decode_32k", cfg, global_batch=128,
                                             kv_len=32768),
        "long_500k": lambda: lm_decode_cell(
            arch,
            "long_500k",
            cfg,
            global_batch=1,
            kv_len=524288,
            shard_seq=True,
            note=(
                "long-context decode is O(L) (one query vs cached KV) — "
                "runnable with full attention; KV sequence axis sharded (SP)."
            ),
        ),
    }


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def gnn_train_cell(
    arch: str,
    shape_id: str,
    cfg: gnn_lib.GATConfig,
    *,
    num_nodes: int,
    num_edges: int,
    with_edge_mask: bool = False,
    lr: float = 5e-3,
    note: str = "",
    pad_multiple: int = 512,
) -> CellSpec:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    GAT's masked cross entropy and its gradient by autograd, then one Adam
    step written into ``params`` and ``opt_state`` in place.  Node and edge
    counts are padded to a multiple of ``pad_multiple`` so both stay
    shardable; padding forces ``edge_mask`` (padded nodes carry label -1,
    padded edges mask 0: the layout ``data/graphs.py`` makes)."""
    if num_nodes % pad_multiple or num_edges % pad_multiple:
        num_nodes += (-num_nodes) % pad_multiple
        num_edges += (-num_edges) % pad_multiple
        with_edge_mask = True
    optimizer = Adam(lr=lr)

    def loss_fn(params, batch):
        return gnn_lib.loss_fn(params, batch, cfg)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = optimizer.apply(params, opt_state, grads)
        return params, opt_state, loss

    a_params = abstract_like(gnn_lib.init_params, torch.Generator(), cfg)
    a_opt = optimizer.init(a_params)
    a_batch = {
        "features": abstract((num_nodes, cfg.d_feat), torch.float32),
        "edges": abstract((num_edges, 2), torch.int32),
        "labels": abstract((num_nodes,), torch.int32),
    }
    if with_edge_mask:
        a_batch["edge_mask"] = abstract((num_edges,), torch.float32)

    def in_shardings(mesh):
        p_sh = shd.tree_shardings(a_params, shd.gnn_spec_fn(mesh), mesh)
        o_sh = {"m": p_sh, "v": p_sh, "t": shd.replicated(mesh)}
        b_all = shd.gnn_batch_shardings(mesh)
        return (p_sh, o_sh, {key: b_all[key] for key in a_batch})

    return CellSpec(
        arch=arch,
        shape_id=shape_id,
        kind="train",
        step_fn=step,
        abstract_args=(a_params, a_opt, a_batch),
        in_shardings=in_shardings,
        donate_argnums=(0, 1),
        note=note,
    )


# ---------------------------------------------------------------------------
# RecSys cells (shared step builders)
# ---------------------------------------------------------------------------

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def _recsys_layouts(a_params: Tree, batch_specs: Dict[str, torch.Tensor]):
    def in_shardings(mesh):
        p_sh = shd.tree_shardings(a_params, shd.recsys_spec_fn(mesh), mesh)
        return (p_sh, shd.recsys_batch_shardings(mesh, batch_specs))

    return in_shardings


def recsys_train_cell(
    arch: str,
    shape_id: str,
    *,
    init_fn: Callable,
    loss_fn: Callable,
    batch_specs: Dict[str, torch.Tensor],
    lr: float = 1e-2,
    note: str = "",
) -> CellSpec:
    """``step(params, batch) -> (params, loss)``: the loss and its gradient
    by autograd, then one plain SGD step (MLPerf DLRM trains its embeddings
    with plain SGD) written into ``params`` in place.  ``init_fn(generator,
    device=None)`` makes the parameters."""
    optimizer = Sgd(lr=lr)

    def step(params, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, _ = optimizer.apply(params, {}, grads)
        return params, loss

    a_params = abstract_like(init_fn, torch.Generator())
    return CellSpec(
        arch=arch,
        shape_id=shape_id,
        kind="train",
        step_fn=step,
        abstract_args=(a_params, batch_specs),
        in_shardings=_recsys_layouts(a_params, batch_specs),
        donate_argnums=(0,),
        note=note,
    )


def recsys_serve_cell(
    arch: str,
    shape_id: str,
    *,
    init_fn: Callable,
    forward_fn: Callable,
    batch_specs: Dict[str, torch.Tensor],
    kind: str = "serve",
    note: str = "",
) -> CellSpec:
    """``step(params, batch) = forward_fn(params, batch)``, without autograd."""
    a_params = abstract_like(init_fn, torch.Generator())

    def step(params, batch):
        with torch.no_grad():
            return forward_fn(params, batch)

    return CellSpec(
        arch=arch,
        shape_id=shape_id,
        kind=kind,
        step_fn=step,
        abstract_args=(a_params, batch_specs),
        in_shardings=_recsys_layouts(a_params, batch_specs),
        note=note,
    )


def streaming_topk_plain(h: torch.Tensor, table: torch.Tensor, *, k: int,
                          chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's loop: each chunk's (B, chunk) scores merged into the
    running top-k by a stable sort, so ties go to the lower item index."""
    b = h.shape[0]
    best_s = torch.full((b, k), float("-inf"), dtype=h.dtype, device=h.device)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=h.device)
    for idx in range(table.shape[0] // chunk):
        scores = torch.matmul(h, table[idx * chunk:(idx + 1) * chunk].T)
        ids = idx * chunk + torch.arange(chunk, dtype=torch.int32, device=h.device)
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids[None].expand(b, chunk)], dim=1)
        pos = torch.sort(cat_s, dim=1, descending=True, stable=True).indices[:, :k]
        best_s, best_i = torch.gather(cat_s, 1, pos), torch.gather(cat_i, 1, pos)
    return best_s, best_i


def streaming_topk_scores(
    h: torch.Tensor,      # (B, d) user states
    table: torch.Tensor,  # (V, d) item embeddings
    *,
    k: int = 100,
    chunk: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Catalog-scale retrieval: the top-``k`` dot products of each user state
    against the item table, ties to the lower item index; scores float32,
    ids int32.  Only the first ``max(V // chunk, 1) * chunk`` rows are
    scored (the reference's chunking drops the rest; a table of fewer than
    ``chunk`` rows raises, as the reference's slice does).

    On CUDA this is one ``pruned_topk`` launch at thresholds 0 (every rank
    full), which never holds more than the kernel's tiles; a failing kernel
    raises.  On the CPU it is the reference's loop over ``chunk``-row
    slices with a stable merge (peak memory (B, chunk))."""
    v = table.shape[0]
    rows = max(v // chunk, 1) * chunk
    if rows > v:
        raise ValueError(f"the table has {v} rows, fewer than one {chunk}-row chunk")
    if h.device.type == "cpu":
        return streaming_topk_plain(h, table[:rows], k=k, chunk=chunk)
    return kops.pruned_topk(h, table[:rows], 0.0, 0.0, k, device=h.device)
