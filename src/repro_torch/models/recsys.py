"""RecSys models: FM, DLRM (MLPerf config), SASRec and BST, with the paper's
dynamic pruning on their latent interactions.

Counterpart of ``repro/models/recsys.py``.  Every latent interaction (FM's
pairwise term, DLRM's dot interaction, SASRec's retrieval scores) runs
through thresholds and effective ranks, and rate 0 is exactly the dense
model.  ``fm_retrieval`` and ``sasrec_retrieval`` score through
``kernels.ops.pruned_matmul``: the CUDA kernel on the card, its plain
version on the CPU.

Parameters are plain dicts (and lists) of tensors with the reference's keys;
:func:`recsys_params_from_numpy` carries a reference tree across, so both
packages compute the same thing from the same weights.  The ``init_*``
functions draw from one explicit ``torch.Generator`` in a fixed order; the
draws differ from ``jax.random``'s for the same seed.

The losses are differentiated by autograd.  None runs a kernel (the
reference takes ``jax.grad`` through the rank mask and its ``einsum``s), and
attention is plain ``matmul`` and ``softmax`` with the reference's float32
``-1e30`` mask, so the masking and the arithmetic stay the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ranks import effective_ranks, rank_mask
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.scatter import add_rows
from repro_torch.models.layers import dense

Params = Dict[str, Any]

# Criteo-1TB per-field cardinalities as used by the MLPerf DLRM benchmark.
MLPERF_CRITEO_VOCABS: Tuple[int, ...] = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


def recsys_params_from_numpy(tree, device: DeviceLike = None):
    """A reference parameter tree (nested dicts and lists of numpy arrays)
    as tensors on ``device``, keys and nesting kept; the tensors are copies."""
    if isinstance(tree, dict):
        return {key: recsys_params_from_numpy(value, device) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [recsys_params_from_numpy(value, device) for value in tree]
    return torch.as_tensor(np.array(tree, copy=True)).to(resolve_device(device))


def recsys_params_to_numpy(tree):
    """The inverse of :func:`recsys_params_from_numpy`: numpy arrays on the host."""
    if isinstance(tree, dict):
        return {key: recsys_params_to_numpy(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [recsys_params_to_numpy(value) for value in tree]
    return tree.detach().cpu().numpy()


class _BagSum(torch.autograd.Function):
    """Segment sum in batch order (``add_rows`` into zeros); its gradient is
    the gather of the bags' gradients."""

    @staticmethod
    def forward(ctx, rows, segment_ids, num_bags):
        ctx.save_for_backward(segment_ids)
        out = rows.new_zeros((num_bags,) + tuple(rows.shape[1:]))
        return add_rows(out, segment_ids, rows.contiguous())

    @staticmethod
    def backward(ctx, grad):
        (segment_ids,) = ctx.saved_tensors
        return grad[segment_ids], None, None


def embedding_bag(
    table: torch.Tensor,        # (V, d)
    values: torch.Tensor,       # (nnz,) flat ids
    segment_ids: torch.Tensor,  # (nnz,) bag index per id
    num_bags: int,
    *,
    combiner: str = "sum",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``torch.nn.EmbeddingBag``'s function written out: a ragged gather and
    a segment reduction.  ``sum`` and ``mean`` add each bag's rows in batch
    order (``add_rows``: the batch-order kernel on the card); ``max`` is
    ``scatter_reduce``'s ``amax``, whose result has no order, with an empty
    bag at ``-inf`` as ``jax.ops.segment_max`` leaves it."""
    rows = table[values]
    if weights is not None:
        rows = rows * weights[:, None]
    segment_ids = segment_ids.long()
    if combiner in ("sum", "mean"):
        sums = _BagSum.apply(rows, segment_ids, num_bags)
        if combiner == "sum":
            return sums
        counts = torch.bincount(segment_ids, minlength=num_bags).float()
        return sums / torch.clamp(counts, min=1.0)[:, None]
    if combiner == "max":
        out = torch.full((num_bags,) + tuple(rows.shape[1:]), float("-inf"), dtype=rows.dtype,
                         device=rows.device)
        index = segment_ids.reshape((-1,) + (1,) * (rows.dim() - 1)).expand_as(rows)
        return out.scatter_reduce(0, index, rows, reduce="amax", include_self=True)
    raise ValueError(f"unknown combiner {combiner!r}")


def _mask_by_rank(rows: torch.Tensor, threshold) -> torch.Tensor:
    """Zero each row's suffix from its first insignificant factor (Alg. 2)."""
    r = effective_ranks(rows.detach(), threshold)
    return rows * rank_mask(r, rows.shape[-1], rows.dtype)


def _bce(logits: torch.Tensor, labels) -> torch.Tensor:
    """Binary cross-entropy on logits, in the reference's stable form."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _draw(generator, shape, scale, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)


def _init_mlp(generator, dims: Sequence[int], dtype, device) -> list:
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        scale = (2.0 / (d_in + d_out)) ** 0.5
        layers.append({"w": _draw(generator, (d_in, d_out), scale, dtype, device),
                       "b": torch.zeros((d_out,), dtype=dtype, device=device)})
    return layers


def _run_mlp(x: torch.Tensor, layers: list, *, final_act: bool = False) -> torch.Tensor:
    for idx, layer in enumerate(layers):
        x = dense(x, layer["w"], layer["b"])
        if idx < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# FM: Rendle ICDM'10, the O(nk) sum-square form; pruning is first-class here.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_fields: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    dtype: Any = torch.float32

    @property
    def total_vocab(self) -> int:
        return self.n_fields * self.vocab_per_field

    def field_offsets(self) -> np.ndarray:
        return (np.arange(self.n_fields) * self.vocab_per_field).astype(np.int32)


def init_fm_params(generator: torch.Generator, cfg: FMConfig,
                   device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    return {
        "w0": torch.zeros((), dtype=cfg.dtype, device=dev),
        "w": torch.zeros((cfg.total_vocab,), dtype=cfg.dtype, device=dev),
        "v": _draw(generator, (cfg.total_vocab, cfg.embed_dim), 0.01, cfg.dtype, dev),
    }


def _offsets(cfg: FMConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(cfg.field_offsets(), dtype=torch.int64, device=like.device)


def fm_forward(params: Params, ids: torch.Tensor, cfg: FMConfig, t_v=0.0) -> torch.Tensor:
    """Logit per example from ``ids`` (B, F), per-field local ids.  With
    ``t_v > 0`` every pairwise term <v_i, v_j> stops at min(rank_i, rank_j):
    masking each row by its own rank makes the sum-square identity compute
    exactly the paper's early-stopped sum."""
    flat = ids.long() + _offsets(cfg, ids)[None, :]
    rows = _mask_by_rank(params["v"][flat.reshape(-1)], t_v)
    rows = rows.reshape(ids.shape[0], cfg.n_fields, cfg.embed_dim)
    s = torch.sum(rows, dim=1)             # (B, k)
    ss = torch.sum(rows * rows, dim=1)     # (B, k)
    pairwise = 0.5 * torch.sum(s * s - ss, dim=-1)
    linear = torch.sum(params["w"][flat.reshape(-1)].reshape(ids.shape), dim=1)
    return (params["w0"] + linear + pairwise).float()


def fm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: FMConfig, t_v=0.0):
    logits = fm_forward(params, batch["ids"], cfg, t_v)
    return torch.mean(_bce(logits, batch["label"].float()))


def _fm_context(params: Params, user_ids: torch.Tensor, cfg: FMConfig, t_v=0.0):
    """``(s_u, const_u)`` of B contexts: the sum of the context fields'
    rank-masked factors, and the context's own pairwise, linear and global
    terms."""
    offsets = _offsets(cfg, user_ids)
    n_ctx = user_ids.shape[1]
    flat_u = user_ids.long() + offsets[None, :n_ctx]
    rows_u = _mask_by_rank(params["v"][flat_u.reshape(-1)], t_v).reshape(
        user_ids.shape[0], n_ctx, cfg.embed_dim)
    s_u = torch.sum(rows_u, dim=1)  # (B, k)
    ss_u = torch.sum(rows_u * rows_u, dim=1)
    const_u = (
        0.5 * torch.sum(s_u * s_u - ss_u, dim=-1)
        + torch.sum(params["w"][flat_u.reshape(-1)].reshape(user_ids.shape), dim=1)
        + params["w0"]
    )
    return s_u, const_u


def fm_retrieval(
    params: Params,
    user_ids: torch.Tensor,   # (B, F-1) context fields
    cand_ids: torch.Tensor,   # (C,) candidate ids of the item field (field F-1)
    cfg: FMConfig,
    t_v=0.0,
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Score B contexts against C candidate items: score(u, c) = const(u) +
    w_c + <s_u, v_c>, with s_u the sum of the context fields' factors, so
    the candidates are one (B, k) x (C, k) pruned product
    (``kops.pruned_matmul``; ``use_kernel=False`` takes the dense product of
    the rank-masked rows)."""
    s_u, const_u = _fm_context(params, user_ids, cfg, t_v)
    offsets = _offsets(cfg, user_ids)
    flat_c = cand_ids.long() + offsets[user_ids.shape[1]]
    v_c = params["v"][flat_c]  # (C, k)
    if use_kernel:
        cross = kops.pruned_matmul(s_u, v_c, 0.0, t_v, device=s_u.device)
    else:
        cross = torch.matmul(s_u, _mask_by_rank(v_c, t_v).T)
    w_c = params["w"][flat_c]
    return (const_u[:, None] + cross + w_c[None, :]).float()


# ---------------------------------------------------------------------------
# DLRM: the MLPerf config; the dot interaction runs on rank-masked embeddings.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    embed_dim: int = 128
    vocab_sizes: Tuple[int, ...] = MLPERF_CRITEO_VOCABS
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def init_dlrm_params(generator: torch.Generator, cfg: DLRMConfig,
                     device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    tables = [_draw(generator, (vocab, cfg.embed_dim), vocab ** -0.5, cfg.dtype, dev)
              for vocab in cfg.vocab_sizes]
    top_in = cfg.bot_mlp[-1] + cfg.n_interact
    return {
        "tables": tables,
        "bot": _init_mlp(generator, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype, dev),
        "top": _init_mlp(generator, (top_in,) + cfg.top_mlp, cfg.dtype, dev),
    }


def dlrm_forward(
    params: Params,
    dense_feats: torch.Tensor,  # (B, 13)
    sparse_ids: torch.Tensor,   # (B, 26)
    cfg: DLRMConfig,
    t_v=0.0,
) -> torch.Tensor:
    d_vec = _run_mlp(dense_feats, params["bot"], final_act=True)  # (B, d)
    sparse_ids = sparse_ids.long()
    emb = torch.stack([table[sparse_ids[:, idx]] for idx, table in enumerate(params["tables"])],
                      dim=1)  # (B, 26, d)
    # the paper's technique prunes the embedding rows' suffixes; the bottom
    # MLP's vector is not a factor-table row and stays dense
    emb = _mask_by_rank(emb.reshape(-1, cfg.embed_dim), t_v).reshape(emb.shape)
    z = torch.cat([d_vec[:, None, :], emb], dim=1)  # (B, 27, d)
    inter = torch.bmm(z, z.transpose(1, 2))
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], offset=1, device=z.device)
    flat = inter[:, iu, ju]  # (B, 351), the reference's triu_indices order
    top_in = torch.cat([d_vec, flat.to(d_vec.dtype)], dim=-1)
    return _run_mlp(top_in, params["top"])[:, 0].float()


def dlrm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: DLRMConfig, t_v=0.0):
    logits = dlrm_forward(params, batch["dense"], batch["sparse"], cfg, t_v)
    return torch.mean(_bce(logits, batch["label"].float()))


def dlrm_retrieval(
    params: Params,
    dense_feats: torch.Tensor,  # (1, 13) one user context
    sparse_ids: torch.Tensor,   # (1, 26) the user's categorical ids
    cand_ids: torch.Tensor,     # (C,) candidates for the item field (field 0)
    cfg: DLRMConfig,
    t_v=0.0,
) -> torch.Tensor:
    """Score one context against C candidate items by swapping field 0."""
    c = cand_ids.shape[0]
    dense_rep = dense_feats.expand(c, cfg.n_dense)
    sparse_rep = sparse_ids.long().expand(c, cfg.n_sparse).clone()
    sparse_rep[:, 0] = cand_ids
    return dlrm_forward(params, dense_rep, sparse_rep, cfg, t_v)


# ---------------------------------------------------------------------------
# SASRec: self-attentive sequential recommendation.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dropout: float = 0.0
    dtype: Any = torch.float32


def _init_blocks(generator, n_blocks: int, d: int, d_ffn: int, dtype, dev) -> list:
    blocks = []
    for _ in range(n_blocks):
        s = d ** -0.5
        blocks.append({
            "wq": _draw(generator, (d, d), s, dtype, dev),
            "wk": _draw(generator, (d, d), s, dtype, dev),
            "wv": _draw(generator, (d, d), s, dtype, dev),
            "wo": _draw(generator, (d, d), s, dtype, dev),
            "ffn_w1": _draw(generator, (d, d_ffn), s, dtype, dev),
            "ffn_b1": torch.zeros((d_ffn,), dtype=dtype, device=dev),
            "ffn_w2": _draw(generator, (d_ffn, d), d_ffn ** -0.5, dtype, dev),
            "ffn_b2": torch.zeros((d,), dtype=dtype, device=dev),
            "ln1": torch.ones((d,), dtype=dtype, device=dev),
            "ln1_b": torch.zeros((d,), dtype=dtype, device=dev),
            "ln2": torch.ones((d,), dtype=dtype, device=dev),
            "ln2_b": torch.zeros((d,), dtype=dtype, device=dev),
        })
    return blocks


def init_sasrec_params(generator: torch.Generator, cfg: SASRecConfig,
                       device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    d = cfg.embed_dim
    return {
        # row 0 is the padding item
        "item_embed": _draw(generator, (cfg.n_items + 1, d), 0.01, cfg.dtype, dev),
        "pos_embed": _draw(generator, (cfg.seq_len, d), 0.01, cfg.dtype, dev),
        "blocks": _init_blocks(generator, cfg.n_blocks, d, d, cfg.dtype, dev),
        "ln_f": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "ln_f_b": torch.zeros((d,), dtype=cfg.dtype, device=dev),
    }


def _ln(x, scale, bias, eps=1e-6):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _block(x: torch.Tensor, blk: Params, attn_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """One pre-norm transformer block; ``attn_mask`` (B, S, S) keeps a key."""
    b, s, _ = x.shape
    h = _ln(x, blk["ln1"], blk["ln1_b"])
    # (B, H, S, hd), as the reference's (B, S, H, hd) with heads in front
    q, k, v = (dense(h, blk[w]).reshape(b, s, n_heads, -1).transpose(1, 2)
               for w in ("wq", "wk", "wv"))
    scores = torch.matmul(q, k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    scores = torch.where(attn_mask[:, None], scores.float(),
                         torch.tensor(-1e30, dtype=torch.float32, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    att = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
    x = x + dense(att, blk["wo"])
    h = _ln(x, blk["ln2"], blk["ln2_b"])
    f = torch.relu(dense(h, blk["ffn_w1"], blk["ffn_b1"]))
    return x + dense(f, blk["ffn_w2"], blk["ffn_b2"])


def sasrec_encode(params: Params, seq: torch.Tensor, cfg: SASRecConfig) -> torch.Tensor:
    """``seq`` (B, S) item ids (0 = pad) -> hidden states (B, S, d)."""
    seq = seq.long()
    s = seq.shape[1]
    x = params["item_embed"][seq] * (cfg.embed_dim ** 0.5)
    x = x + params["pos_embed"][None, :s]
    pad = seq == 0
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=seq.device))
    attn_mask = causal[None] & ~pad[:, None, :]  # (B, S, S)
    for blk in params["blocks"]:
        x = _block(x, blk, attn_mask, cfg.n_heads)
    x = _ln(x, params["ln_f"], params["ln_f_b"])
    return x * (~pad)[..., None]


def sasrec_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: SASRecConfig):
    """BCE over (positive, sampled negative) next items, as in the paper."""
    h = sasrec_encode(params, batch["seq"], cfg)  # (B, S, d)
    pos = params["item_embed"][batch["pos"].long()]
    neg = params["item_embed"][batch["neg"].long()]
    pos_logit = torch.sum(h * pos, dim=-1)
    neg_logit = torch.sum(h * neg, dim=-1)
    mask = (batch["pos"] > 0).float()
    per_tok = _bce(pos_logit, 1.0) + _bce(neg_logit, 0.0)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def sasrec_retrieval(
    params: Params,
    seq: torch.Tensor,  # (B, S)
    cfg: SASRecConfig,
    t_v=0.0,
    *,
    use_kernel: bool = True,
    cand_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Final-state retrieval scores against all (or C candidate) items: the
    latent dot product where the paper's pruning applies
    (``kops.pruned_matmul``; ``use_kernel=False`` takes the dense product of
    the rank-masked rows)."""
    h = sasrec_encode(params, seq, cfg)[:, -1]  # (B, d)
    table = params["item_embed"]
    if cand_ids is not None:
        table = table[cand_ids.long()]
    if use_kernel:
        return kops.pruned_matmul(h, table, 0.0, t_v, device=h.device)
    return torch.matmul(h, _mask_by_rank(table, t_v).T)


# ---------------------------------------------------------------------------
# BST: Behavior Sequence Transformer (Alibaba).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 1_000_000
    embed_dim: int = 32
    seq_len: int = 20            # history; the target item is appended
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    n_profile: int = 16          # dense user-profile features
    dtype: Any = torch.float32


def init_bst_params(generator: torch.Generator, cfg: BSTConfig,
                    device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    d = cfg.embed_dim
    total_seq = cfg.seq_len + 1
    mlp_in = total_seq * d + cfg.n_profile
    return {
        "item_embed": _draw(generator, (cfg.n_items + 1, d), 0.01, cfg.dtype, dev),
        "pos_embed": _draw(generator, (total_seq, d), 0.01, cfg.dtype, dev),
        "blocks": _init_blocks(generator, cfg.n_blocks, d, 4 * d, cfg.dtype, dev),
        "mlp": _init_mlp(generator, (mlp_in,) + cfg.mlp_dims + (1,), cfg.dtype, dev),
    }


def bst_forward(
    params: Params,
    hist: torch.Tensor,     # (B, S) history item ids (0 = pad)
    target: torch.Tensor,   # (B,) target item id
    profile: torch.Tensor,  # (B, n_profile) dense user features
    cfg: BSTConfig,
) -> torch.Tensor:
    b = hist.shape[0]
    seq = torch.cat([hist.long(), target.long()[:, None]], dim=1)  # (B, S+1)
    s = seq.shape[1]
    x = params["item_embed"][seq] + params["pos_embed"][None, :s]
    pad = seq == 0
    attn_mask = (~pad[:, None, :]).expand(b, s, s)  # bidirectional over (hist, target)
    for blk in params["blocks"]:
        x = _block(x, blk, attn_mask, cfg.n_heads)
    flat = x.reshape(b, -1)
    mlp_in = torch.cat([flat, profile.to(flat.dtype)], dim=-1)
    return _run_mlp(mlp_in, params["mlp"])[:, 0].float()


def bst_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: BSTConfig):
    logits = bst_forward(params, batch["hist"], batch["target"], batch["profile"], cfg)
    return torch.mean(_bce(logits, batch["label"].float()))
