"""Effective ranks: the vectorized form of the paper's early stopping.

Counterpart of ``repro/core/ranks.py``.  Algorithms 2/3 scan ``t = 1..k`` and
break at the first ``t`` with ``|p_{u,t}| < T_p`` or ``|q_{t,i}| < T_q``:

    r_u = first insignificant index of row u (k if none)
    r_i = first insignificant index of row i (k if none)

so the early-stopped dot product is exactly ``sum_{t < min(r_u, r_i)}``.
"""
from __future__ import annotations

import torch

# Rows reduced per step of :func:`effective_ranks`: bounds the int32 scratch
# to ~512 MiB at k = 128, so the ranks of a 10M-row catalog fit beside it.
_RANK_CHUNK_ROWS = 1 << 20


def _threshold(threshold, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(threshold, dtype=torch.float32, device=like.device)


def effective_ranks(rows: torch.Tensor, threshold) -> torch.Tensor:
    """First-insignificant index per row of ``rows`` (..., k) -> (...,) int32.

    Written as ``where(|v| < T, iota, k).min(-1)``: ``torch.argmax`` takes
    no bool input.  ``threshold == 0`` disables pruning (no ``|v| < 0``), so
    every rank is k.
    """
    k = rows.shape[-1]
    t = _threshold(threshold, rows)
    flat = rows.reshape(-1, k)
    iota = torch.arange(k, dtype=torch.int32, device=rows.device)
    out = torch.empty(flat.shape[0], dtype=torch.int32, device=rows.device)
    for lo in range(0, flat.shape[0], _RANK_CHUNK_ROWS):
        blk = flat[lo : lo + _RANK_CHUNK_ROWS]
        cand = torch.where(blk.float().abs() < t, iota, k)
        out[lo : lo + blk.shape[0]] = cand.amin(dim=-1) if k else 0
    return out.reshape(rows.shape[:-1])


def pair_rank(r_u: torch.Tensor, r_i: torch.Tensor) -> torch.Tensor:
    """k_eff(u, i): broadcastable min of the two ranks."""
    return torch.minimum(r_u, r_i)


def rank_mask(ranks: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """(...,) ranks -> (..., k) 0/1 mask selecting the computed prefix."""
    iota = torch.arange(k, dtype=torch.int32, device=ranks.device)
    return (iota < ranks[..., None]).to(dtype)


def mask_rows(rows: torch.Tensor, threshold) -> torch.Tensor:
    """Zero the suffix starting at each row's first insignificant factor
    (significant factors after it too, as the paper's ``break`` skips them)."""
    r = effective_ranks(rows, threshold)
    return rows * rank_mask(r, rows.shape[-1], rows.dtype)


def pruned_pair_dot(p_rows, q_rows, t_p, t_q) -> torch.Tensor:
    """Batched Alg. 2: early-stopped dot of paired rows (B, k) x (B, k) -> (B,)."""
    return torch.sum(mask_rows(p_rows, t_p) * mask_rows(q_rows, t_q), dim=-1)


def work_fraction(r_u: torch.Tensor, r_i: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of the dense k-MACs actually executed for a batch of pairs."""
    return pair_rank(r_u, r_i).float().mean() / float(k)


def sparsity_per_dim(matrix: torch.Tensor, threshold) -> torch.Tensor:
    """Per-latent-dim insignificance fraction (paper Figs. 3/5/8)."""
    t = _threshold(threshold, matrix)
    return (matrix.float().abs() < t).float().mean(dim=0)
