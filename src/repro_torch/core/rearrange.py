"""Feature-matrix rearrangement by joint sparsity (paper §4.3, Alg. 1).

Counterpart of ``repro/core/rearrange.py``.  P and Q share the latent axis,
so permuting that axis of both with the same permutation leaves every inner
product unchanged.  Algorithm 1 sorts the latent dims by ascending joint
sparsity

    JS_t = prob(|P[:, t]| < T_p) * prob(|Q[:, t]| < T_q)        (Eq. 10)

so the dense dims land at small indices, where early stopping keeps them.
The permutation is a stable ascending argsort (the paper's O(k^2) swap sort
gives the same order).

At the dpmf size ``|p| < T`` over the whole user table would be a 12.8 GB
bool tensor (51.2 GB as float), and ``p[:, perm]`` a second 51.2 GB table,
so both passes walk the rows in chunks: the sparsity counts are exact
integers summed per chunk, and the permutation is written back in place.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

import torch

CHUNK_ROWS = 1 << 20  # rows per chunk: (2^20, 128) f32 is 512 MiB


class RearrangeResult(NamedTuple):
    perm: torch.Tensor            # (k,) int32, new position -> old latent index
    joint_sparsity: torch.Tensor  # (k,) float32, ascending after applying perm


def sparsity(matrix: torch.Tensor, threshold, *, chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """Per-dim fraction of ``|matrix| < threshold``: (k,) float32, reduced
    over row chunks with exact integer counts."""
    rows, k = matrix.shape
    t = torch.as_tensor(threshold, dtype=torch.float32, device=matrix.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=matrix.device)
    for lo in range(0, rows, chunk_rows):
        counts += (matrix[lo : lo + chunk_rows].float().abs() < t).sum(dim=0)
    # times the float32 reciprocal, which is how the reference's mean rounds
    return counts.float() * torch.full((k,), 1.0 / max(rows, 1), device=matrix.device)


def joint_sparsity(p_matrix, q_matrix, t_p, t_q, *, chunk_rows: int = CHUNK_ROWS):
    """Eq. 10 under the independence assumption stated in the paper."""
    return (sparsity(p_matrix, t_p, chunk_rows=chunk_rows)
            * sparsity(q_matrix, t_q, chunk_rows=chunk_rows))


def rearrangement(p_matrix, q_matrix, t_p, t_q, *, chunk_rows: int = CHUNK_ROWS
                  ) -> RearrangeResult:
    """The ascending-JS permutation of the latent axis (Alg. 1)."""
    js = joint_sparsity(p_matrix, q_matrix, t_p, t_q, chunk_rows=chunk_rows)
    perm = torch.argsort(js, stable=True).to(torch.int32)
    return RearrangeResult(perm=perm, joint_sparsity=js[perm.long()])


def permute_columns_(matrix: torch.Tensor, perm: torch.Tensor, *,
                     chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """``matrix[:, perm]`` written back into ``matrix`` chunk by chunk (one
    chunk of scratch, not a second table).  Returns ``matrix``."""
    cols = perm.long().to(matrix.device)
    for lo in range(0, matrix.shape[0], chunk_rows):
        blk = matrix[lo : lo + chunk_rows]
        blk.copy_(blk[:, cols])
    return matrix


def apply_perm(p_matrix, q_matrix, perm, *, chunk_rows: int = CHUNK_ROWS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permute the shared latent axis of both matrices, in place."""
    return (permute_columns_(p_matrix, perm, chunk_rows=chunk_rows),
            permute_columns_(q_matrix, perm, chunk_rows=chunk_rows))


def apply_perm_tree(tensors: Iterable[torch.Tensor], perm, *,
                    chunk_rows: int = CHUNK_ROWS) -> list:
    """Permute axis 1 of every 2-D tensor in place (the optimizer state that
    must stay aligned with the rearranged factors); returns them."""
    return [permute_columns_(t, perm, chunk_rows=chunk_rows) for t in tensors]
