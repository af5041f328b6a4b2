"""Dense PyTorch oracles for the kernels, exact to the paper's loops.

Counterpart of ``repro/kernels/ref.py`` (serving subset).  These functions
materialize what the kernels never do (the (m, n) score matrix) and are what
the tests hold every path against; no serving path calls them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.ranks import rank_mask


def masked_factors(rows: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Zero columns ``t >= rank`` of each row."""
    return rows * rank_mask(ranks, rows.shape[-1], rows.dtype)


def pruned_matmul_ref(p, q, r_u, r_i, *, out_dtype=torch.float32) -> torch.Tensor:
    """All-pairs early-stopped product: out[u, i] = sum_{t < min(r_u, r_i)}.

    Masking each operand by its own rank makes the product mask the AND of
    the two prefix masks, i.e. exactly ``t < min(r_u, r_i)``.
    """
    pm = masked_factors(p, r_u).float()
    qm = masked_factors(q, r_i).float()
    return (pm @ qm.T).to(out_dtype)


def pruned_topk_ref(
    p, q, r_u, r_i, topk: int, *, item_bias: Optional[torch.Tensor] = None
):
    """Serving oracle: dense pruned scores, a stable descending sort, top-k.

    The stable sort sends score ties to the lower item index, the order every
    streaming path and kernel must reproduce.
    """
    scores = pruned_matmul_ref(p, q, r_u, r_i)
    if item_bias is not None:
        scores = scores + item_bias[None, :].float()
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :topk], order[:, :topk].to(torch.int32)


def pruned_pair_dot_ref(p_rows, q_rows, r_u, r_i) -> torch.Tensor:
    """Early-stopped dot of paired rows by their given ranks: (b, k) -> (b,)."""
    pm = masked_factors(p_rows, r_u).float()
    qm = masked_factors(q_rows, r_i).float()
    return torch.sum(pm * qm, dim=-1)


def early_stop_dot_loop(
    p_row: np.ndarray, q_row: np.ndarray, t_p: float, t_q: float
) -> float:
    """Direct transcription of the paper's Algorithm 2 (scalar, CPU)."""
    acc = 0.0
    for t in range(p_row.shape[0]):
        if abs(float(p_row[t])) < t_p or abs(float(q_row[t])) < t_q:
            break
        acc += float(p_row[t]) * float(q_row[t])
    return acc
