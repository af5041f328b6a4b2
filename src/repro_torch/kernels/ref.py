"""Dense PyTorch oracles for the kernels, exact to the paper's loops.

Counterpart of ``repro/kernels/ref.py``.  These functions materialize what
the kernels never do (the (m, n) score matrix, the (B, k) masks) and are what
the tests hold every path against; :func:`fused_mf_sgd_ref` is also the plain
version of the fused training kernel, which a CPU tensor runs, and
:func:`bpr_step_ref` the oracle of ``workloads.bpr.bpr_train_step``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.ranks import effective_ranks, rank_mask


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


def fused_mf_sgd_ref(
    p_rows: torch.Tensor,   # (b, k) gathered user factors
    q_rows: torch.Tensor,   # (b, k) gathered item factors
    ratings: torch.Tensor,  # (b,)
    t_p,
    t_q,
    *,
    lr: float,
    lam: float,
    bias_u: Optional[torch.Tensor] = None,   # (b,) gathered user biases
    bias_i: Optional[torch.Tensor] = None,   # (b,) gathered item biases
    global_mean=0.0,
    weight: Optional[torch.Tensor] = None,   # (b,) update gate
):
    """Alg. 2 + Alg. 3 fused: masked dot, error, masked SGD row updates.

    Returns ``(new_p_rows, new_q_rows, new_bias_u, new_bias_i, err)``; the
    bias outputs are None when the inputs are.  Ranks come from the current
    row values; the update touches only ``t < min(r_u, r_i)``.  ``weight``
    scales the updates only (0 = inert row); the prediction, biases and
    global mean included, is always the full model output.
    """
    k = p_rows.shape[-1]
    r_u = effective_ranks(p_rows, t_p)
    r_i = effective_ranks(q_rows, t_q)
    mask = rank_mask(torch.minimum(r_u, r_i), k, torch.float32)
    w = (
        torch.ones((p_rows.shape[0],), dtype=torch.float32, device=p_rows.device)
        if weight is None else weight.float()
    )
    pf, qf = p_rows.float(), q_rows.float()
    pred = torch.sum(pf * qf * mask, dim=-1)
    if bias_u is not None:
        mu = torch.as_tensor(global_mean, dtype=torch.float32, device=pred.device)
        pred = pred + mu.reshape(()) + bias_u.float() + bias_i.float()
    err = ratings.float() - pred

    wm = mask * w[:, None]
    new_p = pf + lr * (err[:, None] * qf - lam * pf) * wm
    new_q = qf + lr * (err[:, None] * pf - lam * qf) * wm
    new_bu = new_bi = None
    if bias_u is not None:
        buf, bif = bias_u.float(), bias_i.float()
        new_bu = (buf + lr * (err - lam * buf) * w).to(bias_u.dtype)
        new_bi = (bif + lr * (err - lam * bif) * w).to(bias_i.dtype)
    return new_p.to(p_rows.dtype), new_q.to(q_rows.dtype), new_bu, new_bi, err


def bpr_step_ref(
    p: torch.Tensor,        # (m, k) full user table
    q: torch.Tensor,        # (n, k) full item table
    user: torch.Tensor,     # (b,)
    pos: torch.Tensor,      # (b,)
    neg: torch.Tensor,      # (b,)
    t_p,
    t_q,
    *,
    lr: float,
    lam: float,
    item_bias: Optional[torch.Tensor] = None,   # (n,)
    weight: Optional[torch.Tensor] = None,      # (b,) update gate
):
    """One plain-SGD pruned BPR step over whole tables, in float32.

    Pair scores truncate at ``min(r_u, r_item)``, the regularizer is masked
    by each row's own rank, and duplicate rows accumulate in order
    (``index_add_``, as the reference's ``np.add.at``).  Returns new tables
    ``(new_p, new_q, new_item_bias, mean_loss)``; the inputs are not written.
    """
    k = p.shape[-1]
    pf, qf = p.float(), q.float()
    x_u, y_i, y_j = pf[user], qf[pos], qf[neg]
    r_u = effective_ranks(x_u, t_p)
    r_i = effective_ranks(y_i, t_q)
    r_j = effective_ranks(y_j, t_q)
    m_ui = rank_mask(torch.minimum(r_u, r_i), k)
    m_uj = rank_mask(torch.minimum(r_u, r_j), k)
    m_u, m_i, m_j = rank_mask(r_u, k), rank_mask(r_i, k), rank_mask(r_j, k)

    s_ui = torch.sum(x_u * y_i * m_ui, dim=-1)
    s_uj = torch.sum(x_u * y_j * m_uj, dim=-1)
    if item_bias is not None:
        bf = item_bias.float()
        s_ui = s_ui + bf[pos]
        s_uj = s_uj + bf[neg]
    diff = s_ui - s_uj
    sig = torch.sigmoid(-diff)
    w = torch.ones_like(diff) if weight is None else weight.float()

    g_p = -sig[:, None] * (y_i * m_ui - y_j * m_uj) + lam * x_u * m_u
    g_qi = -sig[:, None] * x_u * m_ui + lam * y_i * m_i
    g_qj = sig[:, None] * x_u * m_uj + lam * y_j * m_j
    new_p = pf.clone().index_add_(0, user, -lr * g_p * w[:, None])
    new_q = qf.clone().index_add_(0, pos, -lr * g_qi * w[:, None])
    new_q.index_add_(0, neg, -lr * g_qj * w[:, None])
    new_bias = None
    if item_bias is not None:
        new_bias = bf.clone().index_add_(0, pos, -lr * (-sig + lam * bf[pos]) * w)
        new_bias.index_add_(0, neg, -lr * (sig + lam * bf[neg]) * w)
    loss = torch.log1p(torch.exp(-diff.abs())) + torch.clamp(-diff, min=0.0)
    denom = max(float(w.sum()), 1e-9)
    return new_p, new_q, new_bias, float((loss * w).sum()) / denom


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


def early_stop_update_loop(
    p_row: np.ndarray,
    q_row: np.ndarray,
    rating: float,
    t_p: float,
    t_q: float,
    lr: float,
    lam: float,
):
    """Algorithm 3 (scalar): prediction with Alg. 2 then truncated Eq. 5/6."""
    pred = early_stop_dot_loop(p_row, q_row, t_p, t_q)
    err = rating - pred
    new_p = p_row.astype(np.float64).copy()
    new_q = q_row.astype(np.float64).copy()
    for t in range(p_row.shape[0]):
        if abs(float(p_row[t])) < t_p or abs(float(q_row[t])) < t_q:
            break
        new_p[t] = p_row[t] + lr * (err * q_row[t] - lam * p_row[t])
        new_q[t] = q_row[t] + lr * (err * p_row[t] - lam * q_row[t])
    return new_p, new_q, err
