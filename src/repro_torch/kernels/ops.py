"""Public entry points of the kernels: ranks from thresholds, then the
hand-written kernel on CUDA or its plain version on the CPU.

Counterpart of ``repro/kernels/ops.py`` with the same signatures minus
``interpret``/``use_kernel`` and the Pallas block sizes: the path follows
the device, and the CUDA kernels mask ragged edges themselves, so callers
never pad.  ``block_n`` of :func:`pruned_topk` sizes the plain version's
item tiles only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.ranks import effective_ranks
from repro_torch.device import DeviceLike, check_on, resolve_device
from repro_torch.kernels.fused_mf_sgd import Result, fused_mf_sgd_rows
from repro_torch.kernels.pruned_matmul import pruned_matmul_ranked
from repro_torch.kernels.pruned_topk import (  # noqa: F401  (layout helpers)
    pruned_topk_ranked,
    stream_topk_tiles,
    tile_catalog,
)
from repro_torch.roofline import analysis


def _device(device: DeviceLike) -> torch.device:
    """The call's device: meta only while :func:`analysis.count` runs."""
    return resolve_device(device, meta_ok=analysis.counting() is not None)


def pruned_matmul(
    p: torch.Tensor,
    q: torch.Tensor,
    t_p,
    t_q,
    *,
    out_dtype=torch.float32,
    device: DeviceLike = None,
) -> torch.Tensor:
    """All-pairs early-stopped product ``(m, k) x (n, k) -> (m, n)``; ranks
    come from the current factor values (dynamic pruning)."""
    dev = _device(device)
    check_on(dev, p=p, q=q)
    r_u = effective_ranks(p, t_p)
    r_i = effective_ranks(q, t_q)
    return pruned_matmul_ranked(
        p.contiguous(), q.contiguous(), r_u, r_i, out_dtype=out_dtype
    )


def pruned_topk(
    p: torch.Tensor,
    q: torch.Tensor,
    t_p,
    t_q,
    topk: int,
    *,
    item_bias: Optional[torch.Tensor] = None,
    block_n: int = 1024,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k pruned scores per user row: ``(m, k) x (n, k) -> 2 x (m, topk)``,
    identical to scoring everything and stable-sorting
    (``ref.pruned_topk_ref``) without the (m, n) score matrix."""
    dev = _device(device)
    check_on(dev, p=p, q=q, item_bias=item_bias)
    n = q.shape[0]
    if not 0 < topk <= n:
        raise ValueError(f"topk must be in [1, {n}], got {topk}")
    r_u = effective_ranks(p, t_p)
    r_i = effective_ranks(q, t_q)
    bias = (
        torch.zeros((n,), dtype=torch.float32, device=dev)
        if item_bias is None else item_bias.float().contiguous()
    )
    return pruned_topk_ranked(
        p.float().contiguous(), q.float().contiguous(), r_u, r_i, bias, topk,
        block_n=block_n,
    )


def fused_mf_sgd(
    p_rows: torch.Tensor,
    q_rows: torch.Tensor,
    ratings: torch.Tensor,
    t_p,
    t_q,
    *,
    lr: float,
    lam: float,
    bias_u: Optional[torch.Tensor] = None,
    bias_i: Optional[torch.Tensor] = None,
    global_mean=0.0,
    weight: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> Result:
    """Fused Alg. 2 + Alg. 3 over a batch of gathered rows.

    Returns ``(new_p_rows, new_q_rows, new_bias_u, new_bias_i, err)`` with
    ``err`` shaped (B,); the bias outputs are None when the inputs are.
    Per-row biases and the global mean fold into the prediction (BiasSVD);
    ``weight`` gates the updates.  Thresholds and the global mean may be
    floats or tensors; tensors already on ``device`` cost no host sync.
    """
    dev = _device(device)
    check_on(dev, p_rows=p_rows, q_rows=q_rows, ratings=ratings, bias_u=bias_u,
             bias_i=bias_i, weight=weight)

    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)

    has_bias = bias_u is not None
    return fused_mf_sgd_rows(
        p_rows.contiguous(), q_rows.contiguous(), ratings.float().contiguous(),
        scalar(t_p), scalar(t_q), lr=lr, lam=lam,
        bias_u=bias_u.float().contiguous() if has_bias else None,
        bias_i=bias_i.float().contiguous() if has_bias else None,
        global_mean=scalar(global_mean) if has_bias else None,
        weight=None if weight is None else weight.float().contiguous(),
    )
