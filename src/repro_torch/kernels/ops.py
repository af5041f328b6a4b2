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


# ---------------------------------------------------------------------------
# the TPU kernel's tiles: padding and work fractions
# ---------------------------------------------------------------------------

TOPK_BLOCK_M = 128  # the reference's pruned_topk tiles: users,
TOPK_BLOCK_N = 256  # items,
TOPK_BLOCK_K = 128  # and the factor depth of a block


def _pad_to(x: torch.Tensor, multiple: int, dim: int, value=0) -> torch.Tensor:
    pad = (-x.shape[dim]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=dim)


def pad_catalog_for_topk_kernel(q: torch.Tensor, r_i: torch.Tensor,
                                item_bias: Optional[torch.Tensor], *,
                                block_n: int = TOPK_BLOCK_N, block_k: int = TOPK_BLOCK_K):
    """The item side of the TPU kernel's layout: ``q`` zero-padded to
    ``block_n`` rows and ``block_k`` columns, the ranks as an int32 column
    and the biases (zeros when None) as a float32 column, both zero-padded to
    ``block_n`` rows.  The CUDA kernels mask ragged edges themselves and take
    none of it; it is the reference's layout, for tools that read it."""
    n = q.shape[0]
    bias = item_bias if item_bias is not None else torch.zeros((n,), dtype=torch.float32,
                                                               device=q.device)
    return (_pad_to(_pad_to(q, block_n, 0), block_k, 1),
            _pad_to(r_i[:, None].to(torch.int32), block_n, 0),
            _pad_to(bias.to(torch.float32)[:, None], block_n, 0))


def pad_users_for_topk_kernel(p: torch.Tensor, r_u: torch.Tensor, *,
                              block_m: int = TOPK_BLOCK_M, block_k: int = TOPK_BLOCK_K):
    """The user side of :func:`pad_catalog_for_topk_kernel`'s layout: ``p``
    zero-padded to ``block_m`` rows and ``block_k`` columns, the ranks an
    int32 column zero-padded to ``block_m`` rows."""
    return (_pad_to(_pad_to(p, block_m, 0), block_k, 1),
            _pad_to(r_u[:, None].to(torch.int32), block_m, 0))


def tile_block_stats(r_u: torch.Tensor, r_i: torch.Tensor, k: int, *, block_m: int = 128,
                     block_n: int = 128, block_k: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tile_fraction, elem_fraction)`` of a pruned all-pairs product, from
    the ranks alone: the share of ``block_k``-deep blocks that a kernel on
    ``block_m`` x ``block_n`` tiles runs (each tile to the smaller of its
    users' and its items' largest rank, in whole blocks) against the dense
    product, and the share of the element-exact work (every pair cut at
    ``min(r_u, r_i)``, the paper's early stop), both float32.  The default
    tiles are the reference TPU kernel's; ``pruned_matmul.cu`` runs tiles of
    64 users by 128 items with 32-deep stages, so its own share differs."""
    tu = _pad_to(r_u.to(torch.int32), block_m, 0).reshape(-1, block_m).amax(dim=1)
    ti = _pad_to(r_i.to(torch.int32), block_n, 0).reshape(-1, block_n).amax(dim=1)
    bound = torch.minimum(tu[:, None], ti[None, :]).to(torch.float32)
    nk = -(-k // block_k)
    tile_fraction = torch.ceil(bound / block_k).mean() / nk
    elem_fraction = torch.minimum(r_u[:, None], r_i[None, :]).to(torch.float32).mean() / float(k)
    return tile_fraction, elem_fraction
