"""Fused pruned MF-SGD step: the CUDA kernel, its plain version, and the
wrapper that picks between them by the tensors' device.

Replaces the TPU kernel ``fused_mf_sgd_padded``
(``src/repro/kernels/fused_mf_sgd.py``): for a batch of gathered (p, q) row
pairs, the per-row ranks from the current values, the error of the pruned
prediction ``sum_{t < min(r_u, r_i)} p q + mu + b_u + b_i``, and the SGD
update of both rows on ``t < min(r_u, r_i)`` gated by the row weight (the
biases by the weight alone).

On the H100 (``csrc/fused_mf_sgd.cu``) the step is bound by bytes: each
element of the two (B, k) blocks is read once and written once, about 8
flops per element.  One warp per row pair keeps both rows in registers, so
the ranks, the dot product and the updates take one pass over device
memory; the thresholds and the global mean are read from device memory, so
a training step never waits on the host.  The kernel masks a ragged ``B``
itself and takes float32 or bfloat16 rows (math in float32).  Rows wider
than :data:`REGISTER_K` do not fit in a warp's registers: a second kernel
reads them in pieces of that width, once for the ranks and the dot product
and once for the updates.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

launches = 0  # kernel launches by :func:`fused_mf_sgd_rows` (CUDA only)

REGISTER_K = 1024  # the widest row kept in registers (32 values per lane)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Result = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               Optional[torch.Tensor], torch.Tensor]


def fused_mf_sgd_plain(
    p_rows, q_rows, ratings, t_p, t_q, *, lr: float, lam: float,
    bias_u=None, bias_i=None, global_mean=None, weight=None,
) -> Result:
    """The plain PyTorch version: :func:`ref.fused_mf_sgd_ref`."""
    return ref.fused_mf_sgd_ref(
        p_rows, q_rows, ratings, t_p, t_q, lr=lr, lam=lam, bias_u=bias_u,
        bias_i=bias_i, global_mean=0.0 if global_mean is None else global_mean,
        weight=weight,
    )


def cost(b: int, k: int, *, itemsize: int = 4, bias: bool = False,
         weight: bool = False) -> analysis.KernelCost:
    """One launch's work: about 16 float32 operations an element pair; both
    (b, k) blocks read once and written once, the ratings read and the
    errors written, the bias columns read and written and the weights read
    where given (the one-value thresholds and mean aside)."""
    nbytes = itemsize * 4.0 * b * k + 8.0 * b + (16.0 * b if bias else 0.0) + (
        4.0 * b if weight else 0.0)
    return analysis.KernelCost(16.0 * b * k, nbytes)


def _launch(p_rows, q_rows, ratings, t_p, t_q, lr, lam, bias_u, bias_i,
            global_mean, weight) -> Result:
    global launches
    if p_rows.dim() != 2 or q_rows.shape != p_rows.shape or q_rows.dtype != p_rows.dtype:
        raise ValueError(
            f"q_rows {tuple(q_rows.shape)} {q_rows.dtype} does not match "
            f"p_rows {tuple(p_rows.shape)} {p_rows.dtype}")
    if p_rows.dtype not in _DTYPE_CODES:
        raise ValueError("fused_mf_sgd takes float32 or bfloat16 rows")
    b, k = p_rows.shape
    if k < 1:
        raise ValueError(f"fused_mf_sgd takes k >= 1 on CUDA, got {k}")
    if (bias_u is None) != (bias_i is None):
        raise ValueError("pass both bias columns or neither")
    columns = {"ratings": ratings, "bias_u": bias_u, "bias_i": bias_i, "weight": weight}
    scalars = {"t_p": t_p, "t_q": t_q, "global_mean": global_mean}
    for name, t in {"p_rows": p_rows, "q_rows": q_rows, **columns, **scalars}.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != p_rows.device:
            raise ValueError(f"{name} must lie on {p_rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in columns.items():
        if t is not None and (t.shape != (b,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({b},) float32, got {tuple(t.shape)} {t.dtype}")
    for name, t in scalars.items():
        if t is not None and (t.numel() != 1 or t.dtype != torch.float32):
            raise ValueError(f"{name} must be one float32 value on the card")

    new_p, new_q = torch.empty_like(p_rows), torch.empty_like(q_rows)
    err = torch.empty((b,), dtype=torch.float32, device=p_rows.device)
    new_bu = None if bias_u is None else torch.empty_like(bias_u)
    new_bi = None if bias_i is None else torch.empty_like(bias_i)
    if b == 0:
        return new_p, new_q, new_bu, new_bi, err

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.library("fused_mf_sgd")
    code = lib.fused_mf_sgd_launch(
        p_rows.data_ptr(), q_rows.data_ptr(), ratings.data_ptr(), ptr(bias_u),
        ptr(bias_i), ptr(weight), t_p.data_ptr(), t_q.data_ptr(), ptr(global_mean),
        float(lr), float(lam), new_p.data_ptr(), new_q.data_ptr(), ptr(new_bu),
        ptr(new_bi), err.data_ptr(), b, k, _DTYPE_CODES[p_rows.dtype],
        torch.cuda.current_stream(p_rows.device).cuda_stream,
    )
    build.check(code, "fused_mf_sgd kernel launch")
    launches += 1
    return new_p, new_q, new_bu, new_bi, err


def fused_mf_sgd_rows(
    p_rows: torch.Tensor,
    q_rows: torch.Tensor,
    ratings: torch.Tensor,
    t_p: torch.Tensor,
    t_q: torch.Tensor,
    *,
    lr: float,
    lam: float,
    bias_u: Optional[torch.Tensor] = None,
    bias_i: Optional[torch.Tensor] = None,
    global_mean: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None,
) -> Result:
    """One fused step over ``B`` gathered row pairs.  Returns ``(new_p_rows,
    new_q_rows, new_bias_u, new_bias_i, err)``; the bias outputs are None
    when the inputs are.  ``t_p``, ``t_q`` and ``global_mean`` are one-value
    float32 tensors.  CUDA tensors launch the kernel (or raise); CPU tensors
    take the plain version.  Under :func:`analysis.count` it records
    :func:`cost` and returns empty outputs."""
    rec = analysis.counting()
    if rec is not None:
        b, k = p_rows.shape
        rec.kernel("fused_mf_sgd", cost(b, k, itemsize=p_rows.element_size(),
                                        bias=bias_u is not None, weight=weight is not None),
                   analysis.reads(p_rows, q_rows, ratings, t_p, t_q, bias_u, bias_i,
                                  global_mean, weight))
        return (torch.empty_like(p_rows), torch.empty_like(q_rows),
                None if bias_u is None else torch.empty_like(bias_u),
                None if bias_i is None else torch.empty_like(bias_i),
                torch.empty((b,), dtype=torch.float32, device=p_rows.device))
    if p_rows.is_cuda:
        return _launch(p_rows, q_rows, ratings, t_p, t_q, lr, lam, bias_u, bias_i,
                       global_mean, weight)
    return fused_mf_sgd_plain(
        p_rows, q_rows, ratings, t_p, t_q, lr=lr, lam=lam, bias_u=bias_u,
        bias_i=bias_i, global_mean=global_mean, weight=weight,
    )
