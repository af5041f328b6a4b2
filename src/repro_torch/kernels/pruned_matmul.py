"""All-pairs early-stopped product: the CUDA kernel, its plain version, and
the wrapper that picks between them by the tensors' device.

Replaces the TPU kernel ``pruned_matmul_padded``
(``src/repro/kernels/pruned_matmul.py``), which computes
``out[u, i] = sum_{t < min(r_u[u], r_i[i])} p[u, t] * q[i, t]`` for all pairs
with whole K-blocks past each tile's rank bound skipped.

On the H100 (``csrc/pruned_matmul.cu``): fp32 FMAs outside the tensor cores
peak at 67 TFLOP/s, and the (m, n) output is written once, so at the serving
shapes (a few dozen users against a 10M-item catalog at k = 128) the kernel
sits near the balance point of FLOPs and bytes; with pruning on, the tile
bound ``min(max r_u, max r_i)`` cuts both the FMAs and the q columns read,
which leaves it bound by the output write.  The design keeps the bound
per 64 x 128 output tile, masks each loaded element by its own row's rank,
and masks the ragged M, N and K edges in the kernel, so no padded copy of
``q`` (5 GB at the full catalog) is ever made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0  # kernel launches by :func:`pruned_matmul_ranked` (CUDA only)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pruned_matmul_plain(p, q, r_u, r_i, *, out_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version: rank-masked operands, one fp32 product."""
    return ref.pruned_matmul_ref(p, q, r_u, r_i, out_dtype=out_dtype)


def _launch(p, q, r_u, r_i, out_dtype) -> torch.Tensor:
    global launches
    m, k = p.shape
    n = q.shape[0]
    if q.shape[1] != k or q.dtype != p.dtype:
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} does not match p {tuple(p.shape)} {p.dtype}")
    if p.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError("pruned_matmul takes float32 or bfloat16 in and out")
    if r_u.shape != (m,) or r_i.shape != (n,):
        raise ValueError("r_u must be (m,) and r_i (n,)")
    for name, t in (("p", p), ("q", q), ("r_u", r_u), ("r_i", r_i)):
        if not t.is_cuda or t.device != p.device:
            raise ValueError(f"{name} must lie on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r_u.dtype != torch.int32 or r_i.dtype != torch.int32:
        raise ValueError("ranks must be int32")
    out = torch.empty((m, n), dtype=out_dtype, device=p.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = build.library("pruned_matmul")
    err = lib.pruned_matmul_launch(
        p.data_ptr(), q.data_ptr(), r_u.data_ptr(), r_i.data_ptr(), out.data_ptr(),
        m, n, k, _DTYPE_CODES[p.dtype], _DTYPE_CODES[out_dtype],
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    build.check(err, "pruned_matmul kernel launch")
    launches += 1
    return out


def pruned_matmul_ranked(p, q, r_u, r_i, *, out_dtype=torch.float32) -> torch.Tensor:
    """``(m, k) x (n, k) -> (m, n)`` with the sum of pair (u, i) cut at
    ``min(r_u[u], r_i[i])``.  CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    if p.is_cuda:
        return _launch(p, q, r_u, r_i, out_dtype)
    return pruned_matmul_plain(p, q, r_u, r_i, out_dtype=out_dtype)
