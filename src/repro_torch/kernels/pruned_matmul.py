"""All-pairs early-stopped product: the CUDA kernel, its plain version, and
the wrapper that picks between them by the tensors' device.

Replaces the TPU kernel ``pruned_matmul_padded``
(``src/repro/kernels/pruned_matmul.py``), which computes
``out[u, i] = sum_{t < min(r_u[u], r_i[i])} p[u, t] * q[i, t]`` for all pairs
with whole K-blocks past each tile's rank bound skipped.

On the H100 (``csrc/pruned_matmul.cu``) the (m, n) output is written once,
so at the serving shape (64 users against a 10M-item catalog, k = 128, f32)
its 2.56 GB of stores set the floor, and the item rows' rank prefixes add
scattered reads; dense, the 5.12 GB of ``q`` add to it and the products,
even on the tensor cores, take about as long as the bytes.  The kernel:

- runs persistent blocks, two per SM, over (64-user, 128-item) tiles, so
  any ``m`` runs, with the user tile resident in shared memory;
- streams each tile's item rows through a three-stage ``cp.async`` ring,
  each 16-byte copy cut at its own row's rank (zero-filled past it), so
  ``q`` is read per row, not to the tile bound ``min(max r_u, max r_i)`` at
  which the tile's K loop ends (each warp stops at its own 32 x 32 block's);
- computes the products on the tensor cores as 3xTF32 ``mma.sync`` (each
  f32 operand split into two TF32 parts, error of the order of an fp32
  product; bfloat16 is exact in TF32 and takes one pass);
- stages each finished tile in shared memory and writes it with one TMA
  bulk store per output row while the next chunks load and multiply.

The launcher picks the copies and stores from the shapes and pointers: rows
off 16-byte alignment (``k * itemsize % 16``, or a base pointer) take 4-byte
copies (f32) or plain loads (bf16), output rows off it plain stores.  The
ragged M, N and K edges are masked in the kernel, so no padded copy of ``q``
(5 GB at the full catalog) is ever made.  Rows wider than :data:`MAX_K`
(the widest user tile that stays resident) run as column slices of at most
that width, read in place through the kernel's row stride: each slice's
ranks are clamped to it, ``clamp(r - c0, 0, width)``, which is exact because
``min`` commutes with the clamp; the slices' float32 outputs are summed and
cast once at the end.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

launches = 0  # kernel launches by :func:`pruned_matmul_ranked` (CUDA only)
MAX_K = 512  # the widest slice of a launch (pruned_matmul.cu keeps its user tile resident)
TF32_PASSES = 3  # 3xTF32: three TF32 products on the tensor cores for each float32 one

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pruned_matmul_plain(p, q, r_u, r_i, *, out_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version: rank-masked operands, one fp32 product."""
    return ref.pruned_matmul_ref(p, q, r_u, r_i, out_dtype=out_dtype)


def cost(m: int, n: int, k: int, r_u=None, r_i=None, *, itemsize: int = 4,
         out_itemsize: int = 4) -> analysis.KernelCost:
    """One call's work: the pair products each (u, i) needs (cut at
    ``min(r_u, r_i)``), the factor prefixes they read, the ranks and the
    (m, n) output written.  Without ranks to read (None, or meta) every
    rank is ``k``.  The kernel runs each float32 product as
    :data:`TF32_PASSES` TF32 ones: ``analysis.bound(TF32_PASSES * flops,
    bytes, hw.PEAK_TF32_FLOPS)``."""
    flops, nbytes, dense = analysis.pair_work(m, n, k, r_u, r_i, itemsize)
    return analysis.KernelCost(flops, nbytes + out_itemsize * m * n, products=True, dense=dense)


def column_slices(k: int):
    """``(c0, width)`` of the latent slices one CUDA call launches: one
    slice up to :data:`MAX_K` columns, then one per :data:`MAX_K`."""
    return [(c0, min(MAX_K, k - c0)) for c0 in range(0, k, MAX_K)]


def slice_ranks(ranks: torch.Tensor, c0: int, width: int) -> torch.Tensor:
    """Ranks within the slice ``[c0, c0 + width)``: ``clamp(r - c0, 0,
    width)``.  ``min(r_u, r_i)`` clamped is the min of the clamped ranks, so
    the slices' products sum to the whole one."""
    return torch.clamp(ranks - c0, 0, width).to(torch.int32)


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
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=p.device)
    lib = build.library("pruned_matmul")
    stream = torch.cuda.current_stream(p.device).cuda_stream
    # one slice writes out_dtype directly; several sum in float32
    acc_dtype = out_dtype if k <= MAX_K else torch.float32
    out = part = None
    for c0, width in column_slices(k):
        if c0 == 0:  # the kernel clamps the first slice's ranks to its width
            ru, ri, dst = r_u, r_i, torch.empty((m, n), dtype=acc_dtype, device=p.device)
        else:
            ru, ri = slice_ranks(r_u, c0, width), slice_ranks(r_i, c0, width)
            if part is None:
                part = torch.empty((m, n), dtype=torch.float32, device=p.device)
            dst = part
        err = lib.pruned_matmul_launch(
            p.data_ptr() + c0 * p.element_size(), q.data_ptr() + c0 * q.element_size(),
            ru.data_ptr(), ri.data_ptr(), dst.data_ptr(), m, n, width, k,
            _DTYPE_CODES[p.dtype], _DTYPE_CODES[acc_dtype], stream,
        )
        build.check(err, "pruned_matmul kernel launch")
        launches += 1
        if c0 == 0:
            out = dst
        else:
            out.add_(dst)
    return out.to(out_dtype)


def pruned_matmul_ranked(p, q, r_u, r_i, *, out_dtype=torch.float32) -> torch.Tensor:
    """``(m, k) x (n, k) -> (m, n)`` with the sum of pair (u, i) cut at
    ``min(r_u[u], r_i[i])``.  CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version.  Under :func:`analysis.count` it
    records :func:`cost` and returns an empty output."""
    rec = analysis.counting()
    if rec is not None:
        (m, k), n = p.shape, q.shape[0]
        out_itemsize = torch.finfo(out_dtype).bits // 8
        rec.kernel("pruned_matmul", cost(m, n, k, r_u, r_i, itemsize=p.element_size(),
                                         out_itemsize=out_itemsize),
                   analysis.reads(p, q, r_u, r_i))
        return torch.empty((m, n), dtype=out_dtype, device=p.device)
    if p.is_cuda:
        return _launch(p, q, r_u, r_i, out_dtype)
    return pruned_matmul_plain(p, q, r_u, r_i, out_dtype=out_dtype)
