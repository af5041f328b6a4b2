"""Batch-order row scatter: the CUDA kernel, its plain versions, and the
wrapper that picks between them by the table's device.

``add_rows(table, idx, rows)`` is ``table[idx] += rows`` with the rows of a
repeated index added in batch order, ``((row + v1) + v2) + ...``, in float32:
the CPU's ``index_add_`` bit for bit, and in float32 the reference's
``.at[idx].add``.  A bfloat16 sum is rounded as the CPU's ``index_add_``
rounds it: once at the end for a ``(n, k)`` table, after every add for a
vector (a bias column).  On CUDA ``index_add_`` adds repeats with
atomics in any order, so a training step there would not be reproducible
from one run to the next.  Every scatter of the port's training path goes
through :func:`add_rows`.

On the CPU it is ``index_add_`` itself.  On CUDA (``csrc/add_rows.cu``) the
indices are stable-sorted (``torch.sort(stable=True)``), and one launch gives
each run of equal indices to one warp, which reads the table row once, adds
the run's rows in batch order and writes the row once: no host sync.  It
replaces no TPU kernel (the reference leaves the scatter to XLA).

:func:`add_rows_in_passes` computes the same bits with plain tensor ops on
any device: pass ``j`` adds the ``j``-th row of every run, one
``index_add_`` over distinct indices a pass (a host sync, and a launch a
pass).  It is the kernel's order written out, and the plain version the card
times the kernel against.

Two autograd functions put it under the models' gathers and segment sums:
:func:`gather_rows` (``table[idx]``, its gradient added into a zero table by
``add_rows``) and :func:`segment_sum` (``add_rows`` into zeros, its gradient
a gather).  Their launches count as ``add_rows``'.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.roofline import analysis

launches = 0  # kernel launches by :func:`add_rows` (CUDA only)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _as_matrix(table: torch.Tensor, rows: torch.Tensor):
    """``table`` as ``(n, k)`` with a row stride and ``rows`` as a contiguous
    ``(B, k)``: a vector is a 1-column table of any stride."""
    if table.dim() == 1:
        return table.shape[0], 1, table.stride(0), rows.reshape(-1, 1).contiguous()
    if table.dim() != 2 or (table.shape[1] > 1 and table.stride(1) != 1):
        raise ValueError("add_rows takes a vector or a (n, k) table with unit column stride, "
                         f"got shape {tuple(table.shape)} strides {table.stride()}")
    return table.shape[0], table.shape[1], table.stride(0), rows.contiguous()


def _launch(table, idx, rows, keep) -> torch.Tensor:
    global launches
    if table.dtype not in _DTYPE_CODES or rows.dtype != table.dtype:
        raise ValueError(f"add_rows takes float32 or bfloat16 tables and rows of the table's "
                         f"type, got {table.dtype} and {rows.dtype}")
    b = idx.shape[0]
    if idx.dim() != 1 or rows.shape != (b,) + tuple(table.shape[1:]):
        raise ValueError(f"rows {tuple(rows.shape)} do not match idx {tuple(idx.shape)} and "
                         f"table {tuple(table.shape)}")
    for name, t in (("idx", idx), ("rows", rows), ("keep", keep)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} must lie on {table.device}")
    n, k, ld, mat = _as_matrix(table, rows)
    if b == 0 or n == 0 or k == 0:
        return table
    key = idx.long()
    if keep is not None:
        key = torch.where(keep, key, -1)  # the kernel leaves negative indices out
    sorted_idx, order = torch.sort(key, stable=True)
    code = build.library("add_rows").add_rows_launch(
        table.data_ptr(), ld, n, k, sorted_idx.data_ptr(), order.data_ptr(), mat.data_ptr(),
        b, _DTYPE_CODES[table.dtype], int(table.dim() == 1),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    build.check(code, "add_rows kernel launch")
    launches += 1
    return table


def cost(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
         keep: Optional[torch.Tensor] = None) -> analysis.KernelCost:
    """One launch's work: an add an element of ``rows``; the rows and the
    indices read once, each distinct row of the table it touches read once
    and written once.  Without indices to read (meta) every index is
    distinct."""
    b = idx.shape[0]
    k = rows.numel() // b if b else 0
    if analysis.has_values(idx) and (keep is None or analysis.has_values(keep)):
        touched = torch.unique(idx if keep is None else idx[keep]).numel()
        dense = False
    else:
        touched, dense = min(b, table.shape[0]), True
    nbytes = (rows.numel() * rows.element_size() + idx.numel() * idx.element_size()
              + 2.0 * table.element_size() * touched * k)
    return analysis.KernelCost(float(rows.numel()), float(nbytes), dense=dense)


def add_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[idx] += rows`` in place, repeats added in batch order; returns
    ``table``.  ``keep`` (B,) bool leaves rows out.  A CUDA table launches the
    kernel (or raises); a CPU table takes ``index_add_``.  Under
    :func:`analysis.count` it records :func:`cost` and returns ``table``."""
    rec = analysis.counting()
    if rec is not None:
        c = cost(table, idx, rows, keep)
        moved = analysis.reads(idx, rows, keep)
        row_bytes = (c.bytes - sum(read for _, read, _ in moved[:2])) / 2
        rec.kernel("add_rows", c, moved + [(table, row_bytes, row_bytes)])
        return table
    if table.is_cuda:
        return _launch(table, idx, rows, keep)
    if keep is not None:
        idx, rows = idx[keep], rows[keep]
    return table.index_add_(0, idx, rows)


def add_rows_in_passes(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *,
                       keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same bits as :func:`add_rows` from plain tensor ops on any device:
    pass ``j`` adds each index's ``j``-th row, so no pass repeats an index.
    A bfloat16 ``(n, k)`` table is summed in a float32 copy and rounded
    once; a bfloat16 vector rounds after every add, as ``index_add_`` does."""
    if keep is not None:
        idx, rows = idx[keep], rows[keep]
    n = idx.numel()
    if n == 0:
        return table
    if table.dtype != torch.float32 and table.dim() > 1:
        acc = add_rows_in_passes(table.float(), idx, rows.float())
        return table.copy_(acc)
    order = torch.argsort(idx, stable=True)
    ordered = idx[order]
    at = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = ordered[1:] != ordered[:-1]
    rank_in_run = at - torch.cummax(torch.where(first, at, 0), 0).values
    by_pass = order[torch.argsort(rank_in_run, stable=True)]
    lo = 0
    for count in torch.bincount(rank_in_run).tolist():
        sel = by_pass[lo:lo + count]
        table.index_add_(0, idx[sel], rows[sel])
        lo += count
    return table


def _flat_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a vector or an ``(n, k)`` table with unit column stride, the
    two forms :func:`add_rows` takes: trailing dims folded into ``k``."""
    return t if t.dim() <= 1 else t.reshape(t.shape[0], -1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, keep):
        ctx.save_for_backward(idx, keep)
        ctx.table_shape = table.shape
        rows = table[idx]
        if keep is None:
            return rows
        return torch.where(keep.reshape(keep.shape + (1,) * (rows.dim() - keep.dim())),
                           rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    @staticmethod
    def backward(ctx, grad):
        idx, keep = ctx.saved_tensors
        out = grad.new_zeros(ctx.table_shape)
        flat = idx.reshape(-1)
        add_rows(_flat_rows(out), flat, _flat_rows(grad.reshape((flat.shape[0],) + out.shape[1:])),
                 keep=None if keep is None else keep.reshape(-1))
        return out, None, None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, seg, num_segments):
        ctx.save_for_backward(seg)
        out = rows.new_zeros((num_segments,) + tuple(rows.shape[1:]))
        add_rows(_flat_rows(out), seg, _flat_rows(rows))
        return out

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        return grad[seg], None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, *,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[idx]`` (``idx`` of any shape) whose gradient is added into a
    zero table by :func:`add_rows`: the repeats of an index in batch order,
    one stable sort and one launch on CUDA, where PyTorch's own backward of
    an index (``index_put_`` with accumulate) adds them with atomics.
    ``keep`` (``idx``'s shape, bool) zeroes the rows it leaves out and
    leaves them out of the gradient's scatter (``add_rows(keep=)``), so a
    placeholder index costs no run of repeats there."""
    return _GatherRows.apply(table, idx.long(), keep)


def segment_sum(rows: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ``out[s] = sum of rows[j] with seg[j] == s``
    over ``(E,)``, ``(E, H)`` or ``(E, H, d)`` rows, added in batch order by
    :func:`add_rows`; an empty segment is 0.  Its gradient is the gather
    ``grad[seg]``."""
    return _SegmentSum.apply(rows, seg.long(), num_segments)
