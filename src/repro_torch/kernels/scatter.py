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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

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


def add_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[idx] += rows`` in place, repeats added in batch order; returns
    ``table``.  ``keep`` (B,) bool leaves rows out.  A CUDA table launches the
    kernel (or raises); a CPU table takes ``index_add_``."""
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
