"""Fused pruned score + top-k: the CUDA kernel, its plain version (the
streaming merge), and the wrapper that picks between them by device.

Replaces the TPU kernel ``pruned_topk_padded``
(``src/repro/kernels/pruned_topk.py``): for every user row, the top-k items of
``sum_{t < min(r_u, r_i)} p[u, t] * q[i, t] + bias[i]``, ties to the lower
item index, without the (m, n) score matrix.

On the H100 (``csrc/pruned_topk.cu``): dense, one 256-user batch against a
10M-item catalog at k = 128 is 655 GFLOP of fp32 FMAs (about 10 ms at
67 TFLOP/s) against 5 GB of ``q`` (1.5 ms at 3.35 TB/s), so it is bound by
operations; pruning shrinks both, the FMAs by the pair work fraction.  The
TPU kernel carries the running top-k through a sequential item axis and so
runs one grid row per 128 users, which would leave most of 132 SMs idle.
The design instead splits the catalog over a grid of (splits x user tiles),
one block of 128 users per SM.  A block keeps its users' rows in shared
memory and streams item factors through a two-stage ``cp.async`` ring, so
loads overlap the FMAs; each 128-item tile runs only to its rank bound in
steps of 8.  It filters its scores in registers against each user's bar
(the last entry of the user's list, raised to a bar pooled from the
entries that a group of splits publish), appends the few that pass to a per-user
buffer of :data:`BUFFER` slots in shared memory, and merges buffers into
the users' sorted lists in device memory as two sorted runs (a warp sorts
the candidates, and each entry's slot is its index plus a binary-searched
count of the other run ahead of it).  A second kernel folds the per-split
lists with the same merge.  No shared-memory array has ``topk`` entries,
so any ``topk <= n`` runs on CUDA as on the CPU.  The price of a large
``topk`` is scratch, ``splits x m x topk x 8`` bytes: :func:`split_geometry`
keeps it within :data:`SCRATCH_BYTES` by taking fewer splits, so above a
few thousand ``topk`` trades parallelism (blocks in flight) for memory.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.core.ranks import rank_mask
from repro_torch.kernels import build
from repro_torch.roofline import analysis

launches = 0  # kernel launches by :func:`pruned_topk_ranked` (CUDA only)
# an engine's worker thread and its caller's thread launch at the same time
_launches_lock = threading.Lock()

BLOCK_M = 128    # users per block of the partial kernel (kBM)
BLOCK_N = 128    # items per score tile; a split is a multiple of it (kBN)
BUFFER = 64      # candidate slots per user in shared memory (kBuf)
SCRATCH_BYTES = 256 << 20  # cap on the per-split lists, splits x m x topk x 8 B
BLOCKS_PER_SM = 1  # one partial block per SM (its shared memory)


def tile_catalog(qm: torch.Tensor, bias: torch.Tensor, block_n: int):
    """Pad + reshape rank-masked item factors into the streaming layout:
    ``(tiles, block_n, k)`` factors, ``(tiles, block_n)`` biases with -inf
    on padding rows, ``(tiles,)`` int32 global offsets."""
    n, k = qm.shape
    pad = (-n) % block_n
    tiles = (n + pad) // block_n
    qm_p = F.pad(qm, (0, 0, 0, pad))
    bias_p = F.pad(bias, (0, pad), value=float("-inf"))
    offs = torch.arange(tiles, dtype=torch.int32, device=qm.device) * block_n
    return qm_p.reshape(tiles, block_n, k), bias_p.reshape(tiles, block_n), offs


def stream_topk_tiles(pm, q_tiles, b_tiles, offs, *, topk: int):
    """Streaming top-k over pre-tiled item factors: fold each (m, block_n)
    score tile into a running (m, topk) buffer.

    Transcribes the reference's merge (``repro/kernels/ops.py``
    ``stream_topk_tiles``), with the tie order made explicit: the running
    buffer goes *before* the tile and the merge is a stable descending sort,
    so equal scores keep the lower item index (``torch.topk`` promises no
    order among ties).
    """
    m = pm.shape[0]
    block_n = q_tiles.shape[1]
    lane = torch.arange(block_n, dtype=torch.int32, device=pm.device)
    run_s = torch.empty((m, 0), dtype=torch.float32, device=pm.device)
    run_i = torch.empty((m, 0), dtype=torch.int32, device=pm.device)
    for qt, bt, off in zip(q_tiles, b_tiles, offs):
        s = pm @ qt.T + bt[None, :]
        cand_s = torch.cat([run_s, s], dim=1)
        cand_i = torch.cat([run_i, (off + lane).expand(m, block_n)], dim=1)
        new_s, sel = torch.sort(cand_s, dim=1, descending=True, stable=True)
        run_s = new_s[:, :topk]
        run_i = torch.gather(cand_i, 1, sel[:, :topk])
    return run_s, run_i


def pruned_topk_plain(p, q, r_u, r_i, bias, topk: int, *, block_n: int = 1024):
    """The plain PyTorch version: rank-masked operands through
    :func:`stream_topk_tiles` over ``block_n``-item tiles."""
    k = p.shape[1]
    pm = p.float() * rank_mask(r_u, k)
    qm = q.float() * rank_mask(r_i, k)
    q_tiles, b_tiles, offs = tile_catalog(qm, bias.float(), block_n)
    return stream_topk_tiles(pm, q_tiles, b_tiles, offs, topk=topk)


def cost(m: int, n: int, k: int, topk: int, r_u=None, r_i=None) -> analysis.KernelCost:
    """One launch's work: the pair products each (u, i) needs (cut at
    ``min(r_u, r_i)``), the factor prefixes they read, the ranks, the bias
    and the (m, topk) scores and indices written.  Without ranks to read
    (None, or meta) every rank is ``k``."""
    flops, nbytes, dense = analysis.pair_work(m, n, k, r_u, r_i)
    return analysis.KernelCost(flops, nbytes + 4.0 * n + 8.0 * m * topk, products=True,
                               dense=dense)


def split_geometry(m: int, n: int, num_sms: int, topk: int):
    """Catalog splits for ``m`` users: about one block per SM in all, each
    split a whole number of ``BLOCK_N`` tiles, and no more splits than keep
    the per-split lists (``splits x m x topk`` entries of 8 bytes) within
    :data:`SCRATCH_BYTES` (one split always).  Returns
    ``(splits, items_per_split)``."""
    user_tiles = -(-m // BLOCK_M)
    tiles = -(-n // BLOCK_N)
    fit = SCRATCH_BYTES // (8 * m * topk)
    splits = max(1, min(tiles, -(-BLOCKS_PER_SM * num_sms // user_tiles), fit))
    per = -(-tiles // splits) * BLOCK_N
    return -(-n // per), per


def _launch(p, q, r_u, r_i, bias, topk):
    global launches
    m, k = p.shape
    n = q.shape[0]
    if not 0 < topk <= n:
        raise ValueError(f"topk must be in [1, {n}], got {topk}")
    if q.shape[1] != k:
        raise ValueError(f"q {tuple(q.shape)} does not match p {tuple(p.shape)}")
    if r_u.shape != (m,) or r_i.shape != (n,) or bias.shape != (n,):
        raise ValueError("r_u must be (m,), r_i and bias (n,)")
    tensors = (("p", p, torch.float32), ("q", q, torch.float32),
               ("r_u", r_u, torch.int32), ("r_i", r_i, torch.int32),
               ("bias", bias, torch.float32))
    for name, t, dtype in tensors:
        if not t.is_cuda or t.device != p.device:
            raise ValueError(f"{name} must lie on {p.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor")
    out_s = torch.empty((m, topk), dtype=torch.float32, device=p.device)
    out_i = torch.empty((m, topk), dtype=torch.int32, device=p.device)
    if m == 0:
        return out_s, out_i
    num_sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    splits, per = split_geometry(m, n, num_sms, topk)
    part_s = torch.empty((splits, m, topk), dtype=torch.float32, device=p.device)
    part_i = torch.empty((splits, m, topk), dtype=torch.int32, device=p.device)
    keys = torch.empty((splits, m), dtype=torch.int64, device=p.device)
    lib = build.library("pruned_topk")
    err = lib.pruned_topk_launch(
        p.data_ptr(), q.data_ptr(), r_u.data_ptr(), r_i.data_ptr(), bias.data_ptr(),
        part_s.data_ptr(), part_i.data_ptr(), keys.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(),
        m, n, k, topk, per, splits,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    build.check(err, "pruned_topk kernel launch")
    with _launches_lock:
        launches += 1
    return out_s, out_i


def pruned_topk_ranked(p, q, r_u, r_i, bias, topk: int, *, block_n: int = 1024):
    """Top-k per user row of ``sum_{t < min(r_u, r_i)} p q + bias``:
    ``(scores, item_indices)``, each (m, topk), scores descending, ties to
    the lower index.  CUDA tensors launch the kernel (or raise); CPU tensors
    take the plain version, whose tile width is ``block_n``.  Under
    :func:`analysis.count` it records :func:`cost` and returns empty
    outputs."""
    rec = analysis.counting()
    if rec is not None:
        (m, k), n = p.shape, q.shape[0]
        rec.kernel("pruned_topk", cost(m, n, k, topk, r_u, r_i),
                   analysis.reads(p, q, r_u, r_i, bias))
        return (torch.empty((m, topk), dtype=torch.float32, device=p.device),
                torch.empty((m, topk), dtype=torch.int32, device=p.device))
    if p.is_cuda:
        return _launch(p, q, r_u, r_i, bias, topk)
    return pruned_topk_plain(p, q, r_u, r_i, bias, topk, block_n=block_n)
