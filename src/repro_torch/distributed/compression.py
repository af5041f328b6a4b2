"""Payload compression: int8 gradient quantization for the collectives of
sharded training, and lossless array compression for the serving fleet's
replication traffic.

Counterpart of ``repro/distributed/compression.py``, a copy of its own, so
the port imports nothing of ``repro``.

**Lossy (int8 with error feedback).** :func:`quantize_int8` maps a tensor
to int8 on one per-tensor scale (``max|x| / 127``, which XLA compiles to a
multiply by ``float32(1/127)``, and so does :data:`INV_127` here; rounded
half to even as ``jnp.round`` rounds), so the payloads are bitwise the
reference's;
:func:`compress_with_feedback` carries each quantizer's residual into the
next transmission (EF-SGD); :func:`compressed_psum` sums quantized tensors
over a process group on a common scale (the group's ``max`` of the local
maxima), so the integer sum is exact.  Over up to four ranks its payload
crosses the links as int8 (an all-gather, summed locally in int32), over
more as one int32 all-reduce, as the reference's does.

**Lossless.** :func:`compress_array` byte-shuffles an
array (viewed as ``(n_elems, itemsize)`` bytes and transposed, the blosc
"shuffle" filter, so the sign/exponent bytes of float factors sit together
and compress as runs) and DEFLATEs it at level 6; arrays under 128 bytes
are stored raw.  The round trip is bit-exact, and the compressed ``data``
is byte-identical to the reference's for the same array, so a message's
payload CRC agrees across the two packages.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CompressedArray:
    """One losslessly compressed ndarray: ``data`` is the DEFLATE stream of
    the byte-shuffled buffer (or the raw buffer when ``codec="raw"``), plus
    the shape and dtype needed to rebuild it."""

    data: bytes
    shape: Tuple[int, ...]
    dtype: str
    codec: str = "shuffle-zlib"

    @property
    def nbytes(self) -> int:
        """Compressed payload size (what crosses the wire)."""
        return len(self.data)

    @property
    def raw_nbytes(self) -> int:
        """Uncompressed size of the array this rebuilds to."""
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize


def compress_array(x, *, level: int = 6, min_bytes: int = 128) -> CompressedArray:
    """Losslessly compress an array (numpy, or anything ``np.asarray``
    takes); arrays under ``min_bytes`` are stored raw, since the zlib header
    would cost more than it saves."""
    # shape before ascontiguousarray: it promotes 0-d scalars to (1,)
    shape = tuple(np.shape(x))
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.nbytes < min_bytes:
        return CompressedArray(arr.tobytes(), shape, arr.dtype.str, codec="raw")
    itemsize = arr.dtype.itemsize
    shuffled = (
        arr.view(np.uint8).reshape(-1, itemsize).T.tobytes() if itemsize > 1 else arr.tobytes()
    )
    return CompressedArray(zlib.compress(shuffled, level), shape, arr.dtype.str)


def decompress_array(c: CompressedArray) -> np.ndarray:
    """Invert :func:`compress_array`: the result is bitwise the array that
    was compressed (a new, writable array)."""
    dtype = np.dtype(c.dtype)
    if c.codec == "raw":
        return np.frombuffer(c.data, dtype).reshape(c.shape).copy()
    if c.codec != "shuffle-zlib":
        raise ValueError(f"unknown codec {c.codec!r}")
    flat = np.frombuffer(zlib.decompress(c.data), np.uint8)
    if dtype.itemsize > 1:
        flat = flat.reshape(dtype.itemsize, -1).T.reshape(-1).copy()
    return flat.view(dtype).reshape(c.shape).copy()


# ---------------------------------------------------------------------------
# int8 gradient quantization (sharded training's collectives)
# ---------------------------------------------------------------------------

# The reference writes ``x / 127.0``; XLA rewrites a division by a constant
# into a multiply by its float32 reciprocal, which rounds differently from
# the division in about 5% of cases.  Multiplying here keeps the scales, and
# so the int8 payloads, bitwise the reference's.
INV_127 = float(np.float32(1.0 / 127.0))


def int8_scale(peak: torch.Tensor) -> torch.Tensor:
    """``max(peak, 1e-12) / 127``, as the reference's compiled code
    computes it."""
    return torch.clamp(peak, min=1e-12) * INV_127


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``x`` on the int8 grid of one scale,
    ``max(max|x|, 1e-12) / 127``, rounded half to even and clipped to
    [-127, 127]."""
    scale = int8_scale(torch.max(torch.abs(x)))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The float32 values an int8 payload stands for: ``q * scale``."""
    return q.to(torch.float32) * scale


def _leaves(tree: Any):
    """(flat tensors, rebuild) for a tensor, or a dict / list / tuple of
    them (the pytrees the reference's helpers map over)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[key] for key in keys], lambda leaves: dict(zip(keys, leaves))
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda leaves: type(tree)(leaves)
    raise TypeError(f"expected a tensor, dict, list or tuple, got {type(tree).__name__}")


def init_error_feedback(grads: Any) -> Any:
    """Zero float32 residuals shaped like ``grads``."""
    flat, rebuild = _leaves(grads)
    return rebuild([torch.zeros_like(g, dtype=torch.float32) for g in flat])


def compress_with_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """``(dequantized compressed grads, new residual)``: each leaf's target
    is ``grad + residual``; what the receiver reconstructs is returned, and
    the residual keeps what the quantizer dropped."""
    flat_g, rebuild = _leaves(grads)
    flat_r, _ = _leaves(residual)
    recon, resid = [], []
    for g, r in zip(flat_g, flat_r):
        target = g.float() + r
        q, scale = quantize_int8(target)
        back = dequantize_int8(q, scale)
        recon.append(back)
        resid.append(target - back)
    return rebuild(recon), rebuild(resid)


# above this many ranks the int8 gather moves more than one int32 all-reduce
INT8_GATHER_MAX_RANKS = 4


def psum_int8(q: torch.Tensor, group=None, *, name: str = "int8 payload") -> torch.Tensor:
    """The exact int32 sum of the int8 tensors ``q`` of every rank of
    ``group``.  Up to :data:`INT8_GATHER_MAX_RANKS` ranks the payloads are
    all-gathered as int8 (``n`` bytes an element in the result) and summed
    locally; above, they are all-reduced as int32 (4 bytes an element), as
    the reference does.  The integer sum is exact either way."""
    import torch.distributed as dist

    from repro_torch.distributed import spmd

    n = dist.get_world_size(group)
    if n == 1:
        return q.to(torch.int32)
    if n > INT8_GATHER_MAX_RANKS:
        return spmd.reduce_in_group(q.to(torch.int32), group, name=name)
    return torch.stack(spmd.gather_in_group(q, group, name=name)).to(torch.int32).sum(dim=0)


def common_scale(local_max: torch.Tensor, group=None, *, name: str = "int8 scale") -> torch.Tensor:
    """``max(max over group of local_max, 1e-12) / 127``: the scale every
    rank of ``group`` quantizes to."""
    import torch.distributed as dist

    from repro_torch.distributed import spmd

    m = local_max.float().reshape(1).clone()
    if dist.get_world_size(group) > 1:
        spmd.reduce_in_group(m, group, dist.ReduceOp.MAX, name=name)
    return int8_scale(m[0])


def compressed_psum(grads: Any, group=None) -> Any:
    """Sum int8-quantized ``grads`` over the ranks of ``group`` (a process
    group; the reference takes a ``shard_map`` axis name).

    Every rank quantizes to the common scale ``max over the group of
    max|g|`` / 127, so the sum of the int8 values is exact (error at most
    scale/2 per element per rank, with no bias where most ranks hold
    zeros).  The links carry the int8 payloads (:func:`psum_int8`) and one
    scalar max.
    """
    flat, rebuild = _leaves(grads)
    out = []
    for g in flat:
        g = g.float()
        scale = common_scale(torch.max(torch.abs(g)), group)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        out.append(psum_int8(q, group).to(torch.float32) * scale)
    return rebuild(out)
