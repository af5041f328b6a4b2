"""Lossless array compression for the serving fleet's replication traffic.

Counterpart of the lossless half of ``repro/distributed/compression.py``
(numpy and the standard library only), a copy of its own, so the port
imports nothing of ``repro``.  :func:`compress_array` byte-shuffles an
array (viewed as ``(n_elems, itemsize)`` bytes and transposed, the blosc
"shuffle" filter, so the sign/exponent bytes of float factors sit together
and compress as runs) and DEFLATEs it at level 6; arrays under 128 bytes
are stored raw.  The round trip is bit-exact, and the compressed ``data``
is byte-identical to the reference's for the same array, so a message's
payload CRC agrees across the two packages.

The lossy half of the reference module (int8 gradient quantization with
error feedback, ``compressed_psum``) belongs to distributed training across
ranks and waits for ROADMAP A7's multi-rank half.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

import numpy as np


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
