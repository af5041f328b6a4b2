"""mmap-backed columnar ratings store and its prefetched slab loader.

Counterpart of ``repro/store/ratings_store.py``.  The in-memory path
(``data/loader.PackedRatings``) uploads the whole ratings table to the
device; this module bounds host *and* device memory by the slab instead:

* :func:`build_store` writes the ratings as fixed-dtype columnar shards
  (``user int32 | item int32 | rating float32`` blocks per shard) plus an
  ``index.json`` header, byte for byte the reference's files, so either
  package reads the other's store; :class:`RatingsStore` reads them back
  through lazily opened ``np.memmap`` views, so touching a slab faults in
  only that slab's pages.
* :class:`FeistelPermutation` is a bijective index permutation on
  ``[0, n)``: any slice of the shuffled epoch order is computable in
  O(slice) without the O(n) permutation array.  It is the reference's,
  bit for bit (numpy ``uint64`` arithmetic wrapping mod 2^64, round keys
  from ``np.random.SeedSequence``).  The order is drawn on the host, where
  the gather that reads the host ``mmap`` pages needs it.
* :class:`ShardedRatingsLoader` streams shuffled ``(slab_steps, B)`` epoch
  slabs through a bounded prefetch queue: a background thread permutes and
  gathers the next slab (in 2^20-row pieces, so its temporaries stay small)
  and copies it to the device while the caller trains on the current one.
  Peak host memory is ``O(prefetch * slab_steps * B)``, independent of the
  dataset size.

On ``cuda`` the worker gathers into pinned host memory, copies on a side
stream of its own and records an event; the consumer's stream waits on
that event before the slab is yielded, and every slab tensor is marked
used on the consumer's stream (``record_stream``), so the caching allocator
cannot hand a slab's memory to the next copy while a step still reads it.
User and item ids are int32 on the shards and int64 on the device (the
dtypes ``mf.train_epoch_scan`` takes): the cast runs on the device.

Determinism: for a given ``(seed, epoch)`` the set of examples an epoch
visits and their batch assignment are fixed; resuming from slab ``s``
replays slabs ``s..`` identically to an uninterrupted epoch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.ratings import RatingsDataset
from repro_torch.device import DeviceLike, resolve_device

_INDEX_NAME = "index.json"
_STORE_VERSION = 1
_ROW_BYTES = 12  # int32 user + int32 item + float32 rating
_GATHER_ROWS = 1 << 20  # rows permuted and gathered at a time by the loader


class CorruptShardError(RuntimeError):
    """A shard file's bytes fail the CRC-32 recorded in ``index.json``.

    Raised instead of feeding flipped bits into training (a corrupt float32
    block reads as valid, often NaN or huge, ratings).  The shard is
    quarantined (renamed with a ``.corrupt`` suffix, best effort) so a
    supervised retrain can detect and rebuild it."""


# ---------------------------------------------------------------------------
# Feistel permutation
# ---------------------------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)


class FeistelPermutation:
    """Bijective shuffle of ``[0, n)`` computable point-wise.

    A balanced Feistel network over the smallest even-bit-width domain
    ``2^(2h) >= n`` with a splitmix64-style round function; indices that
    land outside ``[0, n)`` are cycle-walked (the permutation re-applied)
    back into range.  A Feistel network is a bijection for any round
    function, and cycle-walking restricts it to a bijection of ``[0, n)``.
    Round keys derive from ``np.random.SeedSequence([seed, epoch, 0x5EED])``:
    the order is reproducible from ``(n, seed, epoch)`` alone.
    """

    def __init__(self, n: int, seed: int, epoch: int, *, rounds: int = 4):
        if n <= 0:
            raise ValueError(f"permutation domain must be positive, got {n}")
        self.n = int(n)
        bits = max(int(self.n - 1).bit_length(), 2)
        self._half_bits = np.uint64((bits + 1) // 2)
        self._mask = np.uint64((1 << int(self._half_bits)) - 1)
        ss = np.random.SeedSequence([int(seed), int(epoch), 0x5EED])
        self._keys = [np.uint64(k) for k in ss.generate_state(rounds, np.uint64)]

    def _walk(self, x: np.ndarray) -> np.ndarray:
        h, mask = self._half_bits, self._mask
        left = (x >> h) & mask
        right = x & mask
        with np.errstate(over="ignore"):
            for key in self._keys:
                f = right + key
                f = f * _GOLDEN
                f ^= f >> np.uint64(29)
                f = f * _MIX1
                f ^= f >> np.uint64(32)
                left, right = right, left ^ (f & mask)
        return (left << h) | right

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        """Map indices in ``[0, n)`` through the permutation (vectorized)."""
        out = np.ascontiguousarray(idx, dtype=np.uint64)
        result = np.empty_like(out)
        pos = np.arange(out.size)
        pending = out.reshape(-1)
        while pending.size:
            y = self._walk(pending)
            done = y < np.uint64(self.n)
            result.reshape(-1)[pos[done]] = y[done]
            pending, pos = y[~done], pos[~done]
        return result.astype(np.int64).reshape(np.shape(idx))


def permuted_indices(n: int, seed: int, epoch: int, start: int, count: int) -> np.ndarray:
    """``epoch_permutation(n, seed, epoch)[start:start+count]`` without the
    O(n) permutation: O(count) work and memory."""
    perm = FeistelPermutation(n, seed, epoch)
    return perm(np.arange(start, start + count, dtype=np.int64))


# ---------------------------------------------------------------------------
# Columnar store
# ---------------------------------------------------------------------------


def build_store(ds: RatingsDataset, directory: str, *, shard_rows: int = 1 << 20) -> str:
    """One-shot converter: in-memory arrays to columnar shard files.

    Each shard file is three contiguous blocks (``user[int32] | item[int32]
    | rating[float32]``) of at most ``shard_rows`` rows; ``index.json``
    carries the dataset-level metadata (counts, rating range, global mean,
    each shard's CRC-32) so training never needs the source arrays again.
    Returns ``directory``.
    """
    if shard_rows <= 0:
        raise ValueError(f"shard_rows must be positive, got {shard_rows}")
    os.makedirs(directory, exist_ok=True)
    n = len(ds)
    shards: List[Dict[str, object]] = []
    for start in range(0, max(n, 1), shard_rows):
        rows = min(shard_rows, n - start)
        if rows <= 0:
            break
        name = f"shard_{len(shards):05d}.bin"
        crc = 0
        with open(os.path.join(directory, name), "wb") as f:
            for block in (
                np.ascontiguousarray(ds.user[start:start + rows], np.int32).tobytes(),
                np.ascontiguousarray(ds.item[start:start + rows], np.int32).tobytes(),
                np.ascontiguousarray(ds.rating[start:start + rows], np.float32).tobytes(),
            ):
                f.write(block)
                crc = zlib.crc32(block, crc)
        shards.append({"file": name, "rows": int(rows), "crc32": crc})
    index = {
        "version": _STORE_VERSION,
        "num_examples": int(n),
        "num_users": int(ds.num_users),
        "num_items": int(ds.num_items),
        "rating_min": float(ds.rating_min),
        "rating_max": float(ds.rating_max),
        "global_mean": float(ds.global_mean),
        "shard_rows": int(shard_rows),
        "shards": shards,
    }
    tmp = os.path.join(directory, _INDEX_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(index, f, indent=2)
    os.replace(tmp, os.path.join(directory, _INDEX_NAME))
    return directory


class RatingsStore:
    """Read side of the columnar store: dataset-shaped metadata plus an
    mmap-backed :meth:`gather` that touches only the pages it needs.

    Each shard with a ``crc32`` in ``index.json`` is verified once, on first
    open (one sequential read; the pages are about to be gathered anyway).
    A mismatch quarantines the shard and raises :class:`CorruptShardError`.
    Indexes written before the checksum existed (no ``crc32``) load without
    verification; ``verify_checksums=False`` opts out (benchmarking only).
    """

    def __init__(self, directory: str, *, verify_checksums: bool = True):
        self.directory = directory
        self.verify_checksums = bool(verify_checksums)
        self._verified: set = set()
        with open(os.path.join(directory, _INDEX_NAME)) as f:
            index = json.load(f)
        if index.get("version") != _STORE_VERSION:
            raise ValueError(
                f"unsupported store version {index.get('version')!r} "
                f"(expected {_STORE_VERSION})")
        self.num_examples = int(index["num_examples"])
        self.num_users = int(index["num_users"])
        self.num_items = int(index["num_items"])
        self.rating_min = float(index["rating_min"])
        self.rating_max = float(index["rating_max"])
        self.global_mean = float(index["global_mean"])
        self.shard_rows = int(index["shard_rows"])
        self._shards = [(s["file"], int(s["rows"]), s.get("crc32")) for s in index["shards"]]
        rows = np.array([r for _, r, _ in self._shards], np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(rows)])
        if self._offsets[-1] != self.num_examples:
            raise ValueError(
                f"index.json inconsistent: shards sum to {self._offsets[-1]} "
                f"rows but num_examples={self.num_examples}")
        self._maps: Dict[int, Tuple[np.memmap, np.memmap, np.memmap]] = {}
        self._maps_lock = threading.Lock()

    def __len__(self) -> int:
        return self.num_examples

    def _verify_shard(self, shard: int, path: str, expected: int) -> None:
        crc = 0
        with open(path, "rb") as f:
            while True:
                block = f.read(1 << 20)
                if not block:
                    break
                crc = zlib.crc32(block, crc)
        if crc != int(expected):
            quarantine = path + ".corrupt"
            try:
                os.rename(path, quarantine)
            except OSError:
                quarantine = path  # could not move it; still refuse to serve it
            raise CorruptShardError(
                f"shard {shard} ({os.path.basename(path)}) fails its index.json "
                f"crc32; quarantined at {quarantine}")

    def _columns(self, shard: int) -> Tuple[np.memmap, np.memmap, np.memmap]:
        with self._maps_lock:
            cols = self._maps.get(shard)
            if cols is None:
                name, rows, crc = self._shards[shard]
                path = os.path.join(self.directory, name)
                if self.verify_checksums and crc is not None and shard not in self._verified:
                    self._verify_shard(shard, path, crc)
                    self._verified.add(shard)
                cols = (
                    np.memmap(path, np.int32, "r", offset=0, shape=(rows,)),
                    np.memmap(path, np.int32, "r", offset=4 * rows, shape=(rows,)),
                    np.memmap(path, np.float32, "r", offset=8 * rows, shape=(rows,)),
                )
                self._maps[shard] = cols
            return cols

    def gather(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Gather rows by global example index (any order, duplicates OK);
        returns fresh host arrays ``(user, item, rating)``."""
        idx = np.asarray(idx, np.int64)
        user = np.empty(idx.shape, np.int32)
        item = np.empty(idx.shape, np.int32)
        rating = np.empty(idx.shape, np.float32)
        self._gather_into(idx, user, item, rating)
        return user, item, rating

    def _gather_into(self, idx: np.ndarray, user: np.ndarray, item: np.ndarray,
                     rating: np.ndarray) -> None:
        """:meth:`gather` into caller-owned arrays of ``idx``'s shape, grouped
        per shard so each shard's mmap is fancy-indexed once."""
        if idx.size and (idx.min() < 0 or idx.max() >= self.num_examples):
            raise IndexError(f"example index out of range [0, {self.num_examples})")
        shard_of = np.searchsorted(self._offsets, idx, side="right") - 1
        for s in np.unique(shard_of):
            mask = shard_of == s
            local = idx[mask] - self._offsets[s]
            u_col, i_col, r_col = self._columns(int(s))
            user[mask] = u_col[local]
            item[mask] = i_col[local]
            rating[mask] = r_col[local]

    def iter_shards(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield each shard's ``(user, item, rating)`` columns in order: the
        sequential-scan primitive for converters and evaluators."""
        for s in range(len(self._shards)):
            yield self._columns(s)

    def to_dataset(self) -> RatingsDataset:
        """Materialize the whole store in memory (small stores, tests)."""
        if self._shards:
            cols = list(zip(*self.iter_shards()))
            user, item, rating = (np.concatenate([np.asarray(c) for c in col]) for col in cols)
        else:
            user = np.empty(0, np.int32)
            item = np.empty(0, np.int32)
            rating = np.empty(0, np.float32)
        return RatingsDataset(user=user, item=item, rating=rating, num_users=self.num_users,
                              num_items=self.num_items, rating_min=self.rating_min,
                              rating_max=self.rating_max)


# ---------------------------------------------------------------------------
# Streaming epoch loader
# ---------------------------------------------------------------------------


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


_SENTINEL = object()


@dataclasses.dataclass(frozen=True)
class SlabBatches:
    """One prefetched slab: device-resident ``(steps, B)`` batch tensors
    (``user``, ``item`` int64, ``rating`` float32), and the worker's
    ``timings`` of it in ms: ``perm`` and ``gather`` on the host clock,
    ``copy`` (host to device, the id casts included) on CUDA events."""

    slab_idx: int
    steps: int
    batches: Dict[str, torch.Tensor]
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def host_bytes(self) -> int:
        """Host bytes of the slab as gathered (12 a rating)."""
        return self.steps * int(self.batches["user"].shape[1]) * _ROW_BYTES


class ShardedRatingsLoader:
    """Streams shuffled ``(slab_steps, B)`` epoch slabs from a
    :class:`RatingsStore` through a bounded prefetch queue, onto ``device``
    (default ``cuda``).

    ``epoch_slabs(seed, epoch)`` yields :class:`SlabBatches` whose
    concatenation over an epoch is one deterministic shuffled pass keyed by
    ``(seed, epoch)``.  The worker gathers slab ``s + 1`` and copies it while
    the caller trains on slab ``s``; the queue depth (``prefetch``) bounds
    host memory, not the dataset.
    """

    def __init__(
        self,
        store: RatingsStore,
        batch_size: int,
        *,
        slab_steps: int = 256,
        prefetch: int = 2,
        device: DeviceLike = None,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if slab_steps <= 0:
            raise ValueError(f"slab_steps must be positive, got {slab_steps}")
        if prefetch <= 0:
            raise ValueError(f"prefetch must be positive, got {prefetch}")
        self.store = store
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread selects the card by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.batch_size = int(min(batch_size, max(len(store), 1)))
        self.num_steps = len(store) // self.batch_size
        if self.num_steps == 0:
            raise ValueError(
                f"dataset has {len(store)} examples < batch_size "
                f"{self.batch_size}; nothing to stream")
        self.slab_steps = int(min(slab_steps, self.num_steps))
        self.num_slabs = -(-self.num_steps // self.slab_steps)
        self.prefetch = int(prefetch)

    @property
    def num_examples(self) -> int:
        return len(self.store)

    def slab_bounds(self, slab_idx: int) -> Tuple[int, int]:
        """Half-open ``[start_step, end_step)`` of one slab (the last is ragged)."""
        if not 0 <= slab_idx < self.num_slabs:
            raise IndexError(f"slab {slab_idx} out of [0, {self.num_slabs})")
        start = slab_idx * self.slab_steps
        return start, min(start + self.slab_steps, self.num_steps)

    def _load_slab(self, perm: Optional[FeistelPermutation], slab_idx: int,
                   side: Optional["torch.cuda.Stream"]):
        """Permute, gather and copy one slab; returns ``(SlabBatches, event)``
        with the event the copy recorded (None on the CPU)."""
        start, end = self.slab_bounds(slab_idx)
        steps, b = end - start, self.batch_size
        n = steps * b
        on_cuda = side is not None
        host = {key: torch.empty(n, dtype=dtype, pin_memory=on_cuda)
                for key, dtype in (("user", torch.int32), ("item", torch.int32),
                                   ("rating", torch.float32))}
        cols = [host[key].numpy() for key in ("user", "item", "rating")]
        perm_s = gather_s = 0.0
        for lo in range(0, n, _GATHER_ROWS):
            hi = min(lo + _GATHER_ROWS, n)
            t0 = time.perf_counter()
            idx = np.arange(start * b + lo, start * b + hi, dtype=np.int64)
            if perm is not None:
                idx = perm(idx)
            t1 = time.perf_counter()
            self.store._gather_into(idx, *(col[lo:hi] for col in cols))
            perm_s += t1 - t0
            gather_s += time.perf_counter() - t1
        timings = {"perm": perm_s * 1e3, "gather": gather_s * 1e3}
        ready = None
        if on_cuda:
            with torch.cuda.stream(side):
                begin = torch.cuda.Event(enable_timing=True)
                begin.record(side)
                dev = {
                    "user": host["user"].to(self.device, non_blocking=True).long(),
                    "item": host["item"].to(self.device, non_blocking=True).long(),
                    "rating": host["rating"].to(self.device, non_blocking=True),
                }
                ready = torch.cuda.Event(enable_timing=True)
                ready.record(side)
            # the pinned buffers may be reused once the copy has landed
            ready.synchronize()
            timings["copy"] = begin.elapsed_time(ready)
        else:
            dev = {"user": host["user"].long(), "item": host["item"].long(),
                   "rating": host["rating"]}
        batches = {key: value.view(steps, b) for key, value in dev.items()}
        return SlabBatches(slab_idx=slab_idx, steps=steps, batches=batches,
                           timings=timings), ready

    def epoch_slabs(
        self,
        seed: int,
        epoch: int,
        *,
        start_slab: int = 0,
        shuffle: bool = True,
    ) -> Iterator[SlabBatches]:
        """Yield the epoch's slabs from ``start_slab`` on, prefetched.

        The same ``(seed, epoch)`` always yields the same example-to-batch
        assignment, so a resume from ``start_slab`` sees exactly the slabs
        an uninterrupted epoch would have run from that point.  A worker
        error is raised here, in the consumer; closing the generator early
        stops the worker.
        """
        if not 0 <= start_slab <= self.num_slabs:
            raise ValueError(f"start_slab {start_slab} out of [0, {self.num_slabs}]")
        perm = FeistelPermutation(self.num_examples, seed, epoch) if shuffle else None
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        device = self.device

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                side = None
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                    side = torch.cuda.Stream(device)
                for slab_idx in range(start_slab, self.num_slabs):
                    if stop.is_set() or not put(self._load_slab(perm, slab_idx, side)):
                        return
                payload = _SENTINEL
            except BaseException as exc:  # noqa: BLE001 -- re-raised in the consumer
                payload = _WorkerError(exc)
            put(payload)

        thread = threading.Thread(target=worker, name="ratings-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                got = q.get()
                if got is _SENTINEL:
                    return
                if isinstance(got, _WorkerError):
                    raise got.exc
                slab, ready = got
                if ready is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(ready)
                    for value in slab.batches.values():
                        value.record_stream(stream)
                yield slab
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.1)
