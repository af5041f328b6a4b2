"""Batched top-k recommendation engine over a trained DP-MF model, on one
device.

Counterpart of ``repro/serving/engine.py`` (single device; hot swaps, the
eviction remap and catalog sharding come in later slices).  The engine:

* **loads once, serves many**: per-item effective ranks ``r_i``, item biases
  and per-user constants are computed at load, the scoring layouts on first
  use;
* **never materializes (B, n)**: on CUDA every request batch goes through the
  hand-written ``pruned_topk`` kernel, which reads the raw factors and ranks
  (no padded copy); on the CPU through the plain streaming merge over
  rank-masked item tiles;
* **micro-batches**: request batches are padded to power-of-two buckets
  (``serving/batching.py``), chunked at ``max_batch``;
* **caches hot users**: SVD++ user vectors go through an LRU;
* **pipelines requests**: ``submit()`` hands a request to the continuous
  batching queue (``serving/queue.py``) and returns a future.

Scores returned are full model scores: user and global biases are added on
the host after ranking, since a per-user constant never changes the order.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import mf
from repro_torch.core.ranks import effective_ranks, rank_mask
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pruned_topk import (
    pruned_topk_ranked,
    stream_topk_tiles,
    tile_catalog,
)
from repro_torch.serving.batching import LRUCache, bucket_size


def load_mf_checkpoint(
    directory: str, *, step: Optional[int] = None, device: DeviceLike = None
) -> Tuple[mf.MFParams, torch.Tensor, torch.Tensor, Optional[torch.Tensor], dict]:
    """Load a DP-MF trainer checkpoint for serving, onto ``device``.

    Restores the full ``MFParams`` (biases, global mean and SVD++ implicit
    factors when the checkpoint has them).  Returns
    ``(params, t_p, t_q, perm, metadata)``; missing thresholds are 0.
    """
    dev = resolve_device(device)
    data, meta = ckpt_lib.load_raw(directory, step)
    params = mf.params_from_flat(data, device=dev)

    def threshold(key):
        value = np.float32(data[key]) if key in data else np.float32(0.0)
        return torch.tensor(value, dtype=torch.float32, device=dev)

    perm = torch.as_tensor(data["perm"]).to(dev) if "perm" in data else None
    return params, threshold("t_p"), threshold("t_q"), perm, meta


class _Snapshot:
    """One factor version plus everything derived from it.  Scoring captures
    ``engine._snap`` once per request batch."""

    def __init__(
        self,
        version: int,
        params: mf.MFParams,
        t_p,
        t_q,
        *,
        device: torch.device,
        block_n: int,
        cache: LRUCache,
        user_history: Optional[np.ndarray],
    ):
        self.version = version
        self.params = params
        self.device = device
        self.t_p = torch.as_tensor(t_p, dtype=torch.float32).to(device)
        self.t_q = torch.as_tensor(t_q, dtype=torch.float32).to(device)
        self.num_users, self.k = params.p.shape
        self.n_items = params.q.shape[0]
        self.block_n = block_n
        self.cache = cache
        self.user_history = user_history
        self.r_i = effective_ranks(params.q, self.t_q)
        self.item_bias_vec = (
            params.item_bias[:, 0].float().contiguous()
            if params.item_bias is not None
            else torch.zeros((self.n_items,), dtype=torch.float32, device=device)
        )
        # per-user additive constant, folded in after top-k on the host
        self.user_const = (
            (params.user_bias[:, 0].float() + params.global_mean).cpu().numpy()
            if params.user_bias is not None else None
        )
        self._stream_layout = None
        self._kernel_layout = None
        self._build_lock = threading.Lock()

    def stream_layout(self):
        """Rank-masked float32 item tiles of the plain (CPU) path."""
        with self._build_lock:
            if self._stream_layout is None:
                qm = self.params.q.float() * rank_mask(self.r_i, self.k)
                self._stream_layout = tile_catalog(qm, self.item_bias_vec, self.block_n)
            return self._stream_layout

    def kernel_layout(self):
        """Operands of the CUDA kernel: raw float32 factors, ranks, biases
        (no copy when ``q`` is already contiguous float32)."""
        with self._build_lock:
            if self._kernel_layout is None:
                self._kernel_layout = (
                    self.params.q.float().contiguous(), self.r_i, self.item_bias_vec,
                )
            return self._kernel_layout


class ServingEngine:
    """Load a DP-MF model once; answer batched top-k requests forever.

    Runs on ``device`` (default ``cuda``; ``"cpu"`` selects the plain PyTorch
    path), moving ``params`` there.  ``max_batch`` caps a scoring launch;
    larger requests are chunked.  ``block_n`` sizes the item tiles of the
    CPU path only.  Top-k entry points return ``(scores, indices)`` numpy
    arrays, scores descending, ties to the lower item index.
    """

    def __init__(
        self,
        params: mf.MFParams,
        t_p=0.0,
        t_q=0.0,
        *,
        device: DeviceLike = None,
        max_batch: int = 256,
        block_n: int = 1024,
        cache_size: int = 4096,
        user_history: Optional[np.ndarray] = None,
        allow_missing_history: bool = False,
    ):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.block_n = block_n
        self.cache_size = cache_size
        params = mf.MFParams(
            *(None if v is None else v.to(self.device) for v in params)
        )
        history = self._resolve_history(params, user_history, allow_missing_history)
        cache = LRUCache(cache_size if params.implicit is not None else 0)
        self._snap = _Snapshot(
            0, params, t_p, t_q, device=self.device, block_n=block_n,
            cache=cache, user_history=history,
        )
        self._queue = None  # async frontend, created by start()/submit()
        self._queue_lock = threading.Lock()  # guards _queue transitions
        self._stopping = False               # stop() drain in progress

    @staticmethod
    def _resolve_history(params, user_history, allow_missing_history):
        history = None if user_history is None else np.asarray(user_history)
        if params.implicit is not None and history is None:
            if not allow_missing_history:
                raise ValueError(
                    "SVD++ params need user_history, or pass "
                    "allow_missing_history=True to serve from p alone"
                )
            # every entry is the implicit table's padding row: vectors = p_u
            history = np.full((params.p.shape[0], 1), params.q.shape[0], np.int32)
        return history

    @classmethod
    def from_checkpoint(
        cls, directory: str, *, step: Optional[int] = None,
        device: DeviceLike = None, **kwargs,
    ) -> "ServingEngine":
        """Build an engine from a trainer checkpoint directory (full
        ``MFParams`` and the trained thresholds); ``kwargs`` pass to the
        constructor."""
        params, t_p, t_q, _, _ = load_mf_checkpoint(directory, step=step, device=device)
        return cls(params, t_p, t_q, device=device, **kwargs)

    # -- read-only state ----------------------------------------------------
    @property
    def version(self) -> int:
        """Version of the served snapshot (0: this slice has no swaps)."""
        return self._snap.version

    @property
    def params(self) -> mf.MFParams:
        """Factor tables of the current snapshot."""
        return self._snap.params

    @property
    def t_p(self) -> torch.Tensor:
        """User-side pruning threshold."""
        return self._snap.t_p

    @property
    def t_q(self) -> torch.Tensor:
        """Item-side pruning threshold."""
        return self._snap.t_q

    @property
    def r_i(self) -> torch.Tensor:
        """(n,) per-item effective ranks."""
        return self._snap.r_i

    @property
    def num_users(self) -> int:
        """User-table rows (valid request ids are ``[0, num_users)``)."""
        return self._snap.num_users

    @property
    def n_items(self) -> int:
        """Catalog size."""
        return self._snap.n_items

    @property
    def k(self) -> int:
        """Latent dimension."""
        return self._snap.k

    @property
    def user_history(self) -> Optional[np.ndarray]:
        """(m, H) SVD++ implicit-history matrix, or None."""
        return self._snap.user_history

    @property
    def vector_cache(self) -> LRUCache:
        """Hot-user vector LRU (zero capacity unless SVD++)."""
        return self._snap.cache

    # -- user vectors --------------------------------------------------------
    def _user_vectors(self, snap: _Snapshot, user_ids: np.ndarray) -> torch.Tensor:
        """(B, k) user vectors: plain rows, or SVD++ history-aggregated rows
        memoized per user in the LRU."""
        if snap.params.implicit is None:
            idx = torch.as_tensor(user_ids, dtype=torch.long).to(snap.device)
            return snap.params.p[idx]
        rows = [snap.cache.get(int(u)) for u in user_ids]
        missing = [i for i, r in enumerate(rows) if r is None]
        if missing:
            miss_ids = np.asarray([user_ids[i] for i in missing], np.int64)
            hist = torch.as_tensor(snap.user_history[miss_ids], dtype=torch.long)
            fresh = mf._user_vector(
                snap.params,
                torch.as_tensor(miss_ids).to(snap.device),
                hist.to(snap.device),
            )
            for slot, row in zip(missing, fresh):
                rows[slot] = row
                snap.cache.put(int(user_ids[slot]), row)
        return torch.stack(rows)

    # -- scoring -------------------------------------------------------------
    def _topk_block(self, snap: _Snapshot, pu: torch.Tensor, topk: int):
        r_u = effective_ranks(pu, snap.t_p)
        if pu.is_cuda:
            q, r_i, bias = snap.kernel_layout()
            return pruned_topk_ranked(pu.float().contiguous(), q, r_u, r_i, bias, topk)
        q_tiles, b_tiles, offs = snap.stream_layout()
        pm = pu.float() * rank_mask(r_u, snap.k)
        return stream_topk_tiles(pm, q_tiles, b_tiles, offs, topk=topk)

    def _validate_request(self, user_ids, topk: int) -> np.ndarray:
        return self._validate_for(self._snap, user_ids, topk)

    @staticmethod
    def _validate_for(snap: _Snapshot, user_ids, topk: int) -> np.ndarray:
        if not 0 < topk <= snap.n_items:
            raise ValueError(f"topk must be in [1, {snap.n_items}], got {topk}")
        ids = np.asarray(user_ids, np.int64).reshape(-1)
        # checked on the host before any gather: an out-of-range index on
        # CUDA is a device-side assert that poisons the context
        bad = (ids < 0) | (ids >= snap.num_users)
        if bad.any():
            raise ValueError(
                f"unknown user ids {ids[bad][:5].tolist()} "
                f"(catalog has {snap.num_users} users)"
            )
        return ids

    def _run_chunked(self, snap: _Snapshot, ids: np.ndarray, topk: int):
        """Split into max_batch chunks, pad each chunk to its power-of-two
        bucket, score, fold the user constants back in."""
        out_s = np.empty((len(ids), topk), np.float32)
        out_i = np.empty((len(ids), topk), np.int32)
        for lo in range(0, len(ids), self.max_batch):
            chunk = ids[lo : lo + self.max_batch]
            bucket = bucket_size(len(chunk), self.max_batch)
            padded = np.pad(chunk, (0, bucket - len(chunk)), mode="edge")
            pu = self._user_vectors(snap, padded)
            scores, idx = self._topk_block(snap, pu, topk)
            scores = scores[: len(chunk)].cpu().numpy()
            idx = idx[: len(chunk)].cpu().numpy()
            if snap.user_const is not None:
                scores = scores + snap.user_const[chunk][:, None]
            out_s[lo : lo + len(chunk)] = scores
            out_i[lo : lo + len(chunk)] = idx
        return out_s, out_i

    def topk(self, user_ids, topk: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k items for a batch of users: ``(scores, indices)`` as
        (B, topk) numpy arrays, identical to dense score-and-stable-sort."""
        snap = self._snap  # captured once: the whole batch serves one version
        ids = self._validate_for(snap, user_ids, topk)
        if ids.size == 0:
            return np.empty((0, topk), np.float32), np.empty((0, topk), np.int32)
        return self._run_chunked(snap, ids, topk)

    # -- async frontend ------------------------------------------------------
    def start(self, **queue_kwargs):
        """Start the async request pipeline; returns the
        :class:`~repro_torch.serving.queue.RequestQueue` (kwargs such as
        ``max_batch``, ``max_pending``, ``linger_ms`` pass through).
        Restartable after :meth:`stop`."""
        with self._queue_lock:
            return self._start_locked(**queue_kwargs)

    def _start_locked(self, **queue_kwargs):
        from repro_torch.serving.queue import RequestQueue

        if self._queue is not None:
            if not self._queue.closed:
                raise RuntimeError("engine already has a running request queue")
            self._queue = None  # stale handle: queue was closed directly
        self._queue = RequestQueue(self, **queue_kwargs)
        return self._queue

    def submit(self, user_id: int, topk: int = 10, *, timeout=None, priority: int = 0):
        """Async single-user request: a ``concurrent.futures.Future``
        resolving to ``(scores, item_ids)``, byte-identical to the caller's
        row of :meth:`topk`.  Starts a default queue on first use; rejected
        with ``RuntimeError`` while :meth:`stop` drains."""
        with self._queue_lock:
            if self._stopping:
                raise RuntimeError("engine is stopping; request rejected")
            if self._queue is None or self._queue.closed:
                self._start_locked()
            queue = self._queue
        return queue.submit(user_id, topk, timeout=timeout, priority=priority)

    @property
    def queue_depth(self) -> int:
        """Requests queued or being scored by the async frontend."""
        with self._queue_lock:
            queue = self._queue
        return 0 if queue is None or queue.closed else queue.depth

    def stop(self) -> None:
        """Drain and stop the async pipeline: every accepted request
        completes before this returns.  Idempotent."""
        with self._queue_lock:
            if self._stopping:
                return  # another thread's stop() owns the drain
            queue, self._queue = self._queue, None
            self._stopping = True
        try:
            if queue is not None:
                queue.close()  # outside the lock: close() joins the scheduler
        finally:
            with self._queue_lock:
                self._stopping = False

    # -- convenience ---------------------------------------------------------
    def recommend(self, user_ids, topk: int = 10):
        """JSON-friendly form: list of per-user [{item, score}, ...]."""
        scores, idx = self.topk(user_ids, topk)
        return [
            [{"item": int(i), "score": round(float(s), 4)} for i, s in zip(row_i, row_s)]
            for row_i, row_s in zip(idx, scores)
        ]
