"""Request-side plumbing for the serving engine: micro-batching + caching.

A copy of ``repro/serving/batching.py`` (framework-free), kept here so the
port imports nothing of ``repro``.

Production recommendation traffic arrives as a stream of single-user
requests; scoring them one by one wastes the accelerator (every launch pays
the same fixed cost) while batching naively over arbitrary request counts
recompiles the scoring program per batch shape.  The two pieces here bound
both costs:

* ``bucket_size`` quantizes batch sizes to powers of two so a scoring
  launch sees at most log2(max_batch) batch shapes;
* ``MicroBatcher`` accumulates individual requests and flushes them through
  the engine as one padded batch;
* ``LRUCache`` memoizes computed user vectors (the per-request gather +
  implicit-history aggregation for SVD++) for hot users.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, List, Tuple

import numpy as np


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at ``max_batch``."""
    if n <= 0:
        raise ValueError(f"batch must be positive, got {n}")
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return min(b, max_batch)


class LRUCache:
    """Tiny LRU keyed by user id; tracks hits/misses for bench reporting.

    Thread-safe: the async queue's scheduler thread and direct callers of
    ``engine.topk`` may hit the same cache concurrently, and an OrderedDict
    mutated from two threads can corrupt its link list.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable):
        """Return the cached value (refreshing its recency) or None."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def put(self, key: Hashable, value: Any) -> None:
        """Insert/refresh ``key``, evicting the least-recent past capacity
        (a zero-capacity cache silently drops every put)."""
        if self.capacity <= 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def keys(self):
        """Snapshot of the cached keys (thread-safe copy)."""
        with self._lock:
            return list(self._data.keys())

    def invalidate(self, keys) -> int:
        """Drop the given keys (missing ones are ignored); returns the number
        of entries actually removed.  Used by the serving engine's hot swap
        to evict exactly the users whose vectors a factor update staled."""
        removed = 0
        with self._lock:
            for key in keys:
                if self._data.pop(key, None) is not None:
                    removed += 1
        return removed

    def copy_without(self, keys) -> "LRUCache":
        """New cache with the same capacity, entries minus ``keys``, and the
        hit/miss counters carried over.  The old cache is untouched — an
        in-flight batch may still be writing old-version entries into it,
        which is exactly why hot swaps copy instead of mutating."""
        drop = set(keys)
        clone = LRUCache(self.capacity)
        with self._lock:
            for key, value in self._data.items():
                if key not in drop:
                    clone._data[key] = value
            clone.hits = self.hits
            clone.misses = self.misses
        return clone

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


class MicroBatcher:
    """Collects single-user requests and serves them as one engine batch.

    Synchronous flush model (the event-loop / thread wiring belongs to the
    RPC layer, not here): ``submit`` enqueues and returns a ticket, ``drain``
    scores every pending request in engine-sized chunks and returns
    ``{ticket: (item_ids, scores)}``.  Duplicate user ids within a flush are
    scored once and fanned back out to every ticket.
    """

    def __init__(self, engine, *, topk: int = 10):
        if not 0 < topk <= engine.n_items:
            raise ValueError(
                f"topk must be in [1, {engine.n_items}], got {topk}"
            )
        self.engine = engine
        self.topk = topk
        self._pending: List[Tuple[int, int]] = []  # (ticket, user_id)
        self._next_ticket = 0

    def submit(self, user_id: int) -> int:
        """Enqueue one user's request; returns the ticket to look up in the
        next :meth:`drain`'s result dict."""
        # Validate here, where only the offending request fails — a bad id
        # surfacing inside drain() would take every queued ticket with it.
        uid = int(user_id)
        if not 0 <= uid < self.engine.num_users:
            raise ValueError(
                f"unknown user id {uid} "
                f"(catalog has {self.engine.num_users} users)"
            )
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, uid))
        return ticket

    def drain(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Score all pending tickets; returns {ticket: (scores, item_ids)}."""
        if not self._pending:
            return {}
        pending = self._pending
        users = sorted({uid for _, uid in pending})
        scores, idx = self.engine.topk(users, self.topk)
        self._pending = []  # only after scoring: a failure keeps tickets
        by_user = {uid: row for row, uid in enumerate(users)}
        return {
            ticket: (scores[by_user[uid]], idx[by_user[uid]])
            for ticket, uid in pending
        }
