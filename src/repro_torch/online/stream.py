"""Event sources for the online learning subsystem.

A copy of ``repro/online/stream.py`` (numpy only): the port may not import
the reference package.

Production freshness starts with a stream of ``(user, item, rating)``
interaction events.  Three sources cover the lifecycle:

* :class:`ReplaySource` — replay a :class:`~repro_torch.data.ratings.RatingsDataset`
  (held-out events, a log dump) in deterministic order, optionally for
  multiple passes;
* :class:`PoissonSource` — synthetic traffic: Zipf-popular items, uniform
  users, exponential inter-arrival times under a target event rate, and a
  configurable probability of emitting a *never-seen* user/item id one past
  the current frontier (the cold-start path the updater must handle);
* :class:`IteratorSource` — adapt any iterator of ``(user, item, rating)``
  tuples (a Kafka consumer, a socket reader) into the same interface.

All sources iterate single :class:`Event` records; :func:`iter_microbatches`
accumulates them into fixed-arrays :class:`EventBatch` micro-batches — the
unit the updater consumes.  Everything here is host-side numpy: the stream is
I/O, not math.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Iterator, Optional

import numpy as np


class RatingFreeStreamError(TypeError):
    """A rating-free batch reached a consumer that needs ratings.

    Click/impression streams carry no rating column (``Event.rating is
    None``).  Rating-driven consumers — :class:`~repro_torch.online.updater.
    OnlineUpdater.apply` and :class:`~repro_torch.eval.prequential.
    PrequentialEvaluator` — raise this typed error instead of crashing in a
    numpy cast.  Rating-free streams are served by the ranking-only path
    instead: convert clicks into weighted binary preferences with
    :func:`repro_torch.workloads.implicit.implicit_event_batch`, and evaluate with
    :class:`repro_torch.eval.prequential_ranking.PrequentialRankingEvaluator`.
    """


@dataclasses.dataclass(frozen=True)
class Event:
    """One interaction record on the stream's simulated clock.

    ``rating`` is ``None`` on rating-free streams (clicks, plays,
    impressions) — see :class:`RatingFreeStreamError` for how those are
    consumed.
    """

    user: int
    item: int
    rating: Optional[float]
    timestamp: float = 0.0  # seconds on the source's simulated clock


@dataclasses.dataclass
class EventBatch:
    """A micro-batch of events as contiguous arrays (the updater's unit).

    ``weight`` (optional) is a per-event importance weight in (0, 1] —
    time-decayed recency by default (:func:`iter_microbatches` with
    ``half_life_s``).  It flows through ``batch["weight"]`` in
    ``mf.train_step``: the update (not the prediction) scales by it, so
    stale events move the factors less.
    """

    user: np.ndarray    # (B,) int32
    item: np.ndarray    # (B,) int32
    rating: Optional[np.ndarray]  # (B,) float32; None = rating-free stream
    weight: Optional[np.ndarray] = None  # (B,) float32 update gate

    def __len__(self) -> int:
        return int(self.user.shape[0])

    @classmethod
    def from_events(
        cls,
        events: Iterable[Event],
        *,
        half_life_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> "EventBatch":
        """``half_life_s`` turns on exponential time decay: an event
        ``half_life_s`` seconds older than ``now`` (default: the newest
        event in the batch) gets weight 0.5, twice that 0.25, ...  The
        newest event always carries weight 1, so a trickle of fresh events
        is never down-weighted as a group.

        Rating-free events (``rating is None``) produce a rating-free batch
        (``batch.rating is None``); mixing rated and rating-free events in
        one batch is a :class:`ValueError` — a stream either carries ratings
        or it does not."""
        ev = list(events)
        rated = [e for e in ev if e.rating is not None]
        if rated and len(rated) != len(ev):
            raise ValueError(
                "cannot mix rated and rating-free events in one batch "
                f"({len(rated)}/{len(ev)} carry ratings)"
            )
        batch = cls(
            user=np.asarray([e.user for e in ev], np.int32),
            item=np.asarray([e.item for e in ev], np.int32),
            rating=(
                np.asarray([e.rating for e in ev], np.float32)
                if rated or not ev
                else None
            ),
        )
        if half_life_s is not None and ev:
            if half_life_s <= 0:
                raise ValueError(
                    f"half_life_s must be positive, got {half_life_s}"
                )
            ts = np.asarray([e.timestamp for e in ev], np.float64)
            ref = float(ts.max()) if now is None else float(now)
            batch.weight = np.exp2(
                -np.maximum(ref - ts, 0.0) / half_life_s
            ).astype(np.float32)
        return batch


class ReplaySource:
    """Replay a ratings dataset as an event stream.

    ``epochs`` passes (``None`` = forever); ``shuffle`` draws a fresh
    deterministic permutation per pass (seeded, like the training loader),
    otherwise events replay in stored order — the natural choice for a
    time-ordered log.
    """

    def __init__(self, ds, *, epochs: Optional[int] = 1,
                 shuffle: bool = False, seed: int = 0):
        self.ds = ds
        self.epochs = epochs
        self.shuffle = shuffle
        self.seed = seed
        self.num_users = ds.num_users
        self.num_items = ds.num_items

    def __iter__(self) -> Iterator[Event]:
        passes = itertools.count() if self.epochs is None else range(self.epochs)
        clock = 0.0
        for epoch in passes:
            if self.shuffle:
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch])
                )
                order = rng.permutation(len(self.ds))
            else:
                order = np.arange(len(self.ds))
            for j in order:
                yield Event(
                    int(self.ds.user[j]), int(self.ds.item[j]),
                    float(self.ds.rating[j]), clock,
                )
                clock += 1.0


class PoissonSource:
    """Synthetic live traffic: a Poisson process over a catalog.

    Users are uniform, items Zipf-popular (the long-tail shape real
    interaction streams have), inter-arrival gaps exponential with mean
    ``1 / rate`` on a simulated clock (no wall-clock sleeping — pacing
    belongs to the caller).  With probability ``new_user_prob`` /
    ``new_item_prob`` an event instead introduces a brand-new id one past
    the largest seen so far, which is what exercises the updater's
    cold-start row initialization.  ``rating_fn(user, item, rng)``
    customizes ratings; the default is uniform on ``[rating_min,
    rating_max]``.  Infinite: bound it with ``iter_microbatches(...,
    max_events=N)`` or ``itertools.islice``.
    """

    def __init__(
        self,
        num_users: int,
        num_items: int,
        *,
        rate: float = 1000.0,
        seed: int = 0,
        zipf_a: float = 1.3,
        rating_min: float = 1.0,
        rating_max: float = 5.0,
        new_user_prob: float = 0.0,
        new_item_prob: float = 0.0,
        rating_fn: Optional[Callable[[int, int, np.random.Generator], float]] = None,
    ):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.num_users = num_users
        self.num_items = num_items
        self.rate = rate
        self.seed = seed
        self.zipf_a = zipf_a
        self.rating_min = rating_min
        self.rating_max = rating_max
        self.new_user_prob = new_user_prob
        self.new_item_prob = new_item_prob
        self.rating_fn = rating_fn

    def __iter__(self) -> Iterator[Event]:
        rng = np.random.default_rng(self.seed)
        next_user = self.num_users
        next_item = self.num_items
        clock = 0.0
        while True:
            clock += float(rng.exponential(1.0 / self.rate))
            if self.new_user_prob and rng.random() < self.new_user_prob:
                user, next_user = next_user, next_user + 1
            else:
                user = int(rng.integers(0, next_user))
            if self.new_item_prob and rng.random() < self.new_item_prob:
                item, next_item = next_item, next_item + 1
            else:
                # Zipf with rejection onto the current catalog: popular head,
                # long tail, like the synthetic training data
                item = int(rng.zipf(self.zipf_a)) - 1
                while item >= next_item:
                    item = int(rng.zipf(self.zipf_a)) - 1
            if self.rating_fn is not None:
                rating = float(self.rating_fn(user, item, rng))
            else:
                rating = float(
                    rng.uniform(self.rating_min, self.rating_max)
                )
            yield Event(user, item, rating, clock)


class IteratorSource:
    """Adapt any iterable of ``(user, item, rating)`` / ``(user, item)``
    tuples (or :class:`Event` records) into an event source; two-element
    tuples yield rating-free click events."""

    def __init__(self, it: Iterable):
        self._it = it

    def __iter__(self) -> Iterator[Event]:
        clock = 0.0
        for row in self._it:
            if isinstance(row, Event):
                yield row
            else:
                user, item = row[0], row[1]
                rating = row[2] if len(row) > 2 else None
                yield Event(
                    int(user), int(item),
                    None if rating is None else float(rating), clock,
                )
            clock += 1.0


def iter_microbatches(
    source: Iterable[Event],
    batch_size: int,
    *,
    max_events: Optional[int] = None,
    max_batch_span_s: Optional[float] = None,
    half_life_s: Optional[float] = None,
) -> Iterator[EventBatch]:
    """Accumulate events into :class:`EventBatch` micro-batches.

    A batch closes when it reaches ``batch_size`` events or (if
    ``max_batch_span_s`` is set) when the next event's *simulated* timestamp
    is more than that many seconds past the batch's first event — the
    freshness bound: a trickle of events still reaches the model.  The final
    partial batch is always flushed.  ``max_events`` bounds the total drawn
    from an infinite source.

    ``half_life_s`` enables recency importance weighting: each batch gets a
    ``weight`` column decaying by 0.5 per half-life of age relative to the
    batch's newest event (see :meth:`EventBatch.from_events`), which the
    updater feeds through ``train_step``'s weight gate — older events move
    the factors proportionally less.
    """
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    if max_events is not None:
        source = itertools.islice(iter(source), max_events)
    pending: list = []
    first_ts = 0.0
    for event in source:
        if (
            pending
            and max_batch_span_s is not None
            and event.timestamp - first_ts > max_batch_span_s
        ):
            yield EventBatch.from_events(pending, half_life_s=half_life_s)
            pending = []
        if not pending:
            first_ts = event.timestamp
        pending.append(event)
        if len(pending) >= batch_size:
            yield EventBatch.from_events(pending, half_life_s=half_life_s)
            pending = []
    if pending:
        yield EventBatch.from_events(pending, half_life_s=half_life_s)
