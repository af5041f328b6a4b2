"""Confidence-weighted implicit-feedback MF (Hu/Koren/Volinsky, ICDM'08).

Counterpart of ``repro/workloads/implicit.py`` (numpy only).  Implicit
feedback gives no ratings, only observed interactions (clicks, plays,
purchases).  The WALS formulation trains on a binary preference
``p_ui in {0, 1}`` with a per-example confidence ``c_ui = 1 + alpha * r_ui``
(``r_ui`` the interaction strength, 1 for a bare click), minimizing

    sum_ui  c_ui * (p_ui - x_u . y_i)^2  +  lam * (||X||^2 + ||Y||^2).

The binary preference becomes the ``rating`` column and the confidence the
``batch["weight"]`` gate of ``mf.train_step`` / ``fused_mf_sgd``: the weight
scales the update (and the metrics), never the prediction, which is the
WALS gradient ``c_ui * err * y_i``.  So the implicit objective flows through
``train_epoch_scan``, the fused kernel and the ``OnlineUpdater`` unchanged;
this module only owns the data transformation (positives, sampled
negatives, the confidence column).

Unobserved pairs are weak negatives at preference 0 and the floor
confidence 1; ``negatives`` of them are sampled per positive.

Where the reference keeps one Python ``set`` of items per user (100M sets
at the dpmf size) and tests every sampled negative in a Python loop, the
port keeps one sorted ``int64`` array of keys ``u * num_items + i``
(:class:`PositiveSet`) and tests membership with ``np.searchsorted``.  The
random draws are the reference's calls, on the same clash masks, in the
same order, so the negatives are bitwise the reference's for a seed.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.ratings import RatingsDataset
from repro_torch.online.stream import Event, EventBatch, iter_microbatches


def confidence_weights(ratings: np.ndarray, alpha: float) -> np.ndarray:
    """WALS confidence ``c = 1 + alpha * r`` for interaction strengths ``r``."""
    return (1.0 + alpha * np.asarray(ratings, np.float32)).astype(np.float32)


class PositiveSet:
    """The observed (user, item) pairs of a log, for negative rejection: the
    sorted distinct keys ``user * num_items + item`` (int64; 1e8 users x 1e7
    items stays below 2^63).

    Membership sorts the queries before ``np.searchsorted``: unsorted
    queries cost a cache miss per bisection step (10x slower at 8M keys),
    and ``np.unique``/``np.isin`` are slower than a sort on numpy 2.3."""

    def __init__(self, user: np.ndarray, item: np.ndarray, num_items: int):
        self.num_items = int(num_items)
        keys = np.sort(self._key(user, item))
        self.keys = keys[np.concatenate([[True], keys[1:] != keys[:-1]])] if keys.size else keys

    def _key(self, user, item) -> np.ndarray:
        return np.asarray(user, np.int64) * self.num_items + np.asarray(item, np.int64)

    def contains(self, user: np.ndarray, item: np.ndarray) -> np.ndarray:
        """Bool mask: is ``(user[j], item[j])`` an observed pair."""
        key = self._key(user, item)
        hit = np.zeros(key.shape, bool)
        if self.keys.size == 0 or key.size == 0:
            return hit
        order = np.argsort(key)
        ordered = key[order]
        pos = np.minimum(np.searchsorted(self.keys, ordered), self.keys.size - 1)
        hit[order] = self.keys[pos] == ordered
        return hit


def _sample_negatives(
    rng: np.random.Generator,
    users: np.ndarray,
    positives: PositiveSet,
    num_items: int,
    *,
    max_tries: int = 16,
) -> np.ndarray:
    """One uniformly sampled unobserved item per row of ``users``.

    Rejection against the observed pairs, bounded at ``max_tries`` redraws
    (a user who interacted with the whole catalog keeps the last draw: no
    true negative exists for them).  The draws are the reference's: one
    array draw, then one array draw per round over the rows that clashed.
    """
    neg = rng.integers(0, num_items, users.size).astype(np.int32)
    for _ in range(max_tries):
        clash = positives.contains(users, neg)
        if not clash.any():
            break
        neg[clash] = rng.integers(0, num_items, int(clash.sum()))
    return neg


def implicit_dataset(
    ds: RatingsDataset,
    *,
    alpha: float = 40.0,
    negatives: int = 4,
    seed: int = 0,
) -> Tuple[RatingsDataset, np.ndarray]:
    """Derive the WALS training set from an interaction log.

    Every interaction of ``ds`` becomes a positive (preference 1, confidence
    ``1 + alpha * r`` with ``r`` the rating read as interaction strength),
    and each positive draws ``negatives`` sampled unobserved items at
    preference 0, confidence 1.

    Returns ``(binary_ds, confidence)``: a :class:`RatingsDataset` with
    ratings in {0, 1} on the same geometry, plus the aligned confidence
    column to pass as ``pack_ratings(..., weight=...)``.  Deterministic in
    ``seed``.
    """
    if negatives < 0:
        raise ValueError(f"negatives must be >= 0, got {negatives}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    user = np.asarray(ds.user, np.int32)
    item = np.asarray(ds.item, np.int32)
    strength = np.asarray(ds.rating, np.float32)
    n = user.size

    positives = PositiveSet(user, item, ds.num_items)
    users = [user]
    items = [item]
    ratings = [np.ones(n, np.float32)]
    weights = [confidence_weights(strength, alpha)]
    for _ in range(negatives):
        users.append(user)
        items.append(_sample_negatives(rng, user, positives, ds.num_items))
        ratings.append(np.zeros(n, np.float32))
        weights.append(np.ones(n, np.float32))

    binary = RatingsDataset(
        user=np.concatenate(users),
        item=np.concatenate(items),
        rating=np.concatenate(ratings),
        num_users=ds.num_users,
        num_items=ds.num_items,
        rating_min=0.0,
        rating_max=1.0,
    )
    return binary, np.concatenate(weights)


def binarize_positives(ds: RatingsDataset) -> RatingsDataset:
    """Held-out positives as preference-1 examples (no negatives): the
    evaluation side of :func:`implicit_dataset`."""
    return RatingsDataset(
        user=np.asarray(ds.user, np.int32),
        item=np.asarray(ds.item, np.int32),
        rating=np.ones(len(ds), np.float32),
        num_users=ds.num_users,
        num_items=ds.num_items,
        rating_min=0.0,
        rating_max=1.0,
    )


def implicit_event_batch(
    batch: EventBatch,
    *,
    num_items: int,
    alpha: float = 40.0,
    negatives: int = 4,
    rng: Optional[np.random.Generator] = None,
) -> EventBatch:
    """Convert one click micro-batch into a WALS update batch.

    Each event becomes a preference-1 example at confidence ``1 + alpha * r``
    (``r = 1`` when the batch is rating-free) plus ``negatives`` uniformly
    sampled items of the same user at preference 0, confidence 1.  A recency
    ``weight`` column of the incoming batch multiplies the confidence.  The
    result always carries ratings and weights, so it feeds
    ``OnlineUpdater.apply`` directly.

    Rejection is per batch (the stream has no global catalog view): a
    negative must not be clicked in this batch by this user.  A clashing
    row redraws one scalar at a time, up to 16 times, before the next row,
    as the reference does; the clash test is vectorised, the redraws loop
    over the clashing rows only.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    n = len(batch)
    user = np.asarray(batch.user, np.int32)
    item = np.asarray(batch.item, np.int32)
    strength = (
        np.ones(n, np.float32) if batch.rating is None
        else np.asarray(batch.rating, np.float32)
    )
    conf = confidence_weights(strength, alpha)
    if batch.weight is not None:
        conf = conf * np.asarray(batch.weight, np.float32)

    users = [user]
    items = [item]
    ratings = [np.ones(n, np.float32)]
    weights = [conf]
    seen = PositiveSet(user, item, max(num_items, int(item.max(initial=-1)) + 1))
    for _ in range(negatives):
        neg = rng.integers(0, num_items, n).astype(np.int32)
        for row in np.flatnonzero(seen.contains(user, neg)):
            u = user[row : row + 1]
            tries = 0
            while tries < 16 and seen.contains(u, neg[row : row + 1])[0]:
                neg[row] = rng.integers(0, num_items)
                tries += 1
        users.append(user)
        items.append(neg)
        ratings.append(np.zeros(n, np.float32))
        weights.append(
            np.ones(n, np.float32) if batch.weight is None
            else np.asarray(batch.weight, np.float32)
        )
    return EventBatch(
        user=np.concatenate(users),
        item=np.concatenate(items),
        rating=np.concatenate(ratings),
        weight=np.concatenate(weights),
    )


def implicit_microbatches(
    source: Iterable[Event],
    batch_size: int,
    *,
    num_items: int,
    alpha: float = 40.0,
    negatives: int = 4,
    seed: int = 0,
    max_events: Optional[int] = None,
    half_life_s: Optional[float] = None,
) -> Iterator[EventBatch]:
    """Click stream to WALS update batches: :func:`iter_microbatches`
    composed with :func:`implicit_event_batch` (seeded, deterministic)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x11]))
    for batch in iter_microbatches(
        source, batch_size, max_events=max_events, half_life_s=half_life_s
    ):
        yield implicit_event_batch(
            batch, num_items=num_items, alpha=alpha,
            negatives=negatives, rng=rng,
        )


def strip_ratings(source: Iterable[Event]) -> Iterator[Event]:
    """View a rated stream as a rating-free click stream (``rating=None``)."""
    for event in source:
        yield Event(event.user, event.item, None, event.timestamp)
