"""Prequential *ranking* evaluation for rating-free streams.

Counterpart of ``repro/eval/prequential_ranking.py``.  Click streams carry
no rating, but they support a sharper question: was the clicked item in the
top-k we actually served?  :class:`PrequentialRankingEvaluator` answers it
test-then-learn: every incoming :class:`~repro_torch.online.stream.EventBatch`
is first ranked through the pruned serving path (a live
:class:`~repro_torch.serving.engine.ServingEngine`, which on the card is the
``pruned_topk`` kernel, with whatever snapshot lag it carries; or the
updater's own factors), scored as HR@K / MRR@K against the event's item,
and only then applied as a training update.

Every event is attributed to the ``new`` or ``established`` cohort by how
many stream events its user had before this one (``new_user_events``).
Events naming users or items the serving side does not know yet count as
misses in their cohort.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.eval import ranking as ranking_eval
from repro_torch.online.stream import EventBatch, RatingFreeStreamError


@dataclasses.dataclass
class _CohortAccumulator:
    """Lifetime hit/reciprocal-rank sums for one user cohort."""

    events: int = 0
    hits: int = 0
    rr_sum: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        """``{"events", "hit_rate", "mrr"}`` view (NaN when empty)."""
        n = self.events
        return {
            "events": n,
            "hit_rate": self.hits / n if n else float("nan"),
            "mrr": self.rr_sum / n if n else float("nan"),
        }


class _HitWindow:
    """Fixed-capacity 0/1 ring buffer — windowed hit rate over the last
    ``capacity`` scored events."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"window must be positive, got {capacity}")
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float64)
        self._pos = 0
        self.count = 0

    def extend(self, hits: np.ndarray) -> None:
        n = hits.size
        if n >= self.capacity:
            self._buf[:] = hits[n - self.capacity:]
            self._pos, self.count = 0, self.capacity
            return
        idx = (self._pos + np.arange(n)) % self.capacity
        self._buf[idx] = hits
        self._pos = int((self._pos + n) % self.capacity)
        self.count = min(self.count + n, self.capacity)

    def mean(self) -> float:
        if self.count == 0:
            return float("nan")
        return float(self._buf[: self.count].sum() / self.count)


@dataclasses.dataclass(frozen=True)
class PrequentialRankingStats:
    """One consistent view of the evaluator's accumulators."""

    topk: int
    events: int            # events scored so far
    hit_rate: float        # lifetime HR@K ("served the clicked item")
    mrr: float             # lifetime MRR@K (reciprocal rank, 0 on miss)
    window_hit_rate: float  # HR@K over the last `window` events
    window_events: int
    cohorts: Dict[str, Dict[str, float]]  # "new" / "established" views

    def as_dict(self) -> Dict[str, float]:
        """Flat summary for JSON run reports (cohorts inlined by prefix)."""
        out = {
            "topk": self.topk,
            "events": self.events,
            "hit_rate": self.hit_rate,
            "mrr": self.mrr,
            "window_hit_rate": self.window_hit_rate,
            "window_events": self.window_events,
        }
        for name, view in self.cohorts.items():
            for key, value in view.items():
                out[f"{name}_{key}"] = value
        return out


class PrequentialRankingEvaluator:
    """Test-then-learn top-k evaluation of the pruned serving path.

    ``score(batch)`` ranks each event's user through the serving path and
    checks whether the event's item appears in the served top-``topk``
    (HR@K) and at which position (MRR@K), *before* any update.
    ``consume(batch)`` then applies the batch through the wrapped
    :class:`~repro_torch.online.updater.OnlineUpdater` — converting rating-free
    clicks first via ``update_fn`` (e.g. a
    :func:`repro_torch.workloads.implicit.implicit_event_batch` partial).

    The ranking source, most-production-like first:

    * ``engine`` — a live :class:`~repro_torch.serving.engine.ServingEngine`;
      rankings reflect exactly what was served, including snapshot lag
      between updater and engine;
    * ``rank_fn(users, topk) -> (scores, indices)`` — any custom path, such
      as ``engine.topk_sharded`` on a mesh (every rank consuming the same
      stream) or a serving fleet's router (submit each user, stack the
      rows);
    * neither — the updater's own factors ranked through the pruned
      brute-force pass (:func:`repro_torch.eval.ranking.dense_topk` at the
      updater's live thresholds).

    Ordering guarantee (pinned by ``tests/test_torch_online.py``):
    an event NEVER influences its own ranking — scoring happens strictly
    before the update, so a clicked item absent from the pre-update top-k
    scores a miss even if the update would immediately surface it.
    """

    def __init__(
        self,
        updater=None,
        *,
        engine=None,
        rank_fn: Optional[Callable] = None,
        topk: int = 10,
        window: int = 2048,
        new_user_events: int = 3,
        update_fn: Optional[Callable[[EventBatch], EventBatch]] = None,
    ):
        if topk <= 0:
            raise ValueError(f"topk must be positive, got {topk}")
        if new_user_events <= 0:
            raise ValueError(
                f"new_user_events must be positive, got {new_user_events}"
            )
        if updater is None and engine is None and rank_fn is None:
            raise ValueError(
                "need a ranking source: an updater, an engine, or a rank_fn"
            )
        self.updater = updater
        self.engine = engine
        self.rank_fn = rank_fn
        self.topk = topk
        self.new_user_events = new_user_events
        self.update_fn = update_fn
        self.window = _HitWindow(window)
        self.events = 0
        self._hits = 0
        self._rr_sum = 0.0
        self._cohorts = {
            "new": _CohortAccumulator(),
            "established": _CohortAccumulator(),
        }
        self._seen: Dict[int, int] = {}   # user -> scored events so far

    # -- ranking plumbing ---------------------------------------------------
    def _capacity(self):
        """(num_users, num_items) the ranking source can serve."""
        if self.rank_fn is not None:
            return None, None   # caller-owned: assume it serves everything
        if self.engine is not None:
            return self.engine.num_external, self.engine.n_items
        p = self.updater.params
        return p.p.shape[0], p.q.shape[0]

    def _rank(self, users: np.ndarray) -> np.ndarray:
        """(B, topk) served item indices for the given user rows."""
        if self.rank_fn is not None:
            _, idx = self.rank_fn(users, self.topk)
        elif self.engine is not None:
            _, idx = self.engine.topk(users, self.topk)
        else:
            upd = self.updater
            _, idx = ranking_eval.dense_topk(
                upd.params, users, self.topk,
                t_p=upd.t_p, t_q=upd.t_q,
                hist=upd.user_history,
            )
        return np.asarray(idx)

    # -- scoring ------------------------------------------------------------
    def score(self, batch: EventBatch) -> Dict[str, float]:
        """Score one batch against the CURRENT serving state (no update).

        Returns the batch's own ``{"hit_rate", "mrr", "events"}``; the
        running views live on :attr:`stats`.  Works on rated and
        rating-free batches alike — the rating column is never read.
        """
        n = len(batch)
        if n == 0:
            return {"hit_rate": float("nan"), "mrr": float("nan"),
                    "events": 0}
        users = np.asarray(batch.user, np.int64)
        items = np.asarray(batch.item, np.int64)
        max_u, max_i = self._capacity()
        servable = np.ones(n, bool)
        if max_u is not None:
            servable = (users < max_u) & (items < max_i)

        hits = np.zeros(n, np.float64)
        rr = np.zeros(n, np.float64)
        if servable.any():
            idx = self._rank(users[servable].astype(np.int32))
            pos_mask = idx == items[servable, None]      # (B_s, K)
            hit_rows = pos_mask.any(axis=1)
            first_pos = np.argmax(pos_mask, axis=1)
            hits[servable] = hit_rows.astype(np.float64)
            rr[servable] = np.where(hit_rows, 1.0 / (first_pos + 1.0), 0.0)

        # cohort attribution uses the PRE-batch view of each user's history,
        # processed in stream order so an intra-batch repeat establishes
        for row in range(n):
            u = int(users[row])
            prior = self._seen.get(u, 0)
            cohort = (
                self._cohorts["new"] if prior < self.new_user_events
                else self._cohorts["established"]
            )
            cohort.events += 1
            cohort.hits += int(hits[row])
            cohort.rr_sum += rr[row]
            self._seen[u] = prior + 1

        self.events += n
        self._hits += int(hits.sum())
        self._rr_sum += float(rr.sum())
        self.window.extend(hits)
        return {
            "hit_rate": float(hits.sum() / n),
            "mrr": float(rr.sum() / n),
            "events": n,
        }

    def consume(self, batch: EventBatch) -> Dict[str, float]:
        """Test-then-learn: :meth:`score`, then apply through the updater.

        Rating-free batches require ``update_fn`` (clicks → weighted binary
        preferences); without one this raises
        :class:`~repro_torch.online.stream.RatingFreeStreamError` *after* scoring
        — the evaluation is ranking-only either way.  Returns the batch's
        ranking metrics merged with the updater's step metrics.
        """
        eval_metrics = self.score(batch)
        if self.updater is None or len(batch) == 0:
            return eval_metrics
        update_batch = batch
        if self.update_fn is not None:
            update_batch = self.update_fn(batch)
        elif batch.rating is None:
            raise RatingFreeStreamError(
                "consume() needs ratings to train on; pass update_fn= (e.g. "
                "a repro_torch.workloads.implicit.implicit_event_batch partial) "
                "to convert rating-free clicks into update batches."
            )
        update_metrics = self.updater.apply(update_batch)
        return {**update_metrics, **eval_metrics}

    # -- views --------------------------------------------------------------
    @property
    def stats(self) -> PrequentialRankingStats:
        """Current ranking views (see the class docstring)."""
        n = max(self.events, 1)
        return PrequentialRankingStats(
            topk=self.topk,
            events=self.events,
            hit_rate=self._hits / n,
            mrr=self._rr_sum / n,
            window_hit_rate=self.window.mean(),
            window_events=self.window.count,
            cohorts={
                name: acc.as_dict() for name, acc in self._cohorts.items()
            },
        )
