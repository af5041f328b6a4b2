"""Prequential (test-then-learn) evaluation folded into the online path.

Counterpart of ``repro/eval/prequential.py``.  Every incoming event batch is
**first predicted** with the current model (the pruned forward pass,
``mf.predict_pairs``) and scored, **then applied** as a training update, so
each event is scored once, by a model that has never seen it.

:class:`PrequentialEvaluator` wraps an
:class:`~repro_torch.online.updater.OnlineUpdater` and keeps three error
views over the stream: **cumulative** MAE/RMSE (the lifetime average),
**windowed** over the last ``window`` events (what drift detection keys
off), and **exponentially decayed** with a ``half_life_events`` half-life.
After every consumed batch each drift hook sees the current
:class:`PrequentialStats`; :func:`recalibration_hook` recalibrates the
thresholds when the windowed error degrades.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import mf
from repro_torch.online.stream import EventBatch, RatingFreeStreamError


@dataclasses.dataclass(frozen=True)
class PrequentialStats:
    """One consistent view of the evaluator's error accumulators."""

    events: int          # events scored so far
    mae: float           # cumulative prequential MAE
    rmse: float          # cumulative prequential RMSE
    window_mae: float    # over the last `window` events
    window_rmse: float
    window_events: int   # events currently in the window (<= window)
    ema_mae: float       # exponentially-decayed, bias-corrected
    ema_rmse: float

    def as_dict(self) -> Dict[str, float]:
        """Flat summary for JSON run reports."""
        return dataclasses.asdict(self)


def _prequential_errors(params, user, item, rating, t_p, t_q, hist=None):
    """Per-event |err| and err^2 of the *pre-update* model: the pruned
    forward pass (``mf.predict_pairs``) serving scores with."""
    pred, _ = mf.predict_pairs(params, user, item, t_p, t_q, hist)
    err = rating.float() - pred
    return torch.abs(err), err * err


class _EventWindow:
    """Fixed-capacity ring buffer of per-event (|err|, err^2) pairs.

    Exact event-granular windowing (not batch-granular): a batch larger
    than the window keeps only its newest ``capacity`` events, a trickle of
    small batches ages out one event at a time.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"window must be positive, got {capacity}")
        self.capacity = capacity
        self._abs = np.zeros(capacity, np.float64)
        self._sq = np.zeros(capacity, np.float64)
        self._pos = 0
        self.count = 0

    def extend(self, abs_err: np.ndarray, sq_err: np.ndarray) -> None:
        n = abs_err.size
        if n >= self.capacity:  # batch alone overflows: keep the newest
            self._abs[:] = abs_err[n - self.capacity:]
            self._sq[:] = sq_err[n - self.capacity:]
            self._pos, self.count = 0, self.capacity
            return
        idx = (self._pos + np.arange(n)) % self.capacity
        self._abs[idx] = abs_err
        self._sq[idx] = sq_err
        self._pos = int((self._pos + n) % self.capacity)
        self.count = min(self.count + n, self.capacity)

    def means(self):
        if self.count == 0:
            return float("nan"), float("nan")
        denom = float(self.count)
        if self.count < self.capacity:
            abs_sum = float(self._abs[: self.count].sum())
            sq_sum = float(self._sq[: self.count].sum())
        else:
            abs_sum, sq_sum = float(self._abs.sum()), float(self._sq.sum())
        return abs_sum / denom, float(np.sqrt(sq_sum / denom))


class PrequentialEvaluator:
    """Test-then-learn wrapper around an ``OnlineUpdater``.

    ``consume(batch)`` is the one-call online loop body: score the batch
    with the pre-update model, fold the errors into the running stats,
    apply the batch as a pruned row update, then fire the drift hooks.
    ``score(batch)`` does only the first half (pure evaluation, no model
    movement) — e.g. for shadow-scoring a stream the updater does not own.

    Ordering guarantees (pinned by ``tests/test_torch_online.py``):

    * a rated event NEVER influences its own prediction — scoring happens
      strictly before ``updater.apply``, including the SVD++ history append
      (the event enters its user's implicit set only after being scored);
    * cold-start ids are scored against freshly initialized rows (the
      tables grow *before* prediction — growth draws from the init
      distribution, not from the event's rating, so the prediction is still
      untainted) — the honest prequential cost of an unknown user/item.

    Event ``weight`` columns (recency importance weighting) gate *updates*,
    not evaluation: prequential stats count every event equally.
    """

    def __init__(
        self,
        updater,
        *,
        window: int = 2048,
        half_life_events: float = 4096.0,
        drift_hooks: Optional[
            List[Callable[[PrequentialStats], None]]
        ] = None,
    ):
        if half_life_events <= 0:
            raise ValueError(
                f"half_life_events must be positive, got {half_life_events}"
            )
        self.updater = updater
        self.window = _EventWindow(window)
        self._decay = 0.5 ** (1.0 / float(half_life_events))
        self._hooks = list(drift_hooks or [])
        self.events = 0
        self._abs_sum = 0.0       # float64 lifetime accumulators
        self._sq_sum = 0.0
        self._ema_abs = 0.0       # decayed sums + their weight normalizer
        self._ema_sq = 0.0
        self._ema_norm = 0.0

    def add_drift_hook(
        self, hook: Callable[[PrequentialStats], None]
    ) -> None:
        """Register ``hook(stats)``, called after every :meth:`consume`."""
        self._hooks.append(hook)

    # -- scoring -------------------------------------------------------------
    def score(self, batch: EventBatch) -> Dict[str, float]:
        """Score one batch against the CURRENT model (no update).

        Returns the batch's own ``{"mae", "rmse", "events"}``; the running
        views live on :attr:`stats`.  Ids past the current tables trigger
        cold-start growth first (see the class docstring).
        """
        if len(batch) == 0:
            return {"mae": float("nan"), "rmse": float("nan"), "events": 0}
        if batch.rating is None:
            raise RatingFreeStreamError(
                "PrequentialEvaluator scores rating error and needs a rated "
                "stream; this batch is rating-free.  Use "
                "repro_torch.eval.prequential_ranking.PrequentialRankingEvaluator "
                "for ranking-only prequential evaluation of click streams."
            )
        users = np.asarray(batch.user, np.int32)
        items = np.asarray(batch.item, np.int32)
        # grow BEFORE predicting: a fresh row's prediction is rating-free
        upd = self.updater
        users = upd.resolve_users(users)
        upd.ensure_capacity(-1, int(items.max()))
        dev = upd.params.p.device

        def up(values, dtype):
            return torch.as_tensor(values, dtype=dtype).to(dev)

        hist = None if upd.user_history is None else up(upd.user_history[users], torch.int64)
        abs_err, sq_err = _prequential_errors(
            upd.params, up(users, torch.int64), up(items, torch.int64),
            up(np.asarray(batch.rating, np.float32), torch.float32), upd.t_p, upd.t_q, hist,
        )
        abs_err = abs_err.cpu().numpy().astype(np.float64)
        sq_err = sq_err.cpu().numpy().astype(np.float64)
        self._fold(abs_err, sq_err)
        n = abs_err.size
        return {
            "mae": float(abs_err.sum() / n),
            "rmse": float(np.sqrt(sq_err.sum() / n)),
            "events": n,
        }

    def consume(self, batch: EventBatch) -> Dict[str, float]:
        """Test-then-learn: :meth:`score`, then ``updater.apply``, then the
        drift hooks.  Returns the batch's eval metrics merged with the
        updater's step metrics (``abs_err``/``work_fraction``)."""
        eval_metrics = self.score(batch)
        update_metrics = self.updater.apply(batch) if len(batch) else {}
        stats = self.stats
        for hook in self._hooks:
            hook(stats)
        return {**update_metrics, **eval_metrics}

    def _fold(self, abs_err: np.ndarray, sq_err: np.ndarray) -> None:
        n = abs_err.size
        self.events += n
        self._abs_sum += float(abs_err.sum())
        self._sq_sum += float(sq_err.sum())
        self.window.extend(abs_err, sq_err)
        # exact per-event EMA, vectorized over the batch: applying
        # m <- d*m + (1-d)*e for e_0..e_{n-1} in order collapses to one
        # weighted sum with weights (1-d) * d^(n-1-j)
        d = self._decay
        tail = (1.0 - d) * d ** np.arange(n - 1, -1, -1, dtype=np.float64)
        scale = d ** n
        self._ema_abs = self._ema_abs * scale + float(tail @ abs_err)
        self._ema_sq = self._ema_sq * scale + float(tail @ sq_err)
        self._ema_norm = self._ema_norm * scale + float(tail.sum())

    # -- views ---------------------------------------------------------------
    @property
    def stats(self) -> PrequentialStats:
        """Current error views (see the class docstring for which is which)."""
        n = max(self.events, 1)
        win_mae, win_rmse = self.window.means()
        norm = max(self._ema_norm, 1e-12)
        return PrequentialStats(
            events=self.events,
            mae=self._abs_sum / n,
            rmse=float(np.sqrt(self._sq_sum / n)),
            window_mae=win_mae,
            window_rmse=win_rmse,
            window_events=self.window.count,
            ema_mae=self._ema_abs / norm,
            ema_rmse=float(np.sqrt(self._ema_sq / norm)),
        )


def recalibration_hook(
    updater,
    *,
    degradation: float = 1.2,
    min_events: int = 1024,
    cooldown_events: int = 4096,
) -> Callable[[PrequentialStats], None]:
    """Drift hook: recalibrate thresholds when prequential error degrades.

    Fires ``updater.maybe_recalibrate(force=True)`` when the *windowed* MAE
    exceeds ``degradation`` × the decayed long-term baseline (``ema_mae``)
    — i.e. recalibration keys off the model visibly getting worse at
    predicting the live stream, not off a stale test set.  ``min_events``
    gates early noise; ``cooldown_events`` spaces consecutive firings.
    The returned hook records its firings on its ``fired`` list attribute.
    """
    state = {"last": -cooldown_events}
    fired: List[int] = []

    def hook(stats: PrequentialStats) -> None:
        if stats.events < min_events:
            return
        if stats.events - state["last"] < cooldown_events:
            return
        if not np.isfinite(stats.window_mae) or stats.ema_mae <= 0:
            return
        if stats.window_mae > degradation * stats.ema_mae:
            if updater.maybe_recalibrate(force=True) is not None:
                state["last"] = stats.events
                fired.append(stats.events)

    hook.fired = fired
    return hook
