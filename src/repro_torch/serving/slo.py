"""SLO-aware adaptive pruning: the threshold as a live degradation dial.

Counterpart of ``repro/serving/slo.py``; :class:`LatencyWindow` lives in
``serving/queue.py`` (the queue records into it).  The paper fixes the pruning threshold after epoch 1 and never touches it
again.  In serving, that constant is actually a *control input*: raising
the threshold truncates more latent factors, which (with the engine's
latent-axis compaction) directly sheds scoring FLOPs, at a ranking cost
``eval/ranking.py`` can measure against the dense oracle.  LLM servers
facing the same overload problem degrade gracefully (shorter contexts,
draft models) instead of admission-rejecting; this module closes the same
loop for pruned MF serving:

::

            ┌────────────────────────────────────────────────┐
            │                SLOController.tick()            │
            │                                                │
    queue ──┤ depth, expired, latency histogram (p50/p99)    │
            │        │                                       │
            │        ▼                                       │
            │  control law: p99 vs budget, depth watermarks  │
            │  quality guardrail: prequential drift hook     │
            │        │                                       │
            │        ▼                                       │
            │  per-priority-class effective pruning rates    │
            │        │  threshold_for_rate (Eq. 7/8 solve)   │
            │        ▼                                       │
            │  engine.swap(t_p=, t_q=)  +  publisher pin     │
            │  router.apply_thresholds (rolling, per replica)│
            └────────────────────────────────────────────────┘

* **Load signals** come from the request queue: its per-request latency
  histogram (:class:`~repro_torch.serving.queue.LatencyWindow`, recorded at
  completion in ``RequestQueue._serve_inner``), queue ``depth``, and the ``expired
  counter.  p99 over budget, depth over the high watermark, or any expiry
  ⇒ degrade (raise the base pruning rate by ``step_up``); comfortably
  under budget ⇒ relax by ``step_down`` (AIMD-flavoured: recover slower
  than you shed).
* **Per-priority-class rates**: background traffic (``priority > 0``)
  carries an extra rate offset, so maintenance work is always served
  more-pruned than interactive traffic.  The threshold actually applied
  to the engine follows the most latency-sensitive class observed in the
  window (one engine serves one ``(t_p, t_q)`` at a time); all class
  rates are reported and replicated as controller state.
* **Quality guardrail**: :meth:`SLOController.quality_hook` plugs into
  :meth:`repro_torch.eval.prequential.PrequentialEvaluator.add_drift_hook` —
  when windowed prequential error creeps past
  ``quality_bound * ema`` the next tick relaxes instead of degrading,
  whatever the load says.  Latency SLOs never get to silently destroy
  model quality.
* **Application** goes through the existing full-rebuild swap path
  (``engine.swap(params, t_p, t_q)``), pins the publisher's serving
  thresholds (so subsequent snapshot publishes don't revert the
  degradation), and rolls across a fleet one replica at a time
  (:meth:`repro_torch.serving.fleet.router.Router.apply_thresholds`) —
  exactly the discipline model refreshes use.

Thresholds reach the engine as float32 and the pins keep ``float(t)``, as
in the reference, so both packages serve the same ``(t_p, t_q)`` bit for
bit.  ``_solve`` re-measures the factor statistics on every apply, on the
tables' device.  ``launch/serve.py --slo-p99-ms`` and ``launch/online.py
--slo-p99-ms`` turn the loop on for real traffic and exit non-zero if the
budget is violated at steady state.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.threshold import (
    empirical_pruned_fraction,
    measure_stats,
    threshold_for_rate,
)
from repro_torch.serving.queue import LatencyWindow


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Knobs of the closed loop (see module docstring for the control law).

    ``p99_budget_ms`` is the deadline budget p99 is held under.  Rates are
    pruning fractions in [0, 1]; ``max_rate`` caps degradation (the floor
    on quality), ``min_rate=None`` floors relaxation at the model's own
    trained pruning rate (measured at attach time) rather than 0.
    """

    p99_budget_ms: float = 50.0
    max_rate: float = 0.8
    min_rate: Optional[float] = None
    step_up: float = 0.15        # additive degrade per overloaded tick
    step_down: float = 0.05      # additive relax per comfortable tick
    relax_margin: float = 0.5    # relax only when p99 < margin * budget
    depth_high: int = 64         # queue depth that alone means overload
    depth_low: int = 4
    min_window: int = 16         # completed requests a tick needs to act
    rate_eps: float = 0.01       # smallest rate move worth a re-solve+swap
    tick_interval_s: float = 0.1
    background_offset: float = 0.15   # extra rate for priority > 0 traffic
    class_offsets: Mapping[int, float] = dataclasses.field(
        default_factory=dict
    )
    quality_bound: float = 1.25  # window err > bound * ema err => relax
    quality_min_events: int = 64


@dataclasses.dataclass(frozen=True)
class SLODecision:
    """One tick's observation + action, kept on ``controller.decisions``."""

    tick: int
    action: str              # "degrade" | "relax" | "quality_relax" | "hold"
    p50_ms: float
    p99_ms: float
    depth: int
    expired: int             # expirations since the previous tick
    completed: int           # completions since the previous tick
    base_rate: float
    rates: Dict[int, float]  # per-priority-class effective rates
    applied_class: int
    applied_rate: float
    t_p: float
    t_q: float
    swapped: bool            # thresholds actually re-solved and applied

    def as_dict(self) -> Dict[str, object]:
        """Flat form for JSON reports."""
        d = dataclasses.asdict(self)
        d["rates"] = {str(c): r for c, r in self.rates.items()}
        return d


class SLOController:
    """Closed-loop pruning-rate controller for one serving deployment.

    ``engine`` is the co-located primary (may be None for a fleet-only
    topology); ``queue`` supplies load signals (its :class:`LatencyWindow`,
    ``depth`` and ``expired`` counters) — pass an explicit ``window`` /
    ``depth_fn`` / ``expired_fn`` instead when latency is observed
    elsewhere (e.g. client-side, for process-replica fleets).
    ``publisher`` gets its serving thresholds pinned on every apply so
    snapshot publishes cannot revert a degradation; ``router`` receives
    every decision as a rolling per-replica threshold update.

    ``tick()`` runs one observe→decide→apply cycle; ``maybe_tick()``
    rate-limits it to ``config.tick_interval_s`` for call sites that tick
    from a hot loop.  Thread-safe; applies serialize on an internal lock.
    ``swap_timings`` holds one entry per swap: its tick, rate, thresholds
    and the host milliseconds of the solve and of the apply (an engine's
    swap returns with the rebuilt layouts on the device).
    """

    def __init__(
        self,
        engine=None,
        *,
        config: Optional[SLOConfig] = None,
        queue=None,
        window: Optional[LatencyWindow] = None,
        depth_fn: Optional[Callable[[], int]] = None,
        expired_fn: Optional[Callable[[], int]] = None,
        publisher=None,
        router=None,
        params_fn: Optional[Callable[[], object]] = None,
    ):
        self.config = config or SLOConfig()
        self.engine = engine
        self.queue = queue
        self.publisher = publisher
        self.router = router
        self._params_fn = params_fn
        if window is None:
            window = queue.latency if queue is not None else LatencyWindow()
        self.window = window
        self._depth_fn = depth_fn or self._default_depth
        self._expired_fn = expired_fn or self._default_expired
        self._lock = threading.Lock()
        self._last_count = 0
        self._last_expired = 0
        self._last_tick_at = 0.0
        self._quality_pressure = False
        self.ticks = 0
        self.degrades = 0
        self.relaxes = 0
        self.quality_relaxes = 0
        self.swaps = 0
        self.decisions: List[SLODecision] = []
        self.swap_timings: List[Dict[str, float]] = []

        params = self._params()
        measured = float(
            empirical_pruned_fraction(params.q, self._initial_t_q())
        )
        floor = (
            measured if self.config.min_rate is None
            else float(self.config.min_rate)
        )
        self.floor_rate = min(floor, self.config.max_rate)
        self.base_rate = self.floor_rate
        # thresholds currently applied (None until the first apply)
        self.applied: Optional[Tuple[float, float]] = None
        self._applied_rate: Optional[float] = None

    # -- signal / state plumbing --------------------------------------------
    def _default_depth(self) -> int:
        if self.queue is not None:
            return self.queue.depth
        if self.router is not None:
            return sum(r.depth() for r in self.router.replicas)
        if self.engine is not None:
            return self.engine.queue_depth
        return 0

    def _default_expired(self) -> int:
        return 0 if self.queue is None else self.queue.expired

    def _params(self):
        """Factor tables the threshold solve measures — primary engine,
        else the updater behind the publisher, else a local replica."""
        if self.engine is not None:
            return self.engine.params
        if self._params_fn is not None:
            return self._params_fn()
        if self.publisher is not None and self.publisher.updater is not None:
            return self.publisher.updater.params
        if self.router is not None:
            for rep in self.router.replicas:
                eng = getattr(rep, "engine", None)
                if eng is not None:
                    return eng.params
        raise ValueError(
            "SLOController needs an engine, params_fn, publisher, or a "
            "fleet with at least one in-process replica to measure factor "
            "statistics from"
        )

    def _initial_t_q(self) -> float:
        if self.engine is not None:
            return float(self.engine.t_q)
        if self.publisher is not None and self.publisher.updater is not None:
            return float(self.publisher.updater.t_q)
        if self.router is not None:
            for rep in self.router.replicas:
                eng = getattr(rep, "engine", None)
                if eng is not None:
                    return float(eng.t_q)
        return 0.0

    # -- per-class rates -----------------------------------------------------
    def _class_offset(self, priority: int) -> float:
        if priority in self.config.class_offsets:
            return float(self.config.class_offsets[priority])
        return self.config.background_offset if priority > 0 else 0.0

    def effective_rates(
        self, classes: Optional[Tuple[int, ...]] = None
    ) -> Dict[int, float]:
        """Per-priority-class pruning rate: base + class offset, clamped to
        ``[floor_rate, max_rate]``.  Background classes are always served
        at least as pruned as interactive traffic."""
        if classes is None:
            classes = tuple(sorted({0, *self.config.class_offsets}))
        return {
            int(c): float(
                np.clip(
                    self.base_rate + self._class_offset(int(c)),
                    self.floor_rate,
                    self.config.max_rate,
                )
            )
            for c in classes
        }

    # -- quality guardrail ---------------------------------------------------
    def note_quality(self, stats) -> None:
        """Feed one :class:`~repro_torch.eval.prequential.PrequentialStats`; flags
        quality pressure when the windowed error has crept past
        ``quality_bound`` times the long-term EMA."""
        cfg = self.config
        if (
            stats.events >= cfg.quality_min_events
            and stats.window_events > 0
            and np.isfinite(stats.ema_mae)
            and stats.ema_mae > 0
            and stats.window_mae > cfg.quality_bound * stats.ema_mae
        ):
            self._quality_pressure = True

    def quality_hook(self) -> Callable:
        """A drift hook for
        :meth:`~repro_torch.eval.prequential.PrequentialEvaluator.add_drift_hook`:
        forwards prequential stats into :meth:`note_quality`."""
        def hook(stats):
            self.note_quality(stats)
        hook.controller = self
        return hook

    # -- the loop ------------------------------------------------------------
    def maybe_tick(self) -> Optional[SLODecision]:
        """Run :meth:`tick` if ``tick_interval_s`` has elapsed (hot-loop
        call sites); returns None when skipped."""
        now = time.monotonic()
        if now - self._last_tick_at < self.config.tick_interval_s:
            return None
        return self.tick()

    def tick(self) -> SLODecision:
        """One observe → decide → (solve + apply) cycle."""
        cfg = self.config
        with self._lock:
            self._last_tick_at = time.monotonic()
            total = self.window.count
            completed = total - self._last_count
            self._last_count = total
            expired_total = int(self._expired_fn())
            expired = expired_total - self._last_expired
            self._last_expired = expired_total
            depth = int(self._depth_fn())
            lat, prio = self.window.snapshot()
            p50_ms = float(np.percentile(lat, 50) * 1e3) if lat.size else float("nan")
            p99_ms = float(np.percentile(lat, 99) * 1e3) if lat.size else float("nan")

            have_latency = completed >= cfg.min_window and np.isfinite(p99_ms)
            overloaded = (
                (have_latency and p99_ms > cfg.p99_budget_ms)
                or depth >= cfg.depth_high
                or expired > 0
            )
            comfortable = (
                have_latency
                and p99_ms < cfg.relax_margin * cfg.p99_budget_ms
                and depth <= cfg.depth_low
                and expired == 0
            )
            action = "hold"
            if self._quality_pressure:
                # model quality is drifting: relax regardless of load —
                # latency SLOs don't get to silently destroy accuracy
                self.base_rate = max(
                    self.floor_rate, self.base_rate - cfg.step_down
                )
                action = "quality_relax"
                self.quality_relaxes += 1
                self._quality_pressure = False
            elif overloaded:
                self.base_rate = min(
                    cfg.max_rate, self.base_rate + cfg.step_up
                )
                action = "degrade"
                self.degrades += 1
            elif comfortable and self.base_rate > self.floor_rate:
                self.base_rate = max(
                    self.floor_rate, self.base_rate - cfg.step_down
                )
                action = "relax"
                self.relaxes += 1

            # the engine serves ONE (t_p, t_q); follow the most
            # latency-sensitive class seen in the window (default class 0)
            seen = tuple(sorted(set(int(c) for c in prio))) or (0,)
            applied_class = min(seen)
            rates = self.effective_rates(
                tuple(sorted({*seen, 0, *self.config.class_offsets}))
            )
            applied_rate = rates[applied_class]

            swapped = False
            if (
                self._applied_rate is None
                or abs(applied_rate - self._applied_rate) >= cfg.rate_eps
            ):
                t0 = time.perf_counter()
                t_p, t_q = self._solve(applied_rate)
                t1 = time.perf_counter()
                self._apply(t_p, t_q)
                self.swap_timings.append(dict(
                    tick=self.ticks + 1, rate=float(applied_rate), t_p=t_p, t_q=t_q,
                    solve_ms=(t1 - t0) * 1e3,
                    apply_ms=(time.perf_counter() - t1) * 1e3))
                self._applied_rate = applied_rate
                self.applied = (t_p, t_q)
                self.swaps += 1
                swapped = True
            t_p, t_q = self.applied if self.applied is not None else (0.0, 0.0)

            self.ticks += 1
            decision = SLODecision(
                tick=self.ticks,
                action=action,
                p50_ms=p50_ms,
                p99_ms=p99_ms,
                depth=depth,
                expired=expired,
                completed=completed,
                base_rate=float(self.base_rate),
                rates=rates,
                applied_class=applied_class,
                applied_rate=float(applied_rate),
                t_p=float(t_p),
                t_q=float(t_q),
                swapped=swapped,
            )
            self.decisions.append(decision)
            return decision

    # -- solve + apply -------------------------------------------------------
    def _solve(self, rate: float) -> Tuple[float, float]:
        """Pruning rate -> (t_p, t_q) via the paper's Eq. 7/8 solve against
        the *current* factor statistics (re-measured per solve, so online
        drift in the tables is tracked)."""
        params = self._params()
        if rate <= 0.0:
            return 0.0, 0.0  # exact dense parity, no fitted-normal residue
        t_p = float(threshold_for_rate(measure_stats(params.p), rate))
        t_q = float(threshold_for_rate(measure_stats(params.q), rate))
        return t_p, t_q

    def _apply(self, t_p: float, t_q: float) -> None:
        """Push thresholds everywhere a stale copy could serve from:
        primary engine (full-rebuild swap), publisher pin (so the next
        snapshot publish keeps them), rolling fleet fan-out."""
        if self.engine is not None:
            self.engine.swap(
                self.engine.params,
                np.float32(t_p), np.float32(t_q),
                user_history=self.engine.user_history,
            )
        if self.publisher is not None:
            self.publisher.set_serving_thresholds(t_p, t_q)
        if self.router is not None:
            self.router.apply_thresholds(t_p, t_q)

    # -- reporting -----------------------------------------------------------
    def report(self) -> Dict[str, object]:
        """JSON-friendly controller summary for launchers."""
        last = self.decisions[-1] if self.decisions else None
        return {
            "ticks": self.ticks,
            "degrades": self.degrades,
            "relaxes": self.relaxes,
            "quality_relaxes": self.quality_relaxes,
            "swaps": self.swaps,
            "p99_budget_ms": self.config.p99_budget_ms,
            "floor_rate": self.floor_rate,
            "max_rate": self.config.max_rate,
            "base_rate": float(self.base_rate),
            "applied_rate": (
                None if self._applied_rate is None
                else float(self._applied_rate)
            ),
            "applied_t_p": None if self.applied is None else self.applied[0],
            "applied_t_q": None if self.applied is None else self.applied[1],
            "rates": {
                str(c): r for c, r in self.effective_rates().items()
            },
            "last_decision": None if last is None else last.as_dict(),
        }
