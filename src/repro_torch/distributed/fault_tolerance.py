"""Fault tolerance: bounded step retries, straggler detection, injected faults.

A copy of ``repro/distributed/fault_tolerance.py`` (pure Python): the
training launcher wraps each epoch in :func:`run_with_retries` and times it
with :class:`StragglerDetector`; in store mode the trainer wraps each
streamed slab the same way (``TrainConfig.max_step_retries``) and records
its wall time.  :class:`FailureInjector` drives the tests of both.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Optional, Tuple


class StepFailure(RuntimeError):
    """Raised by the step wrapper after exhausting retries."""


def run_with_retries(
    step_fn: Callable[..., Any],
    *args,
    max_retries: int = 3,
    backoff_s: float = 0.5,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """Execute a re-entrant step with bounded retries and exponential backoff.

    Programming errors (``AssertionError``, ``TypeError``, ``ValueError``)
    propagate at once; other runtime faults are retried up to
    ``max_retries`` times, then raise :class:`StepFailure`.
    """
    attempt = 0
    while True:
        try:
            return step_fn(*args, **kwargs)
        except (AssertionError, TypeError, ValueError):
            raise  # programming errors: retrying cannot help
        except Exception as exc:  # noqa: BLE001 -- runtime faults
            attempt += 1
            if attempt > max_retries:
                raise StepFailure(f"step failed after {max_retries} retries: {exc!r}") from exc
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(backoff_s * (2 ** (attempt - 1)))


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps whose duration is a z-score outlier over a rolling window."""

    window: int = 50
    z_threshold: float = 4.0
    min_samples: int = 10
    _times: Deque[float] = dataclasses.field(default_factory=deque)
    flagged: int = 0

    def record(self, duration_s: float) -> bool:
        times = self._times
        is_straggler = False
        if len(times) >= self.min_samples:
            mean = sum(times) / len(times)
            var = sum((t - mean) ** 2 for t in times) / len(times)
            std = max(var ** 0.5, 1e-9)
            if (duration_s - mean) / std > self.z_threshold:
                is_straggler = True
                self.flagged += 1
        times.append(duration_s)
        if len(times) > self.window:
            times.popleft()
        return is_straggler


class FailureInjector:
    """Deterministic fault injection for integration tests: raises on the
    configured step numbers, once each, then succeeds on retry."""

    def __init__(self, fail_on_steps: Tuple[int, ...]):
        self.fail_on_steps = set(fail_on_steps)
        self.calls = 0
        self.failures = 0

    def __call__(self, step: int) -> None:
        self.calls += 1
        if step in self.fail_on_steps:
            self.fail_on_steps.discard(step)
            self.failures += 1
            raise RuntimeError(f"injected fault at step {step}")
