"""Deterministic chaos harness: seeded fault plans behind test seams.

Counterpart of ``repro/testing/faults.py`` (pure Python and numpy).  A
:class:`FaultPlan` is an explicit schedule of :class:`FaultAction`\\ s
("fail the next checkpoint fsync", "fail the second streamed slab").
Production code carries *seams*, named call sites that ask the harness
whether anything fires now:

    from repro_torch.testing import faults
    ...
    if faults._PLAN is not None:          # one attribute read when off
        for act in faults.fire("trainer.slab"):
            ...

With no plan installed a seam costs that one attribute read.  Tests install
a plan (:func:`install` / the :func:`installed` context manager) and the
seams fire deterministically: every action triggers at an exact
per-``(site, target)`` event count, and :meth:`FaultPlan.from_seed` derives
a whole schedule from one integer seed, drawing exactly the reference's
numpy PCG64 values.

Seams in this package (grep for ``faults.fire``):

* ``"replica.submit"`` (target = replica id): ops ``kill``;
* ``"bus.deliver"`` (target = replica id): ops ``drop``, ``dup``,
  ``corrupt`` (through :func:`corrupt_message`), ``delay``;
* ``"checkpoint.fsync"``: ops ``error`` (the save aborts before publishing);
* ``"trainer.slab"``: ops ``error`` (a retryable step failure, raised before
  the slab's first write).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class FaultError(RuntimeError):
    """An injected failure, raised by seams executing an ``error`` op."""


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One scheduled fault.

    Fires when the seam named ``site`` sees its ``at``-th event (0-based,
    counted per ``(site, target)``) for ``target`` (``""`` matches every
    target at the site).  ``op`` is interpreted by the seam; ``arg`` carries
    an op parameter (e.g. delay seconds).  Each action fires at most once.
    """

    site: str
    op: str
    at: int
    target: str = ""
    arg: float = 0.0


class FaultPlan:
    """A deterministic schedule of fault actions plus its firing log.

    ``fire(site, target)`` bumps the per-``(site, target)`` event counter
    and returns the actions whose ``at`` matches the pre-bump count; callers
    execute the returned ops.  ``fired`` records every trigger as ``(site,
    target, op, count)``.  Thread-safe: seams fire from several threads.
    """

    def __init__(self, actions: Sequence[FaultAction] = ()):
        self._actions: List[FaultAction] = list(actions)
        self._spent: set = set()           # indices already fired
        self._counts: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, str, int]] = []

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        sites: Sequence[Tuple[str, Sequence[str], Sequence[str]]],
        n_actions: int = 8,
        horizon: int = 32,
    ) -> "FaultPlan":
        """Derive a schedule from one integer seed.

        ``sites`` is ``[(site, targets, ops), ...]``; ``n_actions`` faults
        are drawn uniformly over (site row, target, op, at < horizon), in
        the reference's order of draws, so the same seed gives the
        reference's schedule.
        """
        rng = np.random.default_rng(seed)
        actions = []
        for _ in range(int(n_actions)):
            site, targets, ops = sites[int(rng.integers(len(sites)))]
            target = str(targets[int(rng.integers(len(targets)))]) if targets else ""
            op = str(ops[int(rng.integers(len(ops)))])
            actions.append(FaultAction(site=site, op=op, at=int(rng.integers(horizon)),
                                       target=target))
        return cls(actions)

    def fire(self, site: str, target: str = "") -> List[FaultAction]:
        """One event at ``(site, target)``: returns the actions firing now."""
        with self._lock:
            key = (site, target)
            count = self._counts.get(key, 0)
            self._counts[key] = count + 1
            hits = []
            for i, act in enumerate(self._actions):
                if i in self._spent or act.site != site or act.at != count:
                    continue
                if act.target and act.target != target:
                    continue
                self._spent.add(i)
                hits.append(act)
                self.fired.append((site, target, act.op, count))
            return hits

    @property
    def pending(self) -> int:
        """Actions scheduled but not yet fired."""
        return len(self._actions) - len(self._spent)


# The installed plan.  None in production: seams guard on exactly this
# attribute, so the disabled cost is one module-attribute read.
_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Arm the harness: subsequent seam events consult ``plan``."""
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    """Disarm the harness (seams return to the production no-op)."""
    global _PLAN
    _PLAN = None


@contextlib.contextmanager
def installed(plan: FaultPlan):
    """Scoped install (always disarms on exit)."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def fire(site: str, target: str = "") -> Sequence[FaultAction]:
    """Seam entry point.  Callers pre-guard with ``faults._PLAN is not
    None``; this function checks again."""
    plan = _PLAN
    if plan is None:
        return ()
    return plan.fire(site, target)


def corrupt_message(msg):
    """Flip one byte of a :class:`~repro_torch.serving.fleet.bus.DeltaMessage`
    payload without fixing its checksum: what a corrupted wire delivery looks
    like to the sink.  The byte is the reference's: the middle byte of the
    largest payload array (its compressed blob, or its raw bytes), so one
    fault plan corrupts the same delivery in both packages."""
    from repro_torch.distributed.compression import CompressedArray

    tree = dict(msg.tree)
    key = max(tree, key=lambda k: tree[k].nbytes if isinstance(tree[k], CompressedArray)
              else int(np.asarray(tree[k]).nbytes))
    val = tree[key]
    if isinstance(val, CompressedArray):
        blob = bytearray(val.data)
        blob[len(blob) // 2] ^= 0xFF
        tree[key] = dataclasses.replace(val, data=bytes(blob))
    else:
        arr = np.array(val, copy=True)
        flat = arr.view(np.uint8).reshape(-1)
        flat[len(flat) // 2] ^= 0xFF
        tree[key] = arr
    return dataclasses.replace(msg, tree=tree)


def delay_s(actions: Sequence[FaultAction]) -> float:
    """Total delay requested by ``delay`` ops in ``actions`` (seconds)."""
    return sum(a.arg for a in actions if a.op == "delay")
