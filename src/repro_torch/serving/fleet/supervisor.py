"""Fleet supervision: health probes, failover, auto-respawn, readmission.

Counterpart of ``repro/serving/fleet/supervisor.py``.  The supervisor closes the failure loop the rest of the fleet only
half-handles: the router *reacts* to a dead replica (fails over, stops
routing to it) but nothing ever brings the replica back.
:class:`FleetSupervisor` runs the probe → declare → respawn → catch-up →
readmit cycle, tracking each replica through the state machine::

    HEALTHY ──probe miss──▶ SUSPECT ──misses ≥ dead_after──▶ DEAD
       ▲                       │  (pipe EOF / nonzero exitcode:   │
       │                       └──────── straight to DEAD ───────┘
       │                                                          ▼
    HEALTHY ◀── version converged, router readmits ── CATCHING_UP ◀── RESPAWNING

Death evidence, in order of strength: a broken pipe / nonzero exitcode
(``replica.alive`` false) declares DEAD immediately; a missed heartbeat
(``ping`` timeout) only *suspects* — ``dead_after`` consecutive misses
declare death, so one slow probe under load never triggers a respawn.

Respawn rebuilds the replica from the strongest available source:
``checkpoint=`` + ``online_dir=`` (the late-join ``fold_deltas``
bootstrap) when configured, else a ``kind=full`` state message pulled
from a healthy peer.  Either way the replacement is *readmitted only
after convergence*: its version must reach the fleet's current version
(the peer pull repeats until it does), so the router never routes to a
stale replica — the same behind-the-``VersionGate`` discipline the bus
applies to every delta.

Every incident is recorded (detection → respawn → healthy timestamps);
``report()`` summarizes MTTR for ``launch.online --supervise``.  A respawned
replica is built like the one it replaces (its ``spawn_kwargs``: device,
engine and queue options).
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.serving.fleet import bus
from repro_torch.serving.fleet.replica import (
    LocalReplica,
    ProcessReplica,
    ReplicaDiedError,
)


class ReplicaState(enum.Enum):
    """Where a replica slot is in the supervision lifecycle."""

    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"
    RESPAWNING = "respawning"
    CATCHING_UP = "catching_up"


class Incident:
    """One detected replica death and its recovery timeline."""

    def __init__(self, replica_id: str, reason: str):
        self.replica_id = replica_id
        self.reason = reason
        self.detected_at = time.monotonic()
        self.respawned_at: Optional[float] = None
        self.healthy_at: Optional[float] = None
        self.error: Optional[str] = None

    @property
    def mttr_s(self) -> Optional[float]:
        """Detection → readmission, seconds (None while unrecovered)."""
        if self.healthy_at is None:
            return None
        return self.healthy_at - self.detected_at

    def as_dict(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "reason": self.reason,
            "mttr_s": self.mttr_s,
            "recovered": self.healthy_at is not None,
            "error": self.error,
        }


class FleetSupervisor:
    """Probe replicas, declare death, respawn, readmit after convergence.

    Drive it with :meth:`start`/:meth:`stop` (background thread) or call
    :meth:`poll_once` directly — deterministic tests step the loop by hand so detection latency doesn't depend on thread
    scheduling.

    Parameters
    ----------
    router:
        The fleet's :class:`~repro_torch.serving.fleet.router.Router`.
    probe_interval_s:
        Background-thread tick; each tick is one :meth:`poll_once`.
    ping_timeout_s:
        Heartbeat budget per probe.
    dead_after:
        Consecutive probe misses before a SUSPECT replica is declared
        DEAD.  Hard evidence (broken pipe, exited process) skips the
        suspicion ladder entirely.
    respawn:
        When False the supervisor only detects + fails over (routing
        excludes the corpse) — no replacement is spawned.
    checkpoint / online_dir:
        Respawn source for process replicas: training checkpoint plus
        online delta chain (the ``fold_deltas`` late-join path).  Without
        it, a raw ``kind=full`` state message is pulled from a healthy peer.
    state_provider:
        Override for the heal payload: a callable returning a
        ``kind=full`` :class:`~repro_torch.serving.fleet.bus.DeltaMessage` of
        the current fleet state (e.g. ``publisher``-side).  Defaults to
        pulling from a healthy peer.
    max_respawns:
        Per-slot respawn budget; a slot that keeps dying stays DEAD once
        exhausted (crash-loop brake).
    """

    def __init__(
        self,
        router,
        *,
        probe_interval_s: float = 0.5,
        ping_timeout_s: float = 10.0,
        dead_after: int = 2,
        respawn: bool = True,
        checkpoint: Optional[str] = None,
        online_dir: Optional[str] = None,
        state_provider: Optional[Callable[[], bus.DeltaMessage]] = None,
        max_respawns: int = 3,
    ):
        self.router = router
        self.probe_interval_s = float(probe_interval_s)
        self.ping_timeout_s = float(ping_timeout_s)
        self.dead_after = int(dead_after)
        self.respawn = bool(respawn)
        self.checkpoint = checkpoint
        self.online_dir = online_dir
        self.state_provider = state_provider
        self.max_respawns = int(max_respawns)
        n = len(router.replicas)
        self.states: List[ReplicaState] = [ReplicaState.HEALTHY] * n
        self._misses = [0] * n
        self._respawns = [0] * n
        self.incidents: List[Incident] = []
        self._open: Dict[int, Incident] = {}  # slot -> unrecovered incident
        self.probes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        """Launch the background probe loop (idempotent)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the probe loop (any in-progress respawn completes first)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.poll_once()
            except Exception:
                # supervision must never take the fleet down with it; the
                # next tick re-probes from scratch
                pass

    # -- one supervision round ----------------------------------------------
    def poll_once(self) -> None:
        """Probe every slot, declare deaths, run recoveries.

        Serialized: the background loop and a test driving the supervisor
        manually can't respawn the same slot twice."""
        with self._poll_lock:
            for idx in range(len(self.router.replicas)):
                self._probe_slot(idx)

    def _probe_slot(self, idx: int) -> None:
        rep = self.router.replicas[idx]
        state = self.states[idx]
        if state in (ReplicaState.DEAD, ReplicaState.RESPAWNING,
                     ReplicaState.CATCHING_UP):
            # a dead slot only moves through _recover (or stays dead once
            # the respawn budget is spent)
            if state is ReplicaState.DEAD:
                self._maybe_recover(idx)
            return
        self.probes += 1
        alive = getattr(rep, "alive", True)
        exitcode = getattr(rep, "exitcode", None)
        if not alive or (exitcode is not None and exitcode != 0):
            self._declare_dead(
                idx, f"hard evidence: alive={alive} exitcode={exitcode}"
            )
            return
        ok = True
        ping = getattr(rep, "ping", None)
        if ping is not None:
            try:
                ok = bool(ping(self.ping_timeout_s))
            except (ReplicaDiedError, BrokenPipeError, OSError, EOFError):
                ok = False
        if ok:
            self._misses[idx] = 0
            self.states[idx] = ReplicaState.HEALTHY
            return
        self._misses[idx] += 1
        self.states[idx] = ReplicaState.SUSPECT
        if self._misses[idx] >= self.dead_after:
            self._declare_dead(
                idx, f"heartbeat: {self._misses[idx]} consecutive misses"
            )

    def _declare_dead(self, idx: int, reason: str) -> None:
        rep = self.router.replicas[idx]
        self.states[idx] = ReplicaState.DEAD
        self._misses[idx] = 0
        self.router.mark_unhealthy(idx)
        incident = Incident(rep.replica_id, reason)
        self.incidents.append(incident)
        self._open[idx] = incident
        self._maybe_recover(idx)

    def _maybe_recover(self, idx: int) -> None:
        if not self.respawn or self._respawns[idx] >= self.max_respawns:
            return
        incident = self._open.get(idx)
        self._respawns[idx] += 1
        self.states[idx] = ReplicaState.RESPAWNING
        try:
            replacement = self._respawn_slot(idx)
            self.states[idx] = ReplicaState.CATCHING_UP
            if incident is not None:
                incident.respawned_at = time.monotonic()
            self._converge(replacement)
        except Exception as exc:
            # respawn failed: back to DEAD, retry on a later tick while
            # the budget lasts
            if incident is not None:
                incident.error = f"{type(exc).__name__}: {exc}"
            self.states[idx] = ReplicaState.DEAD
            return
        # converged: swap into the routing table and readmit
        old = self.router.replicas[idx]
        self.router.replace_replica(idx, replacement)
        self.states[idx] = ReplicaState.HEALTHY
        if incident is not None:
            incident.healthy_at = time.monotonic()
            self._open.pop(idx, None)
        self._reap(old)

    # -- respawn mechanics ---------------------------------------------------
    def _fleet_version(self) -> int:
        """Highest healthy-replica version — the convergence target."""
        versions = [
            self.router.replicas[i].version
            for i in range(len(self.router.replicas))
            if self.router.is_healthy(i)
        ]
        return max(versions) if versions else 0

    def _heal_message(self) -> bus.DeltaMessage:
        if self.state_provider is not None:
            return self.state_provider()
        for i in range(len(self.router.replicas)):
            if not self.router.is_healthy(i):
                continue
            rep = self.router.replicas[i]
            try:
                return rep.state_message()
            except (ReplicaDiedError, TimeoutError, BrokenPipeError, OSError):
                self.router.mark_unhealthy(i)
        raise ReplicaDiedError(
            "no healthy peer (and no state_provider) to heal from"
        )

    def _respawn_slot(self, idx: int):
        old = self.router.replicas[idx]
        if isinstance(old, ProcessReplica):
            spec = dict(old.spawn_kwargs)
            if spec.get("checkpoint"):
                # late-join bootstrap: training base + fold_deltas over the
                # online chain — lands at the chain's latest version
                return ProcessReplica(old.replica_id, **spec)
            spec.pop("checkpoint", None)
            spec.pop("online_dir", None)
            return ProcessReplica(
                old.replica_id, init_msg=self._heal_message(), **spec
            )
        # local replica: rebuild in-process from the heal payload, on the
        # device and with the options of the replica it replaces
        spec = getattr(old, "spawn_kwargs", {})
        msg = self._heal_message()
        device = (spec.get("engine_kwargs") or {}).get("device")
        params, t_p, t_q, history = bus.state_from_message(msg, device=device)
        return LocalReplica(
            old.replica_id, params, t_p, t_q,
            user_history=history, base_version=msg.version,
            engine_kwargs=spec.get("engine_kwargs"),
            queue_kwargs=spec.get("queue_kwargs"),
        )

    def _converge(self, replacement, *, max_rounds: int = 8) -> None:
        """Apply fresh fleet state until the replacement's version reaches
        the fleet's — the readmission gate.  The pull repeats because the
        fleet may have advanced while the respawn was in flight."""
        for _ in range(max_rounds):
            target = self._fleet_version()
            if replacement.version >= target:
                return
            replacement.apply_update(self._heal_message())
        raise RuntimeError(
            f"replica {replacement.replica_id} failed to converge to fleet "
            f"version {self._fleet_version()} (at {replacement.version})"
        )

    @staticmethod
    def _reap(old) -> None:
        """Release the dead replica's resources (join the child, close the
        pipe) — best-effort; it is already out of the routing table."""
        try:
            old.close(timeout=5.0)
        except TypeError:
            try:
                old.close()
            except Exception:
                pass
        except Exception:
            pass

    # -- reporting -----------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Counters + incident log for launch reports: per-slot states, respawn counts, and MTTR aggregates."""
        mttrs = [i.mttr_s for i in self.incidents if i.mttr_s is not None]
        return {
            "probes": self.probes,
            "states": {
                self.router.replicas[i].replica_id: self.states[i].value
                for i in range(len(self.states))
            },
            "incidents": [i.as_dict() for i in self.incidents],
            "deaths": len(self.incidents),
            "recovered": sum(
                1 for i in self.incidents if i.healthy_at is not None
            ),
            "respawns": sum(self._respawns),
            "mttr_max_s": max(mttrs) if mttrs else None,
            "mttr_mean_s": (sum(mttrs) / len(mttrs)) if mttrs else None,
        }
