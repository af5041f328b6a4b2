"""Cache-aware request routing over a fleet of replicas.

Counterpart of ``repro/serving/fleet/router.py``.  The router keeps each
replica's hot-user LRU warm: a user's cached vector only pays off if their
next request lands on the same replica.  Policy per request:

* **affinity** (default): pin each user to a replica in an LRU map on
  first sight (the then least-loaded); route repeat users to their pin
  while its queue depth is within ``overload_slack`` of the least-loaded
  replica, else spill to the least-loaded and re-pin;
* **priority class**: requests with ``priority > 0`` are background class,
  routed by least depth and never pinned;
* ``policy="least"`` / ``policy="random"`` ignore affinity.

:class:`ServingFleet` is the one-call topology: N replicas (in-process or
spawned) and a router, exposing ``submit``/``apply_update`` so it can be a
subscriber of :meth:`repro_torch.online.publisher.SnapshotPublisher.subscribe`:
the publisher ships each version once and the router applies it rollingly,
one replica at a time, so the fleet never has fewer than N-1 replicas
taking requests mid-refresh.  The ``bus.deliver`` fault seam sits in the
rolling loop (drop, dup, corrupt or delay one delivery).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serving.batching import LRUCache
from repro_torch.serving.fleet import bus
from repro_torch.serving.fleet.replica import (
    LocalReplica,
    ProcessReplica,
    ReplicaDiedError,
)
from repro_torch.testing import faults


class NoHealthyReplicaError(RuntimeError):
    """Every replica is marked unhealthy — nothing can take the request."""


class Router:
    """Load-balance requests across replicas, cache-affine for hot users."""

    def __init__(
        self,
        replicas: List,
        *,
        policy: str = "affinity",
        affinity_capacity: int = 65536,
        overload_slack: int = 8,
        seed: int = 0,
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in ("affinity", "least", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.replicas = list(replicas)
        self.policy = policy
        self.overload_slack = overload_slack
        self._affinity = LRUCache(affinity_capacity)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._healthy = [True] * len(self.replicas)
        self.routed = 0
        self.affinity_hits = 0   # repeat user sent to their pinned replica
        self.affinity_cold = 0   # first-seen user (new pin)
        self.affinity_spills = 0  # pin overloaded: spilled + re-pinned
        self.affinity_repins = 0  # pin pointed at a dead replica: re-pinned
        self.failovers = 0       # submits retried onto another replica

    # -- health --------------------------------------------------------------
    def mark_unhealthy(self, idx: int) -> None:
        """Take replica ``idx`` out of routing (dead or suspected dead).
        Its affinity pins re-pin lazily on the pinned users' next requests —
        no stop-the-world walk over the LRU."""
        with self._lock:
            self._healthy[idx] = False

    def mark_healthy(self, idx: int) -> None:
        """Readmit replica ``idx`` to routing (after supervised respawn +
        convergence — see ``fleet/supervisor.py``)."""
        with self._lock:
            self._healthy[idx] = True

    def is_healthy(self, idx: int) -> bool:
        """Whether replica ``idx`` currently takes traffic."""
        with self._lock:
            return self._healthy[idx]

    def replace_replica(self, idx: int, replica) -> None:
        """Swap a respawned replica into slot ``idx`` and readmit it.
        Affinity pins keyed by slot index become valid again unchanged —
        the replacement starts cache-cold but converged."""
        with self._lock:
            self.replicas[idx] = replica
            self._healthy[idx] = True

    def _healthy_indices(self) -> List[int]:
        return [i for i, ok in enumerate(self._healthy) if ok]

    def pick(self, user_id: int, priority: int = 0) -> int:
        """Choose a replica index for one request (does not submit).
        Only healthy replicas are considered; a user pinned to a dead
        replica is re-pinned to the least-loaded healthy one."""
        with self._lock:
            self.routed += 1
            live = self._healthy_indices()
            if not live:
                raise NoHealthyReplicaError("no healthy replica to route to")
            if self.policy == "random":
                # random ignores load: no depth() poll per replica
                return live[int(self._rng.integers(len(live)))]
            depths = {i: self.replicas[i].depth() for i in live}
            least = min(live, key=depths.__getitem__)
            if self.policy == "least" or priority > 0:
                # background class: depth only, never pinned — bulk traffic
                # must not evict interactive users' affinity entries
                return least
            pinned = self._affinity.get(user_id)
            if pinned is not None:
                if pinned not in depths:
                    self.affinity_repins += 1  # pinned replica is dead
                elif depths[pinned] <= depths[least] + self.overload_slack:
                    self.affinity_hits += 1
                    return pinned
                else:
                    self.affinity_spills += 1
            else:
                self.affinity_cold += 1
            self._affinity.put(user_id, least)
            return least

    def submit(self, user_id: int, topk: int = 10, *, timeout=None,
               priority: int = 0) -> Future:
        """Route one request and enqueue it on the chosen replica.

        Failover: if the chosen replica is dead at submit time — or dies
        mid-flight, failing the pending future with ``ReplicaDiedError`` —
        the request is retried on another healthy replica (the dead one is
        marked unhealthy on the spot).  The caller's future only fails
        when every replica has been exhausted, so a single replica death
        never strands or errors a request."""
        outer: Future = Future()
        self._submit_attempt(outer, int(user_id), topk, timeout, priority,
                             retries_left=len(self.replicas))
        return outer

    def _submit_attempt(self, outer: Future, user_id: int, topk, timeout,
                        priority: int, retries_left: int) -> None:
        try:
            idx = self.pick(user_id, priority)
        except NoHealthyReplicaError as exc:
            _resolve(outer, error=exc)
            return
        try:
            inner = self.replicas[idx].submit(
                user_id, topk, timeout=timeout, priority=priority
            )
        except ReplicaDiedError as exc:
            self.mark_unhealthy(idx)
            if retries_left > 0:
                self.failovers += 1
                self._submit_attempt(outer, user_id, topk, timeout, priority,
                                     retries_left - 1)
            else:
                _resolve(outer, error=exc)
            return

        def relay(done: Future, idx=idx) -> None:
            exc = done.exception()
            if exc is None:
                _resolve(outer, result=done.result())
            elif isinstance(exc, ReplicaDiedError) and retries_left > 0:
                # died mid-flight: the read-loop failed the inner future;
                # same request, different replica, caller none the wiser
                self.mark_unhealthy(idx)
                self.failovers += 1
                self._submit_attempt(outer, user_id, topk, timeout, priority,
                                     retries_left - 1)
            else:
                _resolve(outer, error=exc)

        inner.add_done_callback(relay)

    @property
    def version(self) -> int:
        """Lowest healthy-replica version — what the traffic-taking fleet
        is guaranteed to serve at least (the publisher's lag view).  Dead
        replicas don't count: their stale version is the supervisor's
        problem, not the publisher's."""
        with self._lock:
            live = [self.replicas[i] for i in self._healthy_indices()]
        reps = live or self.replicas
        return min(r.version for r in reps)

    def apply_update(self, msg: bus.DeltaMessage) -> Dict[str, int]:
        """Rolling refresh: ship ``msg`` to one replica at a time, in
        order, waiting for each ack before the next — at most one replica
        is mid-swap at any instant, the rest keep serving.  Returns
        ``{replica_id: acked_version}`` (the dict-ack form the publisher's
        subscriber bookkeeping flattens).

        Unhealthy replicas are skipped (no ack — the publisher sees them
        lag and will force a full heal when they return); a replica dying
        mid-rollout is marked unhealthy and skipped the same way instead
        of failing the whole publish."""
        acks: Dict[str, int] = {}
        for idx, rep in enumerate(self.replicas):
            if not self.is_healthy(idx):
                continue
            delivery, extra = msg, 0
            if faults._PLAN is not None:
                # the chaos seam models the wire: this one delivery can be
                # dropped, duplicated, corrupted, or delayed — the gate +
                # CRC machinery downstream must absorb all of it
                drop = False
                for act in faults.fire("bus.deliver", rep.replica_id):
                    if act.op == "drop":
                        drop = True
                    elif act.op == "dup":
                        extra += 1
                    elif act.op == "corrupt":
                        delivery = faults.corrupt_message(delivery)
                    elif act.op == "delay":
                        time.sleep(act.arg)
                if drop:
                    continue
            try:
                acks[rep.replica_id] = rep.apply_update(delivery)
                for _ in range(extra):
                    acks[rep.replica_id] = rep.apply_update(delivery)
            except (ReplicaDiedError, TimeoutError, BrokenPipeError, OSError):
                self.mark_unhealthy(idx)
        return acks

    def apply_thresholds(self, t_p, t_q) -> Dict[str, int]:
        """Rolling serving-threshold rollout — the SLO controller's fleet
        fan-out.  Same one-replica-at-a-time discipline as
        :meth:`apply_update` (the fleet never dips below N-1 live
        replicas mid-swap); each replica pins the thresholds in its delta
        sink so later replicated snapshots keep them.  Returns
        ``{replica_id: replication_version}`` acks.  Dead replicas are
        skipped/marked like :meth:`apply_update`."""
        acks: Dict[str, int] = {}
        for idx, rep in enumerate(self.replicas):
            if not self.is_healthy(idx):
                continue
            try:
                acks[rep.replica_id] = rep.set_thresholds(t_p, t_q)
            except (ReplicaDiedError, TimeoutError, BrokenPipeError, OSError):
                self.mark_unhealthy(idx)
        return acks

    def stats(self) -> Dict[str, Any]:
        """Routing counters + per-replica stats (pipe round-trips for
        process replicas — don't call on the hot path)."""
        per_replica = []
        for idx, rep in enumerate(self.replicas):
            if not self.is_healthy(idx):
                per_replica.append(
                    {"replica_id": rep.replica_id, "healthy": False}
                )
                continue
            try:
                per_replica.append({**rep.stats(), "healthy": True})
            except (ReplicaDiedError, TimeoutError, BrokenPipeError, OSError):
                per_replica.append(
                    {"replica_id": rep.replica_id, "healthy": False}
                )
        return {
            "policy": self.policy,
            "routed": self.routed,
            "affinity_hits": self.affinity_hits,
            "affinity_cold": self.affinity_cold,
            "affinity_spills": self.affinity_spills,
            "affinity_repins": self.affinity_repins,
            "failovers": self.failovers,
            "replicas": per_replica,
        }

    def close(self) -> None:
        """Drain and close every replica (each completes its in-flight
        requests — the engine/queue graceful-drain contract).  Dead
        replicas still get a close (reaps the child process)."""
        for rep in self.replicas:
            try:
                rep.close()
            except (ReplicaDiedError, TimeoutError, BrokenPipeError, OSError):
                pass


def _resolve(fut: Future, *, result=None, error: Optional[Exception] = None) -> None:
    """Resolve a router-owned future, tolerating caller-side cancellation."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except Exception:
        pass  # cancelled or already resolved — the caller moved on


class ServingFleet:
    """N replicas + a router, built from one model state.

    ``backend="local"`` runs every replica in-process (sharing the given
    tables until a replicated delta gives each its own);
    ``backend="process"`` spawns each as a ``multiprocessing`` child
    bootstrapped from a raw ``kind=full`` bus message of the given state
    (the children start together, each given ``start_timeout`` seconds to
    come up; ``boot_ms`` times the message and the start).  ``engine_kwargs``
    carry the replicas' ``device``.  The fleet quacks like a replica
    (``submit`` / ``apply_update`` / ``version`` / ``stats`` / ``close``),
    so ``publisher.subscribe(fleet.router)`` wires live replication and
    ``fleet.submit(user)`` serves.
    """

    def __init__(
        self,
        params,
        t_p=0.0,
        t_q=0.0,
        *,
        replicas: int = 2,
        backend: str = "local",
        user_history: Optional[np.ndarray] = None,
        base_version: int = 0,
        engine_kwargs: Optional[dict] = None,
        queue_kwargs: Optional[dict] = None,
        router_kwargs: Optional[dict] = None,
        start_timeout: float = 180.0,
    ):
        if replicas < 1:
            raise ValueError("fleet needs at least one replica")
        if backend not in ("local", "process"):
            raise ValueError(f"unknown fleet backend {backend!r}")
        self.backend = backend
        self.boot_ms: Dict[str, float] = {}
        members: List = []
        if backend == "process":
            t0 = time.perf_counter()
            boot = bus.state_message(
                params, t_p, t_q, user_history=user_history,
                version=base_version, compress=False,
            )
            self.boot_ms["message"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            members = self._start_processes(replicas, dict(
                init_msg=boot, engine_kwargs=engine_kwargs,
                queue_kwargs=queue_kwargs, start_timeout=start_timeout))
            self.boot_ms["start"] = (time.perf_counter() - t0) * 1e3
        else:
            for i in range(replicas):
                members.append(LocalReplica(
                    f"r{i}", params, t_p, t_q,
                    user_history=user_history, base_version=base_version,
                    engine_kwargs=engine_kwargs, queue_kwargs=queue_kwargs,
                ))
        self.router = Router(members, **(router_kwargs or {}))

    @staticmethod
    def _start_processes(n: int, kwargs: dict) -> List:
        """Start ``n`` process replicas at once; if any fails to come up,
        close the others and raise its error."""
        members: List = [None] * n
        errors: List[BaseException] = []

        def start(i: int) -> None:
            try:
                members[i] = ProcessReplica(f"r{i}", **kwargs)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        starters = [threading.Thread(target=start, args=(i,), name=f"fleet-start-r{i}")
                    for i in range(n)]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        if errors:
            for rep in members:
                if rep is not None:
                    rep.close()
            raise errors[0]
        return members

    @property
    def replicas(self) -> List:
        """The replica handles, in rolling order."""
        return self.router.replicas

    @property
    def version(self) -> int:
        """Lowest replica version (see :attr:`Router.version`)."""
        return self.router.version

    @property
    def num_users(self) -> int:
        """User-table rows replicas currently serve (min across fleet)."""
        return min(r.num_users for r in self.replicas)

    def submit(self, user_id: int, topk: int = 10, *, timeout=None,
               priority: int = 0) -> Future:
        """Route + enqueue one request (see :meth:`Router.submit`)."""
        return self.router.submit(user_id, topk, timeout=timeout,
                                  priority=priority)

    def apply_update(self, msg: bus.DeltaMessage) -> Dict[str, int]:
        """Rolling refresh across the fleet (see :meth:`Router.apply_update`)."""
        return self.router.apply_update(msg)

    def supervise(self, **kwargs):
        """Attach and start a
        :class:`~repro_torch.serving.fleet.supervisor.FleetSupervisor` over
        this fleet's router (probe → failover →
        respawn → readmit).  Returns the started supervisor; stop it
        before :meth:`close`."""
        from repro_torch.serving.fleet.supervisor import FleetSupervisor

        sup = FleetSupervisor(self.router, **kwargs)
        sup.start()
        return sup

    def stats(self) -> Dict[str, Any]:
        """Router + per-replica counters (see :meth:`Router.stats`)."""
        return self.router.stats()

    def close(self) -> None:
        """Drain and shut down every replica."""
        self.router.close()
