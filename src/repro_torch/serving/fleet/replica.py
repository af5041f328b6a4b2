"""Fleet replicas: one serving engine + queue + version gate per replica.

Counterpart of ``repro/serving/fleet/replica.py``.  Two implementations of
one contract (``replica_id``, ``version``, ``submit() -> Future``,
``apply_update(msg) -> ack``, ``depth()``, ``stats()``, ``close()``):

* :class:`LocalReplica`: everything in this process; the building block the
  process replica runs inside its child.
* :class:`ProcessReplica`: a ``multiprocessing`` child started with
  **spawn** (a forked child cannot use the parent's CUDA context) running a
  ``LocalReplica``, talked to over a duplex pipe.  The child bootstraps from
  a ``kind=full`` :class:`~repro_torch.serving.fleet.bus.DeltaMessage` or
  from a checkpoint directory plus the online delta chain (the late-join
  path, which leaves it at the chain's last version).  It resolves its
  device from ``engine_kwargs`` (``cuda`` unless the caller passes
  ``"cpu"``); a child that cannot reach its device reports the error and
  exits, it never serves on the CPU instead.  Each child has its own CUDA
  context and loads the kernels the parent built
  (``kernels/build.py``; the library path is keyed by the sources' digest),
  and counts its own ``pruned_topk`` launches (``stats()``).

Requests return ``concurrent.futures.Future`` either way; for process
replicas a reader thread resolves them from pipe replies.  Only numpy
arrays, bytes and Python scalars cross the pipe, and a message's payload
leaves of ``SPILL_BYTES`` or more cross through a file in the replica's
temporary directory instead (written and read in one call each): a pipe
moves a large message in 64 KB reads, each of which waits for the GIL
behind the process's busy serving threads.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import shutil
import tempfile
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.distributed.compression import CompressedArray
from repro_torch.serving.fleet import bus
from repro_torch.testing import faults

SPILL_BYTES = 1 << 20  # payload leaves this large cross the pipe through a file


class ReplicaDiedError(RuntimeError):
    """The replica behind a request or control call is dead.

    Raised at once by ``submit`` once death is known, and set on every
    future still pending when the pipe broke: the router catches exactly
    this type to fail over, the supervisor to respawn.
    """


class LocalReplica:
    """One in-process replica: engine + started request queue + gated sink.
    ``engine_kwargs`` (``device`` among them) and ``queue_kwargs`` pass to
    the engine and its queue; a respawn reuses them (``spawn_kwargs``)."""

    def __init__(
        self,
        replica_id: str,
        params,
        t_p=0.0,
        t_q=0.0,
        *,
        user_history: Optional[np.ndarray] = None,
        base_version: int = 0,
        engine_kwargs: Optional[dict] = None,
        queue_kwargs: Optional[dict] = None,
    ):
        from repro_torch.serving.engine import ServingEngine

        self.replica_id = replica_id
        self.spawn_kwargs = {"engine_kwargs": engine_kwargs, "queue_kwargs": queue_kwargs}
        self.engine = ServingEngine(params, t_p, t_q, user_history=user_history,
                                    **(engine_kwargs or {}))
        self.queue = self.engine.start(**(queue_kwargs or {}))
        self._sink = bus.EngineDeltaSink(self.engine, user_history=user_history,
                                         version=base_version, replica_id=replica_id)
        self._dead = False

    @property
    def version(self) -> int:
        """Replication version this replica serves."""
        return self._sink.version

    @property
    def num_users(self) -> int:
        """User-table rows of the served snapshot."""
        return self.engine.num_users

    @property
    def alive(self) -> bool:
        """Liveness flag (a local replica dies only through :meth:`kill`)."""
        return not self._dead

    def ping(self, timeout: float = 5.0) -> bool:
        """Heartbeat probe: True iff the replica would serve a request."""
        return not self._dead

    def kill(self) -> None:
        """Simulated crash: every queued request fails with
        :class:`ReplicaDiedError` at once, later submits raise."""
        if self._dead:
            return
        self._dead = True
        self.queue.abort(ReplicaDiedError(f"replica {self.replica_id} died (injected)"))

    def submit(self, user_id: int, topk: int = 10, *, timeout=None,
               priority: int = 0) -> Future:
        """Enqueue one request; raises :class:`ReplicaDiedError` at once when
        the replica is dead (the ``replica.submit`` fault seam may kill it
        here)."""
        if faults._PLAN is not None:
            for act in faults.fire("replica.submit", self.replica_id):
                if act.op == "kill":
                    self.kill()
        if self._dead:
            raise ReplicaDiedError(f"replica {self.replica_id} is dead")
        return self.engine.submit(user_id, topk, timeout=timeout, priority=priority)

    def apply_update(self, msg: bus.DeltaMessage) -> int:
        """Offer a bus message to the version gate; returns the ack.  The swap
        happens under live traffic: requests in flight finish on the old
        snapshot."""
        if self._dead:
            raise ReplicaDiedError(f"replica {self.replica_id} is dead")
        return self._sink.apply_update(msg)

    def state_message(self) -> bus.DeltaMessage:
        """The served state as a raw ``kind=full`` message (the heal payload)."""
        return self._sink.state_message()

    def set_thresholds(self, t_p, t_q) -> int:
        """Pin SLO serving thresholds (see
        :meth:`~repro_torch.serving.fleet.bus.EngineDeltaSink.set_thresholds`)."""
        return self._sink.set_thresholds(t_p, t_q)

    def depth(self) -> int:
        """Queued + in-scoring requests: the router's load signal."""
        return self.engine.queue_depth

    def stats(self) -> Dict[str, Any]:
        """Counters: version, load, cache, queue, gate; ``apply_ms`` is the
        wall time spent folding and swapping in replicated messages."""
        cache = self.engine.vector_cache
        gate = self._sink.gate
        return {
            "replica_id": self.replica_id,
            "version": self.version,
            "depth": self.depth(),
            "num_users": self.engine.num_users,
            "n_items": self.engine.n_items,
            "requests_served": self.queue.requests_served,
            "batches_served": self.queue.batches_served,
            "expired": self.queue.expired,
            "cache_hits": cache.hits,
            "cache_misses": cache.misses,
            "updates_applied": gate.applied,
            "updates_duplicate": gate.duplicates,
            "updates_buffered": gate.buffered,
            "updates_corrupt": self._sink.corrupt_dropped,
            "apply_ms": self._sink.apply_s * 1e3,
        }

    def close(self) -> None:
        """Drain the queue (every accepted request completes) and stop."""
        self.engine.stop()


# ---------------------------------------------------------------------------
# Process replicas
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Spilled:
    """A payload leaf written to ``path``: a raw array, or a compressed
    blob (``codec`` set)."""

    path: str
    shape: tuple
    dtype: str
    codec: Optional[str] = None


def _spill(msg: Optional[bus.DeltaMessage], directory: str):
    """``msg`` with every payload leaf of :data:`SPILL_BYTES` or more written
    to a new file under ``directory`` (the other side reads and deletes it)."""
    if msg is None:
        return None
    tree = {}
    for key, val in msg.tree.items():
        size = val.nbytes if isinstance(val, CompressedArray) else np.asarray(val).nbytes
        if size < SPILL_BYTES:
            tree[key] = val
            continue
        path = os.path.join(directory, f"{uuid.uuid4().hex}.bin")
        if isinstance(val, CompressedArray):
            with open(path, "wb") as f:
                f.write(val.data)
            tree[key] = _Spilled(path, tuple(val.shape), val.dtype, val.codec)
        else:
            arr = np.ascontiguousarray(val)
            arr.tofile(path)
            tree[key] = _Spilled(path, arr.shape, arr.dtype.str)
    return dataclasses.replace(msg, tree=tree)


def _unspill(msg: Optional[bus.DeltaMessage]):
    """Invert :func:`_spill`, deleting the files."""
    if msg is None or not any(isinstance(v, _Spilled) for v in msg.tree.values()):
        return msg
    tree = {}
    for key, val in msg.tree.items():
        if isinstance(val, _Spilled):
            if val.codec is None:
                tree[key] = np.fromfile(val.path, np.dtype(val.dtype)).reshape(val.shape)
            else:
                with open(val.path, "rb") as f:
                    tree[key] = CompressedArray(f.read(), val.shape, val.dtype, val.codec)
            os.remove(val.path)
        else:
            tree[key] = val
    return dataclasses.replace(msg, tree=tree)


def _process_start_time() -> Optional[float]:
    """Wall-clock start of this process (to a clock tick) from its start in
    ``/proc/self/stat``, counted since boot (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def _child_bootstrap(init: dict, device, boot: Dict[str, float]):
    """The child's initial ``(params, t_p, t_q, history, version)`` from the
    spawn payload (a full message, or checkpoint directories to fold), on
    ``device``; ``boot`` receives the decompress and fold times in ms."""
    from repro_torch.online import publisher

    t0 = time.perf_counter()
    if "msg" in init:
        m = _unspill(init["msg"])
        tree = bus.decode_payload(m.tree)
        boot["decompress_ms"] = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        params, t_p, t_q, history = publisher.apply_delta_tree(
            None, 0.0, 0.0, None, tree, kind="full", num_users=m.num_users,
            num_items=m.num_items, device=device)
        boot["state_ms"] = (time.perf_counter() - t1) * 1e3
        return params, t_p, t_q, history, int(m.version)
    from repro_torch.serving.engine import load_mf_checkpoint

    params, t_p, t_q, _, _ = load_mf_checkpoint(init["checkpoint"], device=device)
    version, history = 0, None
    if init.get("online_dir"):
        params, t_p, t_q, history, version = publisher.fold_deltas(
            init["online_dir"], params, t_p, t_q)
    boot["state_ms"] = (time.perf_counter() - t0) * 1e3
    return params, t_p, t_q, history, version


def _open_device(engine_kwargs: Optional[dict], boot: Dict[str, float]):
    """Resolve the child's device and, on ``cuda``, create its context and
    load the ``pruned_topk`` library (timed into ``boot``)."""
    import torch

    from repro_torch.device import resolve_device

    device = resolve_device((engine_kwargs or {}).get("device"))
    if device.type == "cuda":
        t0 = time.perf_counter()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        boot["cuda_context_ms"] = (time.perf_counter() - t0) * 1e3
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        build.library("pruned_topk")
        boot["kernel_load_ms"] = (time.perf_counter() - t0) * 1e3
    return device


def _replica_main(conn, replica_id: str, init: dict,
                  engine_kwargs: Optional[dict],
                  queue_kwargs: Optional[dict], spawned_at: float = 0.0) -> None:
    """Child process entry: run a :class:`LocalReplica`, serve the pipe.

    Protocol (parent -> child): ``("submit", rid, user, topk, timeout,
    priority)``, ``("update", msg)``, ``("thresholds", t_p, t_q)``,
    ``("stats",)``, ``("ping", seq)``, ``("state",)``, ``("close",)``.
    Child -> parent: ``("ready", version, num_users, boot)``, ``("result",
    rid, scores, items)``, ``("error", rid, repr)``, ``("ack", version,
    ack)``, ``("tack", ack)``, ``("stats", dict)``, ``("pong", seq)``,
    ``("state_msg", DeltaMessage)``, ``("bye",)``.  ``boot`` times the
    bootstrap in ms: ``spawn`` (the parent's start call to this process's
    start), ``import`` (interpreter and imports, up to this function),
    ``cuda_context``, ``kernel_load``, ``decompress`` (the payload read
    from its files and decoded), ``state`` (tables on the device) and ``engine`` (engine and queue built).
    """
    t_main = time.time()
    send_lock = threading.Lock()

    def send(*payload):
        with send_lock:  # the queue's scheduler and the pipe loop both reply
            try:
                conn.send(payload)
            except (BrokenPipeError, OSError):
                pass

    boot: Dict[str, float] = {}
    started = _process_start_time()
    if spawned_at and started is not None:
        boot["spawn_ms"] = max(started - spawned_at, 0.0) * 1e3
        boot["import_ms"] = max(t_main - started, 0.0) * 1e3
    elif spawned_at:
        boot["spawn_import_ms"] = (t_main - spawned_at) * 1e3
    try:
        device = _open_device(engine_kwargs, boot)
        params, t_p, t_q, history, version = _child_bootstrap(init, device, boot)
        t0 = time.perf_counter()
        kwargs = dict(engine_kwargs or {}, device=device)
        replica = LocalReplica(replica_id, params, t_p, t_q, user_history=history,
                               base_version=version, engine_kwargs=kwargs,
                               queue_kwargs=queue_kwargs)
        boot["engine_ms"] = (time.perf_counter() - t0) * 1e3
    except Exception as exc:  # noqa: BLE001 - surface the start failure to the parent
        send("error", -1, f"{type(exc).__name__}: {exc}")
        conn.close()
        return
    send("ready", replica.version, replica.num_users, boot)

    def reply(rid: int, fut: Future) -> None:
        try:
            scores, items = fut.result()
            send("result", rid, np.asarray(scores), np.asarray(items))
        except Exception as exc:  # noqa: BLE001 - the request's own failure
            send("error", rid, f"{type(exc).__name__}: {exc}")

    def child_stats() -> Dict[str, Any]:
        from repro_torch.kernels import pruned_topk

        return {**replica.stats(), "pruned_topk_launches": pruned_topk.launches,
                "pid": os.getpid()}

    try:
        while True:
            try:
                op, *rest = conn.recv()
            except (EOFError, OSError):
                break
            if op == "submit":
                rid, user, topk, timeout, priority = rest
                try:
                    fut = replica.submit(int(user), int(topk), timeout=timeout,
                                         priority=priority)
                except Exception as exc:  # noqa: BLE001
                    send("error", rid, f"{type(exc).__name__}: {exc}")
                else:
                    fut.add_done_callback(lambda f, rid=rid: reply(rid, f))
            elif op == "update":
                (msg,) = rest
                try:
                    msg = _unspill(msg)
                    ack = replica.apply_update(msg)
                except Exception as exc:  # noqa: BLE001
                    send("error", -1, f"{type(exc).__name__}: {exc}")
                else:
                    send("ack", msg.version, ack)
            elif op == "thresholds":
                tp, tq = rest
                try:
                    ack = replica.set_thresholds(tp, tq)
                except Exception as exc:  # noqa: BLE001
                    send("error", -1, f"{type(exc).__name__}: {exc}")
                else:
                    send("tack", ack)
            elif op == "stats":
                send("stats", child_stats())
            elif op == "ping":
                # answered from the pipe loop: a wedged loop reads as a miss
                send("pong", *rest)
            elif op == "state":
                try:
                    send("state_msg", _spill(replica.state_message(), init["spill_dir"]))
                except Exception as exc:  # noqa: BLE001
                    send("error", -1, f"{type(exc).__name__}: {exc}")
            elif op == "close":
                replica.close()  # drains: every queued future resolves and replies
                send("bye")
                break
    finally:
        conn.close()


class ProcessReplica:
    """Parent-side handle to a replica running in a spawned child process.

    Bootstrap with either ``init_msg`` (a ``kind=full`` message, e.g.
    ``bus.state_message``) or ``checkpoint=...`` (+ ``online_dir=...`` to
    fold the delta chain).  ``submit`` returns a Future resolved by the
    reader thread; ``apply_update`` blocks for the child's ack.  A child that
    does not come up within ``start_timeout`` seconds is terminated and the
    constructor raises.  ``boot`` holds the child's bootstrap times (ms).
    """

    def __init__(
        self,
        replica_id: str,
        *,
        init_msg: Optional[bus.DeltaMessage] = None,
        checkpoint: Optional[str] = None,
        online_dir: Optional[str] = None,
        engine_kwargs: Optional[dict] = None,
        queue_kwargs: Optional[dict] = None,
        start_timeout: float = 180.0,
    ):
        if (init_msg is None) == (checkpoint is None):
            raise ValueError("pass exactly one of init_msg / checkpoint")
        # large payload leaves cross the pipe through files here
        self._spill_dir = tempfile.mkdtemp(prefix=f"replica-{replica_id}-")
        init = {"msg": _spill(init_msg, self._spill_dir)} if init_msg is not None else {
            "checkpoint": checkpoint, "online_dir": online_dir}
        init["spill_dir"] = self._spill_dir
        self.replica_id = replica_id
        # what a supervisor needs to spawn an equivalent replacement
        self.spawn_kwargs = {
            "checkpoint": checkpoint, "online_dir": online_dir,
            "engine_kwargs": engine_kwargs, "queue_kwargs": queue_kwargs,
            "start_timeout": start_timeout,
        }
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=_replica_main,
            args=(child_conn, replica_id, init, engine_kwargs, queue_kwargs, time.time()),
            daemon=True,
        )
        self._proc.start()
        child_conn.close()
        self._lock = threading.Lock()          # pipe writes
        self._futs: Dict[int, Future] = {}
        self._futs_lock = threading.Lock()
        self._next_rid = 0
        self._acks: Dict[int, int] = {}
        self._ack_event = threading.Condition()
        self._stats: Optional[dict] = None
        self._stats_event = threading.Event()
        self._tack: Optional[int] = None
        self._tack_event = threading.Event()
        self._pongs: set = set()
        self._pong_event = threading.Condition()
        self._ping_seq = 0
        self._state_msg: Optional[bus.DeltaMessage] = None
        self._state_event = threading.Event()
        self._ready = threading.Event()
        self._bye = threading.Event()
        self._dead = threading.Event()
        self.version = 0
        self.num_users = 0
        self.boot: Dict[str, float] = {}
        self._spawn_error: Optional[str] = None
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"fleet-{replica_id}-reader", daemon=True)
        self._reader.start()
        if not self._ready.wait(start_timeout):
            self._proc.terminate()
            self._proc.join(10)
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            raise TimeoutError(f"replica {replica_id} did not come up in {start_timeout} s")
        if self._spawn_error is not None:
            self._proc.join(10)
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            raise RuntimeError(f"replica {replica_id} failed to start: {self._spawn_error}")

    def _read_loop(self) -> None:
        while True:
            try:
                op, *rest = self._conn.recv()
            except (EOFError, OSError):
                break
            if op == "ready":
                self.version, self.num_users, self.boot = rest
                self._ready.set()
            elif op == "result":
                rid, scores, items = rest
                fut = self._pop_fut(rid)
                if fut is not None:
                    fut.set_result((scores, items))
            elif op == "error":
                rid, text = rest
                if rid == -1 and not self._ready.is_set():
                    self._spawn_error = text
                    self._ready.set()
                    continue
                fut = self._pop_fut(rid)
                if fut is not None:
                    fut.set_exception(RuntimeError(text))
            elif op == "ack":
                version, ack = rest
                with self._ack_event:
                    self._acks[version] = ack
                    self._ack_event.notify_all()
            elif op == "tack":
                (self._tack,) = rest
                self._tack_event.set()
            elif op == "stats":
                (self._stats,) = rest
                self._stats_event.set()
            elif op == "pong":
                (seq,) = rest
                with self._pong_event:
                    self._pongs.add(seq)
                    self._pong_event.notify_all()
            elif op == "state_msg":
                (self._state_msg,) = rest
                self._state_event.set()
            elif op == "bye":
                self._bye.set()
        # the pipe is gone: mark death first so new submits raise at once,
        # then fail everything outstanding (futures, waiters, a constructor
        # still waiting for "ready")
        self._dead.set()
        if not self._ready.is_set():
            if self._spawn_error is None:
                self._spawn_error = "process exited during bootstrap"
            self._ready.set()
        with self._futs_lock:
            leftovers, self._futs = list(self._futs.values()), {}
        exc = ReplicaDiedError(
            f"replica {self.replica_id} died (pipe closed, exitcode={self._proc.exitcode})")
        for fut in leftovers:
            if not fut.done():
                fut.set_exception(exc)
        with self._ack_event:
            self._ack_event.notify_all()
        with self._pong_event:
            self._pong_event.notify_all()
        self._tack_event.set()
        self._stats_event.set()
        self._state_event.set()
        self._bye.set()

    def _pop_fut(self, rid: int) -> Optional[Future]:
        with self._futs_lock:
            return self._futs.pop(rid, None)

    def _send(self, *payload) -> None:
        with self._lock:
            self._conn.send(payload)

    @property
    def alive(self) -> bool:
        """False once the child died or its pipe broke."""
        return not self._dead.is_set() and self._proc.is_alive()

    @property
    def exitcode(self) -> Optional[int]:
        """The child's exit code (None while it runs).  Once the replica is
        known dead the child is reaped first: its pipe can break a moment
        before the process has exited."""
        if self._dead.is_set():
            self._proc.join(timeout=5.0)
        return self._proc.exitcode

    def kill(self) -> None:
        """SIGKILL the child; the reader fails every outstanding future with
        :class:`ReplicaDiedError`."""
        self._proc.kill()

    def ping(self, timeout: float = 5.0) -> bool:
        """Round-trip heartbeat through the child's pipe loop; False on
        timeout, death or a broken pipe, never raises."""
        if self._dead.is_set():
            return False
        with self._pong_event:
            seq = self._ping_seq
            self._ping_seq += 1
        try:
            self._send("ping", seq)
        except (BrokenPipeError, OSError, ReplicaDiedError):
            return False
        with self._pong_event:
            self._pong_event.wait_for(lambda: seq in self._pongs or self._dead.is_set(),
                                      timeout)
            got = seq in self._pongs
            self._pongs.discard(seq)
        return got

    def _raise_if_dead(self) -> None:
        if self._dead.is_set():
            raise ReplicaDiedError(
                f"replica {self.replica_id} is dead (exitcode={self._proc.exitcode})")

    def submit(self, user_id: int, topk: int = 10, *, timeout=None,
               priority: int = 0) -> Future:
        """Forward one request to the child; raises :class:`ReplicaDiedError`
        at once when the child is dead."""
        if faults._PLAN is not None:
            for act in faults.fire("replica.submit", self.replica_id):
                if act.op == "kill":
                    self.kill()
        self._raise_if_dead()
        fut: Future = Future()
        with self._futs_lock:
            rid = self._next_rid
            self._next_rid += 1
            self._futs[rid] = fut
        try:
            self._send("submit", rid, int(user_id), int(topk), timeout, int(priority))
        except (BrokenPipeError, OSError):
            self._pop_fut(rid)
            raise ReplicaDiedError(
                f"replica {self.replica_id} died (pipe write failed)") from None
        return fut

    def apply_update(self, msg: bus.DeltaMessage, *, timeout: float = 180.0) -> int:
        """Ship a bus message and block for the child's ack (its version
        after gating)."""
        self._raise_if_dead()
        try:
            self._send("update", _spill(msg, self._spill_dir))
        except (BrokenPipeError, OSError):
            raise ReplicaDiedError(
                f"replica {self.replica_id} died (pipe write failed)") from None
        with self._ack_event:
            if not self._ack_event.wait_for(
                    lambda: msg.version in self._acks or self._dead.is_set(), timeout):
                raise TimeoutError(f"replica {self.replica_id}: no ack for v{msg.version}")
            if msg.version not in self._acks:
                self._raise_if_dead()
            ack = self._acks.pop(msg.version)
        self.version = max(self.version, ack)
        return ack

    def state_message(self, *, timeout: float = 180.0) -> bus.DeltaMessage:
        """The child's served state as a raw ``kind=full`` message (its
        large leaves through files)."""
        self._raise_if_dead()
        self._state_event.clear()
        self._state_msg = None
        self._send("state")
        if not self._state_event.wait(timeout):
            raise TimeoutError(f"replica {self.replica_id}: state timed out")
        if self._state_msg is None:
            self._raise_if_dead()
            raise RuntimeError(f"replica {self.replica_id}: state fetch failed")
        return _unspill(self._state_msg)

    def set_thresholds(self, t_p, t_q, *, timeout: float = 120.0) -> int:
        """Pin SLO serving thresholds in the child and block for its ack."""
        self._raise_if_dead()
        self._tack_event.clear()
        self._tack = None
        tp = None if t_p is None else float(t_p)
        tq = None if t_q is None else float(t_q)
        self._send("thresholds", tp, tq)
        if not self._tack_event.wait(timeout):
            raise TimeoutError(f"replica {self.replica_id}: threshold swap not acked")
        if self._tack is None:
            self._raise_if_dead()
            raise RuntimeError(f"replica {self.replica_id}: no threshold ack")
        return int(self._tack)

    def depth(self) -> int:
        """Requests submitted here and not yet resolved (no pipe round trip)."""
        with self._futs_lock:
            return len(self._futs)

    def stats(self, *, timeout: float = 60.0) -> Dict[str, Any]:
        """The child's counters over the pipe, with its own
        ``pruned_topk_launches``."""
        self._raise_if_dead()
        self._stats_event.clear()
        self._stats = None
        self._send("stats")
        if not self._stats_event.wait(timeout):
            raise TimeoutError(f"replica {self.replica_id}: stats timed out")
        if self._stats is None:
            self._raise_if_dead()
            raise RuntimeError(f"replica {self.replica_id}: no stats reply")
        return dict(self._stats)

    def close(self, *, timeout: float = 120.0) -> None:
        """Drain the child (requests in flight complete and reply), then
        join the process."""
        try:
            self._send("close")
        except (BrokenPipeError, OSError):
            pass
        self._bye.wait(timeout)
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(10)
        try:
            self._conn.close()
        except OSError:
            pass
        shutil.rmtree(self._spill_dir, ignore_errors=True)
