"""Replication wire format and per-replica version gating.

Counterpart of ``repro/serving/fleet/bus.py``.  One :class:`DeltaMessage`
is one published snapshot on the wire: the same touched-rows-only tree the
delta checkpoints store (``kind=full`` carries the whole params), flattened
to ``{key: array}`` with the checkpoint's npz keys
(:func:`repro_torch.checkpoint.checkpoint.flatten_with_paths`) and
losslessly compressed per array (``distributed/compression.py``).  The keys,
the compressed bytes and the CRC are the reference's for the same snapshot,
so a replica that decompresses a message and one that replays the checkpoint
chain fold the same bytes with the same applier
(:func:`repro_torch.online.publisher.apply_delta_tree`) and end bitwise
equal.  Messages hold numpy arrays and bytes only: no torch tensor crosses a
process pipe (a CUDA tensor would be shared by IPC handle, not copied).

Delivery over processes is at-least-once and unordered in general, so each
replica fronts its engine with a :class:`VersionGate`:

* duplicate or stale (``version <= current``): acked, not applied;
* in-order delta (``prev_version == current``): applied, then any buffered
  successors chain-apply;
* out-of-order delta (a gap): buffered until the chain fills in, or until a
  ``kind=full`` message fast-forwards past it;
* ``kind=full``: always applicable, the heal path for a replica behind.

:class:`EngineDeltaSink` is the gate bound to one
:class:`~repro_torch.serving.engine.ServingEngine`.  An accepted message
folds into **new** tables (:func:`apply_message` clones every table it
writes: the engine's current snapshot, which requests in flight read, and
any other replica built from the same tensors keep theirs bit for bit) and
hot-swaps in through ``engine.swap``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import mf
from repro_torch.device import DeviceLike
from repro_torch.distributed.compression import (
    CompressedArray,
    compress_array,
    decompress_array,
)
from repro_torch.online import publisher as publisher_lib
from repro_torch.online.updater import PublishSnapshot


@dataclasses.dataclass(frozen=True)
class DeltaMessage:
    """One versioned snapshot publication on the replication bus.

    ``tree`` is the flattened delta/full checkpoint payload (``{key:
    CompressedArray | np.ndarray}``); ``kind`` says how to apply it
    ("delta" scatters touched rows, "full" replaces the params).
    ``full_rebuild`` is separate from ``kind``: a retention-anchor full still
    describes a touched-rows change, so replicas patch their layouts; only a
    recalibration (``full_rebuild=True``) makes the engine rebuild them.
    ``remap_epoch`` is the publishing updater's eviction remap generation (a
    bump forces a full-layout swap).  ``payload_crc`` is the CRC-32 of the
    payload (:func:`payload_checksum`), ``-1`` when unstamped; a sink NAKs a
    mismatch.  Everything here pickles (numpy and bytes only).
    """

    version: int
    prev_version: int
    kind: str                       # "delta" | "full"
    full_rebuild: bool
    num_users: int
    num_items: int
    touched_users: np.ndarray
    touched_items: np.ndarray
    touched_implicit_items: np.ndarray
    tree: Dict[str, object]         # CompressedArray or raw np.ndarray
    events_seen: int = 0
    snapshot_id: int = 0
    remap_epoch: int = 0
    payload_crc: int = -1

    @property
    def wire_bytes(self) -> int:
        """Payload bytes as shipped (compressed where the codec ran)."""
        return sum(v.nbytes if isinstance(v, CompressedArray) else int(np.asarray(v).nbytes)
                   for v in self.tree.values())

    @property
    def raw_bytes(self) -> int:
        """Payload bytes before compression."""
        return sum(v.raw_nbytes if isinstance(v, CompressedArray) else int(np.asarray(v).nbytes)
                   for v in self.tree.values())


def payload_checksum(tree: Dict[str, object]) -> int:
    """CRC-32 over a wire payload: sorted keys, then each value's exact bytes
    (the compressed blob of a :class:`CompressedArray`, dtype/shape-tagged
    raw bytes of a plain array), as the reference computes it."""
    crc = 0
    for key in sorted(tree):
        val = tree[key]
        crc = zlib.crc32(key.encode(), crc)
        if isinstance(val, CompressedArray):
            crc = zlib.crc32(val.data, crc)
        else:
            arr = np.ascontiguousarray(np.asarray(val))
            crc = zlib.crc32(f"{arr.dtype}{arr.shape}".encode(), crc)
            crc = zlib.crc32(arr.tobytes(), crc)
    return crc


def verify_message(msg: DeltaMessage) -> bool:
    """True when the payload matches its stamped checksum (or the message is
    unstamped): every sink's admission precondition."""
    if msg.payload_crc < 0:
        return True
    return payload_checksum(msg.tree) == msg.payload_crc


def _flat_payload(tree: dict, *, compress: bool) -> Dict[str, object]:
    """Flatten a delta/full checkpoint tree to the wire ``{key: payload}``
    dict (the checkpoint npz keys; tensors copied to host numpy)."""
    flat = ckpt_lib.flatten_with_paths(tree)
    if compress:
        return {key: compress_array(arr) for key, arr in flat}
    return {key: np.asarray(arr) for key, arr in flat}


def decode_payload(payload: Dict[str, object]) -> Dict[str, np.ndarray]:
    """The message payload as plain numpy arrays (decompressed)."""
    return {key: decompress_array(v) if isinstance(v, CompressedArray) else np.asarray(v)
            for key, v in payload.items()}


def make_message(
    snap: PublishSnapshot,
    version: int,
    prev_version: int,
    *,
    full: bool,
    compress: bool = True,
) -> DeltaMessage:
    """Serialize one updater snapshot for the bus.  The payload is exactly
    what the delta checkpoint of this publish stores
    (``publisher._delta_tree``), so wire version ``v`` and checkpoint step
    ``v`` hold identical bytes."""
    payload = _flat_payload(publisher_lib._delta_tree(snap, full=full), compress=compress)
    return DeltaMessage(
        version=int(version),
        prev_version=int(prev_version),
        kind="full" if full else "delta",
        full_rebuild=bool(snap.full_rebuild),
        num_users=int(snap.params.p.shape[0]),
        num_items=int(snap.params.q.shape[0]),
        touched_users=np.asarray(snap.touched_users, np.int64),
        touched_items=np.asarray(snap.touched_items, np.int64),
        touched_implicit_items=np.asarray(snap.touched_implicit_items, np.int64),
        tree=payload,
        events_seen=int(snap.events_seen),
        snapshot_id=int(snap.snapshot_id),
        remap_epoch=int(snap.remap_epoch),
        payload_crc=payload_checksum(payload),
    )


def _f32(value) -> np.float32:
    """A threshold as numpy float32 (a tensor on any device, or a number)."""
    return np.float32(float(value))


def state_message(
    params: mf.MFParams,
    t_p,
    t_q,
    *,
    user_history: Optional[np.ndarray] = None,
    version: int = 0,
    compress: bool = True,
) -> DeltaMessage:
    """A ``kind=full`` message carrying a whole model state: the bootstrap
    payload of a :class:`~repro_torch.serving.fleet.replica.ProcessReplica`
    and the heal payload of a respawn."""
    tree = {"params": params, "t_p": _f32(t_p), "t_q": _f32(t_q)}
    if user_history is not None:
        tree["user_history"] = np.asarray(user_history)
    payload = _flat_payload(tree, compress=compress)
    return DeltaMessage(
        version=int(version),
        prev_version=int(version),
        kind="full",
        full_rebuild=True,
        num_users=int(params.p.shape[0]),
        num_items=int(params.q.shape[0]),
        touched_users=np.empty(0, np.int64),
        touched_items=np.empty(0, np.int64),
        touched_implicit_items=np.empty(0, np.int64),
        tree=payload,
        payload_crc=payload_checksum(payload),
    )


def state_from_message(msg: DeltaMessage, *, device: DeviceLike = None):
    """Rebuild ``(params, t_p, t_q, user_history)`` from a ``kind=full``
    message on ``device`` (default ``cuda``): the inverse of
    :func:`state_message`."""
    if msg.kind != "full":
        raise ValueError("state_from_message needs a kind=full message")
    return publisher_lib.apply_delta_tree(
        None, 0.0, 0.0, None, decode_payload(msg.tree), kind="full",
        num_users=msg.num_users, num_items=msg.num_items, device=device,
    )


# tables a delta payload writes, by the payload key that carries their rows
_WRITES = (("user_idx", ("p",)), ("item_idx", ("q",)),
           ("user_bias_rows", ("user_bias", "item_bias")), ("implicit_idx", ("implicit",)))


def _writable(params: mf.MFParams, tree: dict, num_users: int, num_items: int) -> mf.MFParams:
    """``params`` with every table that ``tree`` scatters into cloned, so the
    fold never writes a tensor someone else holds.  Tables the fold grows are
    new tensors anyway and are not cloned."""
    grows = {"p": num_users > params.p.shape[0], "user_bias": num_users > params.p.shape[0],
             "q": num_items > params.q.shape[0], "item_bias": num_items > params.q.shape[0],
             "implicit": num_items > params.q.shape[0]}
    fields = {name for key, names in _WRITES if key in tree for name in names}
    return params._replace(**{
        name: getattr(params, name).clone() for name in fields
        if getattr(params, name) is not None and not grows[name]})


def apply_message(
    params: Optional[mf.MFParams],
    t_p,
    t_q,
    history: Optional[np.ndarray],
    msg: DeltaMessage,
    *,
    extras: Optional[dict] = None,
    device: DeviceLike = None,
) -> Tuple[mf.MFParams, torch.Tensor, torch.Tensor, Optional[np.ndarray]]:
    """Decompress a message and fold it into ``(params, t_p, t_q, history)``,
    the wire twin of the checkpoint fold in
    :func:`repro_torch.online.publisher.fold_deltas` (both call
    ``apply_delta_tree``, so the results are bitwise equal).  The tables of
    ``params`` are never written: a delta lands in clones.  ``extras``
    receives the remap (``user_remap``, ``remap_epoch``) when the payload
    carries one; ``device`` places a full state when ``params`` is None."""
    tree = decode_payload(msg.tree)
    if params is not None and msg.kind != "full":
        params = _writable(params, tree, msg.num_users, msg.num_items)
    return publisher_lib.apply_delta_tree(
        params, t_p, t_q, history, tree, kind=msg.kind, num_users=msg.num_users,
        num_items=msg.num_items, extras=extras, device=device,
    )


class VersionGate:
    """Idempotent, monotonic delta admission for one replica.

    ``offer`` returns the replica's version after considering the message
    (the ack the publisher tracks).  ``apply_fn`` is called with each
    admitted message, oldest first: every version at most once, in order,
    without gaps.  Thread-safe.
    """

    def __init__(self, apply_fn: Callable[[DeltaMessage], None], *, version: int = 0,
                 max_buffer: int = 64):
        self._apply = apply_fn
        self.version = int(version)
        self._pending: Dict[int, DeltaMessage] = {}  # keyed by prev_version
        self._max_buffer = max_buffer
        self._lock = threading.Lock()
        self.applied = 0
        self.duplicates = 0
        self.buffered = 0

    def offer(self, msg: DeltaMessage) -> int:
        """Consider one delivery; returns the current version (the ack)."""
        with self._lock:
            if msg.version <= self.version:
                self.duplicates += 1      # duplicate or stale: ack, drop
                return self.version
            if msg.kind == "full" or msg.prev_version == self.version:
                self._apply_chain(msg)
            else:
                # a gap: hold until the missing predecessor (or a full) lands
                self._pending[msg.prev_version] = msg
                self.buffered += 1
                if len(self._pending) > self._max_buffer:
                    del self._pending[min(self._pending)]
            return self.version

    def _apply_chain(self, msg: DeltaMessage) -> None:
        self._apply(msg)
        self.version = msg.version
        self.applied += 1
        while self.version in self._pending:
            nxt = self._pending.pop(self.version)
            if nxt.version <= self.version:
                continue
            self._apply(nxt)
            self.version = nxt.version
            self.applied += 1
        # anything a full fast-forwarded past is stale now
        self._pending = {base: m for base, m in self._pending.items()
                         if m.version > self.version}


class EngineDeltaSink:
    """A :class:`VersionGate` bound to one live engine.

    Admitted messages fold into new host-side ``(params, t_p, t_q,
    history)`` and hot-swap in through ``engine.swap``: touched rows patch
    the layouts unless the message carries ``full_rebuild`` (or is a full
    that skips versions).  ``apply_update`` is the subscriber interface of
    :meth:`repro_torch.online.publisher.SnapshotPublisher.subscribe`.
    ``apply_s`` sums the wall time of the folds and swaps.
    """

    def __init__(self, engine, *, user_history: Optional[np.ndarray] = None,
                 version: int = 0, replica_id: Optional[str] = None):
        self.engine = engine
        self.replica_id = replica_id
        self._history = None if user_history is None else np.asarray(user_history)
        self._gate = VersionGate(self._apply_one, version=version)
        # SLO serving-threshold pin: while set, replicated snapshots swap in
        # with these thresholds instead of the message's (runtime state
        # only: wire and checkpoints keep the model's)
        self._threshold_override: Optional[Tuple[float, float]] = None
        self.corrupt_dropped = 0
        self.apply_s = 0.0

    @property
    def version(self) -> int:
        """Version of the snapshot the engine serves."""
        return self._gate.version

    @property
    def gate(self) -> VersionGate:
        """The underlying gate (counters ``applied``/``duplicates``/``buffered``)."""
        return self._gate

    def apply_update(self, msg: DeltaMessage) -> int:
        """Offer one delivery to the gate; returns the acked version.  A
        corrupt payload (CRC mismatch) is dropped before the gate, and the
        stale ack is the NAK: the publisher sees the lag and heals with
        ``kind=full``."""
        if not verify_message(msg):
            self.corrupt_dropped += 1
            return self._gate.version
        return self._gate.offer(msg)

    def state_message(self) -> DeltaMessage:
        """The engine's served state as a raw ``kind=full`` message (with any
        SLO pin): what a healthy peer hands the supervisor to heal a respawn.
        A whole state only crosses between processes of one host, where the
        codec costs more than it saves."""
        return state_message(self.engine.params, self.engine.t_p, self.engine.t_q,
                             user_history=self.engine.user_history,
                             version=self._gate.version, compress=False)

    def set_thresholds(self, t_p, t_q) -> int:
        """Pin SLO serving thresholds: swap them in now (a full rebuild) and
        apply them over the model thresholds of every later snapshot.
        ``None, None`` unpins.  Returns the replication version (unchanged)."""
        if t_p is None and t_q is None:
            self._threshold_override = None
        else:
            self._threshold_override = (float(t_p), float(t_q))
            self.engine.swap(self.engine.params, np.float32(t_p), np.float32(t_q),
                             user_history=self.engine.user_history)
        return self._gate.version

    def _apply_one(self, msg: DeltaMessage) -> None:
        t0 = time.perf_counter()
        # a full that skips versions replaced more than this publish's
        # touched rows: the touched-rows patch is sound only for the next one
        sequential = msg.prev_version == self._gate.version
        extras: Dict[str, object] = {}
        params, t_p, t_q, history = apply_message(
            self.engine.params, self.engine.t_p, self.engine.t_q, self._history, msg,
            extras=extras)
        self._history = history
        if self._threshold_override is not None:
            t_p, t_q = (np.float32(v) for v in self._threshold_override)
        remap_kwargs = {}
        if "user_remap" in extras:
            remap_kwargs = {"user_remap": extras["user_remap"],
                            "remap_epoch": extras["remap_epoch"]}
        if msg.full_rebuild or (msg.kind == "full" and not sequential):
            self.engine.swap(params, t_p, t_q, user_history=history, **remap_kwargs)
        else:
            self.engine.swap(
                params, t_p, t_q,
                touched_users=msg.touched_users,
                touched_items=msg.touched_items,
                touched_implicit_items=msg.touched_implicit_items,
                user_history=history,
                **remap_kwargs,
            )
        self.apply_s += time.perf_counter() - t0
