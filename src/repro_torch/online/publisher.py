"""Versioned factor publication: updater -> serving engine(s), without downtime.

Counterpart of ``repro/online/publisher.py``.  :class:`SnapshotPublisher`
drains the updater's accumulated delta (:meth:`OnlineUpdater.snapshot`) and
pushes it into a running :class:`~repro_torch.serving.engine.ServingEngine`
through :meth:`ServingEngine.swap`: batches in flight finish on the version
they started on; the item layouts are patched for the touched rows only, or
rebuilt after a recalibration or a catalog growth.

The publisher is also the **replication bus** of a serving fleet
(``serving/fleet``): :meth:`subscribe` registers any sink exposing
``apply_update(msg) -> ack`` (a replica, or a router fanning out to many),
and every :meth:`publish` ships one versioned
:class:`~repro_torch.serving.fleet.bus.DeltaMessage` (touched rows only,
losslessly compressed; ``kind=full`` after a recalibration, and then raw:
a whole state only crosses between processes of one host, where the codec
costs more than it saves) to each subscriber in order, waiting for each
ack.  Acked versions are tracked per
subscriber; one that falls behind by more than one delta is healed by the
next publish going out ``kind=full``.  :meth:`set_serving_thresholds` pins
the thresholds the primary engine serves with (the SLO controller's hook);
checkpoints and wire messages keep the model's.

Durability rides along as **delta checkpoints**: each publish writes only
the touched rows (plus thresholds and bookkeeping) through the port's
:class:`~repro_torch.checkpoint.checkpoint.AsyncCheckpointer`, whose
serialization overlaps the next update batches.  A ``kind=full`` checkpoint
is written whenever a delta cannot describe the change (a recalibration
permuted the latent axis) and as a retention anchor.  :func:`fold_deltas`
replays a chain over a base state.  The files are the reference's: either
package folds the other's chain.

With eviction armed (``OnlineUpdater.attach_evictor``) every payload carries
the id remap (``user_remap``) and its ``remap_epoch``, the engine's swap
receives them, and a remap-epoch bump (a compaction renumbered the physical
user rows) forces the next payload to ``kind=full``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import mf
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.online.updater import OnlineUpdater, PublishSnapshot


@dataclasses.dataclass
class SwapReport:
    """What one :meth:`SnapshotPublisher.publish` did."""

    version: int
    swap_s: float               # wall time of the swap and the rolling fan-out
    touched_users: int
    touched_items: int
    full_rebuild: bool
    events_seen: int
    checkpoint_step: Optional[int] = None
    kind: str = "delta"                       # wire/checkpoint payload kind
    acked: Optional[Dict[str, int]] = None    # per-subscriber acked version
    wire_bytes: int = 0                       # compressed message payload
    wire_raw_bytes: int = 0                   # uncompressed equivalent
    encode_s: float = 0.0                     # building the message (codec included)


class SnapshotPublisher:
    """Publish updater snapshots into live engines, optionally
    checkpointing.

    ``engine`` is the co-located primary (swapped directly, no
    serialization) and may be None for a fleet-only topology where every
    engine is a subscriber.  ``checkpoint_dir`` enables async delta
    checkpoints (one per publish, step = publish version, ``keep``
    retention, a full anchor whenever the chain would outgrow it).
    ``compress`` turns the lossless byte-shuffle + DEFLATE codec on for
    shipped deltas (``distributed/compression.py``); ``kind=full`` messages
    ship raw.  :meth:`publish` is
    safe under concurrent request traffic.
    """

    def __init__(
        self,
        engine,
        updater: OnlineUpdater,
        *,
        checkpoint_dir: Optional[str] = None,
        keep: int = 8,
        compress: bool = True,
    ):
        self.engine = engine
        self.updater = updater
        self.keep = keep
        self.compress = compress
        self._ckpt = (
            ckpt_lib.AsyncCheckpointer(checkpoint_dir, keep=keep) if checkpoint_dir else None
        )
        self._last_step = 0       # previous checkpoint step (0 = the base)
        self._last_full_step = 0  # most recent kind=full anchor
        self._force_full_next = False
        # eviction remap epoch last published: a bump forces a full payload
        self._last_remap_epoch = 0
        if checkpoint_dir:
            # resume an existing chain: steps keep counting from the
            # directory's frontier, and the first checkpoint after a restart
            # is a full anchor
            frontier = ckpt_lib.latest_step(checkpoint_dir)
            if frontier is not None:
                self._last_step = frontier
                self._force_full_next = True
        # wire versions share the checkpoint step number line, so a replica
        # rebuilt by fold_deltas joins the live bus without translation
        self._version = self._last_step
        self.subscribers: List = []
        self.acked: Dict[str, int] = {}
        self.reports: list = []
        # SLO serving-threshold pin: while set, the primary engine swaps in
        # with these thresholds instead of the snapshot's, so a publish does
        # not revert the controller's degradation
        self._serving_thresholds: Optional[Tuple[float, float]] = None

    @property
    def version(self) -> int:
        """Version of the most recently published snapshot (and the step of
        its checkpoint, when checkpointing is on)."""
        return self._version

    def subscribe(self, sink, *, name: Optional[str] = None):
        """Register a replication sink: anything exposing
        ``apply_update(msg)`` that returns an acked version (int) or a
        ``{replica_id: version}`` dict (a router fanning out to a fleet).
        Sinks are shipped to in subscription order, the rolling order.  A
        sink behind the bus (a late joiner, a fresh replica at version 0) is
        healed by the next publish going out ``kind=full``.  Returns the
        sink."""
        self.subscribers.append(sink)
        sink_name = name or getattr(sink, "replica_id", None)
        if sink_name is not None:
            self.acked[sink_name] = int(getattr(sink, "version", 0))
        return sink

    def set_serving_thresholds(self, t_p, t_q) -> None:
        """Pin the thresholds the primary engine swaps in with on every
        later :meth:`publish` (the SLO controller's hook), until
        :meth:`clear_serving_thresholds`."""
        self._serving_thresholds = (float(t_p), float(t_q))

    def clear_serving_thresholds(self) -> None:
        """Unpin: the next publish serves the snapshot's thresholds again."""
        self._serving_thresholds = None

    def lag(self) -> int:
        """Worst subscriber staleness in publish versions (0 = every
        subscriber acked the latest publish)."""
        if not self.acked:
            return 0
        return self._version - min(self.acked.values())

    def _record_ack(self, sink, ack) -> None:
        if isinstance(ack, dict):
            for rid, v in ack.items():
                self.acked[str(rid)] = int(v)
        else:
            name = getattr(sink, "replica_id", None)
            self.acked[str(name) if name is not None else f"sink{id(sink)}"] = int(ack)

    def publish(self) -> SwapReport:
        """One snapshot -> swap -> rolling fan-out -> (async) checkpoint
        cycle."""
        snap = self.updater.snapshot()
        self._version += 1
        version = self._version
        # a full payload wherever a row delta cannot describe the change
        # (recalibration, an eviction compaction), the chain restarts,
        # retention would orphan the delta chain, or a subscriber is behind
        # by more than this one delta (its gate would buffer it forever)
        full = (
            snap.full_rebuild
            or self._force_full_next
            or snap.remap_epoch != self._last_remap_epoch
            or (self._ckpt is not None
                and version - self._last_full_step >= max(self.keep - 1, 1))
            or any(a < version - 1 for a in self.acked.values())
        )
        self._last_remap_epoch = snap.remap_epoch
        remap_kwargs = ({} if snap.user_remap is None
                        else {"user_remap": snap.user_remap, "remap_epoch": snap.remap_epoch})

        start = time.perf_counter()
        engine_version = None
        pin = self._serving_thresholds
        serve_t_p = snap.t_p if pin is None else np.float32(pin[0])
        serve_t_q = snap.t_q if pin is None else np.float32(pin[1])
        if self.engine is not None:
            engine_version = self.engine.swap(
                snap.params, serve_t_p, serve_t_q,
                touched_users=None if snap.full_rebuild else snap.touched_users,
                touched_items=None if snap.full_rebuild else snap.touched_items,
                touched_implicit_items=snap.touched_implicit_items,
                user_history=snap.user_history,
                **remap_kwargs,
            )

        msg = None
        acked = None
        encode_s = 0.0
        if self.subscribers:
            from repro_torch.serving.fleet import bus

            t0 = time.perf_counter()
            msg = bus.make_message(snap, version, version - 1, full=full,
                                   compress=self.compress and not full)
            encode_s = time.perf_counter() - t0
            # rolling: one subscriber at a time, in order, each ack awaited
            for sink in self.subscribers:
                self._record_ack(sink, sink.apply_update(msg))
            acked = dict(self.acked)
        swap_s = time.perf_counter() - start

        step = None
        if self._ckpt is not None:
            step = version
            self._ckpt.save(
                step,
                _delta_tree(snap, full=full),
                metadata={
                    "kind": "full" if full else "delta",
                    "prev_step": self._last_step,
                    "version": engine_version if engine_version is not None else version,
                    "events_seen": snap.events_seen,
                    "snapshot_id": snap.snapshot_id,
                    "num_users": snap.params.p.shape[0],
                    "num_items": snap.params.q.shape[0],
                    "remap_epoch": snap.remap_epoch,
                },
            )
            self._last_step = step
            if full:
                self._last_full_step = step
        self._force_full_next = False
        report = SwapReport(
            version=engine_version if engine_version is not None else version,
            swap_s=swap_s,
            touched_users=len(snap.touched_users),
            touched_items=len(snap.touched_items),
            full_rebuild=snap.full_rebuild,
            events_seen=snap.events_seen,
            checkpoint_step=step,
            kind="full" if full else "delta",
            acked=acked,
            wire_bytes=0 if msg is None else msg.wire_bytes,
            wire_raw_bytes=0 if msg is None else msg.raw_bytes,
            encode_s=encode_s,
        )
        self.reports.append(report)
        return report

    def close(self) -> None:
        """Join the in-flight checkpoint write (surfaces async errors)."""
        if self._ckpt is not None:
            self._ckpt.wait()


# ---------------------------------------------------------------------------
# Delta checkpoint format (the reference's keys)
# ---------------------------------------------------------------------------


def _delta_tree(snap: PublishSnapshot, *, full: bool) -> dict:
    """Checkpoint payload of one publish: ``kind=delta`` the touched row
    indices and their current values, ``kind=full`` the whole params."""
    params = snap.params
    if full:
        tree = {"params": params}
    else:
        dev = params.p.device
        u = torch.as_tensor(snap.touched_users, dtype=torch.int64).to(dev)
        i = torch.as_tensor(snap.touched_items, dtype=torch.int64).to(dev)
        tree = {
            "user_idx": u.to(torch.int32),
            "p_rows": params.p[u],
            "item_idx": i.to(torch.int32),
            "q_rows": params.q[i],
        }
        if params.user_bias is not None:
            tree["user_bias_rows"] = params.user_bias[u]
            tree["item_bias_rows"] = params.item_bias[i]
            tree["global_mean"] = params.global_mean
        if params.implicit is not None:
            y = torch.as_tensor(snap.touched_implicit_items, dtype=torch.int64).to(dev)
            tree["implicit_idx"] = y.to(torch.int32)
            tree["implicit_rows"] = params.implicit[y]
    tree["t_p"] = snap.t_p
    tree["t_q"] = snap.t_q
    if snap.user_history is not None:
        tree["user_history"] = np.asarray(snap.user_history)
    if snap.user_remap is not None:
        # eviction armed: every payload carries the current ext -> phys
        # table (cold start extends it between compactions) and its epoch
        tree["user_remap"] = np.asarray(snap.user_remap, np.int32)
        tree["remap_epoch"] = np.int64(snap.remap_epoch)
    return tree


def _grow_like(params: mf.MFParams, num_users: int, num_items: int) -> mf.MFParams:
    """Zero-extend params to ``(num_users, num_items)`` before a delta
    scatter (new tensors); grown rows are always in the delta's touched set,
    so the zero fill is overwritten at once."""
    m, k = params.p.shape
    n = params.q.shape[0]
    if num_users <= m and num_items <= n:
        return params

    def pad(t, rows):
        return torch.cat([t, t.new_zeros((rows,) + tuple(t.shape[1:]))])

    out = params
    if num_items > n:
        add = num_items - n
        out = out._replace(
            q=pad(out.q, add),
            item_bias=None if out.item_bias is None else pad(out.item_bias, add),
            implicit=None if out.implicit is None else torch.cat([
                out.implicit[:n], out.implicit.new_zeros((add, k)), out.implicit[n:]]),
        )
    if num_users > m:
        add = num_users - m
        out = out._replace(
            p=pad(out.p, add),
            user_bias=None if out.user_bias is None else pad(out.user_bias, add),
        )
    return out


def apply_delta_tree(
    params: mf.MFParams,
    t_p,
    t_q,
    history: Optional[np.ndarray],
    tree: dict,
    *,
    kind: str,
    num_users: int,
    num_items: int,
    extras: Optional[dict] = None,
    device: DeviceLike = None,
) -> Tuple[mf.MFParams, torch.Tensor, torch.Tensor, Optional[np.ndarray]]:
    """Fold one delta/full payload (flat ``{key: array}``, as on disk) into
    ``(params, t_p, t_q, history)``.  A delta is scattered **in place** into
    the tables of ``params`` (or of their grown copies): pass tables the
    caller owns.  A full payload replaces them, on ``params``' device, or on
    ``device`` when ``params`` is None (a state rebuilt from nothing).
    ``extras`` (an optional out-parameter dict) receives the eviction remap
    (``user_remap``, ``remap_epoch``) when the payload has one."""
    dev = resolve_device(device) if params is None else params.p.device
    if kind == "full":
        params = mf.params_from_flat(tree, device=dev)
    else:
        params = _grow_like(params, num_users, num_items)

        def rows(key, like):
            return torch.as_tensor(np.asarray(tree[key])).to(dev, like.dtype)

        u = torch.as_tensor(np.asarray(tree["user_idx"]), dtype=torch.int64).to(dev)
        i = torch.as_tensor(np.asarray(tree["item_idx"]), dtype=torch.int64).to(dev)
        params.p[u] = rows("p_rows", params.p)
        params.q[i] = rows("q_rows", params.q)
        if "user_bias_rows" in tree and params.user_bias is not None:
            params.user_bias[u] = rows("user_bias_rows", params.user_bias)
            params.item_bias[i] = rows("item_bias_rows", params.item_bias)
        if "implicit_idx" in tree and params.implicit is not None:
            y = torch.as_tensor(np.asarray(tree["implicit_idx"]), dtype=torch.int64).to(dev)
            params.implicit[y] = rows("implicit_rows", params.implicit)
    t_p = torch.as_tensor(np.float32(tree["t_p"])).to(dev)
    t_q = torch.as_tensor(np.float32(tree["t_q"])).to(dev)
    if "user_history" in tree:
        history = np.asarray(tree["user_history"])
    if extras is not None and "user_remap" in tree:
        extras["user_remap"] = np.asarray(tree["user_remap"], np.int32)
        extras["remap_epoch"] = int(np.asarray(tree["remap_epoch"]))
    return params, t_p, t_q, history


def fold_deltas(
    directory: str,
    params: mf.MFParams,
    t_p,
    t_q,
    *,
    user_history: Optional[np.ndarray] = None,
    from_step: int = 0,
    extras: Optional[dict] = None,
) -> Tuple[mf.MFParams, torch.Tensor, torch.Tensor, Optional[np.ndarray], int]:
    """Replay the delta chain under ``directory`` onto a base state (written
    in place: pass tables the caller owns).

    Steps apply ascending, skipping those at or below ``from_step``; the
    replay anchors on the latest surviving ``kind=full`` checkpoint and
    checks the chain's continuity through each delta's ``prev_step`` (a
    missing predecessor raises).  Returns ``(params, t_p, t_q,
    user_history, last_step)``; with ``extras`` given, the remap carried by
    the replayed payloads (``user_remap``, ``remap_epoch``) is written into
    it.
    """
    dev = params.p.device
    t_p = torch.as_tensor(t_p, dtype=torch.float32).to(dev)
    t_q = torch.as_tensor(t_q, dtype=torch.float32).to(dev)
    history = None if user_history is None else np.asarray(user_history)
    last = from_step
    steps = [s for s in ckpt_lib.all_steps(directory) if s > from_step]
    metas = {s: ckpt_lib.load_metadata(directory, s) for s in steps}
    fulls = [s for s in steps if metas[s].get("kind", "delta") == "full"]
    if fulls:  # everything before the latest full is subsumed by it
        steps = [s for s in steps if s >= fulls[-1]]
    for step in steps:
        meta = metas[step]
        tree, _ = ckpt_lib.load_raw(directory, step, metadata=meta)
        kind = meta.get("kind", "delta")
        if kind == "delta":
            prev = meta.get("prev_step")
            if prev is not None and int(prev) != last:
                raise ValueError(
                    f"delta chain broken at step {step}: expects predecessor "
                    f"{prev} but replay state is at {last} (retention "
                    "deleted intermediate deltas?)")
        params, t_p, t_q, history = apply_delta_tree(
            params, t_p, t_q, history, tree, kind=kind,
            num_users=int(meta.get("num_users", params.p.shape[0])),
            num_items=int(meta.get("num_items", params.q.shape[0])),
            extras=extras,
        )
        last = step
    return params, t_p, t_q, history, last
