"""The port's serving fleet held against the JAX reference on the CPU: the
lossless codec, the wire messages, version gating, the publisher's
replication fan-out, late join from a reference delta chain, the router's
policies and rolling refresh, copy on write across replicas, and one
process fleet.

Tolerances: none.  Codec blobs, message keys, bytes and CRCs are
byte-identical to the reference's for the same arrays; every convergence
check is bitwise (tables, or top-k scores and ids against a fresh port
engine on the published state).  The reference's
``test_message_wire_smaller_than_raw`` asserts that DEFLATE pays for itself
on a 24-row delta, a property of the data rather than of the bus (ROADMAP
C2); the codec is held byte for byte to the reference's instead.
"""
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.online import publisher as jpublisher
from repro.online import updater as jupdater
from repro.serving.fleet import bus as jbus
from repro.serving.fleet import router as jrouter
from repro_torch.distributed import compression
from repro_torch.online import EventBatch, SnapshotPublisher, fold_deltas
from repro_torch.online import updater
from repro_torch.serving.fleet import (
    EngineDeltaSink,
    LocalReplica,
    ProcessReplica,
    Router,
    ServingFleet,
    VersionGate,
    apply_message,
    make_message,
    state_from_message,
    state_message,
)
from repro_torch.serving.fleet import bus
from tests.fleet_parity import (
    CPU,
    M,
    N,
    assert_params_equal,
    assert_serves,
    batch,
    engine,
    events,
    fields,
    messages,
    port_params,
    port_updater,
    ref_batch,
    ref_params,
    ref_updater,
    to_port_message,
)

CODEC_ARRAYS = [
    np.float32(3.5),
    np.zeros((), np.float64),
    np.empty((0, 8), np.float32),
    np.arange(7, dtype=np.int32),
    np.linspace(-2, 2, 4096, dtype=np.float32).reshape(64, 64),
    (np.random.default_rng(0).normal(size=(512, 24)) * 0.1).astype(np.float32),
    np.arange(4, dtype=np.int8),
    (np.random.default_rng(1).normal(size=(2048, 24)) * 0.1).astype(np.float32),
]
CODEC_IDS = ["scalar32", "scalar64", "empty", "tiny-int", "grid", "factors", "int8-raw", "rows"]


# ---------------------------------------------------------------------------
# lossless codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arr", CODEC_ARRAYS, ids=CODEC_IDS)
def test_codec_bytes_are_the_references(arr):
    got, want = compression.compress_array(arr), jcomp.compress_array(arr)
    assert (got.data, got.shape, got.dtype, got.codec) == (
        want.data, want.shape, want.dtype, want.codec)
    assert (got.nbytes, got.raw_nbytes) == (want.nbytes, want.raw_nbytes)
    # bitwise round trip, and each package reads the other's blob
    for back in (compression.decompress_array(got),
                 compression.decompress_array(compression.CompressedArray(
                     want.data, want.shape, want.dtype, want.codec)),
                 jcomp.decompress_array(jcomp.CompressedArray(
                     got.data, got.shape, got.dtype, got.codec))):
        assert back.shape == np.shape(arr) and back.dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(back, np.asarray(arr))


def test_codec_rejects_an_unknown_codec():
    c = compression.compress_array(np.ones(64, np.float32))
    with pytest.raises(ValueError, match="unknown codec"):
        compression.decompress_array(compression.CompressedArray(c.data, c.shape, c.dtype, "lz4"))


# ---------------------------------------------------------------------------
# wire format: the same snapshot in both packages
# ---------------------------------------------------------------------------


def _snapshots(variant, seed, *, history=False, remap=False, full_rebuild=False):
    """One snapshot with the same tables, thresholds and touched rows in
    both packages: ``(reference, port)``."""
    f = fields(variant=variant, seed=seed)
    rng = np.random.default_rng(seed + 1)
    touched_u = np.unique(rng.integers(0, M, 20)).astype(np.int64)
    touched_i = np.unique(rng.integers(0, N, 30)).astype(np.int64)
    touched_y = touched_i[:5] if variant == "svdpp" else np.empty(0, np.int64)
    hist = rng.integers(0, N + 1, (M, 4)).astype(np.int32) if history else None
    user_remap = np.arange(M + 3, dtype=np.int32) if remap else None
    if remap:
        user_remap[M:] = -1
    common = dict(touched_users=touched_u, touched_items=touched_i,
                  touched_implicit_items=touched_y, user_history=hist,
                  full_rebuild=full_rebuild, events_seen=77, snapshot_id=3,
                  user_remap=user_remap, remap_epoch=2 if remap else 0)
    t_p, t_q = np.float32(0.031), np.float32(0.047)
    ref = jupdater.PublishSnapshot(params=ref_params(f), t_p=jnp.float32(t_p),
                                   t_q=jnp.float32(t_q), **common)
    port = updater.PublishSnapshot(params=port_params(f), t_p=torch.tensor(t_p),
                                   t_q=torch.tensor(t_q), **common)
    return ref, port


def _assert_same_message(got, want):
    assert list(got.tree) == list(want.tree)
    for key in want.tree:
        g, w = got.tree[key], want.tree[key]
        if hasattr(w, "codec"):
            assert (g.data, g.shape, g.dtype, g.codec) == (w.data, w.shape, w.dtype, w.codec), key
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), key
    assert got.payload_crc == want.payload_crc >= 0
    assert bus.payload_checksum(got.tree) == jbus.payload_checksum(want.tree)
    assert (got.wire_bytes, got.raw_bytes) == (want.wire_bytes, want.raw_bytes)
    for name in ("version", "prev_version", "kind", "full_rebuild", "num_users", "num_items",
                 "events_seen", "snapshot_id", "remap_epoch"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("touched_users", "touched_items", "touched_implicit_items"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("variant", ["funk", "bias", "svdpp"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("compress", [True, False])
def test_message_from_the_same_snapshot_is_the_references(variant, full, compress):
    ref, port = _snapshots(variant, seed=3, history=variant == "svdpp")
    got = make_message(port, 5, 4, full=full, compress=compress)
    want = jbus.make_message(ref, 5, 4, full=full, compress=compress)
    _assert_same_message(got, want)
    assert bus.verify_message(got)


def test_message_carries_the_remap_and_history_as_the_references():
    ref, port = _snapshots("bias", seed=4, history=True, remap=True, full_rebuild=True)
    for full in (False, True):
        _assert_same_message(make_message(port, 2, 1, full=full),
                             jbus.make_message(ref, 2, 1, full=full))


@pytest.mark.parametrize("variant", ["funk", "bias", "svdpp"])
def test_state_message_is_the_references_and_round_trips(variant):
    f = fields(variant=variant, seed=5)
    hist = np.random.default_rng(0).integers(0, N, (M, 6)).astype(np.int32)
    got = state_message(port_params(f), 0.1, torch.tensor(0.2), user_history=hist, version=7)
    want = jbus.state_message(ref_params(f), 0.1, 0.2, user_history=hist, version=7)
    _assert_same_message(got, want)
    params, t_p, t_q, history = state_from_message(got, **CPU)
    assert_params_equal(params, ref_params(f))
    assert float(t_p) == np.float32(0.1) and float(t_q) == np.float32(0.2)
    np.testing.assert_array_equal(history, hist)
    with pytest.raises(ValueError, match="kind=full"):
        state_from_message(make_message(_snapshots(variant, 5)[1], 1, 0, full=False), **CPU)


def test_a_replicas_state_is_the_references_raw_state_message():
    """A replica hands over its served state raw: the message is the
    reference's ``state_message(..., compress=False)`` of the same tables,
    key for key and byte for byte."""
    f = fields(seed=8)
    rep = LocalReplica("r0", port_params(f), 0.1, 0.2, base_version=4, engine_kwargs=CPU)
    try:
        got = rep.state_message()
    finally:
        rep.close()
    assert got.tree and all(isinstance(v, np.ndarray) for v in got.tree.values())
    _assert_same_message(got, jbus.state_message(ref_params(f), 0.1, 0.2, version=4,
                                                 compress=False))


@pytest.mark.parametrize("variant", ["funk", "bias", "svdpp"])
def test_reference_messages_fold_bitwise_in_the_port(variant):
    """The reference's own wire sequence (deltas, a full, deltas) folded by
    the port's ``apply_message`` equals the reference's fold bitwise."""
    f = fields(variant=variant, seed=6)
    rng = np.random.default_rng(6)
    hist = rng.integers(0, N, (M, 4)).astype(np.int32) if variant == "svdpp" else None
    jupd = ref_updater(ref_params(f), seed=6, user_history=hist)
    jstate = (ref_params(f), 0.0, 0.0, hist)
    pstate = (port_params(f), 0.0, 0.0, hist)
    for v in range(1, 5):
        jupd.apply(ref_batch(*events(rng)))
        jmsg = jbus.make_message(jupd.snapshot(), v, v - 1, full=v == 3)
        jstate = jbus.apply_message(*jstate, jmsg)
        pstate = apply_message(*pstate, to_port_message(jmsg))
    assert_params_equal(pstate[0], jstate[0])
    assert float(pstate[1]) == float(jstate[1]) and float(pstate[2]) == float(jstate[2])
    if hist is not None:
        np.testing.assert_array_equal(pstate[3], jstate[3])


# ---------------------------------------------------------------------------
# version gating: duplicates, out-of-order, full fast-forward
# ---------------------------------------------------------------------------


def _gate_pair():
    applied = {"port": [], "ref": []}
    return (VersionGate(lambda m: applied["port"].append(m.version)),
            jbus.VersionGate(lambda m: applied["ref"].append(m.version)), applied)


@pytest.mark.parametrize("order,full_at", [
    ([0, 0, 1, 2], ()),                       # in order, one duplicate
    ([2, 1, 0], ()),                          # out of order: buffered, then drained
    ([1, 2, 0, 1, 3], (3,)),                  # a full fast-forwards past a gap
    ([3, 0, 2, 1, 1, 3], (2,)),
])
def test_gate_admits_as_the_reference(order, full_at):
    msgs, _ = messages(4, full_at=full_at)
    port, ref, applied = _gate_pair()
    for j in order:
        assert port.offer(msgs[j]) == ref.offer(msgs[j])
    assert applied["port"] == applied["ref"]
    assert (port.version, port.applied, port.duplicates, port.buffered) == (
        ref.version, ref.applied, ref.duplicates, ref.buffered)


def test_out_of_order_and_duplicates_converge_bitwise():
    msgs, upd = messages(4, full_at=(2,))
    eng = engine(port_params(fields()))
    sink = EngineDeltaSink(eng)
    for msg in [msgs[1], msgs[0], msgs[0], msgs[3], msgs[2], msgs[1], msgs[3]]:
        sink.apply_update(msg)
    assert sink.version == 4
    assert_serves(eng, upd)
    assert_params_equal(eng.params, upd.params)


# ---------------------------------------------------------------------------
# the publisher as replication bus
# ---------------------------------------------------------------------------


def test_publisher_ships_to_subscribers_and_tracks_acks():
    rng = np.random.default_rng(2)
    params = port_params(fields())
    upd = port_updater(params, seed=2)
    engines = [engine(params) for _ in range(2)]
    pub = SnapshotPublisher(None, upd)
    for i, e in enumerate(engines):
        pub.subscribe(EngineDeltaSink(e, replica_id=f"r{i}"))
    for _ in range(3):
        upd.apply(batch(rng))
        report = pub.publish()
    assert report.acked == {"r0": 3, "r1": 3}
    assert pub.lag() == 0 and pub.version == 3 and report.kind == "delta"
    msg = make_message(upd.snapshot(), 4, 3, full=False)
    assert report.wire_bytes > 0 and report.wire_raw_bytes > 0
    assert msg.tree and all(isinstance(v, compression.CompressedArray) for v in msg.tree.values())
    for e in engines:
        assert_serves(e, upd)


def test_publisher_heals_a_lagging_subscriber_with_full():
    rng = np.random.default_rng(3)
    params = port_params(fields())
    upd = port_updater(params, seed=3)
    pub = SnapshotPublisher(None, upd, compress=False)
    first = engine(params)
    pub.subscribe(EngineDeltaSink(first, replica_id="r0"))
    upd.apply(batch(rng))
    assert pub.publish().kind == "delta"
    # a replica joins cold at version 0, having missed v1: the next publish
    # goes out kind=full so its gate can apply it
    late = engine(port_params(fields(seed=9)))
    pub.subscribe(EngineDeltaSink(late, replica_id="late"))
    assert pub.lag() == 1
    upd.apply(batch(rng))
    report = pub.publish()
    assert report.kind == "full" and report.acked == {"r0": 2, "late": 2}
    assert report.wire_bytes == report.wire_raw_bytes  # compress=False ships raw
    assert_serves(late, upd)
    assert_serves(first, upd)


def test_publisher_compresses_deltas_and_ships_full_states_raw():
    """With its default ``compress=True`` the publisher compresses a delta
    and ships a ``kind=full`` message raw; each report carries the time
    spent building its message, and both messages fold bitwise."""
    class Capture:
        replica_id = "cap"

        def __init__(self):
            self.msgs = []

        def apply_update(self, msg):
            self.msgs.append(msg)
            return msg.version

    rng = np.random.default_rng(4)
    params = port_params(fields())
    upd = port_updater(params, seed=4)
    pub = SnapshotPublisher(None, upd)
    cap = pub.subscribe(Capture())
    sink = pub.subscribe(EngineDeltaSink(engine(params), replica_id="r0"))
    upd.apply(batch(rng))
    delta = pub.publish()
    pub.acked["cap"] = 0          # a lagging subscriber: the next publish is full
    upd.apply(batch(rng))
    full = pub.publish()
    assert (delta.kind, full.kind) == ("delta", "full")
    d_msg, f_msg = cap.msgs
    assert all(isinstance(v, compression.CompressedArray) for v in d_msg.tree.values())
    assert f_msg.tree and all(isinstance(v, np.ndarray) for v in f_msg.tree.values())
    assert full.wire_bytes == full.wire_raw_bytes == f_msg.raw_bytes
    assert delta.wire_raw_bytes == d_msg.raw_bytes and delta.wire_bytes == d_msg.wire_bytes
    assert delta.encode_s > 0 and full.encode_s > 0
    assert bus.verify_message(d_msg) and bus.verify_message(f_msg)
    assert_serves(sink.engine, upd)


def test_publisher_fan_out_matches_the_references_kinds_and_acks(tmp_path):
    """The same publish schedule (a cold subscriber joining late, a delivery
    lost to a dead sink) drives the same message kinds and acks in both
    packages, and the port's delta checkpoints fold to the live tables."""
    class Sink:
        def __init__(self, rid, pkg):
            self.replica_id, self.version, self.lost = rid, 0, False
            self._gate = (bus.VersionGate if pkg == "port" else jbus.VersionGate)(
                lambda m: None)

        def apply_update(self, msg):
            if self.lost:
                return self._gate.version
            return self._gate.offer(msg)

    f = fields(seed=8)
    runs = {}
    for pkg in ("port", "ref"):
        rng = np.random.default_rng(8)
        if pkg == "port":
            upd, pub_cls, make_batch = port_updater(port_params(f), seed=8), SnapshotPublisher, (
                lambda u, i, r: EventBatch(user=u, item=i, rating=r))
        else:
            upd, pub_cls, make_batch = (ref_updater(ref_params(f), seed=8),
                                        jpublisher.SnapshotPublisher, ref_batch)
        pub = pub_cls(None, upd, checkpoint_dir=str(tmp_path / pkg), keep=8)
        a = pub.subscribe(Sink("a", pkg))
        kinds, acks = [], []
        for step in range(6):
            upd.apply(make_batch(*events(rng)))
            if step == 2:
                pub.subscribe(Sink("b", pkg))
            a.lost = step == 3
            rep = pub.publish()
            kinds.append(rep.kind)
            acks.append(dict(rep.acked))
        pub.close()
        runs[pkg] = (kinds, acks, upd)
    assert runs["port"][:2] == runs["ref"][:2]
    assert "full" in runs["port"][0]
    upd = runs["port"][2]
    folded = fold_deltas(str(tmp_path / "port"), port_params(f), 0.0, 0.0)
    assert_params_equal(folded[0], upd.params)


def test_late_join_from_a_reference_delta_chain(tmp_path):
    """A port replica bootstrapped by folding the delta chain the reference
    wrote joins the bus at the chain's last version and then follows the
    reference's live deltas, its tables bitwise the reference updater's."""
    f = fields(seed=4)
    rng = np.random.default_rng(4)
    jupd = ref_updater(ref_params(f), seed=4)
    jpub = jpublisher.SnapshotPublisher(None, jupd, checkpoint_dir=str(tmp_path), keep=8)
    for _ in range(3):
        jupd.apply(ref_batch(*events(rng)))
        jpub.publish()
    jpub.close()
    folded, f_tp, f_tq, _, last = fold_deltas(str(tmp_path), port_params(f), 0.0, 0.0)
    assert last == jpub.version == 3
    late = LocalReplica("late", folded, f_tp, f_tq, base_version=last,
                        engine_kwargs=CPU, queue_kwargs={"linger_ms": 0.5})
    try:
        captured = []

        class Capture:
            replica_id, version = "cap", 3

            def apply_update(self, msg):
                captured.append(msg)
                return msg.version

        jpub.subscribe(Capture())
        jupd.apply(ref_batch(*events(rng)))
        report = jpub.publish()
        assert report.kind == "delta"       # no heal needed: joined current
        assert late.apply_update(to_port_message(captured[0])) == 4
        assert_params_equal(late.engine.params, jupd.params)
        assert float(late.engine.t_q) == float(jupd.t_q)
    finally:
        late.close()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


class _Stub:
    """Deterministic replica for routing tests: settable depth."""

    def __init__(self, rid, depth=0):
        self.replica_id, self.version, self._depth = rid, 0, depth
        self.submitted, self.thresholds = [], None

    def submit(self, user_id, topk=10, *, timeout=None, priority=0):
        self.submitted.append(user_id)
        fut = Future()
        fut.set_result((np.zeros(topk), np.arange(topk)))
        return fut

    def apply_update(self, msg):
        self.version = msg.version
        return self.version

    def set_thresholds(self, t_p, t_q):
        self.thresholds = (t_p, t_q)
        return self.version

    def depth(self):
        return self._depth

    def stats(self):
        return {"replica_id": self.replica_id, "version": self.version}

    def close(self):
        pass


ROUTER_COUNTERS = ("routed", "affinity_hits", "affinity_cold", "affinity_spills",
                   "affinity_repins", "failovers")


@pytest.mark.parametrize("policy", ["affinity", "least", "random"])
@pytest.mark.parametrize("seed", [0, 1])
def test_router_picks_as_the_reference(policy, seed):
    """A seeded sequence of requests (users, priorities), depth changes and
    health marks: both routers pick the same replicas, counters equal."""
    stubs = {pkg: [_Stub(f"r{i}") for i in range(3)] for pkg in ("port", "ref")}
    routers = {"port": Router(stubs["port"], policy=policy, overload_slack=2, seed=seed,
                              affinity_capacity=16),
               "ref": jrouter.Router(stubs["ref"], policy=policy, overload_slack=2, seed=seed,
                                     affinity_capacity=16)}
    rng = np.random.default_rng(seed)
    for step in range(300):
        if step % 7 == 0:
            depths = rng.integers(0, 6, 3)
            for pkg in stubs:
                for s, d in zip(stubs[pkg], depths):
                    s._depth = int(d)
        if step == 120:
            for r in routers.values():
                r.mark_unhealthy(1)
        if step == 200:
            for r in routers.values():
                r.mark_healthy(1)
        user, prio = int(rng.integers(0, 24)), int(rng.random() < 0.2)
        assert routers["port"].pick(user, prio) == routers["ref"].pick(user, prio)
    for name in ROUTER_COUNTERS:
        assert getattr(routers["port"], name) == getattr(routers["ref"], name), name


def test_router_random_never_polls_depth():
    class NoDepth(_Stub):
        def depth(self):
            raise AssertionError("random policy polled depth()")

    router = Router([NoDepth("a"), NoDepth("b")], policy="random", seed=1)
    assert {router.pick(u) for u in range(64)} == {0, 1}


def test_router_rolling_update_and_threshold_rollout_ack_every_replica():
    reps = [_Stub("a"), _Stub("b"), _Stub("c")]
    router = Router(reps)
    msgs, _ = messages(1)
    assert router.apply_update(msgs[0]) == {"a": 1, "b": 1, "c": 1}
    assert router.version == 1
    assert router.apply_thresholds(0.03, 0.04) == {"a": 1, "b": 1, "c": 1}
    assert all(r.thresholds == (0.03, 0.04) for r in reps)
    stats = router.stats()
    assert stats["policy"] == "affinity" and len(stats["replicas"]) == 3
    assert set(stats) == set(jrouter.Router([_Stub("x")]).stats())
    with pytest.raises(ValueError):
        Router([])
    with pytest.raises(ValueError, match="policy"):
        Router([_Stub("a")], policy="sticky")


# ---------------------------------------------------------------------------
# copy on write: a delta never writes tables someone still reads
# ---------------------------------------------------------------------------


def test_a_delta_leaves_other_replicas_and_requests_in_flight_as_they_were():
    params = port_params(fields(seed=11))
    saved = {name: v.clone() for name, v in params._asdict().items() if v is not None}
    a = LocalReplica("a", params, 0.0, 0.0, engine_kwargs=CPU)
    b = LocalReplica("b", params, 0.0, 0.0, engine_kwargs=CPU)
    try:
        # local replicas built from one params share its tensors
        assert a.engine.params.p.data_ptr() == b.engine.params.p.data_ptr()
        users = np.arange(M)
        before = b.engine.topk(users, 5)
        in_flight = a.engine._snap          # what a batch started now holds
        before_a = a.engine.topk(users, 5)
        msgs, upd = messages(2, seed=11)
        for msg in msgs:
            assert a.apply_update(msg) == msg.version
        assert_serves(a.engine, upd)
        after = b.engine.topk(users, 5)
        np.testing.assert_array_equal(after[0], before[0])
        np.testing.assert_array_equal(after[1], before[1])
        old = a.engine._run_chunked(in_flight, users, 5)
        np.testing.assert_array_equal(old[0], before_a[0])
        np.testing.assert_array_equal(old[1], before_a[1])
        for name, v in saved.items():       # the caller's tables untouched
            assert torch.equal(getattr(params, name), v), name
        assert a.engine.params.p.data_ptr() != params.p.data_ptr()
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the fleet under load
# ---------------------------------------------------------------------------


def test_fleet_rolling_swap_under_load_zero_drops():
    rng = np.random.default_rng(5)
    params = port_params(fields(seed=5))
    upd = port_updater(params, seed=5)
    fleet = ServingFleet(params, 0.0, 0.0, replicas=2, engine_kwargs=CPU,
                         queue_kwargs={"linger_ms": 0.5})
    pub = SnapshotPublisher(None, upd)
    pub.subscribe(fleet.router)
    failures, done = [], []
    stop = threading.Event()

    def client(seed):
        crng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                fleet.submit(int(crng.integers(0, M)), 5, timeout=30.0).result(60)
                done.append(1)
            except Exception as exc:  # noqa: BLE001
                failures.append(repr(exc))

    threads = [threading.Thread(target=client, args=(100 + i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            upd.apply(batch(rng))
            pub.publish()
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    versions = [r.version for r in fleet.replicas]
    stats = fleet.stats()
    fleet.close()
    assert not failures, failures[:3]
    assert done and versions == [3, 3] == [pub.version] * 2
    assert all(r["updates_applied"] == 3 and r["apply_ms"] > 0 for r in stats["replicas"])
    for r in fleet.replicas:
        assert_serves(r.engine, upd)


def test_fleet_affinity_warms_caches():
    """Hot-user traffic on SVD++ replicas: affinity routing lands a higher
    hot-user cache hit rate than random routing."""
    m, n = 120, 600
    params = port_params(fields(m, n, variant="svdpp"))
    hist = np.random.default_rng(0).integers(0, n, (m, 4)).astype(np.int32)
    hot = np.random.default_rng(1).choice(m, 40, replace=False)
    rng = np.random.default_rng(2)
    users = np.where(rng.random(240) < 0.8, hot[rng.integers(0, len(hot), 240)],
                     rng.integers(0, m, 240))
    rates = {}
    for policy in ("affinity", "random"):
        fleet = ServingFleet(params, 0.0, 0.0, replicas=2, user_history=hist,
                             engine_kwargs={"device": "cpu", "cache_size": 24},
                             queue_kwargs={"linger_ms": 0.5},
                             router_kwargs={"policy": policy, "seed": 3})
        for u in users:
            fleet.submit(int(u), 5, timeout=60.0).result(120)
        stats = fleet.stats()
        fleet.close()
        hits = sum(r["cache_hits"] for r in stats["replicas"])
        misses = sum(r["cache_misses"] for r in stats["replicas"])
        rates[policy] = hits / max(hits + misses, 1)
    assert rates["affinity"] > rates["random"], rates


# ---------------------------------------------------------------------------
# process replicas
# ---------------------------------------------------------------------------


def test_process_fleet_on_the_cpu_replicates_and_drains(tmp_path):
    """Two spawned replicas on ``device="cpu"``: a rolling delta, requests
    before and after it, every answer bitwise a fresh engine's; then a third
    replica bootstrapped in its child from a checkpoint + delta chain."""
    rng = np.random.default_rng(6)
    m, n = 30, 200
    params = port_params(fields(m, n, seed=6))
    upd = port_updater(params, seed=6)
    online = str(tmp_path / "online")
    fleet = ServingFleet(params, 0.0, 0.0, replicas=2, backend="process", engine_kwargs=CPU,
                         queue_kwargs={"linger_ms": 1.0}, start_timeout=45.0)
    late = None
    try:
        pub = SnapshotPublisher(None, upd, checkpoint_dir=online)
        pub.subscribe(fleet.router)
        futs = [fleet.submit(int(u), 5, timeout=60.0) for u in rng.integers(0, m, 8)]
        upd.apply(batch(rng, m, n))
        report = pub.publish()
        assert report.acked == {"r0": 1, "r1": 1}
        futs += [fleet.submit(int(u), 5, timeout=60.0) for u in rng.integers(0, m, 8)]
        for f in futs:
            assert len(np.asarray(f.result(60)[1])) == 5
        pub.close()
        ref = engine(upd.params, upd.t_p, upd.t_q)
        s_ref, i_ref = ref.topk(np.arange(m), 5)
        from repro_torch.checkpoint import checkpoint as ckpt

        base = str(tmp_path / "train")
        ckpt.save(base, 1, {"params": params, "t_p": np.float32(0.0), "t_q": np.float32(0.0)})
        late = ProcessReplica("late", checkpoint=base, online_dir=online, engine_kwargs=CPU,
                              queue_kwargs={"linger_ms": 1.0}, start_timeout=45.0)
        assert late.version == 1 and late.boot["engine_ms"] > 0
        for r in list(fleet.replicas) + [late]:
            rows = [r.submit(u, 5, timeout=60.0) for u in range(m)]
            got = [f.result(60) for f in rows]
            np.testing.assert_array_equal(np.stack([g[0] for g in got]), s_ref)
            np.testing.assert_array_equal(np.stack([g[1] for g in got]), i_ref)
            stats = r.stats()
            assert stats["version"] == 1 and stats["pruned_topk_launches"] == 0  # CPU: none
    finally:
        fleet.close()
        if late is not None:
            late.close()
    assert all(not r.alive for r in fleet.replicas)


@pytest.mark.parametrize("fail_at", [None, 1])
def test_process_fleet_boots_its_replicas_together_from_a_raw_state(monkeypatch, fail_at):
    """A process fleet builds one raw ``kind=full`` boot message and starts
    every replica from it at once; when one fails to come up, the fleet
    closes the ones that did and raises that error."""
    from repro_torch.serving.fleet import router as router_mod

    started, closed = [], []
    both_started = threading.Barrier(2, timeout=10)

    class FakeProcessReplica:
        def __init__(self, replica_id, *, init_msg, **kwargs):
            self.replica_id, self.init_msg, self.kwargs = replica_id, init_msg, kwargs
            started.append(replica_id)
            both_started.wait()   # the second start does not wait for the first
            if fail_at is not None and replica_id == f"r{fail_at}":
                raise RuntimeError(f"replica {replica_id} failed to start: boom")

        def close(self):
            closed.append(self.replica_id)

    monkeypatch.setattr(router_mod, "ProcessReplica", FakeProcessReplica)
    f = fields(seed=13)
    kwargs = dict(replicas=2, backend="process", engine_kwargs=CPU, start_timeout=7.0)
    if fail_at is not None:
        with pytest.raises(RuntimeError, match="r1 failed to start: boom"):
            ServingFleet(port_params(f), 0.1, 0.2, **kwargs)
        assert sorted(started) == ["r0", "r1"] and closed == ["r0"]
        return
    fleet = ServingFleet(port_params(f), 0.1, 0.2, **kwargs)
    assert [r.replica_id for r in fleet.replicas] == ["r0", "r1"]
    boot = fleet.replicas[0].init_msg
    assert all(r.init_msg is boot for r in fleet.replicas)
    assert all(r.kwargs["start_timeout"] == 7.0 for r in fleet.replicas)
    _assert_same_message(boot, jbus.state_message(ref_params(f), 0.1, 0.2, compress=False))
    assert set(fleet.boot_ms) == {"message", "start"}
    fleet.close()
    assert sorted(closed) == ["r0", "r1"]


def test_process_replica_refuses_a_missing_card():
    """The child resolves its device from ``engine_kwargs``: without a card
    and without ``"cpu"`` it reports the error and exits, and the
    constructor raises; it never serves on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the child would serve on it")
    msg = state_message(port_params(fields(seed=1)), 0.0, 0.0)
    with pytest.raises(RuntimeError, match="failed to start: .*no CUDA device"):
        ProcessReplica("nocard", init_msg=msg, start_timeout=45.0)


@pytest.mark.parametrize("compress", [True, False])
def test_large_payload_leaves_cross_the_pipe_through_files_bitwise(tmp_path, compress):
    """A process replica's transport writes payload leaves of SPILL_BYTES
    or more to files and reads them back: the message is bitwise the one
    sent (its CRC verifies) and the files are gone."""
    from repro_torch.serving.fleet import replica

    f = fields(5000, 6000, 64, seed=12)
    msg = state_message(port_params(f), 0.1, 0.2, version=3, compress=compress)
    assert max(v.nbytes for v in msg.tree.values()) >= replica.SPILL_BYTES
    spilled = replica._spill(msg, str(tmp_path))
    assert any(isinstance(v, replica._Spilled) for v in spilled.tree.values())
    assert len(list(tmp_path.iterdir())) == sum(
        isinstance(v, replica._Spilled) for v in spilled.tree.values())
    back = replica._unspill(spilled)
    assert not list(tmp_path.iterdir()) and bus.verify_message(back)
    assert back.payload_crc == msg.payload_crc and list(back.tree) == list(msg.tree)
    assert_params_equal(state_from_message(back, **CPU)[0], port_params(f))
    assert replica._unspill(msg) is msg and replica._spill(None, str(tmp_path)) is None
