"""The port's fleet fault handling held against the JAX reference on the
CPU: ``corrupt_message`` (the reference's byte flipped), the sink's NAK and
``kind=full`` heal, replica death at submit and in flight, failover routing,
the ``bus.deliver`` seam, the supervisor's ladder, respawn, budget and
no-respawn mode, a seeded adversarial schedule (the reference's draws)
converging bitwise, and a process replica's death.

Tolerances: none.  Corrupted payloads are byte-identical to the
reference's; acks, routing decisions and fault logs are equal; every
convergence check is bitwise against a fresh port engine on the updater's
state.
"""
import dataclasses
import time
from concurrent.futures import Future

import numpy as np
import pytest

from repro.online import publisher as jpublisher
from repro.serving.fleet import bus as jbus
from repro.serving.fleet.replica import ReplicaDiedError as JReplicaDiedError
from repro.serving.fleet import router as jrouter
from repro.serving.fleet import supervisor as jsupervisor
from repro.testing import faults as jfaults
from repro_torch.online import EventBatch, SnapshotPublisher
from repro_torch.serving.fleet import (
    EngineDeltaSink,
    FleetSupervisor,
    LocalReplica,
    NoHealthyReplicaError,
    ProcessReplica,
    ReplicaDiedError,
    ReplicaState,
    Router,
    ServingFleet,
    bus,
    make_message,
    payload_checksum,
    state_message,
    verify_message,
)
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultAction, FaultPlan
from tests.fleet_parity import (
    CPU,
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
)
from tests.test_torch_fleet import _snapshots

LOCAL = {"engine_kwargs": CPU, "queue_kwargs": {"linger_ms": 0.5}}


def _local(rid, params=None, **kw):
    return LocalReplica(rid, port_params(fields()) if params is None else params, 0.0, 0.0,
                        **{**LOCAL, **kw})


# ---------------------------------------------------------------------------
# corrupt_message and the payload CRC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["funk", "bias", "svdpp"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("compress", [True, False])
def test_corrupt_message_flips_the_references_byte(variant, full, compress):
    ref, port = _snapshots(variant, seed=7, history=variant == "svdpp")
    good = make_message(port, 3, 2, full=full, compress=compress)
    jgood = jbus.make_message(ref, 3, 2, full=full, compress=compress)
    bad, jbad = faults.corrupt_message(good), jfaults.corrupt_message(jgood)
    assert list(bad.tree) == list(jbad.tree)
    changed = [k for k in bad.tree if payload_checksum({k: bad.tree[k]})
               != payload_checksum({k: good.tree[k]})]
    assert len(changed) == 1
    for key in bad.tree:
        g, w = bad.tree[key], jbad.tree[key]
        got = g.data if hasattr(g, "codec") else np.asarray(g).tobytes()
        want = w.data if hasattr(w, "codec") else np.asarray(w).tobytes()
        assert got == want, key
    assert verify_message(good) and not verify_message(bad)
    assert not jbus.verify_message(jbad)
    assert bad.payload_crc == good.payload_crc == jbad.payload_crc


def test_checksum_covers_every_leaf_and_legacy_messages_pass():
    msgs, upd = messages(1, full_at=(1,))
    tree = dict(msgs[0].tree)
    base = payload_checksum(tree)
    tree.pop(sorted(tree)[0])
    assert payload_checksum(tree) != base
    assert verify_message(dataclasses.replace(faults.corrupt_message(msgs[0]), payload_crc=-1))
    for compress in (True, False):
        full = state_message(upd.params, upd.t_p, upd.t_q, version=3, compress=compress)
        assert full.payload_crc >= 0 and verify_message(full)


def test_sink_naks_a_corrupt_delta_then_heals_bitwise():
    msgs, upd = messages(3)
    eng = engine(port_params(fields()))
    sink = EngineDeltaSink(eng, replica_id="r0")
    assert sink.apply_update(msgs[0]) == 1
    # a corrupted v2: NAK, the ack stays at 1 and nothing was folded
    assert sink.apply_update(faults.corrupt_message(msgs[1])) == 1
    assert sink.corrupt_dropped == 1
    assert sink.apply_update(msgs[2]) < 3   # v3 with a gap: still behind
    heal = state_message(upd.params, upd.t_p, upd.t_q, version=3)
    assert sink.apply_update(heal) == 3     # a full always lands
    assert_params_equal(eng.params, upd.params)
    assert_serves(eng, upd)


# ---------------------------------------------------------------------------
# replica death and failover routing
# ---------------------------------------------------------------------------


def test_local_replica_kill_fails_pending_and_raises_fast():
    rep = _local("r0", queue_kwargs={"linger_ms": 200.0, "max_batch": 64})
    futs = [rep.submit(u, 5, timeout=30.0) for u in range(4)]
    rep.kill()
    for fut in futs:
        with pytest.raises(ReplicaDiedError):
            fut.result(timeout=10.0)
    assert not rep.alive and not rep.ping()
    with pytest.raises(ReplicaDiedError):
        rep.submit(1, 5)
    with pytest.raises(ReplicaDiedError):
        rep.apply_update(messages(1)[0][0])


def test_kill_seam_fires_inside_submit():
    rep = _local("r0")
    plan = FaultPlan([FaultAction(site="replica.submit", op="kill", at=1, target="r0")])
    with faults.installed(plan):
        rep.submit(0, 5, timeout=10.0).result(10.0)
        with pytest.raises(ReplicaDiedError):
            rep.submit(1, 5)                   # the killing submit raises
    assert not rep.alive and plan.pending == 0 and faults._PLAN is None


def test_router_fails_over_at_submit_without_losing_a_request():
    params = port_params(fields())
    reps = [_local(f"r{i}", params) for i in range(2)]
    router = Router(reps)
    plan = FaultPlan([FaultAction(site="replica.submit", op="kill", at=3, target="r0")])
    with faults.installed(plan):
        futs = [router.submit(u % 40, 5, timeout=30.0) for u in range(64)]
        for fut in futs:
            assert len(np.asarray(fut.result(timeout=30.0)[1])) == 5
    assert plan.pending == 0 and router.failovers >= 1
    assert not router.is_healthy(0) and router.is_healthy(1)
    router.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_router_fails_over_a_request_that_dies_in_flight(pkg):
    """A replica dying after it accepted the request: the relay resubmits
    elsewhere, in both packages the same way."""
    died = ReplicaDiedError if pkg == "port" else JReplicaDiedError
    router_cls = Router if pkg == "port" else jrouter.Router

    class Pending:
        replica_id, version = "p", 0

        def __init__(self):
            self.inner = Future()

        def submit(self, *a, **k):
            return self.inner

        def depth(self):
            return 0

    class Healthy:
        replica_id, version = "h", 0

        def submit(self, user_id, topk=10, **k):
            fut = Future()
            fut.set_result((np.zeros(topk), np.arange(topk)))
            return fut

        def depth(self):
            return 1

    pending = Pending()
    router = router_cls([pending, Healthy()], policy="least")
    outer = router.submit(7, topk=5)
    assert not outer.done()
    pending.inner.set_exception(died("mid-flight death"))
    assert len(np.asarray(outer.result(timeout=10.0)[1])) == 5
    assert router.failovers == 1 and not router.is_healthy(0)


def test_router_repins_a_dead_replicas_users_and_fails_when_all_are_dead():
    params = port_params(fields())
    reps = [_local(f"r{i}", params) for i in range(2)]
    router = Router(reps)
    pinned = router.pick(7)
    assert router.pick(7) == pinned
    router.mark_unhealthy(pinned)
    repinned = router.pick(7)
    assert repinned != pinned and router.affinity_repins == 1 and router.pick(7) == repinned
    router.mark_unhealthy(repinned)
    with pytest.raises(NoHealthyReplicaError):
        router.submit(1, 5).result(timeout=10.0)
    router.close()


def test_router_skips_unhealthy_on_update_thresholds_and_stats():
    msgs, _ = messages(1)
    params = port_params(fields())
    reps = [_local(f"r{i}", params) for i in range(2)]
    router = Router(reps)
    router.mark_unhealthy(0)
    assert router.apply_update(msgs[0]) == {"r1": 1}
    assert list(router.apply_thresholds(0.01, 0.02)) == ["r1"]
    by_id = {r["replica_id"]: r for r in router.stats()["replicas"]}
    assert by_id["r0"] == {"replica_id": "r0", "healthy": False}
    assert by_id["r1"]["healthy"] and by_id["r1"]["version"] == 1
    assert router.version == 1
    router.close()


def test_router_marks_a_replica_dead_on_rollout_and_the_publisher_heals():
    params = port_params(fields())
    rng = np.random.default_rng(3)
    upd = port_updater(params, seed=3)
    reps = [_local(f"r{i}", params) for i in range(2)]
    router = Router(reps)
    pub = SnapshotPublisher(None, upd)
    pub.subscribe(router)
    upd.apply(batch(rng))
    pub.publish()
    reps[0].kill()
    upd.apply(batch(rng))
    pub.publish()                              # r0 dies mid-rollout: skipped
    assert not router.is_healthy(0) and pub.lag() >= 1
    fresh = _local("r0", params)
    router.replace_replica(0, fresh)
    upd.apply(batch(rng))
    assert pub.publish().kind == "full"
    assert all(rep.version == pub.version for rep in router.replicas)
    assert_serves(fresh.engine, upd)
    for rep in router.replicas:
        rep.close()


class _GateSink:
    """A replica reduced to its admission: CRC check, then the gate."""

    def __init__(self, rid, gate_cls, verify):
        self.replica_id, self._verify = rid, verify
        self._gate = gate_cls(lambda m: None)

    @property
    def version(self):
        return self._gate.version

    def apply_update(self, msg):
        return self._gate.offer(msg) if self._verify(msg) else self._gate.version

    def depth(self):
        return 0


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_deliver_seam_drops_dups_and_corrupts_as_the_reference(seed):
    """The same seeded ``bus.deliver`` schedule over the same publish
    sequence gives the same acks, message kinds and fault log in both
    packages (routers, publishers and gated sinks of each)."""
    sites = [("bus.deliver", ["r0", "r1"], ["drop", "dup", "corrupt"])]
    f = fields(seed=seed)
    out = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            fmod, upd, pub_cls, router_cls = faults, port_updater(port_params(f), seed=seed), \
                SnapshotPublisher, Router
            sinks = [_GateSink(f"r{i}", bus.VersionGate, verify_message) for i in range(2)]
        else:
            fmod, upd, pub_cls, router_cls = jfaults, ref_updater(ref_params(f), seed=seed), \
                jpublisher.SnapshotPublisher, jrouter.Router
            sinks = [_GateSink(f"r{i}", jbus.VersionGate, jbus.verify_message)
                     for i in range(2)]

        plan = fmod.FaultPlan.from_seed(seed, sites=sites, n_actions=6, horizon=6)
        pub = pub_cls(None, upd)
        pub.subscribe(router_cls(sinks))
        rng = np.random.default_rng(seed)
        log = []
        with fmod.installed(plan):
            for _ in range(8):
                u, i, r = events(rng)
                upd.apply(EventBatch(user=u, item=i, rating=r) if pkg == "port"
                          else ref_batch(u, i, r))
                rep = pub.publish()
                log.append((rep.kind, dict(rep.acked)))
        out[pkg] = (log, plan.fired, [s.version for s in sinks])
    assert out["port"] == out["ref"]
    assert out["port"][1]                     # the schedule really fired


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


def test_supervisor_detects_a_kill_respawns_and_readmits():
    msgs, upd = messages(2)
    fleet = ServingFleet(port_params(fields()), 0.0, 0.0, replicas=2, **LOCAL)
    fleet.apply_update(msgs[0])
    fleet.apply_update(msgs[1])
    sup = FleetSupervisor(fleet.router, dead_after=1)
    old = fleet.replicas[0]
    old.kill()
    sup.poll_once()                            # hard evidence: at once
    assert sup.states[0] is ReplicaState.HEALTHY
    replacement = fleet.replicas[0]
    assert replacement is not old and replacement.version == 2
    assert replacement.engine.device.type == "cpu"   # built like the one it replaced
    assert fleet.router.is_healthy(0)
    rep = sup.report()
    assert rep["deaths"] == 1 and rep["recovered"] == 1
    assert rep["incidents"][0]["mttr_s"] is not None
    assert set(rep) == set(jsupervisor.FleetSupervisor(jrouter.Router([_GateSink(
        "x", jbus.VersionGate, jbus.verify_message)])).report())
    assert len(np.asarray(fleet.submit(3, 5, timeout=10.0).result(10.0)[1])) == 5
    fleet.apply_update(state_message(upd.params, upd.t_p, upd.t_q, version=3))
    assert all(r.version == 3 for r in fleet.replicas)
    assert_serves(replacement.engine, upd)
    fleet.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_supervisor_suspect_ladder_needs_consecutive_misses(pkg):
    class Flaky:
        replica_id, version, alive = "f", 0, True

        def __init__(self):
            self.pings = []

        def ping(self, timeout=5.0):
            return self.pings.pop(0) if self.pings else True

        def depth(self):
            return 0

    flaky = Flaky()
    router = (Router if pkg == "port" else jrouter.Router)([flaky, Flaky()])
    sup_cls = FleetSupervisor if pkg == "port" else jsupervisor.FleetSupervisor
    sup = sup_cls(router, dead_after=2, respawn=False)
    flaky.pings = [False, True, False, False]
    states = []
    for _ in range(4):
        sup.poll_once()
        states.append((sup.states[0].value, router.is_healthy(0)))
    assert states == [("suspect", True), ("healthy", True), ("suspect", True), ("dead", False)]
    assert sup.report()["deaths"] == 1


def test_supervisor_respawn_budget_brakes_a_crash_loop():
    router = Router([_local("r0"), _local("r1")])
    sup = FleetSupervisor(router, dead_after=1, max_respawns=2)
    for _ in range(4):
        router.replicas[0].kill()
        sup.poll_once()
    assert sup.report()["respawns"] == 2
    assert sup.states[0] is ReplicaState.DEAD and not router.is_healthy(0)
    router.close()


def test_supervisor_without_respawn_only_fences():
    rep0 = _local("r0")
    router = Router([rep0, _local("r1")])
    sup = FleetSupervisor(router, dead_after=1, respawn=False)
    rep0.kill()
    sup.poll_once()
    assert sup.states[0] is ReplicaState.DEAD and not router.is_healthy(0)
    assert router.replicas[0] is rep0
    assert len(np.asarray(router.submit(1, 5, timeout=10.0).result(10.0)[1])) == 5
    router.close()


def test_supervisor_thread_recovers_a_kill_and_heals_from_a_state_provider():
    msgs, upd = messages(2)
    fleet = ServingFleet(port_params(fields()), 0.0, 0.0, replicas=2, **LOCAL)
    fleet.apply_update(msgs[0])
    fleet.apply_update(msgs[1])
    calls = []

    def provider():
        calls.append(1)
        return state_message(upd.params, upd.t_p, upd.t_q, version=2)

    sup = fleet.supervise(probe_interval_s=0.01, dead_after=1, state_provider=provider)
    fleet.replicas[1].kill()
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        r = sup.report()
        if r["deaths"] and r["recovered"] == r["deaths"]:
            break
        time.sleep(0.01)
    sup.stop()
    r = sup.report()
    assert r["deaths"] >= 1 and r["recovered"] == r["deaths"] and r["mttr_max_s"] is not None
    assert calls and fleet.router.is_healthy(1) and fleet.replicas[1].version == 2
    assert_params_equal(fleet.replicas[1].engine.params, upd.params)
    fleet.close()


# ---------------------------------------------------------------------------
# a seeded adversarial schedule converges bitwise
# ---------------------------------------------------------------------------

ADVERSARY = [("bus.deliver", ["r0", "r1"], ["drop", "dup", "corrupt", "delay"]),
             ("replica.submit", ["r0"], ["kill"])]


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 8, 13])
def test_fleet_converges_bitwise_under_a_seeded_schedule(seed):
    """Drops, duplicates, corruptions, delays and kills drawn by
    ``FaultPlan.from_seed`` (the reference's schedule for the seed) hit a
    supervised fleet while it serves and replicates: no request fails, and
    once the plan is spent and a publish has gone out every replica serves
    the updater's state bitwise."""
    plan = FaultPlan.from_seed(seed, sites=ADVERSARY, n_actions=8, horizon=6)
    want = jfaults.FaultPlan.from_seed(seed, sites=ADVERSARY, n_actions=8, horizon=6)
    assert [dataclasses.astuple(a) for a in plan._actions] == [
        dataclasses.astuple(a) for a in want._actions]
    rng = np.random.default_rng(seed)
    params = port_params(fields(seed=seed))
    upd = port_updater(params, seed=seed)
    fleet = ServingFleet(params, 0.0, 0.0, replicas=2, **LOCAL)
    pub = SnapshotPublisher(None, upd)
    pub.subscribe(fleet.router)
    # a respawn budget above the plan's kills: no slot is left fenced
    sup = FleetSupervisor(fleet.router, dead_after=1, max_respawns=len(plan._actions) + 1)
    try:
        with faults.installed(plan):
            for _ in range(6):
                upd.apply(batch(rng))
                pub.publish()
                for u in rng.integers(0, 40, 3):
                    got = fleet.submit(int(u), 5, timeout=30.0).result(30.0)
                    assert len(np.asarray(got[1])) == 5
                    sup.poll_once()
        assert plan.fired
        upd.apply(batch(rng))
        pub.publish()                          # heals any replica behind
        sup.poll_once()
        assert [r.version for r in fleet.replicas] == [pub.version] * 2
        assert all(fleet.router.is_healthy(i) for i in range(2))
        for rep in fleet.replicas:
            assert_serves(rep.engine, upd)
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# a process replica's death
# ---------------------------------------------------------------------------


def test_process_replica_death_fails_pending_futures_fast():
    boot = state_message(port_params(fields()), 0.0, 0.0, version=0)
    rep = ProcessReplica("victim", init_msg=boot, engine_kwargs=CPU,
                         queue_kwargs={"linger_ms": 200.0, "max_batch": 64},
                         start_timeout=45.0)
    try:
        assert rep.alive and rep.ping(timeout=10.0)
        futs = [rep.submit(u, 5, timeout=60.0) for u in range(8)]
        rep.kill()
        t0 = time.monotonic()
        for fut in futs:
            with pytest.raises(ReplicaDiedError):
                fut.result(timeout=30.0)
        assert time.monotonic() - t0 < 20.0
        deadline = time.monotonic() + 10.0
        while rep.alive and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not rep.alive and rep.exitcode not in (None, 0)
        assert rep.ping(timeout=2.0) is False
        with pytest.raises(ReplicaDiedError):
            rep.submit(1, 5)
        with pytest.raises(ReplicaDiedError):
            rep.apply_update(messages(1)[0][0])
    finally:
        rep.close(timeout=10.0)
