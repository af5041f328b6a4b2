"""Smoke of the port's fleet fault tolerance, on the card (or the CPU with
``--device cpu``).

Two gates over ONE two-process fleet, each fatal on failure:

1. **scripted kill under load**: concurrent traffic while a seeded
   :class:`FaultPlan` SIGKILLs replica r0 at its Nth submit; the
   supervisor must detect the death, respawn the child from a healthy
   peer's ``kind=full`` state, and readmit it after convergence.
   Asserted: zero dropped/stranded requests (the router's failover
   absorbs the death) and MTTR under budget.
2. **corrupt delta -> heal -> bitwise convergence**: live replication
   with one delivery corrupted on the wire: the child's CRC check NAKs
   it (stale ack), the publisher's lag check forces a ``kind=full``
   heal, and every replica's full served state must end bitwise equal
   to a fault-free in-process shadow fed the same messages.

Usage:  PYTHONPATH=src python tools/torch_chaos_smoke.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import mf  # noqa: E402
from repro_torch.device import device_name  # noqa: E402
from repro_torch.online import OnlineUpdater, PoissonSource, SnapshotPublisher, \
    iter_microbatches  # noqa: E402
from repro_torch.serving.fleet import FleetSupervisor, ServingFleet, bus  # noqa: E402
from repro_torch.serving.fleet.replica import LocalReplica  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.testing.faults import FaultAction, FaultPlan  # noqa: E402

MTTR_BUDGET_S = 150.0  # respawn = process spawn + torch import: generous
M, N, K = 300, 2000, 8
N_REQUESTS, KILL_AT = 400, 20


def _drive(frontend, users, topk=5, clients=4, timeout=120.0):
    failures = []

    def one(u):
        try:
            frontend.submit(int(u), topk, timeout=timeout).result(timeout)
        except Exception as exc:  # noqa: BLE001 - any failure is a drop
            failures.append(repr(exc))

    with ThreadPoolExecutor(max_workers=clients) as pool:
        list(pool.map(one, users))
    return failures


def _leaves(params):
    return [t.cpu() for t in params if t is not None]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    rng = np.random.default_rng(0)
    params = mf.init_params(torch.Generator(device=args.device).manual_seed(0), M, N, K,
                            variant="bias", global_mean=3.5, device=args.device)
    engine_kwargs = {"device": args.device}
    print(f"[0/2] spawning 2-process fleet on {device_name(args.device)}")
    fleet = ServingFleet(params, 0.0, 0.0, replicas=2, backend="process",
                         engine_kwargs=engine_kwargs, queue_kwargs={"linger_ms": 1.0})
    shadow = LocalReplica("shadow", params, 0.0, 0.0, engine_kwargs=engine_kwargs)
    supervisor = FleetSupervisor(
        fleet.router, probe_interval_s=0.05, ping_timeout_s=5.0, dead_after=2,
    )
    supervisor.start()
    try:
        # ---- gate 1: scripted SIGKILL under load -------------------------
        print(f"[1/2] kill r0 at submit #{KILL_AT} under "
              f"{N_REQUESTS}-request load")
        plan = FaultPlan([FaultAction(site="replica.submit", op="kill",
                                      at=KILL_AT, target="r0")])
        users = rng.integers(0, M, N_REQUESTS)
        with faults.installed(plan):
            failures = _drive(fleet, users)
            deadline = time.monotonic() + MTTR_BUDGET_S + 30.0
            while time.monotonic() < deadline:
                rep = supervisor.report()
                if rep["deaths"] and rep["recovered"] == rep["deaths"]:
                    break
                time.sleep(0.2)
        rep = supervisor.report()
        assert plan.pending == 0, "the scheduled kill never fired"
        assert not failures, f"dropped requests: {failures[:3]}"
        assert rep["deaths"] >= 1, "supervisor never detected the kill"
        assert rep["recovered"] == rep["deaths"], f"unrecovered: {rep}"
        assert rep["mttr_max_s"] < MTTR_BUDGET_S, (
            f"MTTR {rep['mttr_max_s']:.1f}s over budget {MTTR_BUDGET_S}s"
        )
        print(f"  zero drops; death detected+respawned, "
              f"MTTR {rep['mttr_max_s']:.2f}s")

        # ---- gate 2: corrupt delta -> NAK -> full heal -> bitwise --------
        print("[2/2] corrupt one delta to r1, demand bitwise heal")
        upd = OnlineUpdater(params, None, 0.0, 0.0, batch_size=128, seed=7,
                            device=args.device)
        pub = SnapshotPublisher(None, upd, compress=True)
        pub.subscribe(fleet.router)
        pub.subscribe(shadow)  # fault-free reference, same messages
        plan = FaultPlan([FaultAction(site="bus.deliver", op="corrupt",
                                      at=1, target="r1")])
        src = PoissonSource(M, N, rate=1e4, seed=7)
        swaps = []
        with faults.installed(plan):
            for batch in iter_microbatches(src, 128, max_events=128 * 3):
                upd.apply(batch)
                swaps.append(pub.publish())
        # clean publish after the faults: the corrupt NAK left r1's ack
        # stale, so the publisher has forced a kind=full heal by now
        upd.apply(next(iter_microbatches(
            PoissonSource(M, N, rate=1e4, seed=8), 128, max_events=128)))
        swaps.append(pub.publish())
        assert plan.pending == 0, "the scheduled corruption never fired"
        heals = sum(1 for s in swaps if s.kind == "full")
        assert heals >= 1, "corrupt NAK never forced a kind=full heal"
        versions = [r.version for r in fleet.replicas] + [shadow.version]
        assert all(v == pub.version for v in versions), (
            f"fleet diverged after heal: {versions} != v{pub.version}"
        )
        want = _leaves(shadow.engine.params)
        for r in fleet.replicas:
            got = _leaves(bus.state_from_message(r.state_message(), device="cpu")[0])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (
                    f"{r.replica_id} not bitwise-equal to fault-free shadow"
                )
        print(f"  corrupt delta NAKed, healed kind=full, "
              f"fleet bitwise-convergent at v{pub.version}")
        print("chaos-smoke: all gates passed")
        return {"mttr_s": rep["mttr_max_s"], "deaths": rep["deaths"], "heals": heals,
                "version": pub.version, "requests": N_REQUESTS}
    finally:
        supervisor.stop()
        fleet.close()
        shadow.close()


if __name__ == "__main__":
    main()
