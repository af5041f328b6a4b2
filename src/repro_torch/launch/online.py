"""Online serving launcher of the port: train -> stream -> serve, in one
process.

    PYTHONPATH=src python -m repro_torch.launch.online --dataset movielens100k \
        --scale 0.05 --train-epochs 3 --events 500 --swap-every 3 --clients 4

Runs on ``cuda`` (the hand-written kernels) unless ``--device cpu`` selects
the plain PyTorch path.  The freshness loop:

1. train a DP-MF model (or resume from ``--ckpt``) on a train split;
2. start the serving engine and its async request queue, and send it
   requests from ``--clients`` threads for the whole run;
3. stream held-out (or synthetic Poisson) events through the
   :class:`~repro_torch.online.updater.OnlineUpdater`: pruned row updates
   only, each batch scored prequentially (test-then-learn) before it is
   applied;
4. every ``--swap-every`` micro-batches, hot-swap the new factor version
   into the live engine and write an async delta checkpoint.

``--evict-max-users N`` bounds the user table: past N rows the coldest
rows spill to disk (under ``--ckpt``/spill, or a temporary directory that
is removed at exit) down to ``--evict-target-users`` (default 80% of N) at
each publish point; spilled users keep getting answers through the engine's
bias-only fallback, and an event naming one revives its row.

The exit status is non-zero if any request failed or was dropped.  A JSON
report (throughput, swap latency, serving percentiles, work fraction,
prequential MAE/RMSE, MAE before and after) goes to stdout and, with
``--json``, to a file.

``--slo-p99-ms BUDGET`` arms the SLO-aware degradation loop
(:mod:`repro_torch.serving.slo`): the controller ticks inside the update
loop, adapts the pruning thresholds to hold serving p99 under the budget
(pinning them through publishes), relaxes when the prequential drift hook
reports quality pressure, and the run exits non-zero if the steady-state
p99 still violates the budget.

With ``--replicas N`` (N > 1) the serving side becomes a fleet
(``repro_torch.serving.fleet``): N replica engines (``--replica-backend
local`` in this process, ``process`` as spawned children) behind the
cache-aware router, subscribed to the publisher's replication bus; every
publish ships a compressed versioned delta and applies it rolling, one
replica at a time, while the clients keep sending requests to the router.
``--supervise`` adds a :class:`~repro_torch.serving.fleet.FleetSupervisor`
(heartbeats, failover, respawn).  The same exit rule holds, and every
replica must have converged to the published version.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import threading
import time

import numpy as np

from repro_torch.core.trainer import DPMFTrainer, TrainConfig
from repro_torch.data.ratings import paper_dataset, train_test_split
from repro_torch.eval import PrequentialEvaluator, recalibration_hook
from repro_torch.online import (
    OnlineUpdater,
    PoissonSource,
    ReplaySource,
    SnapshotPublisher,
    iter_microbatches,
)
from repro_torch.serving import LatencyWindow, ServingEngine, SLOConfig, SLOController
from repro_torch.store import EvictionConfig, UserEvictor


def run_online(args) -> dict:
    if args.use_kernel and args.device == "cpu":
        raise SystemExit("--use-kernel with --device cpu is not supported by the port's "
                         "online launcher (the kernel runs on the card)")
    spill_tmp = None if args.ckpt or args.evict_max_users <= 0 else tempfile.mkdtemp(
        prefix="dpmf_spill_")
    try:
        return _run_online(args, spill_tmp)
    finally:
        if spill_tmp is not None:
            shutil.rmtree(spill_tmp, ignore_errors=True)


def _run_online(args, spill_tmp) -> dict:
    ds = paper_dataset(args.dataset, seed=args.seed, scale=args.scale)
    rest, test_ds = train_test_split(ds, 0.15, seed=args.seed)
    train_ds, stream_ds = train_test_split(rest, 0.25, seed=args.seed + 1)

    config = TrainConfig(
        k=args.k, epochs=args.train_epochs, batch_size=args.batch_size, lr=args.lr,
        pruning_rate=args.pruning_rate, variant=args.variant, seed=args.seed,
        checkpoint_dir=args.ckpt,
    )
    trainer = DPMFTrainer(config, train_ds, test_ds, device=args.device)
    if trainer.maybe_restore():
        print(f"# resumed training checkpoint at epoch {trainer.epoch}")
    trainer.run()
    mae_before = trainer.evaluate()
    print(f"# trained on {trainer.device}: MAE {mae_before:.4f}, t_q {float(trainer.t_q):.4f}")

    # the updater writes copies of the trainer's tables (copy on write), so
    # the engine's version 0 and the trainer stay as they are
    updater = OnlineUpdater.from_trainer(trainer, batch_size=max(args.batch_events, 64))
    evictor = None
    if args.evict_max_users > 0:
        # a bounded user table: cold rows spill to disk and the table
        # compacts at publish points
        spill_dir = args.ckpt + "/spill" if args.ckpt else spill_tmp
        evictor = UserEvictor(EvictionConfig(
            max_users=args.evict_max_users, spill_dir=spill_dir,
            target_users=args.evict_target_users or None))
        updater.attach_evictor(evictor)
        print(f"# eviction armed: max {args.evict_max_users} rows, target "
              f"{evictor.config.resolved_target()}, spill {spill_dir}")
    engine_kwargs = dict(device=args.device, block_n=args.block_n)
    fleet = supervisor = engine = None
    if args.replicas > 1:
        from repro_torch.serving.fleet import ServingFleet

        fleet = ServingFleet(
            trainer.params, trainer.t_p, trainer.t_q, replicas=args.replicas,
            backend=args.replica_backend, user_history=trainer.hist,
            engine_kwargs=engine_kwargs, queue_kwargs={"linger_ms": 1.0},
            router_kwargs={"policy": args.routing},
        )
        frontend = fleet
        print(f"# fleet: {args.replicas} {args.replica_backend} replicas on {args.device}, "
              f"routing={args.routing}")
        if args.supervise:
            supervisor = fleet.supervise(
                probe_interval_s=0.5, checkpoint=args.ckpt or None,
                online_dir=(args.ckpt + "/online") if args.ckpt else None)
            print("# supervisor armed: probe 0.5s, respawn on")
    else:
        engine = ServingEngine(trainer.params, trainer.t_p, trainer.t_q,
                               user_history=trainer.hist, **engine_kwargs)
        frontend = engine
    publisher = SnapshotPublisher(
        engine, updater, checkpoint_dir=(args.ckpt + "/online") if args.ckpt else None)
    if fleet is not None:
        publisher.subscribe(fleet.router)

    if args.source == "replay":
        source = ReplaySource(stream_ds, epochs=None, shuffle=True, seed=args.seed)
    else:
        source = PoissonSource(
            updater.num_users, updater.num_items, rate=1000.0, seed=args.seed,
            new_user_prob=args.new_id_prob, new_item_prob=args.new_id_prob,
            rating_min=ds.rating_min, rating_max=ds.rating_max,
        )

    queue = None
    if engine is not None:
        # warm the power-of-two buckets queue batches can land in, so the
        # first requests in flight measure serving, not first-call set-up
        warm_users = np.arange(min(engine.num_users, 8), dtype=np.int32)
        for b in (1, 2, 4, 8):
            if b <= len(warm_users):
                engine.topk(warm_users[:b], args.topk)
        queue = engine.start(linger_ms=1.0)

    # ---- SLO-aware degradation loop (off unless --slo-p99-ms > 0) ---------
    controller = None
    if args.slo_p99_ms > 0:
        slo_config = SLOConfig(p99_budget_ms=args.slo_p99_ms, max_rate=args.slo_max_rate)
        if engine is not None:
            # the queue supplies every load signal: latency, depth, expiry
            controller = SLOController(engine, config=slo_config, queue=queue,
                                       publisher=publisher)
        else:
            # the replicas own their queues: latency is observed client-side
            controller = SLOController(config=slo_config, window=LatencyWindow(),
                                       router=fleet.router, publisher=publisher,
                                       params_fn=lambda: updater.params)
        print(f"# slo: p99 budget {args.slo_p99_ms} ms, floor rate "
              f"{controller.floor_rate:.3f}, max rate {args.slo_max_rate}")

    # ---- concurrent request traffic over the whole stream window ----------
    num_users = frontend.num_users
    stop = threading.Event()
    latencies: list = []
    failures: list = []
    ok = [0]
    lock = threading.Lock()

    def client(seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            user = int(rng.integers(0, num_users))
            t0 = time.perf_counter()
            try:
                frontend.submit(user, args.topk, timeout=30.0).result(timeout=60)
                dt = time.perf_counter() - t0
                if controller is not None and controller.queue is None:
                    # fleet: the queues live in the replicas, so the
                    # controller's window is fed client-side
                    controller.window.record(dt)
                with lock:
                    ok[0] += 1
                    latencies.append(dt)
            except Exception as exc:  # noqa: BLE001 - any failure fails the run
                with lock:
                    failures.append(f"user {user}: {exc!r}")

    threads = [threading.Thread(target=client, args=(1000 + c,), daemon=True)
               for c in range(args.clients)]
    for t in threads:
        t.start()

    # ---- the update loop: prequential test-then-learn ----------------------
    evaluator = PrequentialEvaluator(updater, window=args.prequential_window)
    evaluator.add_drift_hook(recalibration_hook(updater, min_events=args.prequential_window))
    if controller is not None:
        # quality guardrail: prequential drift makes the next tick relax
        evaluator.add_drift_hook(controller.quality_hook())
    swaps = []
    events = 0
    work_fractions = []
    eviction_rounds = []
    t_stream = time.perf_counter()
    try:
        for b, batch in enumerate(
            iter_microbatches(source, args.batch_events, max_events=args.events)
        ):
            metrics = evaluator.consume(batch)
            events += metrics["events"]
            work_fractions.append(metrics["work_fraction"])
            if controller is not None:
                controller.maybe_tick()
            if (b + 1) % args.swap_every == 0:
                info = updater.maybe_recalibrate()  # no-op within the drift budget
                if info:
                    print(f"# recalibrated: drift {info['drift']:.3f}")
                if evictor is not None:
                    ev_info = evictor.maybe_evict()
                    if ev_info:
                        eviction_rounds.append(ev_info)
                        print(f"# evicted {ev_info['evicted']} cold rows -> "
                              f"{ev_info['num_users']} live (remap epoch "
                              f"{ev_info['remap_epoch']})")
                swaps.append(publisher.publish())
        swaps.append(publisher.publish())  # final flush
        stream_s = time.perf_counter() - t_stream
        publisher.close()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        fleet_stats = supervisor_report = None
        if supervisor is not None:
            supervisor.stop()
            supervisor_report = supervisor.report()
        if engine is not None:
            engine.stop()
        else:
            try:
                fleet_stats = fleet.stats()
            finally:
                fleet.close()
    preq = evaluator.stats
    print(f"# prequential: MAE {preq.mae:.4f} (window {preq.window_mae:.4f},"
          f" ema {preq.ema_mae:.4f}) over {preq.events} events")
    stuck = sum(t.is_alive() for t in threads)
    if stuck:
        failures.append(f"{stuck} client threads did not finish")

    mae_after = updater.evaluate(test_ds)
    lat_ms = np.asarray(latencies) * 1e3 if latencies else np.zeros(1)
    report = {
        "device": str(trainer.device),
        "events": events,
        "event_rate_per_s": events / max(stream_s, 1e-9),
        "mean_work_fraction": float(np.mean(work_fractions)),
        "swaps": len(swaps),
        "final_version": engine.version if engine is not None else publisher.version,
        "swap_ms_p50": float(np.percentile([s.swap_s * 1e3 for s in swaps], 50)),
        "swap_ms_max": float(max(s.swap_s * 1e3 for s in swaps)),
        "requests_ok": ok[0],
        "requests_failed": len(failures),
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p99": float(np.percentile(lat_ms, 99)),
        "mae_before": mae_before,
        "mae_after": mae_after,
        "prequential": preq.as_dict(),
        "num_users": num_users,
        "num_items": updater.num_items,
    }
    if evictor is not None:
        report["eviction"] = {
            "rounds": len(eviction_rounds),
            "evicted_total": int(sum(e["evicted"] for e in eviction_rounds)),
            "spilled_resident": len(evictor.spilled_external_ids()),
            "remap_epoch": evictor.remap.epoch,
            "physical_users": int(updater.num_users),
            "external_users": int(evictor.remap.num_external),
        }
    if controller is not None:
        # steady state: the back half of the completions, after the
        # controller has had the stream window to settle
        steady = lat_ms[len(lat_ms) // 2:]
        steady_p99 = float(np.percentile(steady, 99)) if steady.size else 0.0
        report["slo"] = controller.report()
        report["steady_p99_ms"] = steady_p99
        report["slo_violated"] = bool(steady_p99 > args.slo_p99_ms)
    if supervisor_report is not None:
        report["failures"] = supervisor_report
    if fleet_stats is not None:
        # an unhealthy replica reports a stub without "version"
        replica_versions = {r["replica_id"]: r.get("version") for r in fleet_stats["replicas"]}
        stale = [rid for rid, v in replica_versions.items()
                 if v is not None and v != publisher.version]
        report.update({
            "replicas": args.replicas,
            "replica_backend": args.replica_backend,
            "routing": fleet_stats["policy"],
            "affinity_hits": fleet_stats["affinity_hits"],
            "replica_versions": replica_versions,
            "publisher_lag": publisher.lag(),
            "wire_bytes_total": int(sum(s.wire_bytes for s in swaps)),
            "wire_raw_bytes_total": int(sum(s.wire_raw_bytes for s in swaps)),
        })
        if stale:
            failures.append(f"replicas did not converge to v{publisher.version}: {stale}")
            report["requests_failed"] = len(failures)
    if failures:
        report["failure_samples"] = failures[:5]
    return report


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="movielens100k",
                        choices=["movielens100k", "appliances", "bookcrossings", "jester"])
    parser.add_argument("--scale", type=float, default=0.05, help="dataset size multiplier")
    parser.add_argument("--k", type=int, default=24)
    parser.add_argument("--train-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=1024,
                        help="offline training batch size")
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--pruning-rate", type=float, default=0.3)
    parser.add_argument("--variant", default="funk", choices=["funk", "bias", "svdpp"])
    parser.add_argument("--events", type=int, default=500, help="total streamed events")
    parser.add_argument("--batch-events", type=int, default=64,
                        help="events per update micro-batch")
    parser.add_argument("--swap-every", type=int, default=3,
                        help="hot-swap every N micro-batches")
    parser.add_argument("--source", default="replay", choices=["replay", "poisson"])
    parser.add_argument("--prequential-window", type=int, default=256,
                        help="windowed prequential MAE/RMSE span (events)")
    parser.add_argument("--new-id-prob", type=float, default=0.02,
                        help="cold-start id probability (poisson source)")
    parser.add_argument("--clients", type=int, default=4,
                        help="concurrent request threads during the stream")
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--block-n", type=int, default=1024,
                        help="item tile of the CPU path")
    parser.add_argument("--use-kernel", action="store_true",
                        help="kept for the reference's command line: the port takes the CUDA "
                             "kernels whenever --device is cuda, so there the flag has no "
                             "effect; with --device cpu it is refused")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their plain versions")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint dir (training + online deltas)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the run report to PATH")
    parser.add_argument("--replicas", type=int, default=1,
                        help="serve through a fleet of N replica engines on the "
                             "replication bus (1 = one engine)")
    parser.add_argument("--replica-backend", choices=("local", "process"), default="local",
                        help="fleet replicas in this process or as spawned children")
    parser.add_argument("--supervise", action="store_true",
                        help="run a FleetSupervisor: heartbeats, failover, respawn of dead "
                             "replicas (with --replicas > 1)")
    parser.add_argument("--routing", choices=("affinity", "least", "random"),
                        default="affinity", help="fleet routing policy")
    parser.add_argument("--evict-max-users", type=int, default=0,
                        help="spill + compact cold user rows past this many physical rows at "
                             "publish points (0 = unbounded, eviction off)")
    parser.add_argument("--evict-target-users", type=int, default=0,
                        help="rows left after a compaction (default: 80%% of "
                             "--evict-max-users)")
    parser.add_argument("--slo-p99-ms", type=float, default=0.0,
                        help="enable the SLO controller with this p99 budget (ms; 0 = off); "
                             "exit non-zero if the steady-state p99 still violates it")
    parser.add_argument("--slo-max-rate", type=float, default=0.8,
                        help="ceiling on the controller's effective pruning rate")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    report = run_online(args)
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if report["requests_failed"]:
        raise SystemExit(f"{report['requests_failed']} requests failed during the run")
    if report.get("slo_violated"):
        raise SystemExit(f"SLO violated: steady-state p99 {report['steady_p99_ms']:.2f} ms "
                         f"> budget {args.slo_p99_ms:.2f} ms")


if __name__ == "__main__":
    main()
