"""Serving launcher: batched top-k recommendation from a trained DP-MF
checkpoint through the port's serving engine (``repro_torch.serving``).

    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt /path/to/ckpt \
        --users 0 1 2 --topk 10

Runs on ``cuda`` (the hand-written ``pruned_topk`` kernel) unless
``--device cpu`` selects the plain PyTorch path.  The engine restores the
full ``MFParams`` and precomputes the per-item ranks once at load.

Traffic modes on top of the one-shot lookup:

* ``--batched-requests N``: one synchronous N-user batch;
* ``--concurrent N --clients C``: N single-user requests from C client
  threads through the async request queue; reports latency percentiles and
  throughput;
* ``--http PORT``: a minimal threaded server, ``GET /recommend?user=3&topk=10``;
  concurrent HTTP clients coalesce into shared scoring launches.

``--slo-p99-ms BUDGET`` arms the SLO-aware degradation loop for
``--concurrent`` runs: an :class:`~repro_torch.serving.slo.SLOController`
observes client latency and queue depth while the load runs and adapts the
pruning thresholds (up to ``--slo-max-rate``) to hold p99 under the budget;
the process exits non-zero if the steady-state p99 (the back half of the
completions) still violates it.

With ``--replicas N`` (N > 1) the same traffic modes run against a serving
fleet instead of one engine: N replica engines (``--replica-backend local``
in this process, ``process`` as spawned children, each with its own CUDA
context) behind the cache-aware router (``repro_torch.serving.fleet``);
``--routing`` selects the policy (affinity/least/random).
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from repro_torch.serving import (
    LatencyWindow,
    QueueFullError,
    RequestTimeout,
    ServingEngine,
    SLOConfig,
    SLOController,
    load_mf_checkpoint,
)


def build_slo_controller(frontend, params, *, p99_budget_ms: float,
                         max_rate: float, tick_ms: float) -> SLOController:
    """Attach an :class:`SLOController` to either frontend kind.  Latency is
    observed client-side (one shared :class:`LatencyWindow` the traffic loop
    records into), which works alike for one engine and for a fleet of
    process replicas whose queues live in the children."""
    config = SLOConfig(p99_budget_ms=p99_budget_ms, max_rate=max_rate,
                       tick_interval_s=tick_ms / 1e3)
    window = LatencyWindow()
    if isinstance(frontend, ServingEngine):
        return SLOController(frontend, config=config, window=window,
                             depth_fn=lambda: frontend.queue_depth)
    return SLOController(
        config=config, window=window, router=frontend.router,
        depth_fn=lambda: sum(r.depth() for r in frontend.router.replicas),
        params_fn=lambda: params,
    )


def _shutdown(frontend) -> None:
    """Graceful drain of either frontend kind (``ServingEngine.stop`` or
    ``ServingFleet.close``): requests in flight complete first."""
    if isinstance(frontend, ServingEngine):
        frontend.stop()
    else:
        frontend.close()


def run_concurrent(frontend, n_requests: int, clients: int, topk: int, timeout: float,
                   controller: SLOController | None = None) -> dict:
    """Drive the async frontend (one engine, or a routed fleet) from
    ``clients`` submitter threads; returns a report of wall time, req/s and
    client-side p50/p99 latency.  With a ``controller`` the loop records
    client latency into its window and ticks it while the load runs; the
    report then carries the controller's state and the steady-state p99
    (the back half of the completions)."""
    from concurrent.futures import ThreadPoolExecutor

    queue = None
    rng = np.random.default_rng(0)
    users = rng.integers(0, frontend.num_users, n_requests)
    if isinstance(frontend, ServingEngine):
        queue = frontend.start(linger_ms=1.0, max_pending=max(1024, n_requests))
        # warm every power-of-two bucket a batch can land in
        for b in (1, 2, 4, 8, 16, 32, 64):
            if b <= min(frontend.max_batch, n_requests):
                frontend.topk(users[:b], topk)
    latencies = np.empty(n_requests)
    order = np.empty(n_requests)  # latencies in completion order
    done = [0]
    done_lock = threading.Lock()

    def client(i_u):
        i, u = i_u
        t0 = time.perf_counter()
        frontend.submit(int(u), topk, timeout=timeout).result(timeout=timeout)
        dt = time.perf_counter() - t0
        latencies[i] = dt
        if controller is not None:
            controller.window.record(dt)
        with done_lock:
            order[done[0]] = dt
            done[0] += 1

    stop_tick = threading.Event()

    def ticker():
        while not stop_tick.is_set():
            controller.maybe_tick()
            stop_tick.wait(controller.config.tick_interval_s / 4)

    tick_thread = None
    if controller is not None:
        tick_thread = threading.Thread(target=ticker, daemon=True)
        tick_thread.start()
    start = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=clients) as pool:
            list(pool.map(client, enumerate(users)))
    finally:
        wall = time.perf_counter() - start
        if tick_thread is not None:
            stop_tick.set()
            tick_thread.join(60)
        stats = None if queue is not None else frontend.stats()
        _shutdown(frontend)
    p50, p99 = np.percentile(latencies * 1e3, [50, 99])
    line = (f"concurrent: {n_requests} requests, {clients} clients in "
            f"{wall:.3f}s ({n_requests / wall:.1f} req/s; p50 {p50:.2f} ms, "
            f"p99 {p99:.2f} ms")
    if queue is not None:
        line += (f"; {queue.batches_served} launches, mean batch "
                 f"{queue.requests_served / queue.batches_served:.1f})")
    else:
        line += (f"; routed over {len(stats['replicas'])} replicas, "
                 f"policy={stats['policy']}, affinity hits {stats['affinity_hits']})")
    print(line)
    report = {"requests": n_requests, "wall_s": wall, "req_per_s": n_requests / wall,
              "p50_ms": float(p50), "p99_ms": float(p99)}
    if controller is not None:
        # judge the SLO on the back half of completions: the front half is
        # the controller still hunting for an operating point
        steady = order[n_requests // 2:done[0]]
        steady_p99 = float(np.percentile(steady * 1e3, 99)) if steady.size else float("nan")
        report["slo"] = controller.report()
        report["steady_p99_ms"] = steady_p99
        report["slo_violated"] = bool(np.isfinite(steady_p99)
                                      and steady_p99 > controller.config.p99_budget_ms)
        print(f"slo: steady-state p99 {steady_p99:.2f} ms vs budget "
              f"{controller.config.p99_budget_ms:.2f} ms "
              f"({'VIOLATED' if report['slo_violated'] else 'ok'}); "
              f"rate {report['slo']['applied_rate']}, {report['slo']['degrades']} degrades / "
              f"{report['slo']['relaxes']} relaxes over {report['slo']['ticks']} ticks")
    return report


def run_http(frontend, port: int, topk_default: int, timeout: float) -> None:
    """Blocking HTTP front end over the async queue, or over a fleet's
    router (stdlib only).  Shutdown drains: in-flight requests complete
    before the process exits."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    if isinstance(frontend, ServingEngine):
        frontend.start(linger_ms=1.0)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _reply(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path != "/recommend":
                return self._reply(404, {"error": "GET /recommend?user=..."})
            qs = parse_qs(url.query)
            try:
                user = int(qs["user"][0])
                topk = int(qs.get("topk", [topk_default])[0])
                scores, items = frontend.submit(
                    user, topk, timeout=timeout
                ).result(timeout=timeout)
            except (KeyError, ValueError, IndexError) as exc:
                return self._reply(400, {"error": str(exc)})
            except QueueFullError as exc:
                return self._reply(503, {"error": str(exc)})
            except (RequestTimeout, TimeoutError) as exc:
                return self._reply(504, {"error": str(exc)})
            self._reply(200, {
                "user": user,
                "items": [
                    {"item": int(i), "score": round(float(s), 4)}
                    for i, s in zip(items, scores)
                ],
            })

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"# serving http://127.0.0.1:{port}/recommend?user=0&topk="
          f"{topk_default} (Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        _shutdown(frontend)


def main(argv=None) -> None:
    """Parse arguments, load the checkpoint, serve the requested traffic."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--users", type=int, nargs="+", default=[0])
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--batched-requests", type=int, default=0,
                        help="simulate N random-user requests and report latency")
    parser.add_argument("--concurrent", type=int, default=0,
                        help="simulate N single-user requests through the "
                             "async queue")
    parser.add_argument("--clients", type=int, default=32,
                        help="submitter threads for --concurrent")
    parser.add_argument("--timeout", type=float, default=30.0,
                        help="per-request timeout (seconds) for async modes")
    parser.add_argument("--http", type=int, default=0, metavar="PORT",
                        help="serve GET /recommend over HTTP on PORT")
    parser.add_argument("--max-batch", type=int, default=256,
                        help="micro-batch bucket cap")
    parser.add_argument("--history", default=None,
                        help="(.npy) padded per-user item-history matrix for "
                             "SVD++ checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="serve through a fleet of N replica engines behind the "
                             "cache-aware router (1 = one engine)")
    parser.add_argument("--replica-backend", choices=("local", "process"), default="local",
                        help="fleet replicas in this process or as spawned children")
    parser.add_argument("--routing", choices=("affinity", "least", "random"),
                        default="affinity", help="fleet routing policy")
    parser.add_argument("--slo-p99-ms", type=float, default=0.0,
                        help="enable the SLO controller with this p99 budget (ms) for "
                             "--concurrent; exit non-zero if the steady-state p99 still "
                             "violates it (0 = off)")
    parser.add_argument("--slo-max-rate", type=float, default=0.8,
                        help="ceiling on the controller's effective pruning rate")
    parser.add_argument("--slo-tick-ms", type=float, default=100.0,
                        help="controller tick interval (ms)")
    args = parser.parse_args(argv)

    params, t_p, t_q, _, meta = load_mf_checkpoint(args.ckpt, device=args.device)
    user_history = None if args.history is None else np.load(args.history)
    if params.implicit is not None and user_history is None:
        print("# warning: SVD++ checkpoint served without --history — "
              "user vectors fall back to p alone")
    engine_kwargs = dict(device=args.device, max_batch=args.max_batch,
                         allow_missing_history=True)
    engine = ServingEngine(params, t_p, t_q, user_history=user_history, **engine_kwargs)
    variant = (
        "svdpp" if params.implicit is not None
        else "bias" if params.user_bias is not None
        else "funk"
    )
    print(f"# loaded step {meta.get('step')} variant={variant} on "
          f"{engine.device} ({engine.num_users} users x {engine.n_items} "
          f"items, k={engine.k})")

    frontend = engine
    if args.replicas > 1:
        from repro_torch.serving.fleet import ServingFleet

        frontend = ServingFleet(
            params, t_p, t_q, replicas=args.replicas, backend=args.replica_backend,
            user_history=user_history, engine_kwargs=engine_kwargs,
            queue_kwargs={"linger_ms": 1.0}, router_kwargs={"policy": args.routing},
        )
        print(f"# fleet: {args.replicas} {args.replica_backend} replicas on {args.device}, "
              f"routing={args.routing}")

    if args.http:
        return run_http(frontend, args.http, args.topk, args.timeout)

    recs = engine.recommend(args.users, topk=args.topk)
    print(json.dumps({str(u): r for u, r in zip(args.users, recs)}, indent=2))

    if args.batched_requests:
        rng = np.random.default_rng(0)
        users = rng.integers(0, engine.num_users, args.batched_requests)
        engine.topk(users, args.topk)  # warm every bucket the mix hits
        start = time.perf_counter()
        engine.topk(users, args.topk)
        dt = time.perf_counter() - start
        print(f"batched: {args.batched_requests} requests in {dt:.3f}s "
              f"({args.batched_requests / dt:.1f} req/s)")

    if args.concurrent:
        controller = None
        if args.slo_p99_ms > 0:
            controller = build_slo_controller(
                frontend, params, p99_budget_ms=args.slo_p99_ms,
                max_rate=args.slo_max_rate, tick_ms=args.slo_tick_ms)
            print(f"# slo: p99 budget {args.slo_p99_ms} ms, floor rate "
                  f"{controller.floor_rate:.3f}, max rate {args.slo_max_rate}")
        report = run_concurrent(frontend, args.concurrent, args.clients, args.topk,
                                args.timeout, controller=controller)
        print(json.dumps(report))
        if report.get("slo_violated"):
            raise SystemExit(f"SLO violated: steady-state p99 {report['steady_p99_ms']:.2f} "
                             f"ms > budget {args.slo_p99_ms:.2f} ms")
    elif frontend is not engine:
        frontend.close()


if __name__ == "__main__":
    main()
