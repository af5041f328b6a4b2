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
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.serving import (
    QueueFullError,
    RequestTimeout,
    ServingEngine,
    load_mf_checkpoint,
)


def run_concurrent(engine: ServingEngine, n_requests: int, clients: int,
                   topk: int, timeout: float) -> dict:
    """Drive the async queue from ``clients`` submitter threads; returns a
    report of wall time, req/s and client-side p50/p99 latency."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(0)
    users = rng.integers(0, engine.num_users, n_requests)
    queue = engine.start(linger_ms=1.0, max_pending=max(1024, n_requests))
    # warm every power-of-two bucket a batch can land in
    for b in (1, 2, 4, 8, 16, 32, 64):
        if b <= min(engine.max_batch, n_requests):
            engine.topk(users[:b], topk)
    latencies = np.empty(n_requests)

    def client(i_u):
        i, u = i_u
        t0 = time.perf_counter()
        engine.submit(int(u), topk, timeout=timeout).result(timeout=timeout)
        latencies[i] = time.perf_counter() - t0

    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        list(pool.map(client, enumerate(users)))
    wall = time.perf_counter() - start
    engine.stop()
    p50, p99 = np.percentile(latencies * 1e3, [50, 99])
    print(f"concurrent: {n_requests} requests, {clients} clients in "
          f"{wall:.3f}s ({n_requests / wall:.1f} req/s; p50 {p50:.2f} ms, "
          f"p99 {p99:.2f} ms; {queue.batches_served} launches, mean batch "
          f"{queue.requests_served / queue.batches_served:.1f})")
    return {"requests": n_requests, "wall_s": wall, "req_per_s": n_requests / wall,
            "p50_ms": float(p50), "p99_ms": float(p99)}


def run_http(engine: ServingEngine, port: int, topk_default: int,
             timeout: float) -> None:
    """Blocking HTTP front end over the async queue (stdlib only).  Shutdown
    drains: in-flight requests complete before the process exits."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    engine.start(linger_ms=1.0)

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
                scores, items = engine.submit(
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
        engine.stop()


def main() -> None:
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
    args = parser.parse_args()

    params, t_p, t_q, _, meta = load_mf_checkpoint(args.ckpt, device=args.device)
    user_history = None if args.history is None else np.load(args.history)
    if params.implicit is not None and user_history is None:
        print("# warning: SVD++ checkpoint served without --history — "
              "user vectors fall back to p alone")
    engine = ServingEngine(
        params, t_p, t_q, device=args.device, max_batch=args.max_batch,
        user_history=user_history, allow_missing_history=True,
    )
    variant = (
        "svdpp" if params.implicit is not None
        else "bias" if params.user_bias is not None
        else "funk"
    )
    print(f"# loaded step {meta.get('step')} variant={variant} on "
          f"{engine.device} ({engine.num_users} users x {engine.n_items} "
          f"items, k={engine.k})")

    if args.http:
        return run_http(engine, args.http, args.topk, args.timeout)

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
        run_concurrent(engine, args.concurrent, args.clients, args.topk,
                       args.timeout)


if __name__ == "__main__":
    main()
