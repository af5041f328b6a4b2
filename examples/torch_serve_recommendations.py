"""Serving example on the port: train briefly, then serve top-k
recommendations through the serving engine (streaming pruned top-k: the
``pruned_topk`` kernel on the card, the (B, n) score matrix never
materialized) three ways: a synchronous batch, the synchronous
micro-batcher, and the async request pipeline (continuous batching from
concurrent clients).

    PYTHONPATH=src python examples/torch_serve_recommendations.py [--device cpu] [--scale 0.3]

``--scale`` sizes the dataset (the reference's 0.3 by default).
"""
import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core import DPMFTrainer, TrainConfig
from repro_torch.data import paper_dataset, train_test_split
from repro_torch.device import device_name
from repro_torch.serving import MicroBatcher, ServingEngine


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--scale", type=float, default=0.3)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    ds = paper_dataset("movielens100k", seed=0, scale=args.scale)
    train_ds, test_ds = train_test_split(ds, 0.2, seed=0)

    trainer = DPMFTrainer(
        TrainConfig(k=32, epochs=6, pruning_rate=0.3), train_ds, test_ds, device=args.device
    )
    trainer.run()
    print(f"trained: test MAE {trainer.history[-1].test_mae:.4f}")

    # Load once: per-item ranks, masked factors, and tile layout are
    # precomputed here, not per request.
    engine = ServingEngine(trainer.params, trainer.t_p, trainer.t_q, device=args.device)
    where = device_name(engine.device)

    for user, recs in zip([3, 14, 15], engine.recommend([3, 14, 15], topk=5)):
        line = ", ".join(f"item {r['item']} ({r['score']:.2f})" for r in recs)
        print(f"user {user}: {line}")

    # micro-batched single-user traffic: tickets collapse into one engine batch
    batcher = MicroBatcher(engine, topk=5)
    tickets = [batcher.submit(u) for u in (3, 14, 15, 3)]
    results = batcher.drain()
    assert np.array_equal(results[tickets[0]][1], results[tickets[3]][1])
    print(f"micro-batched {len(tickets)} tickets in one flush")

    # batched-request latency through the streaming scoring path
    rng = np.random.default_rng(0)
    batch_users = rng.integers(0, ds.num_users, 256)
    engine.topk(batch_users, topk=10)  # warm the kernel and the buckets
    start = time.perf_counter()
    engine.topk(batch_users, topk=10)
    dt = time.perf_counter() - start
    sync_rate = 256 / dt
    print(f"256 top-10 requests in {dt * 1e3:.1f} ms "
          f"({sync_rate:.0f} req/s on {where}, no (B, n) score matrix)")

    # async pipeline: concurrent clients submit single-user requests and
    # block on futures; the scheduler thread coalesces them into shared
    # scoring launches (continuous batching) with per-request timeouts.
    # Results are byte-identical to the synchronous path.
    queue = engine.start(linger_ms=1.0)   # engine.submit() now routes here

    def one_client(user):
        scores, items = engine.submit(int(user), topk=10, timeout=30).result(30)
        return items

    for b in (1, 2, 4, 8, 16, 32):        # warm the buckets batches can hit
        engine.topk(batch_users[:b], topk=10)
    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=32) as pool:
        async_items = list(pool.map(one_client, batch_users))
    dt = time.perf_counter() - start
    sync_scores, sync_items = engine.topk(batch_users, topk=10)
    assert all(np.array_equal(a, s) for a, s in zip(async_items, sync_items)), (
        "async results differ from the sync path")
    async_rate = 256 / dt
    print(f"async: 256 requests from 32 clients in {dt * 1e3:.1f} ms "
          f"({async_rate:.0f} req/s on {where}; {queue.batches_served} launches, "
          f"results identical to the sync path)")
    engine.stop()
    return {"test_mae": trainer.history[-1].test_mae, "sync_req_s": sync_rate,
            "async_req_s": async_rate, "launches": queue.batches_served}


if __name__ == "__main__":
    main()
