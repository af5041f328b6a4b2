"""Implicit-feedback workload end to end on the port: clicks in, pruned top-k
out.

    PYTHONPATH=src python examples/torch_implicit_stream.py [--events 384] [--device cpu]

The rating-free pipeline, on the card (or the CPU):

1. train a confidence-weighted implicit MF model (WALS-style: positives at
   confidence ``1 + alpha`` plus sampled negatives) with dynamic pruning,
   through the same fused update the explicit objective uses;
2. serve it through the pruned top-k engine and check the ranking gap vs
   the dense brute-force oracle (and exact parity at thresholds 0);
3. replay a **rating-free click stream** prequentially: every click batch
   is first scored by the engine the user would actually have hit ("was
   the clicked item in our top-k?"), then converted to a WALS micro-batch
   and applied: live hit-rate/MRR, segmented into new vs established
   users, with no ratings anywhere in the stream;
4. encode a few SASRec sessions (``repro_torch.models.recsys``) and serve
   them through the *same* pruned engine (``workloads.sequential``):
   session vectors are just user rows the engine has never had to
   special-case.
"""
import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.core.trainer import DPMFTrainer, TrainConfig
from repro_torch.data import clicks, synthetic_ratings, train_test_split
from repro_torch.device import device_name
from repro_torch.eval import PrequentialRankingEvaluator, evaluate_engine, \
    evaluate_oracle
from repro_torch.models import recsys
from repro_torch.online import OnlineUpdater, ReplaySource, SnapshotPublisher, \
    iter_microbatches
from repro_torch.serving import ServingEngine
from repro_torch.workloads import implicit_event_batch, serve_sessions, \
    session_engine, strip_ratings


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--events", type=int, default=384)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--alpha", type=float, default=8.0)
    parser.add_argument("--negatives", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    # 1. implicit training: clicks become weighted binary preferences
    ds = synthetic_ratings(num_users=400, num_items=3000, num_ratings=12000,
                           seed=0)
    rest, stream_ds = train_test_split(ds, 0.25, seed=1)
    train_ds, test_ds = train_test_split(rest, 0.2, seed=2)
    config = TrainConfig(k=16, epochs=3, batch_size=2048, lr=0.02,
                         pruning_rate=0.3, ranking_topk=args.topk,
                         objective="implicit", implicit_alpha=args.alpha,
                         implicit_negatives=args.negatives, seed=0)
    trainer = DPMFTrainer(config, train_ds, test_ds, device=args.device)
    trainer.run()
    last = trainer.history[-1]
    print(f"implicit-trained on {device_name(trainer.device)}: HR@{args.topk} "
          f"{last.hr:.4f}, NDCG {last.ndcg:.4f}, work_fraction {last.work_fraction:.2f} "
          f"(alpha {args.alpha}, {args.negatives} negatives/positive)")

    # 2. pruned engine vs dense oracle on the binarized holdout
    engine = ServingEngine(trainer.params, trainer.t_p, trainer.t_q, device=args.device)
    holdout = trainer.test_ds
    pruned = evaluate_engine(engine, holdout, args.topk)
    dense = evaluate_oracle(trainer.params, holdout, args.topk)
    dense_engine = ServingEngine(trainer.params, 0.0, 0.0, device=args.device)
    assert evaluate_engine(dense_engine, holdout, args.topk) == dense, (
        "the engine at thresholds 0 differs from the dense oracle")
    print(f"serving: pruned NDCG@{args.topk} {pruned.ndcg:.4f} vs dense "
          f"{dense.ndcg:.4f} (gap {dense.ndcg - pruned.ndcg:+.4f}; "
          f"engine == oracle exactly at thresholds 0)")

    # 3. rating-free prequential ranking: score the click, then learn it
    updater = OnlineUpdater.from_trainer(trainer, batch_size=64)
    publisher = SnapshotPublisher(engine, updater)
    evaluator = PrequentialRankingEvaluator(
        updater, topk=args.topk,
        update_fn=functools.partial(
            implicit_event_batch, num_items=3000, alpha=args.alpha,
            negatives=args.negatives, rng=np.random.default_rng(0),
        ),
    )
    source = strip_ratings(
        ReplaySource(stream_ds, epochs=None, shuffle=True, seed=0)
    )
    start = time.perf_counter()
    for b, batch in enumerate(
        iter_microbatches(source, 64, max_events=args.events)
    ):
        assert batch.rating is None   # genuinely rating-free end to end
        evaluator.consume(batch)
        if (b + 1) % 3 == 0:
            stats = evaluator.stats
            print(f"  {stats.events:5d} clicks: windowed HR@{args.topk} "
                  f"{stats.window_hit_rate:.4f} (cumulative "
                  f"{stats.hit_rate:.4f}, MRR {stats.mrr:.4f})")
            publisher.publish()
    publisher.publish()
    stats = evaluator.stats
    rate = stats.events / (time.perf_counter() - start)
    cohorts = stats.cohorts
    print(f"prequential over {stats.events} clicks: HR@{args.topk} "
          f"{stats.hit_rate:.4f}, MRR {stats.mrr:.4f} ({rate:.0f} clicks/s; "
          f"new users {cohorts['new']['hit_rate']:.4f} over "
          f"{cohorts['new']['events']}, established "
          f"{cohorts['established']['hit_rate']:.4f} over "
          f"{cohorts['established']['events']})")

    # 4. sequential coda: SASRec session vectors through the same engine
    cfg = recsys.SASRecConfig(n_items=60, embed_dim=16, n_blocks=2,
                              n_heads=2, seq_len=10)
    sasrec = recsys.init_sasrec_params(torch.Generator(device=args.device).manual_seed(1), cfg,
                                       device=args.device)
    sessions = torch.as_tensor(
        clicks.sasrec_batch(5, seq_len=10, n_items=60, seed=4)["seq"]
    ).to(args.device)
    sengine = session_engine(sasrec, sessions, cfg, t_p=0.0, t_q=0.0, device=args.device)
    _, item_ids = serve_sessions(sengine, np.arange(5), topk=5)
    print("sequential: SASRec sessions served by the unchanged pruned "
          "engine; next-item ids per session:")
    for row in np.asarray(item_ids):
        print(f"  {list(map(int, row))}")
    return {"hr": last.hr, "ndcg_gap": dense.ndcg - pruned.ndcg, "clicks": stats.events,
            "hit_rate": stats.hit_rate, "clicks_s": rate, "sessions": len(item_ids)}


if __name__ == "__main__":
    main()
