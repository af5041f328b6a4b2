"""Evaluation on a live stream, on the port: prequential MAE + pruned-vs-dense
NDCG@10.

    PYTHONPATH=src python examples/torch_eval_on_stream.py [--events 512] [--device cpu]

The evaluation loop end to end, on the card (or the CPU):

1. train a small dynamically-pruned MF model;
2. measure ranking quality of the *pruned* serving engine against the dense
   brute-force oracle (HR@10 / NDCG@10 / recall@10);
3. replay a held-out rating stream **prequentially**: every event batch is
   scored by the current model (test-then-learn) before the online updater
   applies it, printing the windowed MAE as it evolves;
4. hot-swap the refreshed factors into the live engine and re-measure the
   pruned-vs-dense ranking gap after the stream.
"""
import argparse
import time

from repro_torch.core.trainer import DPMFTrainer, TrainConfig
from repro_torch.data.ratings import paper_dataset, train_test_split
from repro_torch.device import device_name
from repro_torch.eval import PrequentialEvaluator, evaluate_engine, evaluate_oracle
from repro_torch.online import OnlineUpdater, ReplaySource, SnapshotPublisher, \
    iter_microbatches
from repro_torch.serving import ServingEngine


def gap_line(tag, pruned, dense):
    """One comparison line: pruned engine vs dense oracle metrics."""
    return (f"{tag}: NDCG@{pruned.topk} {pruned.ndcg:.4f} vs dense "
            f"{dense.ndcg:.4f} (gap {dense.ndcg - pruned.ndcg:+.4f}), "
            f"HR {pruned.hr:.4f} vs {dense.hr:.4f}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--events", type=int, default=512)
    parser.add_argument("--scale", type=float, default=0.05)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--window", type=int, default=256)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    # 1. train a pruned model on a small split of the paper's dataset
    ds = paper_dataset("movielens100k", seed=0, scale=args.scale)
    rest, test_ds = train_test_split(ds, 0.2, seed=0)
    train_ds, stream_ds = train_test_split(rest, 0.3, seed=1)
    config = TrainConfig(k=16, epochs=3, batch_size=1024, pruning_rate=0.3,
                         ranking_topk=args.topk, seed=0)
    trainer = DPMFTrainer(config, train_ds, test_ds, device=args.device)
    trainer.run()
    last = trainer.history[-1]
    print(f"trained on {device_name(trainer.device)}: test MAE {last.test_mae:.4f}, "
          f"NDCG@{args.topk} {last.ndcg:.4f}, work_fraction {last.work_fraction:.2f}")

    # 2. ranking quality of the PRUNED engine vs the dense oracle
    engine = ServingEngine(trainer.params, trainer.t_p, trainer.t_q, device=args.device)
    pruned = evaluate_engine(engine, test_ds, args.topk)
    dense = evaluate_oracle(trainer.params, test_ds, args.topk)
    print(gap_line("before stream", pruned, dense))

    # 3. prequential replay: score-then-apply every micro-batch
    updater = OnlineUpdater.from_trainer(trainer, batch_size=64)
    publisher = SnapshotPublisher(engine, updater)
    evaluator = PrequentialEvaluator(updater, window=args.window)
    source = ReplaySource(stream_ds, epochs=None, shuffle=True, seed=0)
    start = time.perf_counter()
    for b, batch in enumerate(
        iter_microbatches(source, 64, max_events=args.events)
    ):
        evaluator.consume(batch)
        if (b + 1) % 4 == 0:
            stats = evaluator.stats
            print(f"  {stats.events:5d} events: windowed MAE "
                  f"{stats.window_mae:.4f} (cumulative {stats.mae:.4f})")
            publisher.publish()   # hot-swap the refreshed factors
    publisher.publish()
    rate = evaluator.stats.events / (time.perf_counter() - start)
    stats = evaluator.stats
    print(f"prequential over {stats.events} events: MAE {stats.mae:.4f}, "
          f"RMSE {stats.rmse:.4f} ({rate:.0f} events/s, engine now at "
          f"version {engine.version})")

    # 4. the gap after refresh: same engine, now serving the swapped factors
    after = evaluate_engine(engine, test_ds, args.topk)
    dense_after = evaluate_oracle(engine.params, test_ds, args.topk)
    print(gap_line("after stream ", after, dense_after))
    return {"test_mae": last.test_mae, "prequential_mae": stats.mae, "events": stats.events,
            "events_s": rate, "version": engine.version,
            "ndcg_gap": dense_after.ndcg - after.ndcg}


if __name__ == "__main__":
    main()
