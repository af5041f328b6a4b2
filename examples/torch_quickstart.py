"""Quickstart on the port: dynamic-pruning MF in ~40 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--scale 0.5]

Trains FunkSVD on a MovieLens-100K-shaped synthetic dataset twice (dense
baseline vs dynamically pruned) on the card, or the CPU with
``--device cpu``, and prints the paper's headline metrics (MAE,
percentage-MAE, work-proportional speedup).  ``--scale`` sizes the dataset
(the reference's 0.5 by default).
"""
import argparse
import time

from repro_torch.core import DPMFTrainer, TrainConfig, percentage_mae, work_speedup
from repro_torch.data import paper_dataset, train_test_split
from repro_torch.device import device_name


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--scale", type=float, default=0.5)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    start = time.perf_counter()
    ds = paper_dataset("movielens100k", seed=0, scale=args.scale)
    train_ds, test_ds = train_test_split(ds, test_fraction=0.2, seed=0)

    dense = DPMFTrainer(
        TrainConfig(k=30, epochs=15, pruning_rate=0.0, lr=0.1, init_method="libmf"),
        train_ds, test_ds, device=args.device,
    )
    dense.run()

    pruned = DPMFTrainer(
        TrainConfig(k=30, epochs=15, pruning_rate=0.3, lr=0.1, init_method="libmf"),
        train_ds, test_ds, device=args.device,
    )
    pruned.run()

    mae_org = dense.history[-1].test_mae
    mae_acc = pruned.history[-1].test_mae
    speedup = work_speedup(pruned.history)
    print(f"dense  MAE: {mae_org:.4f}")
    print(f"pruned MAE: {mae_acc:.4f}  (P_MAE = {percentage_mae(mae_acc, mae_org):+.2f}%)")
    print(f"thresholds: T_p={pruned.history[-1].t_p:.4f} T_q={pruned.history[-1].t_q:.4f}")
    print(f"work-proportional speedup: {speedup:.2f}x "
          f"(paper reports 1.2-1.65x wall-clock)")
    wall = time.perf_counter() - start
    print(f"both runs on {device_name(dense.device)} in {wall:.1f} s")
    return {"dense_mae": mae_org, "pruned_mae": mae_acc,
            "p_mae": percentage_mae(mae_acc, mae_org), "work_speedup": speedup}


if __name__ == "__main__":
    main()
