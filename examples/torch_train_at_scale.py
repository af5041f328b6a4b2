"""End-to-end driver on the port: train a ~100M-parameter DP-MF model for a
few hundred steps on synthetic ratings, with checkpointing and
fault-tolerant stepping, on the card (or the CPU with ``--device cpu``).

    PYTHONPATH=src python examples/torch_train_at_scale.py [--steps 300] [--device cpu]

The model is 600k users x 200k items x k=128 => (600k + 200k) * 128 ~= 102M
parameters.  Uses the paper's full pipeline: dense first epoch, one-shot
threshold + rearrangement, dynamically pruned steps after.  A run that
finds a checkpoint in ``--ckpt`` resumes from it.
"""
import argparse
import os
import tempfile
import time

from repro_torch.core import DPMFTrainer, TrainConfig, work_speedup
from repro_torch.data import synthetic_ratings, train_test_split
from repro_torch.device import device_name


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch-size", type=int, default=16384)
    parser.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                       "dpmf_100m_ckpt_torch"))
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    num_ratings = args.steps * args.batch_size // 2  # ~2 epochs of steps
    print(f"generating {num_ratings:,} synthetic ratings (600k x 200k, k*=16)")
    ds = synthetic_ratings(600_000, 200_000, num_ratings, k_true=16, seed=0)
    train_ds, test_ds = train_test_split(ds, 0.1, seed=0)

    config = TrainConfig(
        k=128,
        epochs=4,
        batch_size=args.batch_size,
        pruning_rate=0.3,
        optimizer="adagrad",
        checkpoint_dir=args.ckpt,
        checkpoint_every_epochs=1,
    )
    trainer = DPMFTrainer(config, train_ds, test_ds, device=args.device)
    n_params = (ds.num_users + ds.num_items) * config.k
    print(f"model: {n_params / 1e6:.1f}M parameters on {device_name(trainer.device)}")
    if trainer.maybe_restore():
        print(f"resumed at epoch {trainer.epoch}")

    start = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - start
    steps = sum(
        len(train_ds) // config.batch_size for _ in trainer.history
    )
    print(f"{steps} steps in {wall:.1f}s "
          f"({steps / wall:.1f} steps/s, batch {config.batch_size})")
    print(f"final test MAE: {trainer.history[-1].test_mae:.4f}")
    print(f"work speedup vs dense: {work_speedup(trainer.history):.2f}x")
    print(f"checkpoints: {args.ckpt}")
    return {"params_m": n_params / 1e6, "steps": steps, "steps_s": steps / wall,
            "test_mae": trainer.history[-1].test_mae,
            "work_speedup": work_speedup(trainer.history)}


if __name__ == "__main__":
    main()
