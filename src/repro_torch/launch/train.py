"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --dataset movielens100k \
        --pruning-rate 0.3 --epochs 15 --k 50 --ckpt /tmp/dpmf_ckpt

Runs the paper's DP-MF pipeline (epoch 0 dense -> thresholds -> rearrange ->
pruned epochs) on ``cuda`` unless ``--device cpu`` is given, with bounded
retries around each epoch, straggler timing and async checkpointing.
Restarting the same command resumes from the latest checkpoint (same data
order).  The tables are updated in place, so a retried epoch resumes from
the tables as the failed attempt left them.  The checkpoint serves through
``repro_torch.launch.serve`` and through the reference's
``repro.launch.serve``.  ``--objective implicit|bpr`` trains the workloads
of ``repro_torch.workloads``.

Out of core: ``--store-dir DIR --build-store`` writes the train split into a
ratings store (``repro_torch.store``) and trains from it, streaming
``--slab-steps`` steps a slab through a ``--prefetch-slabs`` deep queue;
``--ckpt-every-slabs N`` checkpoints mid-epoch, so rerunning the same
command after a kill resumes at the last saved slab.  Without
``--build-store`` an existing store is read and the dataset is not made.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.trainer import DPMFTrainer, TrainConfig, work_speedup
from repro_torch.data.ratings import paper_dataset, train_test_split
from repro_torch.distributed.fault_tolerance import StragglerDetector, run_with_retries
from repro_torch.store import build_store


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", default="movielens100k",
                        choices=["movielens100k", "appliances", "bookcrossings", "jester"])
    parser.add_argument("--scale", type=float, default=1.0, help="dataset size multiplier")
    parser.add_argument("--k", type=int, default=50)
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--lam", type=float, default=0.02)
    parser.add_argument("--pruning-rate", type=float, default=0.3)
    parser.add_argument("--optimizer", default="adagrad",
                        choices=["sgd", "momentum", "adagrad", "adadelta", "adam"])
    parser.add_argument("--epoch-mode", default="scan", choices=["scan", "python"],
                        help="scan: device-resident epoch loop; python: per-batch host loop")
    parser.add_argument("--strategy", default="standard", choices=["standard", "twin"])
    parser.add_argument("--init", default="normal", choices=["normal", "uniform"])
    parser.add_argument("--variant", default="funk", choices=["funk", "bias", "svdpp"])
    parser.add_argument("--objective", default="explicit", choices=["explicit", "implicit", "bpr"],
                        help="explicit: squared rating error (the paper); implicit: WALS "
                             "confidence-weighted binary preference with sampled negatives; "
                             "bpr: pairwise ranking loss (test mae is NaN)")
    parser.add_argument("--implicit-alpha", type=float, default=40.0,
                        help="implicit confidence c = 1 + alpha*r")
    parser.add_argument("--implicit-negatives", type=int, default=4,
                        help="sampled negatives per observed interaction")
    parser.add_argument("--use-fused-kernel", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--ckpt-every", type=int, default=5)
    parser.add_argument("--store-dir", default=None,
                        help="train out of core from this ratings store directory (mmap + "
                             "streamed slabs) instead of loading the dataset into memory")
    parser.add_argument("--build-store", action="store_true",
                        help="with --store-dir: build the store from the selected dataset's "
                             "train split first, then train from it")
    parser.add_argument("--slab-steps", type=int, default=256,
                        help="steps per streamed slab (store mode)")
    parser.add_argument("--prefetch-slabs", type=int, default=2,
                        help="bounded prefetch queue depth (store mode)")
    parser.add_argument("--ckpt-every-slabs", type=int, default=0,
                        help="mid-epoch checkpoint every N slabs (store mode; 0 = epoch "
                             "boundaries only)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their plain versions")
    args = parser.parse_args(argv)

    train_ds = test_ds = None
    if args.store_dir is None or args.build_store:
        ds = paper_dataset(args.dataset, seed=args.seed, scale=args.scale)
        train_ds, test_ds = train_test_split(ds, 0.2, seed=args.seed)
    if args.store_dir is not None:
        if args.build_store:
            build_store(train_ds, args.store_dir)
            print(f"built store: {len(train_ds)} ratings at {args.store_dir}")
        # the point of the store: the ratings never have to fit in host memory
        train_ds = None
    config = TrainConfig(
        k=args.k, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr, lam=args.lam,
        pruning_rate=args.pruning_rate, optimizer=args.optimizer, strategy=args.strategy,
        init_method=args.init, variant=args.variant, objective=args.objective,
        implicit_alpha=args.implicit_alpha, implicit_negatives=args.implicit_negatives,
        use_fused_kernel=args.use_fused_kernel,
        epoch_mode=args.epoch_mode, seed=args.seed, checkpoint_dir=args.ckpt,
        checkpoint_every_epochs=args.ckpt_every, store_dir=args.store_dir,
        slab_steps=args.slab_steps, prefetch_slabs=args.prefetch_slabs,
        checkpoint_every_slabs=args.ckpt_every_slabs,
    )
    trainer = DPMFTrainer(config, train_ds, test_ds, device=args.device)
    if trainer.maybe_restore():
        slab = f", slab {trainer._resume_slab}" if trainer._resume_slab else ""
        print(f"resumed from checkpoint at epoch {trainer.epoch}{slab}")

    detector = StragglerDetector(window=20, z_threshold=4.0)
    try:
        while trainer.epoch < config.epochs:
            record = run_with_retries(trainer.run_epoch, max_retries=3)
            straggler = detector.record(record.wall_time_s)
            print(
                f"epoch {record.epoch:3d}  mae={record.test_mae:.4f}  "
                f"work={record.work_fraction:.3f}  t={record.wall_time_s:.2f}s"
                + ("  [straggler-flagged]" if straggler else "")
            )
    except KeyboardInterrupt:
        # an interrupted run leaves the checkpoint in flight complete
        if trainer._ckpt is not None:
            trainer._ckpt.wait()
        raise
    trainer.finish()
    print(json.dumps({
        "device": str(trainer.device),
        "final_mae": trainer.history[-1].test_mae if trainer.history else None,
        "work_speedup": work_speedup(trainer.history),
        "total_time_s": trainer.total_train_time(),
        "t_p": float(trainer.t_p),
        "t_q": float(trainer.t_q),
    }, indent=2))


if __name__ == "__main__":
    main()
