"""Smoke of the port's out-of-core data path, on the card (or the CPU with
``--device cpu``).

Three gates, each fatal on failure:

1. **store build + streamed training**: converts a synthetic ratings
   dataset into an on-disk columnar store and trains two epochs from it
   through the bounded-prefetch slab loader;
2. **mid-epoch kill + resume, bitwise**: repeats the run but kills the
   process-equivalent (a ``KeyboardInterrupt`` injected into the slab scan)
   partway through epoch 1, restores from the mid-epoch checkpoint, and
   asserts every parameter/optimizer tensor AND the logged epoch metrics
   are bitwise identical to the uninterrupted run;
3. **eviction-armed online launcher**: runs ``repro_torch.launch.online``
   with ``--evict-max-users`` small enough that the poisson new-user
   stream forces live eviction/compaction rounds, and checks the report
   says so.

Usage:  PYTHONPATH=src python tools/torch_scale_smoke.py [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import repro_torch.core.trainer as trainer_lib  # noqa: E402
from repro_torch.core.trainer import DPMFTrainer, TrainConfig  # noqa: E402
from repro_torch.data import synthetic_ratings  # noqa: E402
from repro_torch.device import device_name  # noqa: E402
from repro_torch.store import RatingsStore, build_store  # noqa: E402


def _cfg(store_dir: str, ckpt_dir: str | None) -> TrainConfig:
    return TrainConfig(
        k=8, epochs=2, batch_size=64, lr=0.05, lam=0.02, pruning_rate=0.5,
        seed=0, store_dir=store_dir, slab_steps=4, prefetch_slabs=2,
        checkpoint_dir=ckpt_dir, checkpoint_every_epochs=1,
        checkpoint_every_slabs=2,
    )


def _train(store_dir: str, ckpt_dir: str | None, device: str, *, kill_after: int = 0):
    """Train 2 epochs; if kill_after > 0, raise after that many slab scans."""
    trainer = DPMFTrainer(_cfg(store_dir, ckpt_dir), device=device)
    resumed = trainer.maybe_restore()
    if resumed:
        print(f"  resumed at epoch {trainer.epoch} "
              f"slab {trainer._resume_slab}")
    calls = {"n": 0}
    original = trainer_lib.mf.train_epoch_scan

    def counting(*args, **kwargs):
        calls["n"] += 1
        if kill_after and calls["n"] > kill_after:
            raise KeyboardInterrupt("injected mid-epoch kill")
        return original(*args, **kwargs)

    trainer_lib.mf.train_epoch_scan = counting
    try:
        while trainer.epoch < trainer.config.epochs:
            trainer.run_epoch()
    except KeyboardInterrupt:
        print(f"  killed after {kill_after} slab scans")
    finally:
        trainer_lib.mf.train_epoch_scan = original
        if trainer._ckpt is not None:
            trainer._ckpt.wait()
    return trainer


def _assert_bitwise(a: DPMFTrainer, b: DPMFTrainer) -> None:
    pairs = [("params.p", a.params.p, b.params.p),
             ("params.q", a.params.q, b.params.q)]
    for name, x, y in pairs:
        assert torch.equal(x, y), f"{name} diverged after resume"
    for group in a.opt_state._fields:
        ga, gb = getattr(a.opt_state, group), getattr(b.opt_state, group)
        if isinstance(ga, dict):
            for key in ga:
                assert torch.equal(ga[key], gb[key]), (
                    f"opt_state.{group}[{key}] diverged after resume")
    ra, rb = a.history[-1], b.history[-1]
    assert ra.train_abs_err == rb.train_abs_err, (
        f"epoch metric diverged: {ra.train_abs_err!r} vs "
        f"{rb.train_abs_err!r}")
    print("  bitwise parity: params, opt_state, epoch metrics all equal")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    workdir = tempfile.mkdtemp(prefix="torch_scale_smoke_")
    report = {}
    try:
        # ---- gate 1: build a store and stream-train from it --------------
        print(f"[1/3] build store + streamed 2-epoch training on "
              f"{device_name(args.device)}")
        t0 = time.perf_counter()
        ds = synthetic_ratings(400, 120, 4096, seed=0)
        store_dir = os.path.join(workdir, "store")
        build_store(ds, store_dir)
        store = RatingsStore(store_dir)
        assert len(store) == len(ds), "store lost ratings"
        baseline = _train(store_dir, None, args.device)
        assert len(baseline.history) == 2
        print(f"  mae trajectory: "
              f"{[round(r.test_mae, 4) for r in baseline.history]}")
        report["train_s"] = time.perf_counter() - t0

        # ---- gate 2: kill mid-epoch-1, resume, demand bitwise parity -----
        print("[2/3] mid-epoch kill + resume (bitwise)")
        ckpt_dir = os.path.join(workdir, "ckpt")
        # epoch 0 has num_slabs scans; kill 3 scans into epoch 1, after the
        # slab-2 mid-epoch checkpoint has been written
        num_slabs = baseline._loader.num_slabs
        assert num_slabs >= 4, "need >=4 slabs for a mid-epoch kill"
        _train(store_dir, ckpt_dir, args.device, kill_after=num_slabs + 3)
        resumed = _train(store_dir, ckpt_dir, args.device)
        _assert_bitwise(baseline, resumed)
        report["slabs"] = num_slabs

        # ---- gate 3: online launcher with eviction armed -----------------
        print("[3/3] launch.online with cold-row eviction armed")
        report_path = os.path.join(workdir, "online_report.json")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.abspath(SRC)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.online",
             "--device", args.device,
             "--train-epochs", "2", "--events", "640", "--batch-events", "16",
             "--swap-every", "4", "--source", "poisson",
             "--new-id-prob", "0.5", "--evict-max-users", "60",
             "--json", report_path],
            env=env, capture_output=True, text=True, timeout=900,
        )
        sys.stdout.write(proc.stdout[-2000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise AssertionError("launch.online exited nonzero")
        with open(report_path) as f:
            online = json.load(f)
        ev = online.get("eviction")
        assert ev is not None, "report missing eviction section"
        assert ev["rounds"] >= 1, "eviction never triggered: smoke too small"
        assert ev["physical_users"] <= 60, "eviction failed to bound residency"
        print(f"  eviction rounds={ev['rounds']} evicted={ev['evicted_total']}"
              f" live={ev['physical_users']} remap_epoch={ev['remap_epoch']}")
        report.update(eviction_rounds=ev["rounds"], evicted=ev["evicted_total"],
                      live_users=ev["physical_users"])
        print("scale-smoke: all gates passed")
        return report
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
