#!/usr/bin/env python3
"""The multi-rank path across four cards: 4 ranks, one per card, NCCL, a
(2, 2) ("data", "model") mesh, dpmf at its full 100M users x 10M items x
128 with adagrad.

    python3 tools/multirank_nccl.py        # on a host with 4 CUDA cards

Runs ``chip_smoke.py``'s multirank-dpmf rank functions with
``RankPool(4, backend="nccl")``: the parity checks at 2^16 x 2^15 (the
sharded step against the single-device step, the sharded updater, a
(2, 2) checkpoint restored onto (1, 4)), two sharded steps of 2^20 ratings
in modes none and int8 (the last timed by part, the replicas of every block
bitwise equal; int8_ef's residuals, 28.2 GB a card more, do not fit beside
56.3 GB of blocks), then ``topk_sharded`` (top-100, 256 users) and
``evaluate_engine(mesh=)`` on an engine of the full tables on every card,
against rank 0's ``engine.topk``.  Prints its checks, then one JSON object
on the last line; exits non-zero without 4 cards or when a check fails.
Imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if torch.cuda.device_count() < 4:
        print("multirank_nccl.py: needs 4 CUDA cards", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.testing.ranks import RankPool

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    build.build_all()
    out = {"cards": smi, "torch": torch.__version__}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            RankPool(4, backend="nccl", device="cuda", timeout_s=300.0) as pool:
        out["spawn_s"] = time.perf_counter() - t0
        small = pool.run(cs._mr_small, os.path.join(tmp, "ckpt"), cs.MR_SMALL)
        steps = {k: max(r[k][1] for r in small) for k in small[0] if k.startswith("step")}
        cs.check(all(v <= 2e-8 for v in steps.values()),
                 f"sharded steps within 2e-8 + 1e-6 |x| of the single-device step {steps}")
        cs.check(all(cs._mr_replicas_agree([r[k] for r in small])
                     for k in small[0] if k.startswith("digest")),
                 "the replicas of every block hold the same bits")
        cs.check(max(r["updater"] for r in small) <= 2e-7,
                 "the sharded updater within 2e-7 of the single-device updater")
        cs.check(all(r["restore bitwise"] for r in small), "the (2, 2) -> (1, 4) restore, bitwise")
        for mode in ("none", "int8"):
            res = pool.run(cs._mr_train, mode, cs.MR_STEPS, cs.N_USERS, cs.N_ITEMS, cs.MR_BATCH)
            cs.check(all(r["finite"] for r in res) and len({r["abs_err"] for r in res}) == 1
                     and cs._mr_replicas_agree([r["digests"] for r in res]),
                     f"{mode}: finite, metrics equal on every rank, replicas bitwise equal")
            out[mode] = {k: v for k, v in res[0].items() if k not in ("digests", "peak_gb")}
            out[mode]["peak_gb"] = [r["peak_gb"] for r in res]
        pool.run(cs._mr_release)
        users = np.random.default_rng(cs.SEED + 82).integers(0, cs.N_USERS, cs.TOPK_USERS)
        serve = pool.run(cs._mr_serve, users, cs.N_USERS, cs.N_ITEMS, 1 << 18)
        r0 = serve[0]
        cs.compare_topk(torch.as_tensor(r0["got"][0]), torch.as_tensor(r0["got"][1]),
                        torch.as_tensor(r0["want"][0]), torch.as_tensor(r0["want"][1]),
                        f"topk_sharded vs rank 0's engine.topk (top-{cs.TOPK})")
        cs.check(r0["report"] == r0["local_report"]
                 and all(r["slab"]["near"] and r["slab"]["ids_outside_ties"] for r in serve)
                 and all(r["launches"] > 0 for r in serve),
                 "evaluate_engine(mesh=) equals the local engine's; every rank's kernel against "
                 "the plain version on its slab; pruned_topk launched on every rank")
        out["serve"] = dict(sharded_ms=r0["sharded_ms"], local_ms=r0["local_ms"],
                            launches=[r["launches"] for r in serve],
                            peak_gb=[r["peak_gb"] for r in serve])
    out["total_s"] = time.perf_counter() - t0
    out["failures"] = cs.failures
    print(json.dumps(out, default=str))
    return 1 if cs.failures else 0


if __name__ == "__main__":
    sys.exit(main())
