#!/usr/bin/env python3
"""Time the parts of ``ServingEngine.swap`` on one card, at the dpmf serving
size of ``chip_smoke.py`` (FunkSVD, 100M users x 10M items x k = 128,
float32, thresholds for pruning rate 0.3, 1% of the items perturbed).

    python3 tools/profile_swap.py [--users N] [--reps R]

Each part of a touched-rows patch and of a full rebuild is run on its own
between two ``torch.cuda.synchronize()`` calls and timed both on the host
clock and by CUDA events, then the whole swap is timed the same way and
traced once by ``torch.profiler`` (the ops by host time, then by device
time).  FunkSVD has no biases, so the user count only sizes ``p``; ``--users``
cuts it.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import mf  # noqa: E402
from repro_torch.core.ranks import effective_ranks  # noqa: E402
from repro_torch.core.threshold import thresholds_from_matrices  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.engine import _Snapshot  # noqa: E402

ITEMS, K, RATE, TOPK, SEED = 10_000_000, 128, 0.3, 100, 0


def timed(label, fn, reps):
    """Mean host and device ms of ``fn`` over ``reps`` synchronized calls."""
    host = dev = 0.0
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        host += (time.perf_counter() - t0) * 1e3
        dev += start.elapsed_time(end)
    print(f"  {label:52s} host {host / reps:9.3f} ms   events {dev / reps:9.3f} ms", flush=True)
    return out


def profile(label, fn):
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(f"## torch.profiler, {label}: by host time", flush=True)
    print(events.table(sort_by="cpu_time_total", row_limit=15), flush=True)
    print(f"## torch.profiler, {label}: by device time", flush=True)
    print(events.table(sort_by="cuda_time_total", row_limit=10), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=100_000_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_swap.py: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sigma = 0.1 * torch.exp(-2.0 * torch.arange(K, device=dev, dtype=torch.float32) / K)
    q = torch.randn((ITEMS, K), generator=gen, device=dev).mul_(sigma)
    p = torch.randn((args.users, K), generator=gen, device=dev).mul_(sigma)
    t_p, t_q = thresholds_from_matrices(p, q, RATE)
    params = mf.MFParams(p=p, q=q, user_bias=None, item_bias=None, global_mean=None, implicit=None)
    engine = ServingEngine(params, t_p, t_q, max_batch=256)
    users = np.arange(256) * (args.users // 256)
    engine.topk(users, TOPK)  # builds the kernel layout

    touched = torch.randperm(ITEMS, generator=gen, device=dev)[: ITEMS // 100]
    q_new = q.clone()
    q_new[touched] = torch.randn((touched.numel(), K), generator=gen, device=dev).mul_(sigma)
    new_params = params._replace(q=q_new)
    touched_np = touched.cpu().numpy()
    print(f"# {args.users} users x {ITEMS} items x k={K}, {touched_np.size} touched items, "
          f"mean of {args.reps} calls each", flush=True)
    engine.swap(new_params, touched_users=[], touched_items=touched_np)  # lazy loads
    prev = engine._snap

    print("## patch (touched_items, thresholds unchanged), part by part", flush=True)
    timed("np.unique(touched_items) (not in the swap)", lambda: np.unique(touched_np), args.reps)
    rows = timed("touched ids to the card", lambda: torch.as_tensor(touched_np).to(dev), args.reps)
    r_i = timed("clone of the previous r_i", lambda: prev.r_i.clone(), args.reps)
    q_rows = timed("gather q[rows]", lambda: q_new[rows], args.reps)
    r_rows = timed("effective_ranks(q[rows])", lambda: effective_ranks(q_rows, t_q), args.reps)

    def scatter():
        r_i[rows] = r_rows

    timed("scatter into the clone", scatter, args.reps)
    cache = timed("_carry_cache", lambda: engine._carry_cache(
        prev, new_params, np.zeros(0, np.int64), touched_np, None, None), args.reps)

    def snapshot(r=r_i, t=t_q):
        return _Snapshot(prev.version + 1, new_params, t_p, t, device=dev, block_n=engine.block_n,
                         cache=cache, user_history=None, r_i=r)

    new = timed("_Snapshot(..., r_i=patched)", snapshot, args.reps)
    timed("clone_layouts_from", lambda: new.clone_layouts_from(prev, rows), args.reps)
    timed("whole swap (patch)", lambda: engine.swap(
        new_params, touched_users=[], touched_items=touched_np), args.reps)

    print("## rebuild (a moved T_q), part by part", flush=True)
    t_q2 = t_q * 1.25
    timed("effective_ranks(q) over the catalog", lambda: effective_ranks(q_new, t_q2), args.reps)
    new = timed("_Snapshot(...) (ranks included)", lambda: snapshot(None, t_q2), args.reps)
    timed("build_like (kernel layout)", lambda: new.build_like(prev), args.reps)
    flip = [t_q, t_q2]

    def rebuild():
        flip.reverse()
        engine.swap(new_params, t_p, flip[0])

    timed("whole swap (rebuild, T_q alternating)", rebuild, args.reps)
    engine.swap(new_params, t_p, t_q)
    profile("one patch swap", lambda: engine.swap(
        new_params, touched_users=[], touched_items=touched_np))
    profile("one rebuild swap", lambda: engine.swap(new_params, t_p, t_q2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
