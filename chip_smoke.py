#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: drives its serving, swap, SLO,
training, ranking-evaluation, implicit and BPR, online freshness,
out-of-core (ratings store, streamed training, eviction), serving-fleet,
multi-rank and recsys (FM, DLRM, SASRec with its sessions, BST) paths on
one card.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA card

Imports nothing of JAX or of the ``repro`` package.  In one process (the
fleet-process phase spawns replica children, the multirank phase 4 ranks,
and the launcher phases run subprocesses; every one is stopped before the
script exits) it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` per source, in parallel) and prints each one's
   registers, shared memory and spills;
3. serving: holds ``pruned_topk`` and ``pruned_matmul`` against their plain
   PyTorch versions on the card at the serving path's shapes, without and
   with pruning (T = 0 and T for rate 0.3), plus an exact case on 1/8-grid
   factors, and times kernel, plain version and a PyTorch yardstick with
   CUDA events (TF32 off); times ``pruned_topk`` at top-1, 100, 1024 and
   4096 and holds the full-size top-4096 launch against the plain version;
   then builds the dpmf model at full size (FunkSVD,
   k = 128, 100M users x 10M items, float32, random factors from a seed)
   with thresholds for rate 0.3 and serves it through ``ServingEngine``
   (``topk`` for 1024 users at top-100, ``recommend``, 32 requests through
   the queue, ``predict_all_items`` for 64 users), with the serving kernels'
   launch counts set to 0 just before and read just after, then times
   ``predict_all_items``' parts (user ranks, ``effective_ranks(q)``, the
   kernel, the rest) with CUDA events; ``pruned_matmul``'s bound is given
   both for fp32 CUDA cores and for the 3xTF32 tensor-core products it runs;
   then hot-swaps the served model to a new ``q`` with 1% of the items
   perturbed, by the touched-rows patch (twice: the first call pays its
   kernels' lazy loads) and by a full rebuild at a moved ``T_q``, each held
   bitwise against a fresh engine, and serves 1024 users under an eviction
   remap that spills a quarter of them, who must get the fallback ranking
   (counts set to 0 before the swaps and read after); then slo-dpmf: the
   served model behind its queue with an ``SLOController`` and 4 client
   threads at top-100, the budget half the measured p99 (it degrades to
   0.8) and then ten times that (it relaxes to the floor); per apply the
   solve's and the swap's ms, each applied threshold against the solve on
   float64 statistics, the served top-k after each apply bitwise a fresh
   engine's, ``pruned_topk`` at both ends (counted under ``slo``);
4. frees the serving model, then holds ``fused_mf_sgd`` against its plain
   version at the training step's shape (B = 2^20 rows, k = 128, float32) at
   T = 0 and at rate 0.3, with and without bias and weight columns, plus a
   bfloat16 case and an exact case on 1/8-grid rows, and times it; then
   holds ``add_rows`` (the batch-order row scatter of every training step)
   at 2^20 rows x k = 128 into a 10M-row table with the training path's
   skewed items bitwise against the CPU's ``index_add_`` on CPU copies of
   the touched rows and against its plain form in passes, with a bfloat16
   table and two bias vectors, and times it against ``index_add_``;
5. trains a small model (20k users x 5k items x 400k ratings, k = 128,
   3 epochs, rate 0.3) on the card and on the CPU from the same initial
   factors, once with sgd through the fused kernel and once with adagrad,
   and holds the epoch records and the latent permutation to each other;
6. trains dpmf at full size through ``DPMFTrainer.run()`` in scan mode:
   FunkSVD, 100M x 10M x k = 128, sgd with the fused kernel, lr 0.05,
   lam 0.02, rate 0.3, batch 2^20, 3 epochs of 8 steps, on 8 x 2^20 ratings
   made with numpy from the seed (users uniform, items power-law so the
   scatter-adds collide, integer ratings 1-5) and 2^20 test ratings; the
   kernel counts are set to 0 just before ``run()`` and read just after;
   every epoch also logs HR/NDCG/recall@10 over 512 test users (two
   256-user ``pruned_topk`` launches an epoch, counted); the last epoch's
   ids are held against the plain version's and one evaluation is timed;
   then one more full-size step is held against the plain masked step
   recomputed on the CPU over the touched rows only, two steps from one
   state must give the same bits, and the stages of the step are timed one
   by one (the scatter both as ``add_rows`` and as ``index_add_``);
7. ranking evaluation: ``evaluate_engine`` (the ``pruned_topk`` kernel)
   against ``evaluate_oracle`` (``pruned_matmul`` and a stable sort of the
   (B, n) scores) at T = 0 on 1/8-grid factors, 100k users x 1M items x
   k = 128, 512 users in 16-user batches, half of each user's 20 held-out
   items drawn from the oracle's top-100: the reports must be equal and
   every user must hit (counts set to 0 before and read after); then each
   batch of ``engine.topk`` is held against ``dense_topk`` and one batch of
   ``predict_all_items`` against the plain ``pruned_matmul``, exactly;
8. inputs the kernels refused before: ``pruned_topk`` at 65535 x 128 + 1
   users in one call, ``pruned_matmul`` at k = 520 and 1024 and
   ``fused_mf_sgd`` at k = 1030 and 2048, each against its plain version
   (random factors within the tolerance, 1/8-grid factors exactly) and
   timed;
9. implicit-dpmf: ``DPMFTrainer.run()`` under ``objective="implicit"`` at
   100M x 10M x k = 128 (8 x 2^20 interactions, alpha 40, 4 negatives each,
   2 epochs of 40 steps, sgd through ``fused_mf_sgd`` with the confidence
   as its weight column, lr 0.05 / 201, ranking evaluation every epoch),
   counts set to 0 just before and read just after; then one weighted step
   against the plain masked step on the CPU over the touched rows;
10. bpr-dpmf: one BPR epoch of 8 steps of 2^20 triples at the same size
   (masked tensor ops: the reference has no kernel for it), then one pruned
   step against the plain ``bpr_step_ref`` over the touched rows (random
   factors within the tolerance, 1/8-grid rows exactly), timed;
11. online-dpmf: at k = 128, 10M items and 20M users (two copies of the
   tables live at once), an sgd ``OnlineUpdater`` fed 64 rated Poisson
   batches of 4096 events, 3 batches without new items, a forced
   recalibration and 64 click batches through ``implicit_microbatches``,
   new ids at p = 0.001, a ``SnapshotPublisher``
   swap every 4 batches into a live ``ServingEngine`` answering 4 client
   threads, delta checkpoints in the rated half, both prequential
   evaluators (the ranking one through the engine); after every publish a
   probe batch equals a fresh engine on a copy of the version, a batch
   started before an apply returns its version's answer, the delta chain
   folds to the live tables; ``pruned_topk`` counted under ``online``;
12. runs ``python -m repro_torch.launch.online --use-kernel`` at a small size
   (exit 0, its report on one line);
13. store-dpmf: ``DPMFTrainer.run()`` in store mode at 100M x 10M x 128:
   2^25 ratings built into a ratings store (then dropped from memory),
   streamed as 4 slabs of 8 x 2^20 an epoch through a 2-deep prefetch
   queue, sgd through ``fused_mf_sgd`` every step, 2 epochs with
   HR/NDCG/recall@10; a ``FailureInjector`` fails epoch 1's first slab once
   (``max_step_retries`` 1); anonymous RSS read after every slab and held
   flat; per slab the host permutation, gather, copy and step ms; one
   streamed step against the plain step on the CPU, one ranking batch
   against the plain version (counts under ``store``);
14. store-resume: at 2^20 x 2^17 x 128, a run killed mid-epoch 1 and
   resumed from its slab checkpoint against an uninterrupted run (within
   1e-4), and a ``checkpoint.fsync`` fault that leaves the latest step;
15. evict-dpmf: at 20M users x 10M items x 128, an updater with a
   ``UserEvictor`` (20M rows, target 20M - 2^21), a publisher and an
   engine; 16 batches of 4096 events, a compaction, a ``kind=full``
   publish, 4096 spilled users revived bitwise, probes against a fresh
   engine and the plain version, the fallback for spilled users, victims
   against ``np.lexsort`` (counts under ``evict``);
16. runs ``launch.train --store-dir --build-store`` twice (the second
   resumes) and ``launch.online --evict-max-users`` on the card;
17. fleet-local: 3 ``LocalReplica``s of 10M users x 10M items x 128 behind
   the affinity router, an sgd updater's publisher (its defaults:
   compressed deltas) subscribed, 32 Poisson batches of 4096 events without new ids (every
   message a delta), a publish every 4, 4 clients at top-10, one SLO
   degrade and relax rolled out; wire/raw bytes, encode and rolling-apply
   ms; every replica bitwise a fresh engine on the published state
   (counted under ``fleet_local``);
18. fleet-process: ``ServingFleet(backend="process")``, 2 children on the
   card at 2^19 x 2^18 x 128, under ``fleet.supervise`` and a publisher
   with the launchers' settings; the host codec's MB/s; a seeded kill of
   r0 respawned from r1's raw state (MTTR and the child's boot by part), a
   corrupted delivery NAKed and healed; both children's served state and
   top-k bitwise a fault-free shadow's (each child's own counts under
   ``fleet_process``);
19. multirank-dpmf: 4 ranks spawned on the card (``RankPool``, gloo over
   CUDA tensors), a (2, 2) ("data", "model") mesh, dpmf's width and
   catalog with the users cut to 2^22 and adagrad: at 2^16 x 2^15 the
   sharded step against the single-device ``train_step`` (bitwise: both
   scatter through ``add_rows``), the sharded updater against the single-device one
   (2e-7) and a (2, 2) checkpoint ``elastic_load``-ed onto (1, 4)
   (bitwise); then two sharded steps of 2^20 ratings in each of none, int8
   and int8_ef, the last timed by part with the bytes of each collective,
   every block's replicas bitwise equal; ``topk_sharded`` (top-100, 256
   users) and ``evaluate_engine(mesh=)`` over 512 users, ``pruned_topk``
   counted on every rank (under ``multirank``), held against rank 0's
   ``engine.topk`` and each rank's kernel against the plain version on a
   slice of its slab; ``OnlineUpdater(mesh=)`` with new ids;
20. runs ``launch.serve --replicas 2 --replica-backend process
   --slo-p99-ms`` and ``launch.online --replicas 2 --supervise
   --slo-p99-ms`` on a small checkpoint (exit 0);
21. recsys: FM (39 x 2^20 x k = 10), SASRec (2^20 items x k = 50, 2
   blocks), BST and DLRM (k = 128, MLPerf's MLPs, each table cut to 2^23
   rows: 23.6 of 96.1 GB) at their published widths with random weights from
   the seed; counted under ``recsys``: FM's forward at 512 and
   ``fm_retrieval`` of 512 contexts against 1M candidates (one
   ``pruned_matmul`` launch), ``sasrec_retrieval`` of 512 sessions against
   1M candidates (one more), 4096 sessions served at top-100 by
   ``serve_sessions`` (``pruned_topk``, one launch a 256-session chunk),
   SASRec's, BST's and DLRM's losses with their backward at 65,536 rows,
   and BST's and DLRM's ranking of 2^18 candidates; then both
   ``pruned_matmul`` answers on 4096-candidate slices and the sessions'
   top-100 against the plain versions, rate 0 against the dense routes
   (bitwise on 1/8-grid operands; the sessions against ``dense_topk``),
   each model at its widths on a 64-row batch on the card against the CPU
   (1e-4 of the largest value), and the timings;
22. prints a ``kernels`` JSON line (``launches`` summed over the counted
   paths, with ``launches_by_path``) and, last, the device JSON line.

The store, checkpoint and spill files live in one temporary directory,
removed at exit; each phase prints the disk it used.

Tolerances: rtol = atol = 1e-5 for float32 (fp32 sums in another order),
2e-2 for bfloat16; indices identical except where the two compared scores
lie within that tolerance; the 1/8-grid cases exactly equal; epoch records
of the card and the CPU within 1e-4 relative (3 epochs of atomics in another
order).  Any failed check exits non-zero without the last line.  Without a
card, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
TF32_PASSES = 3           # pruned_matmul's 3xTF32: three TF32 products per fp32 one
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
RTOL = ATOL = 1e-5
BF16_TOL = 2e-2
RECORD_RTOL = 1e-4
SEED = 0
N_USERS, N_ITEMS, K = 100_000_000, 10_000_000, 128   # src/repro/configs/dpmf.py
RATE = 0.3
TOPK = 100
WIDE_TOPK = 4096   # past the 1024 lists the first kernel could keep
TOPK_USERS, MATMUL_USERS = 256, 64
RANKING_TOPK = 10  # the trainer's per-epoch HR/NDCG/recall@10
C6_ITEMS, C6_ROWS = 200_000, 1 << 16  # pruned_matmul items, fused_mf_sgd row pairs at k > 512
PLAIN_BLOCK_N = 65536
# training main path: dpmf's train_1m batch, lr and lam; sgd + fused kernel
BATCH, TRAIN_STEPS, EPOCHS = 1 << 20, 8, 3
LR, LAM = 0.05, 0.02
# items ~ 1/(i + 10000): item 0 takes ~15 ratings a batch and ~10^5 items
# collide in every batch.  At an offset of 1000 (~120 ratings of item 0 a
# batch) the summed updates of popular items at lr 0.05 grow the tables
# without bound.
ITEM_OFFSET = 10_000
# implicit-dpmf: the confidence 1 + alpha r reaches 1 + 40 * 5 = 201 and
# multiplies a row's step; dpmf's lr 0.05 times 201 diverges (as C4), so the
# lr is dpmf's divided by the largest confidence: no weighted step exceeds
# dpmf's own.  alpha stays the default 40.
IMPLICIT_ALPHA, IMPLICIT_NEGATIVES, IMPLICIT_EPOCHS = 40.0, 4, 2
IMPLICIT_LR = LR / (1.0 + IMPLICIT_ALPHA * 5.0)
# online-dpmf: dpmf's width and catalog, the user table cut to 20M rows.  The
# served version and the updater's live tables are two copies of p and q
# (copy on write after each publish), plus one more for the fresh-engine
# check: at 100M users two copies alone are 112.6 GB.
ONLINE_USERS = 20_000_000
ONLINE_BATCH, ONLINE_BATCHES, PUBLISH_EVERY, CLIENTS, PROBE_USERS = 4096, 64, 4, 4, 256
PATCH_SWAPS = 3   # publishes after a batch without new items (every other one grows q)
NEW_ID_PROB = 0.001
# a zipf(1.3) stream puts ~25% of its events on item 0 (~1040 a 4096-event
# batch), each at confidence 41 in the click half: sgd stays stable while
# lr * sum(w) * (lam + sigma_0^2) < 2, i.e. lr < 0.0016
ONLINE_LR = 0.001
# store-dpmf: 2^25 ratings streamed from a ratings store (4 slabs an epoch)
STORE_RATINGS, STORE_SLAB_STEPS, STORE_PREFETCH, STORE_EPOCHS = 1 << 25, 8, 2, 2
# store-resume: small tables so that each checkpoint is 0.6 GB, not 56 GB; the
# kill lands 6 scans into epoch 1, past its first mid-epoch checkpoint (slab 4)
RESUME_USERS, RESUME_ITEMS, RESUME_RATINGS = 1 << 20, 1 << 17, 1 << 22
RESUME_BATCH, RESUME_SLAB_STEPS, RESUME_CKPT_SLABS, RESUME_KILL = 1 << 16, 4, 4, 6
# evict-dpmf: online-dpmf's tables; a compaction spills 2^21 users
EVICT_SPILL, EVICT_BATCHES = 1 << 21, 16
# slo-dpmf: the served model; a baseline, ticks, and a hold at each end (s)
SLO_BASELINE_S, SLO_TICK_S, SLO_HOLD_S = 2.0, 0.25, 2.0
# fleet-local: 3 in-process replicas of 10M users x the full catalog (10.24
# GB a copy; with the updater's copy and a copy-on-write transient ~51 GB)
FLEET_USERS, FLEET_REPLICAS, FLEET_BATCHES = 10_000_000, 3, 32
# fleet-process: 2 spawned replicas, each with its own CUDA context
PROC_USERS, PROC_ITEMS, PROC_START_TIMEOUT = 1 << 19, 1 << 18, 180.0
LAUNCHER_SLO_MS = 250.0
# multirank-dpmf: 4 ranks on the card, a (2, 2) mesh; the users cut to 2^22 so
# that the four ranks' adagrad tables (29.2 GB summed), int8_ef residuals
# (14.4 GB) and step transients at B = 2^20 (4.6 GB a rank) fit beside five
# CUDA contexts; at 2^23 the int8_ef steps ran out of memory
MR_SHAPE, MR_NAMES = (2, 2), ("data", "model")
MR_USERS, MR_BATCH, MR_STEPS = 1 << 22, 1 << 20, 2
MR_SMALL = (1 << 16, 1 << 15)
MR_ONLINE = (1 << 21, 1 << 22)

failures: list = []
PATH_LAUNCHES: dict = {}  # path -> {kernel: launches in that path's counted run}


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def above(r, k):
    """#{rows with rank > t} for t = 0..k-1."""
    counts = torch.bincount(r.long(), minlength=k + 1).double()
    return counts.flip(0).cumsum(0).flip(0)[1:]


def pair_flops(r_u, r_i, k):
    return 2.0 * float((above(r_u, k) * above(r_i, k)).sum())


def factor_bytes(r_u, r_i, itemsize):
    """Factor elements the pruned product needs: each row's prefix up to its
    own rank, cut at the other side's largest rank."""
    need_u = torch.clamp(r_u, max=int(r_i.max())).double().sum()
    need_i = torch.clamp(r_i, max=int(r_u.max())).double().sum()
    return itemsize * float(need_u + need_i) + 4.0 * (r_u.numel() + r_i.numel())


def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare_topk(got_s, got_i, want_s, want_i, what, exact=False):
    got_s, want_s = got_s.float(), want_s.float()
    err = float((got_s - want_s).abs().max())
    rel = float(((got_s - want_s).abs() / want_s.abs().clamp(min=1e-30)).max())
    near = (got_s - want_s).abs() <= ATOL + RTOL * want_s.abs()
    differ = got_i != want_i
    agree = float((~differ).float().mean())
    log(f"  {what}: max abs err {err:.3e}, max rel err {rel:.3e}, "
        f"index agreement {agree:.6f}, differing indices at near-ties "
        f"{int((differ & near).sum())}")
    if exact:
        check(torch.equal(got_s, want_s) and torch.equal(got_i, want_i),
              f"{what}: scores and indices exactly equal")
    else:
        check(bool(near.all()), f"{what}: scores within rtol/atol {RTOL}")
        check(not bool((differ & ~near).any()), f"{what}: indices identical outside near-ties")
    return err


def decaying_factors(gen, rows, dev):
    """N(0, sigma_t^2) per latent column, sigma_t = 0.1 exp(-2t/k): the
    front-loaded significance that the paper's Alg. 1 leaves."""
    sigma = 0.1 * torch.exp(-2.0 * torch.arange(K, device=dev, dtype=torch.float32) / K)
    return torch.randn((rows, K), generator=gen, device=dev).mul_(sigma)


def reset_launch_counts():
    from repro_torch.kernels import fused_mf_sgd, pruned_matmul, pruned_topk, scatter

    for module in (fused_mf_sgd, pruned_matmul, pruned_topk, scatter):
        module.launches = 0


# ---------------------------------------------------------------------------
# serving: pruned_topk and pruned_matmul, then the dpmf model served
# ---------------------------------------------------------------------------


def serving_path(dev):
    from repro_torch.core import mf
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.kernels import pruned_matmul, pruned_topk
    from repro_torch.serving import ServingEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    q = decaying_factors(gen, N_ITEMS, dev)
    p_topk = decaying_factors(gen, TOPK_USERS, dev)
    p_mm = p_topk[:MATMUL_USERS].contiguous()
    zero_bias = torch.zeros(N_ITEMS, device=dev)
    t_p30, t_q30 = thresholds_from_matrices(p_topk, q, RATE)
    log(f"# kernel phases: q {N_ITEMS}x{K} float32; rate {RATE} -> "
        f"T_p {float(t_p30):.6g}, T_q {float(t_q30):.6g} (from these operands)")
    stats = {"pruned_topk": {"err": 0.0}, "pruned_matmul": {"err": 0.0}}

    # -- kernel phase: pruned_topk ---------------------------------------------
    log(f"## pruned_topk: {TOPK_USERS} users x {N_ITEMS} items x k={K}, top-{TOPK}")
    for label, t_p, t_q in (("T=0", 0.0, 0.0), (f"rate {RATE}", t_p30, t_q30)):
        r_u, r_i = effective_ranks(p_topk, t_p), effective_ranks(q, t_q)
        got_s, got_i = pruned_topk.pruned_topk_ranked(p_topk, q, r_u, r_i, zero_bias, TOPK)
        want_s, want_i = pruned_topk.pruned_topk_plain(
            p_topk, q, r_u, r_i, zero_bias, TOPK, block_n=PLAIN_BLOCK_N)
        torch.cuda.synchronize()
        err = compare_topk(got_s, got_i, want_s, want_i, f"pruned_topk {label}")
        ms = time_ms(lambda: pruned_topk.pruned_topk_ranked(p_topk, q, r_u, r_i, zero_bias, TOPK), 5)
        plain_ms = time_ms(lambda: pruned_topk.pruned_topk_plain(
            p_topk, q, r_u, r_i, zero_bias, TOPK, block_n=PLAIN_BLOCK_N), 2)
        pm = p_topk * (torch.arange(K, device=dev) < r_u[:, None])
        qm = q * (torch.arange(K, device=dev) < r_i[:, None])
        yard_ms = time_ms(lambda: torch.topk(torch.addmm(zero_bias, pm, qm.T), TOPK, dim=1), 2)
        del pm, qm
        flops = pair_flops(r_u, r_i, K)
        nbytes = factor_bytes(r_u, r_i, 4) + 4.0 * N_ITEMS + 8.0 * TOPK_USERS * TOPK
        b_ms, b_by = bound(flops, nbytes)
        log(f"  {label}: mean r_u {float(r_u.float().mean()):.3f}, mean r_i "
            f"{float(r_i.float().mean()):.3f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"yardstick addmm+topk (two calls) {yard_ms:.3f} ms; bound {b_ms:.3f} ms "
            f"({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB)")
        st = stats["pruned_topk"]
        st["err"] = max(st["err"], err)
        st[label] = dict(ms=ms, plain_ms=plain_ms, yard_ms=yard_ms, bound_ms=b_ms, bound_by=b_by)

    # -- breakdown: list length and scoring alone --------------------------------
    log("## pruned_topk breakdown: the same launch at top-1, top-100, top-1024 and "
        "top-4096 (selection = top-100 minus top-1), the scores alone (pruned_matmul "
        "writing the 256 x 10M matrix), and top-4096 held against the plain version")
    for label, t_p, t_q in (("T=0", 0.0, 0.0), (f"rate {RATE}", t_p30, t_q30)):
        r_u, r_i = effective_ranks(p_topk, t_p), effective_ranks(q, t_q)
        got_s, got_i = pruned_topk.pruned_topk_ranked(p_topk, q, r_u, r_i, zero_bias, WIDE_TOPK)
        want_s, want_i = pruned_topk.pruned_topk_plain(
            p_topk, q, r_u, r_i, zero_bias, WIDE_TOPK, block_n=PLAIN_BLOCK_N)
        torch.cuda.synchronize()
        st = stats["pruned_topk"]
        st["err"] = max(st["err"], compare_topk(
            got_s, got_i, want_s, want_i, f"pruned_topk {label} top-{WIDE_TOPK}"))
        del got_s, got_i, want_s, want_i
        times = {
            f"top-{n}": time_ms(lambda n=n: pruned_topk.pruned_topk_ranked(
                p_topk, q, r_u, r_i, zero_bias, n), 3)
            for n in (1, TOPK, 1024, WIDE_TOPK)
        }
        times[f"selection at top-{TOPK}"] = times[f"top-{TOPK}"] - times["top-1"]
        times["scores only"] = time_ms(
            lambda: pruned_matmul.pruned_matmul_ranked(p_topk, q, r_u, r_i), 3)
        st[label]["breakdown_ms"] = times
        torch.cuda.empty_cache()
        # the depth the kernel runs each 128-user x 128-item tile to
        tile_bound = torch.minimum(r_u.view(-1, 128).amax(1)[:, None], r_i.view(-1, 128).amax(1)[None, :])
        depth = float(((tile_bound + 7) // 8 * 8).float().mean())
        log(f"  {label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
            + f"; mean tile depth {depth:.2f} of {K}")

    # -- kernel phase: pruned_matmul -------------------------------------------
    log(f"## pruned_matmul: {MATMUL_USERS} users x {N_ITEMS} items x k={K}, float32 out")
    for label, t_p, t_q in (("T=0", 0.0, 0.0), (f"rate {RATE}", t_p30, t_q30)):
        r_u, r_i = effective_ranks(p_mm, t_p), effective_ranks(q, t_q)
        got = pruned_matmul.pruned_matmul_ranked(p_mm, q, r_u, r_i)
        want = pruned_matmul.pruned_matmul_plain(p_mm, q, r_u, r_i)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        log(f"  pruned_matmul {label}: max abs err {err:.3e}, max rel err {rel:.3e}")
        check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)),
              f"pruned_matmul {label}: within rtol/atol {RTOL}")
        del got, want
        ms = time_ms(lambda: pruned_matmul.pruned_matmul_ranked(p_mm, q, r_u, r_i), 5)
        plain_ms = time_ms(lambda: pruned_matmul.pruned_matmul_plain(p_mm, q, r_u, r_i), 2)
        pm = p_mm * (torch.arange(K, device=dev) < r_u[:, None])
        qm = q * (torch.arange(K, device=dev) < r_i[:, None])
        lib_ms = time_ms(lambda: torch.matmul(pm, qm.T), 3)
        del pm, qm
        flops = pair_flops(r_u, r_i, K)
        nbytes = factor_bytes(r_u, r_i, 4) + 4.0 * MATMUL_USERS * N_ITEMS
        b_ms, b_by = bound(flops, nbytes)
        # the units the kernel runs its products on: 3 TF32 passes on the tensor cores
        tc_ms, tc_by = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)
        log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul on "
            f"pre-masked operands {lib_ms:.3f} ms; bound {b_ms:.3f} ms on fp32 CUDA cores "
            f"({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB), {tc_ms:.3f} ms as "
            f"{TF32_PASSES}xTF32 on the tensor cores ({tc_by})")
        st = stats["pruned_matmul"]
        st["err"] = max(st["err"], err)
        st[label] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         bound_tc_ms=tc_ms, bound_tc_by=tc_by)
        torch.cuda.empty_cache()

    # -- exact case: 1/8-grid factors, T = 0 -----------------------------------
    log("## exact case: 1/8-grid factors with duplicated items, T = 0")
    g_n = 200_000
    gp = torch.randint(-16, 17, (TOPK_USERS, K), generator=gen, device=dev).float() / 8
    gq = torch.randint(-16, 17, (g_n, K), generator=gen, device=dev).float() / 8
    dup = torch.randint(0, g_n, (2, g_n // 2), generator=gen, device=dev)
    gq[dup[0]] = gq[dup[1]]
    gb = torch.randint(-16, 17, (g_n,), generator=gen, device=dev).float() / 8
    g_ru = torch.full((TOPK_USERS,), K, dtype=torch.int32, device=dev)
    g_ri = torch.full((g_n,), K, dtype=torch.int32, device=dev)
    got_s, got_i = pruned_topk.pruned_topk_ranked(gp, gq, g_ru, g_ri, gb, TOPK)
    want_s, want_i = pruned_topk.pruned_topk_plain(gp, gq, g_ru, g_ri, gb, TOPK, block_n=PLAIN_BLOCK_N)
    compare_topk(got_s, got_i, want_s, want_i, "pruned_topk grid", exact=True)
    got = pruned_matmul.pruned_matmul_ranked(gp[:MATMUL_USERS].contiguous(), gq, g_ru[:MATMUL_USERS].contiguous(), g_ri)
    want = pruned_matmul.pruned_matmul_plain(gp[:MATMUL_USERS], gq, g_ru[:MATMUL_USERS], g_ri)
    check(torch.equal(got, want), "pruned_matmul grid: exactly equal")
    del gp, gq, gb, got, want, p_topk, p_mm, zero_bias
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- main path: the dpmf model served at full size ---------------------------
    log(f"## serving main path: dpmf FunkSVD {N_USERS} users x {N_ITEMS} items x k={K}, float32")
    torch.cuda.reset_peak_memory_stats()
    p = decaying_factors(gen, N_USERS, dev)
    t_p, t_q = thresholds_from_matrices(p, q, RATE)
    r_u_all = effective_ranks(p, t_p)
    r_i_all = effective_ranks(q, t_q)
    work = float((above(r_u_all, K) / N_USERS * above(r_i_all, K) / N_ITEMS).sum()) / K
    log(f"  rate {RATE}: T_p {float(t_p):.6g}, T_q {float(t_q):.6g}; mean r_u "
        f"{float(r_u_all.float().mean()):.3f}, mean r_i {float(r_i_all.float().mean()):.3f}, "
        f"pair work fraction {work:.4f}")
    del r_u_all, r_i_all
    params = mf.MFParams(p=p, q=q, user_bias=None, item_bias=None, global_mean=None, implicit=None)
    t0 = time.perf_counter()
    engine = ServingEngine(params, t_p, t_q, max_batch=256)
    torch.cuda.synchronize()
    log(f"  engine built on {engine.device} in {time.perf_counter() - t0:.2f} s")
    rng = torch.Generator().manual_seed(SEED)
    users = torch.randint(0, N_USERS, (1024,), generator=rng).numpy()
    engine.topk(users[:256], TOPK)  # warm-up outside the counted run
    mf.predict_all_items(params, torch.as_tensor(users[:2], device=dev), t_p, t_q)
    torch.cuda.synchronize()

    reset_launch_counts()
    t_main = time.perf_counter()
    t0 = time.perf_counter()
    top_s, top_i = engine.topk(users, TOPK)
    t_topk = time.perf_counter() - t0
    recs = engine.recommend(users[:3])
    t0 = time.perf_counter()
    futures = [engine.submit(int(u), TOPK, timeout=120) for u in users[:32]]
    queued = [f.result(timeout=120) for f in futures]
    t_queue = time.perf_counter() - t0
    engine.stop()
    mm_users = torch.as_tensor(users[:MATMUL_USERS], device=dev)
    t0 = time.perf_counter()
    scores_all = mf.predict_all_items(params, mm_users, t_p, t_q)
    torch.cuda.synchronize()
    t_mm = time.perf_counter() - t0
    wall = time.perf_counter() - t_main
    launches = {"pruned_topk": pruned_topk.launches, "pruned_matmul": pruned_matmul.launches}
    PATH_LAUNCHES["serving"] = launches
    served = len(users) + len(recs) + len(queued)
    log(f"  launches on the serving path: {launches}")
    log(f"  engine.topk: {len(users)} users in {t_topk:.3f} s ({len(users) / t_topk:.1f} req/s); "
        f"queue: {len(queued)} single-user requests in {t_queue:.3f} s "
        f"({len(queued) / t_queue:.1f} req/s); predict_all_items {MATMUL_USERS} users in "
        f"{t_mm:.3f} s")
    log(f"  requests served {served} in {wall:.3f} s ({served / wall:.1f} req/s)")
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the serving path ({count})")

    check(top_s.shape == (1024, TOPK) and bool(np.isfinite(top_s).all()),
          "topk scores finite, shape (1024, 100)")
    check(bool(((top_i >= 0) & (top_i < N_ITEMS)).all()), "topk indices in range")
    check(bool((top_s[:, :-1] >= top_s[:, 1:]).all()), "topk scores descending")
    check(len(recs) == 3 and all(len(r) == 10 for r in recs), "recommend: 3 users x 10 items")
    check(all(s.tobytes() == top_s[j].tobytes() and i.tobytes() == top_i[j].tobytes()
              for j, (s, i) in enumerate(queued)),
          "queue rows byte-identical to engine.topk rows")
    pu = p[torch.as_tensor(users[:32], device=dev)]
    r_u = effective_ranks(pu, t_p)
    want_s, want_i = pruned_topk.pruned_topk_plain(
        pu, q, r_u, engine.r_i, torch.zeros(N_ITEMS, device=dev), TOPK, block_n=PLAIN_BLOCK_N)
    compare_topk(torch.as_tensor(top_s[:32], device=dev), torch.as_tensor(top_i[:32], device=dev),
                 want_s, want_i, "serving main path: 32 users vs plain")
    check(scores_all.shape == (MATMUL_USERS, N_ITEMS) and bool(torch.isfinite(scores_all).all()),
          "predict_all_items finite, shape (64, 10M)")
    cut = 1_000_000
    pm_u = p[mm_users]
    want = pruned_matmul.pruned_matmul_plain(pm_u, q[:cut], effective_ranks(pm_u, t_p), engine.r_i[:cut])
    err = float((scores_all[:, :cut] - want).abs().max())
    log(f"  predict_all_items vs plain on the first {cut} items: max abs err {err:.3e}")
    check(bool(torch.allclose(scores_all[:, :cut], want, rtol=RTOL, atol=ATOL)),
          "predict_all_items within rtol/atol of plain")
    log(f"  peak device memory (max_memory_allocated) {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # -- where predict_all_items' time goes (CUDA events, after the counted run)
    pu = mf._user_vector(params, mm_users, None)
    r_u = effective_ranks(pu, t_p)
    parts = {
        "gather p[u] + effective_ranks of the users": lambda: effective_ranks(
            mf._user_vector(params, mm_users, None), t_p),
        f"effective_ranks(q) over {N_ITEMS} items": lambda: effective_ranks(q, t_q),
        "pruned_matmul kernel": lambda: pruned_matmul.pruned_matmul_ranked(pu, q, r_u, engine.r_i),
        "whole predict_all_items": lambda: mf.predict_all_items(params, mm_users, t_p, t_q),
    }
    part_ms = {name: time_ms(fn, 3) for name, fn in parts.items()}
    part_ms["rest"] = part_ms["whole predict_all_items"] - sum(
        v for name, v in part_ms.items() if name != "whole predict_all_items")
    log(f"  predict_all_items for {MATMUL_USERS} users, by part: "
        + "; ".join(f"{name} {v:.3f} ms" for name, v in part_ms.items()))
    del pu, r_u, scores_all, want, pm_u
    torch.cuda.empty_cache()
    swap_stats = swap_path(dev, engine, params, t_p, t_q, users)

    rows = []
    main_label = f"rate {RATE}"
    for name, replaces, source in (
        ("pruned_topk", "src/repro/kernels/pruned_topk.py:157",
         "src/repro_torch/kernels/csrc/pruned_topk.cu"),
        ("pruned_matmul", "src/repro/kernels/pruned_matmul.py:97",
         "src/repro_torch/kernels/csrc/pruned_matmul.cu"),
    ):
        st = stats[name][main_label]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": stats[name]["err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st.get("lib_ms"),
            "dense_ms": stats[name]["T=0"]["ms"], "dense_bound_ms": stats[name]["T=0"]["bound_ms"],
        }
        if name == "pruned_matmul":
            row["bound_tc_ms"] = st["bound_tc_ms"]
            row["dense_bound_tc_ms"] = stats[name]["T=0"]["bound_tc_ms"]
            row["predict_all_items_ms"] = part_ms
        if name == "pruned_topk":
            row["swap"] = swap_stats
            row["breakdown_ms"] = st["breakdown_ms"]
            row["yardstick_ms"] = st["yard_ms"]
            row["yardstick"] = "torch.addmm + torch.topk on pre-masked operands (two calls)"
        rows.append(row)
    return rows, (params, t_p, t_q)  # the served model, for slo-dpmf


def swap_path(dev, engine, params, t_p, t_q, users):
    """The served dpmf model hot-swapped at full size: a new q with 1% of
    the items perturbed, first by the touched-rows patch and then by a full
    rebuild at a moved item threshold, each against a fresh engine on the
    same params; then an eviction remap under which the evicted users get
    the bias-only fallback.  The kernels' counts are set to 0 just before
    and read just after."""
    from repro_torch.kernels import pruned_topk
    from repro_torch.serving import ServingEngine

    log(f"## hot swap at full size: 1% of the {N_ITEMS} items perturbed, then a moved T_q, "
        "then an eviction remap")
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    touched = torch.randperm(N_ITEMS, generator=gen, device=dev)[: N_ITEMS // 100]
    q_new = params.q.clone()
    q_new[touched] = decaying_factors(gen, touched.numel(), dev)
    new_params = params._replace(q=q_new)
    touched_np = touched.cpu().numpy()
    batch = users[:256]
    out = {}

    def equal(got, want):
        return np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])

    reset_launch_counts()
    torch.cuda.synchronize()
    for key in ("patch_first_ms", "patch_ms"):  # the first pays the lazy loads of its kernels
        t0 = time.perf_counter()
        engine.swap(new_params, touched_users=[], touched_items=touched_np)
        out[key] = (time.perf_counter() - t0) * 1e3
    got_patch = engine.topk(batch, TOPK)
    t_q2 = t_q * 1.25
    t0 = time.perf_counter()
    engine.swap(new_params, t_p, t_q2)
    out["rebuild_ms"] = (time.perf_counter() - t0) * 1e3
    got_rebuild = engine.topk(batch, TOPK)
    remap = np.arange(N_USERS, dtype=np.int32)
    evicted_users = users[::4]
    remap[evicted_users] = -1
    t0 = time.perf_counter()
    engine.swap(new_params, t_p, t_q, user_remap=remap, remap_epoch=1)
    out["remap_ms"] = (time.perf_counter() - t0) * 1e3
    got_remap = engine.topk(users, TOPK)
    torch.cuda.synchronize()
    launches = {"pruned_topk": pruned_topk.launches}
    PATH_LAUNCHES["swap"] = launches
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["extra_gb"] = out["peak_gb"] - base_gb
    log(f"  launches: {launches}; swap (patch, {touched.numel()} items) {out['patch_first_ms']:.1f} "
        f"ms the first time, {out['patch_ms']:.1f} ms again, "
        f"swap (rebuild, T_q x 1.25) {out['rebuild_ms']:.1f} ms, swap (remap epoch 1) "
        f"{out['remap_ms']:.1f} ms; device memory {base_gb:.2f} GB before, peak "
        f"{out['peak_gb']:.2f} GB (+{out['extra_gb']:.2f} GB)")
    check(launches["pruned_topk"] > 0, f"pruned_topk launched on the swap path ({launches})")
    check(engine.version == 4 and engine.remap_epoch == 1, "four swaps published")

    fresh = ServingEngine(new_params, t_p, t_q, max_batch=256)
    want = fresh.topk(users, TOPK)
    check(equal(got_patch, (want[0][:256], want[1][:256])),
          "patch swap equals a fresh engine on the new params, bit for bit")
    fresh2 = ServingEngine(new_params, t_p, t_q2, max_batch=256)
    check(equal(got_rebuild, fresh2.topk(batch, TOPK)),
          "rebuild swap (T_q x 1.25) equals a fresh engine, bit for bit")
    del fresh, fresh2
    evicted = remap[users] < 0
    fs, fi = engine._snap.fallback_topk(TOPK)
    check(bool((got_remap[1][evicted] == fi).all() and (got_remap[0][evicted] == fs).all())
          and np.array_equal(fi, np.arange(TOPK)),
          f"{int(evicted.sum())} evicted users get the fallback (funk: items 0..{TOPK - 1})")
    check(np.array_equal(got_remap[1][~evicted], want[1][~evicted])
          and np.array_equal(got_remap[0][~evicted], want[0][~evicted]),
          "resident users under the remap get their own rows, bit for bit")
    return out


def grid_tensor(gen, shape, dev):
    """Values on the 1/8 grid in [-2, 2]: products and sums stay exact."""
    return torch.randint(-16, 17, shape, generator=gen, device=dev).float() / 8


def repairs_phase(dev):
    """Inputs the kernels refused before: more than 65535 x 128 users for
    pruned_topk (C5), rows wider than 512 for pruned_matmul and wider than
    1024 for fused_mf_sgd (C6); each against its plain version, random
    factors within the tolerance and 1/8-grid factors exactly."""
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.kernels import fused_mf_sgd, pruned_matmul, pruned_topk

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    out = {}

    m, n, k, topk = 65535 * pruned_topk.BLOCK_M + 1, 256, 8, 10
    log(f"## C5: pruned_topk at {m} users (65535 x 128 + 1) x {n} items x k={k}, top-{topk}, "
        "1/8-grid factors, T = 1/8")
    p, q, bias = grid_tensor(gen, (m, k), dev), grid_tensor(gen, (n, k), dev), grid_tensor(gen, (n,), dev)
    r_u, r_i = effective_ranks(p, 1 / 8), effective_ranks(q, 1 / 8)
    before = pruned_topk.launches
    got_s, got_i = pruned_topk.pruned_topk_ranked(p, q, r_u, r_i, bias, topk)
    launched = pruned_topk.launches - before
    same = True
    for lo in range(0, m, 1 << 21):
        hi = min(lo + (1 << 21), m)
        want_s, want_i = pruned_topk.pruned_topk_plain(p[lo:hi], q, r_u[lo:hi], r_i, bias, topk,
                                                       block_n=n)
        same &= bool(torch.equal(got_s[lo:hi], want_s) and torch.equal(got_i[lo:hi], want_i))
    check(launched == 1 and same, f"C5: pruned_topk at m = {m} in one call equals the plain "
                                  "version exactly")
    ms = time_ms(lambda: pruned_topk.pruned_topk_ranked(p, q, r_u, r_i, bias, topk), 3)
    plain_ms = time_ms(lambda: [pruned_topk.pruned_topk_plain(
        p[lo:lo + (1 << 21)], q, r_u[lo:lo + (1 << 21)], r_i, bias, topk, block_n=n)
        for lo in range(0, m, 1 << 21)], 1)
    b_ms, b_by = bound(pair_flops(r_u, r_i, k),
                       factor_bytes(r_u, r_i, 4) + 4.0 * n + 8.0 * m * topk)
    log(f"  kernel {ms:.3f} ms, plain (in 2^21-user pieces) {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by})")
    out["pruned_topk"] = {f"m={m}": dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)}
    del p, q, bias, r_u, r_i, got_s, got_i, want_s, want_i
    torch.cuda.empty_cache()

    mu, mn = MATMUL_USERS, C6_ITEMS
    log(f"## C6: pruned_matmul at {mu} users x {mn} items, k = 520 and 1024 (column slices of "
        f"{pruned_matmul.MAX_K}), float32")
    out["pruned_matmul"] = {}
    for kw in (520, 1024):
        for label, rows, t in (("random", None, 0.02), ("grid", grid_tensor, 0.0)):
            if rows is None:
                p = torch.randn((mu, kw), generator=gen, device=dev).mul_(0.1)
                q = torch.randn((mn, kw), generator=gen, device=dev).mul_(0.1)
            else:
                p, q = rows(gen, (mu, kw), dev), rows(gen, (mn, kw), dev)
            r_u, r_i = effective_ranks(p, t), effective_ranks(q, t)
            before = pruned_matmul.launches
            got = pruned_matmul.pruned_matmul_ranked(p, q, r_u, r_i)
            launched = pruned_matmul.launches - before
            want = pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i)
            err = float((got - want).abs().max())
            ok = torch.equal(got, want) if rows is not None else bool(
                torch.allclose(got, want, rtol=RTOL, atol=ATOL))
            check(ok and launched == len(pruned_matmul.column_slices(kw)),
                  f"C6: pruned_matmul k={kw} {label} (T={t}) "
                  f"{'exactly equal' if rows is not None else f'within rtol/atol {RTOL}'} "
                  f"({launched} launches, max abs err {err:.3e})")
            if rows is None:
                ms = time_ms(lambda: pruned_matmul.pruned_matmul_ranked(p, q, r_u, r_i), 5)
                plain_ms = time_ms(lambda: pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i), 2)
                flops = pair_flops(r_u, r_i, kw)
                nbytes = factor_bytes(r_u, r_i, 4) + 4.0 * mu * mn
                b_ms, b_by = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)
                log(f"  k={kw} T={t}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                    f"{b_ms:.3f} ms as 3xTF32 ({b_by})")
                out["pruned_matmul"][f"k={kw}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                                       bound_by=b_by, max_abs_err=err)
            del p, q, got, want
    torch.cuda.empty_cache()

    b = C6_ROWS
    log(f"## C6: fused_mf_sgd at B = {b} row pairs, k = 1030 and 2048 (1024-wide pieces)")
    out["fused_mf_sgd"] = {}
    for kw in (1030, 2048):
        for label, rows, t_p, t_q in (("random", None, 0.02, 0.02), ("grid", grid_tensor, 1 / 8, 1 / 4)):
            if rows is None:
                pr = torch.randn((b, kw), generator=gen, device=dev).mul_(0.1)
                qr = torch.randn((b, kw), generator=gen, device=dev).mul_(0.1)
                lr, lam = LR, LAM
            else:
                pr, qr = rows(gen, (b, kw), dev), rows(gen, (b, kw), dev)
                # no small values before column 1100: ranks fall in the second piece
                pr[:, :1100] = torch.where(pr[:, :1100] == 0, 0.5, pr[:, :1100])
                qr[:, :1100] = torch.where(qr[:, :1100].abs() < 1 / 4, 0.5, qr[:, :1100])
                lr, lam = 1 / 16, 1 / 32
            ratings = torch.randint(1, 6, (b,), generator=gen, device=dev).float()
            tp, tq = torch.tensor([t_p], device=dev), torch.tensor([t_q], device=dev)
            before = fused_mf_sgd.launches
            got = fused_mf_sgd.fused_mf_sgd_rows(pr, qr, ratings, tp, tq, lr=lr, lam=lam)
            launched = fused_mf_sgd.launches - before
            want = fused_mf_sgd.fused_mf_sgd_plain(pr, qr, ratings, tp, tq, lr=lr, lam=lam)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want) if g is not None)
            if rows is None:
                ok = all(torch.allclose(g, w, rtol=RTOL, atol=ATOL)
                         for g, w in zip(got, want) if g is not None)
            else:
                ok = all(torch.equal(g, w) for g, w in zip(got, want) if g is not None)
            check(ok and launched == 1,
                  f"C6: fused_mf_sgd k={kw} {label} "
                  f"{'exactly equal' if rows is not None else f'within rtol/atol {RTOL}'} "
                  f"(max abs err {err:.3e})")
            if rows is None:
                ms = time_ms(lambda: fused_mf_sgd.fused_mf_sgd_rows(
                    pr, qr, ratings, tp, tq, lr=lr, lam=lam), 10)
                plain_ms = time_ms(lambda: fused_mf_sgd.fused_mf_sgd_plain(
                    pr, qr, ratings, tp, tq, lr=lr, lam=lam), 3)
                nbytes = 4.0 * b * kw * 4 + 8.0 * b
                b_ms, b_by = bound(16.0 * b * kw, nbytes)
                log(f"  k={kw}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
                    f"({b_by}); {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
                out["fused_mf_sgd"][f"k={kw}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                                      bound_by=b_by, max_abs_err=err)
            del pr, qr, got, want
    torch.cuda.empty_cache()
    return out


def ranking_eval_phase(dev):
    """evaluate_engine (the pruned_topk kernel) against evaluate_oracle
    (predict_all_items through pruned_matmul, then a stable sort of the
    (B, n) scores) at T = 0 on 1/8-grid factors, where the two must give
    the same report; the kernels' counts are set to 0 just before and read
    just after.  Half of each user's held-out items come from the oracle's
    own top-k, so the reports measure hits; outside the counted run every
    16-user batch of engine.topk is held id for id and score for score
    against dense_topk, and one batch of predict_all_items against the
    plain pruned_matmul."""
    from repro_torch.core import mf
    from repro_torch.data.ratings import RatingsDataset
    from repro_torch.eval import ranking
    from repro_torch.kernels import pruned_matmul, pruned_topk
    from repro_torch.serving import ServingEngine

    m, n, users, per_user, from_top, batch = 100_000, N_ITEMS // 10, 512, 20, 10, 16
    log(f"## ranking evaluation: evaluate_engine vs evaluate_oracle, {m} users x {n} items x "
        f"k={K}, 1/8-grid factors, T = 0, top-{TOPK}, {users} users in {batch}-user batches, "
        f"{per_user} held-out items each ({from_top} from the oracle's top-{TOPK})")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    params = mf.MFParams(p=grid_tensor(gen, (m, K), dev), q=grid_tensor(gen, (n, K), dev),
                         user_bias=None, item_bias=None, global_mean=None, implicit=None)
    rng = np.random.default_rng(SEED + 4)
    chosen = np.sort(rng.choice(m, users, replace=False)).astype(np.int32)
    # the oracle's top-k of the chosen users (comparison launches, not counted)
    oracle = [ranking.dense_topk(params, chosen[lo:lo + batch], TOPK)
              for lo in range(0, users, batch)]
    oracle_i = np.concatenate([i for _, i in oracle])
    picks = np.argsort(rng.random((users, TOPK)), axis=1)[:, :from_top]
    items = np.concatenate([np.take_along_axis(oracle_i, picks, axis=1),
                            rng.integers(0, n, (users, per_user - from_top))], axis=1)
    held = RatingsDataset(
        user=np.repeat(chosen, per_user), item=items.reshape(-1).astype(np.int32),
        rating=rng.integers(1, 6, users * per_user).astype(np.float32), num_users=m, num_items=n)
    relevance = ranking.relevance_from_dataset(held)
    engine = ServingEngine(params, 0.0, 0.0, device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    # the same batches on both sides: the reports sum per-batch float32
    # sums, so equal reports need equal batches
    got = ranking.evaluate_engine(engine, topk=TOPK, relevance=relevance, batch_size=batch)
    engine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ranking.evaluate_oracle(params, topk=TOPK, relevance=relevance, batch_size=batch)
    oracle_s = time.perf_counter() - t0
    launches = {"pruned_topk": pruned_topk.launches, "pruned_matmul": pruned_matmul.launches}
    log(f"  launches: {launches}; evaluate_engine {engine_s * 1e3:.1f} ms, "
        f"evaluate_oracle {oracle_s * 1e3:.1f} ms; report {got.as_dict()}")
    check(np.array_equal(relevance[0], chosen), f"{users} users with held-out items")
    check(got == want, "evaluate_engine equals evaluate_oracle exactly at T = 0 on the grid")
    check(got.users == users and got.hr == 1.0 and got.recall >= from_top / per_user,
          f"every user hits; recall at least {from_top}/{per_user}")
    for name, count in launches.items():
        check(count > 0, f"{name} launched by the ranking evaluation ({count})")
    PATH_LAUNCHES["ranking"] = launches

    same = True
    for b, lo in enumerate(range(0, users, batch)):
        got_s, got_i = engine.topk(chosen[lo:lo + batch], TOPK)
        same &= np.array_equal(got_s, oracle[b][0]) and np.array_equal(got_i, oracle[b][1])
    check(same, f"engine.topk equals dense_topk in all {users // batch} batches, "
                "ids and scores exactly")
    u = torch.as_tensor(chosen[:batch].astype(np.int64), device=dev)
    full_u = torch.full((batch,), K, dtype=torch.int32, device=dev)
    full_i = torch.full((n,), K, dtype=torch.int32, device=dev)
    scores = mf.predict_all_items(params, u, 0.0, 0.0, device=dev)
    plain = pruned_matmul.pruned_matmul_plain(params.p[u], params.q, full_u, full_i)
    check(torch.equal(scores, plain),
          f"predict_all_items ({batch} x {n}) equals the plain pruned_matmul exactly")


# ---------------------------------------------------------------------------
# training: fused_mf_sgd, the small trainer card vs CPU, dpmf trained
# ---------------------------------------------------------------------------


def fused_kernel_phase(dev):
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.kernels import fused_mf_sgd

    log(f"## fused_mf_sgd: {BATCH} row pairs x k={K}, float32, at lr 1 (as the step runs it)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    p_rows = decaying_factors(gen, BATCH, dev)
    q_rows = decaying_factors(gen, BATCH, dev)
    ratings = torch.randint(1, 6, (BATCH,), generator=gen, device=dev).float()
    bias_u = torch.randn((BATCH,), generator=gen, device=dev).mul_(0.2)
    bias_i = torch.randn((BATCH,), generator=gen, device=dev).mul_(0.2)
    weight = torch.randint(0, 3, (BATCH,), generator=gen, device=dev).float() / 2  # a third are 0
    mu = torch.tensor([3.5], device=dev)
    t30 = thresholds_from_matrices(p_rows, q_rows, RATE)
    zero = torch.zeros((1,), device=dev)
    thresholds = {"T=0": (zero, zero), f"rate {RATE}": (t30[0].reshape(1), t30[1].reshape(1))}
    log(f"  rate {RATE} -> T_p {float(t30[0]):.6g}, T_q {float(t30[1]):.6g} (from these rows)")

    def compare(got, want, what, tol=RTOL, exact=False):
        errs = [0.0 if g is None else float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want)]
        if exact:
            ok = all(g is None or torch.equal(g, w) for g, w in zip(got, want))
            check(ok, f"{what}: every output exactly equal")
        else:
            ok = all(g is None or torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
                     for g, w in zip(got, want))
            check(ok, f"{what}: within rtol/atol {tol} (max abs errs of new_p, new_q, "
                      f"new_bu, new_bi, err: {', '.join(f'{e:.3e}' for e in errs)})")
        return max(errs)

    stats = {"err": 0.0}
    for label, (t_p, t_q) in thresholds.items():
        for extra_label, extra in (("", {}), (" with bias and weight", dict(
                bias_u=bias_u, bias_i=bias_i, global_mean=mu, weight=weight))):
            args = (p_rows, q_rows, ratings, t_p, t_q)
            got = fused_mf_sgd.fused_mf_sgd_rows(*args, lr=1.0, lam=LAM, **extra)
            want = fused_mf_sgd.fused_mf_sgd_plain(*args, lr=1.0, lam=LAM, **extra)
            torch.cuda.synchronize()
            stats["err"] = max(stats["err"], compare(got, want, f"fused_mf_sgd {label}{extra_label}"))
            del got, want
        ms = time_ms(lambda: fused_mf_sgd.fused_mf_sgd_rows(
            p_rows, q_rows, ratings, t_p, t_q, lr=1.0, lam=LAM), 20)
        plain_ms = time_ms(lambda: fused_mf_sgd.fused_mf_sgd_plain(
            p_rows, q_rows, ratings, t_p, t_q, lr=1.0, lam=LAM), 5)
        # each row element read once and written once, plus the rating and
        # err columns; ~16 fp32 operations an element pair
        nbytes = 4.0 * BATCH * K * 4 + 8.0 * BATCH
        b_ms, b_by = bound(16.0 * BATCH * K, nbytes)
        log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound {b_ms:.3f} ms "
            f"({b_by}: {nbytes / 1e9:.3f} GB); {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
        stats[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # bfloat16 rows at a small, ragged B
    nb = 4099
    bp, bq = p_rows[:nb].bfloat16(), q_rows[:nb].bfloat16()
    t_p, t_q = thresholds[f"rate {RATE}"]
    bargs = (bp, bq, ratings[:nb], t_p, t_q)
    bextra = dict(bias_u=bias_u[:nb], bias_i=bias_i[:nb], global_mean=mu, weight=weight[:nb])
    compare(fused_mf_sgd.fused_mf_sgd_rows(*bargs, lr=LR, lam=LAM, **bextra),
            fused_mf_sgd.fused_mf_sgd_plain(*bargs, lr=LR, lam=LAM, **bextra),
            f"fused_mf_sgd bfloat16 B={nb}", tol=BF16_TOL)

    # 1/8-grid rows, lr and lam powers of two: every product is exact
    gb = 65_537
    grid = lambda *s: torch.randint(-16, 17, s, generator=gen, device=dev).float() / 8  # noqa: E731
    gargs = (grid(gb, K), grid(gb, K), torch.randint(1, 6, (gb,), generator=gen, device=dev).float(),
             torch.tensor([1 / 8], device=dev), torch.tensor([1 / 4], device=dev))
    gextra = dict(bias_u=grid(gb), bias_i=grid(gb), global_mean=torch.tensor([3.0], device=dev),
                  weight=torch.randint(0, 3, (gb,), generator=gen, device=dev).float() / 2)
    compare(fused_mf_sgd.fused_mf_sgd_rows(*gargs, lr=1 / 16, lam=1 / 32, **gextra),
            fused_mf_sgd.fused_mf_sgd_plain(*gargs, lr=1 / 16, lam=1 / 32, **gextra),
            f"fused_mf_sgd 1/8-grid B={gb}", exact=True)
    return stats


def small_trainer_phase():
    from repro_torch.core import mf
    from repro_torch.core.trainer import DPMFTrainer, TrainConfig
    from repro_torch.data.ratings import synthetic_ratings, train_test_split
    from repro_torch.kernels import fused_mf_sgd

    m, n = 20_000, 5_000
    log(f"## small trainer, card against CPU: {m} users x {n} items x 400000 ratings, "
        f"k={K}, 3 epochs, rate {RATE}, funk")
    train, test = train_test_split(synthetic_ratings(m, n, 400_000, seed=SEED), 0.2, seed=SEED)
    rng = np.random.default_rng(SEED)
    init = {"p": rng.normal(0, 0.1, (m, K)).astype(np.float32),
            "q": rng.normal(0, 0.1, (n, K)).astype(np.float32)}
    fields = ("train_abs_err", "test_mae", "work_fraction", "t_p", "t_q")
    # sgd at a smaller lr: the zipf(1.3) items put ~1000 ratings of item 0 in
    # every 4096-rating batch, and their summed updates diverge at 0.05
    for opt, lr, fused in (("sgd", 0.002, True), ("adagrad", 0.05, False)):
        runs = {}
        for device in ("cuda", "cpu"):
            cfg = TrainConfig(k=K, epochs=3, pruning_rate=RATE, optimizer=opt, lr=lr,
                              use_fused_kernel=fused, seed=SEED)
            trainer = DPMFTrainer(cfg, train, test, device=device)
            trainer.params = mf.params_from_numpy(init, device=device)
            trainer.opt_state = mf.init_opt_state(trainer.params, trainer.opt)
            before = fused_mf_sgd.launches
            t0 = time.perf_counter()
            history = trainer.run()
            steps = len(train) // cfg.batch_size
            log(f"  {opt} on {device}: {time.perf_counter() - t0:.2f} s; " + "; ".join(
                f"epoch {r.epoch}: err {r.train_abs_err:.6f} mae {r.test_mae:.6f} "
                f"work {r.work_fraction:.6f}" for r in history))
            if device == "cuda":
                want = 3 * steps if fused else 0
                check(fused_mf_sgd.launches - before == want,
                      f"{opt} on the card: fused_mf_sgd launched {want} times")
            runs[device] = (history, trainer.perm.cpu(), trainer.joint_sparsity.cpu())
        (h_gpu, perm_gpu, js_gpu), (h_cpu, perm_cpu, js_cpu) = runs["cuda"], runs["cpu"]
        worst = max(abs(getattr(a, f) - getattr(b, f)) / max(abs(getattr(b, f)), 1e-30)
                    for a, b in zip(h_gpu, h_cpu) for f in fields)
        check(all(math.isfinite(getattr(r, f)) for r in h_gpu for f in fields)
              and worst <= RECORD_RTOL,
              f"{opt}: epoch records of card and CPU within {RECORD_RTOL} relative "
              f"(worst {worst:.3e})")
        differ = perm_gpu != perm_cpu
        log(f"  {opt}: perms differ at {int(differ.sum())} of {K} positions")
        check(bool(((js_gpu - js_cpu).abs()[differ] <= 1e-6).all()),
              f"{opt}: perms identical except between joint sparsities within 1e-6")


def dpmf_ratings(rng, count, num_users=N_USERS, num_items=N_ITEMS):
    """Users uniform over 100M; items ~ 1/(i + ITEM_OFFSET) over 10M (a power
    law with exponent 1, so popular items collide in every batch); integer
    ratings 1-5."""
    from repro_torch.data.ratings import RatingsDataset

    users = rng.integers(0, num_users, count, dtype=np.int64).astype(np.int32)
    span = math.log((num_items + ITEM_OFFSET) / ITEM_OFFSET)
    items = np.floor(ITEM_OFFSET * np.exp(rng.random(count) * span) - ITEM_OFFSET)
    items = np.clip(items, 0, num_items - 1).astype(np.int32)
    ratings = rng.integers(1, 6, count).astype(np.float32)
    return RatingsDataset(user=users, item=items, rating=ratings, num_users=num_users,
                          num_items=num_items)


def step_against_cpu(trainer, batch, lr, what):
    """One full-size fused step of ``trainer``'s tables on the card, held
    against the plain masked step recomputed on the CPU over the touched
    rows only (weight column included when the batch has one); returns the
    step's host-clock ms."""
    from repro_torch.core import mf

    params, opt = trainer.params, trainer.opt
    users, user_pos = torch.unique(batch["user"], return_inverse=True)
    items, item_pos = torch.unique(batch["item"], return_inverse=True)
    p_before, q_before = params.p[users].cpu(), params.q[items].cpu()
    dim_mask = torch.ones((K,), device=params.p.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mf.train_step(params, trainer.opt_state, batch, trainer.t_p, trainer.t_q, lr, dim_mask,
                  opt=opt, lam=LAM, use_fused_kernel=True)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    cpu = mf.MFParams(p=p_before, q=q_before, user_bias=None, item_bias=None,
                      global_mean=None, implicit=None)
    cpu_batch = {"user": user_pos.cpu(), "item": item_pos.cpu(), "rating": batch["rating"].cpu()}
    if "weight" in batch:
        cpu_batch["weight"] = batch["weight"].cpu()
    mf.train_step(cpu, mf.init_opt_state(cpu, opt), cpu_batch, trainer.t_p.cpu(),
                  trainer.t_q.cpu(), lr, dim_mask.cpu(), opt=opt, lam=LAM, use_fused_kernel=False)
    for name, got, want in (("p", params.p[users].cpu(), cpu.p), ("q", params.q[items].cpu(), cpu.q)):
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)),
              f"{what}: {len(want)} updated {name} rows within rtol/atol {RTOL} of the CPU "
              f"(max abs err {err:.3e}, max |value| {float(want.abs().max()):.4f})")
    return step_ms


def training_main_path(dev):
    from repro_torch.core import mf
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.core.trainer import DPMFTrainer, TrainConfig
    from repro_torch.data import loader
    from repro_torch.eval import ranking
    from repro_torch.kernels import fused_mf_sgd, pruned_topk

    log(f"## training main path: dpmf FunkSVD {N_USERS} users x {N_ITEMS} items x k={K}, "
        f"float32; sgd + fused kernel, lr {LR}, lam {LAM}, rate {RATE}, batch {BATCH}, "
        f"{EPOCHS} epochs of {TRAIN_STEPS} steps")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    train = dpmf_ratings(rng, TRAIN_STEPS * BATCH)
    test = dpmf_ratings(rng, BATCH)
    counts = np.bincount(train.item[:BATCH], minlength=N_ITEMS)
    log(f"  data made in {time.perf_counter() - t0:.2f} s: {len(train)} train, {len(test)} test "
        f"ratings; first batch: {int((counts > 1).sum())} items rated more than once, item 0 "
        f"{int(counts[0])} times")
    torch.cuda.reset_peak_memory_stats()
    cfg = TrainConfig(k=K, epochs=EPOCHS, batch_size=BATCH, lr=LR, lam=LAM, pruning_rate=RATE,
                      optimizer="sgd", use_fused_kernel=True, epoch_mode="scan", seed=SEED,
                      eval_batch_size=BATCH, ranking_topk=RANKING_TOPK)
    t0 = time.perf_counter()
    trainer = DPMFTrainer(cfg, train, test)
    torch.cuda.synchronize()
    log(f"  trainer built on {trainer.device} in {time.perf_counter() - t0:.2f} s; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"fused_mf_sgd": fused_mf_sgd.launches, "pruned_topk": pruned_topk.launches,
                "add_rows": scatter_launches()}
    PATH_LAUNCHES["training"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches on the training path: {launches}; run() {run_s:.2f} s")
    for r in history:
        log(f"  epoch {r.epoch}: train err {r.train_abs_err:.6f}, test mae {r.test_mae:.6f}, "
            f"work {r.work_fraction:.6f}, T_p {r.t_p:.6g}, T_q {r.t_q:.6g}, "
            f"HR@{RANKING_TOPK} {r.hr:.6f} NDCG {r.ndcg:.6f} recall {r.recall:.6f}; train "
            f"{r.wall_time_s:.3f} s = {r.wall_time_s / TRAIN_STEPS * 1e3:.2f} ms a step, "
            f"{len(train) / r.wall_time_s / 1e6:.2f} M ratings/s")
    # aminmax is one reduction; .abs() would be a second 51 GB table
    largest = {name: float(max(-lo, hi)) for name, (lo, hi) in (
        ("p", torch.aminmax(trainer.params.p)), ("q", torch.aminmax(trainer.params.q)))}
    log(f"  peak device memory (max_memory_allocated) {peak_gb:.2f} GB; after training "
        f"max |p| {largest['p']:.4f}, max |q| {largest['q']:.4f}")
    check(launches["fused_mf_sgd"] == EPOCHS * TRAIN_STEPS,
          f"fused_mf_sgd launched {EPOCHS * TRAIN_STEPS} times on the training path "
          f"({launches['fused_mf_sgd']})")
    check(launches["add_rows"] == 2 * EPOCHS * TRAIN_STEPS,
          f"add_rows launched {2 * EPOCHS * TRAIN_STEPS} times on the training path, for p and q "
          f"every step ({launches['add_rows']})")
    check(all(math.isfinite(v) for r in history for v in (
        r.train_abs_err, r.test_mae, r.work_fraction, r.t_p, r.t_q)), "epoch records finite")
    packed = trainer._packed_ranking
    ranking_steps = packed["user"].shape[0]
    check(all(math.isfinite(v) for r in history for v in (r.hr, r.ndcg, r.recall)),
          f"HR/NDCG/recall@{RANKING_TOPK} finite from epoch 0")
    check(launches["pruned_topk"] == EPOCHS * ranking_steps,
          f"pruned_topk launched {EPOCHS * ranking_steps} times by the ranking evaluation "
          f"({launches['pruned_topk']}: {ranking_steps} batches of {packed['user'].shape[1]} users "
          "an epoch)")
    check(history[0].work_fraction == 1.0 and all(r.work_fraction < 1.0 for r in history[1:]),
          "work fraction 1.0 in epoch 0, below 1 after calibration")
    check(peak_gb < 80.0, f"peak device memory under 80 GB ({peak_gb:.2f})")

    # -- the last epoch's ranking sums: kernel ids against the plain version's
    log(f"## ranking evaluation of the last epoch: kernel against the plain version, "
        f"{ranking_steps} x {packed['user'].shape[1]} users x {N_ITEMS} items, top-{RANKING_TOPK}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = trainer.evaluate_ranking()
    eval_ms = (time.perf_counter() - t0) * 1e3
    check(report.hr == history[-1].hr and report.ndcg == history[-1].ndcg
          and report.recall == history[-1].recall,
          "evaluate_ranking() again gives the last epoch's record")
    eval_ms = min(eval_ms, time_ms(trainer.evaluate_ranking, 3))
    log(f"  one evaluation (host clock, synchronized): {eval_ms:.2f} ms")
    r_i = effective_ranks(trainer.params.q, trainer.t_q)
    zero_bias = torch.zeros(N_ITEMS, device=dev)
    kernel_sums = {key: 0.0 for key in ("hr_sum", "ndcg_sum", "recall_sum", "weight_sum")}
    plain_sums = dict(kernel_sums)
    for step in range(ranking_steps):
        pu = trainer.params.p[packed["user"][step]]
        r_u = effective_ranks(pu, trainer.t_p)
        got_s, got_i = pruned_topk.pruned_topk_ranked(pu, trainer.params.q, r_u, r_i, zero_bias,
                                                      RANKING_TOPK)
        want_s, want_i = pruned_topk.pruned_topk_plain(pu, trainer.params.q, r_u, r_i, zero_bias,
                                                       RANKING_TOPK, block_n=PLAIN_BLOCK_N)
        compare_topk(got_s, got_i, want_s, want_i, f"ranking batch {step}")
        for ids, sums in ((got_i, kernel_sums), (want_i, plain_sums)):
            counts = ranking.ranking_counts(ids, packed["relevant"][step], packed["n_valid"][step],
                                            packed["weight"][step])
            for key in sums:
                sums[key] += float(counts[key])
        del want_s, want_i
        torch.cuda.empty_cache()
    via_kernel = ranking.report_from_sums(kernel_sums, RANKING_TOPK)
    via_plain = ranking.report_from_sums(plain_sums, RANKING_TOPK)
    log(f"  through the kernel {via_kernel.as_dict()}; through the plain version "
        f"{via_plain.as_dict()}")
    check(abs(via_kernel.ndcg - report.ndcg) <= 1e-6 and abs(via_kernel.hr - report.hr) <= 1e-6,
          "the kernel's ids give the scan's metrics")
    check(all(abs(getattr(via_kernel, f) - getattr(via_plain, f)) <= 1e-6
              for f in ("hr", "ndcg", "recall")),
          "metrics through the kernel and through the plain version within 1e-6")
    del r_i, zero_bias
    torch.cuda.empty_cache()

    # -- one more full-size step against the plain step on the CPU -------------
    log("## one full-size step against the plain masked step on the CPU (touched rows only)")
    params, opt = trainer.params, trainer.opt
    batch = {"user": torch.as_tensor(train.user[:BATCH], dtype=torch.int64).to(dev),
             "item": torch.as_tensor(train.item[:BATCH], dtype=torch.int64).to(dev),
             "rating": torch.as_tensor(train.rating[:BATCH]).to(dev)}
    dim_mask = torch.ones((K,), device=dev)
    step_ms = step_against_cpu(trainer, batch, LR, "step")
    log(f"  one step (host clock, synchronized): {step_ms:.2f} ms")
    steps_reproducible(trainer, batch, LR, "train-dpmf")

    # -- where a step's time goes: its stages one by one (CUDA events) --------
    from repro_torch.kernels import ops, scatter

    u, i, r = batch["user"], batch["item"], batch["rating"]
    pu, qi = params.p[u], params.q[i]
    new = ops.fused_mf_sgd(pu, qi, r, trainer.t_p, trainer.t_q, lr=1.0, lam=LAM)
    dp, dq = (new[0] - pu).mul_(LR), (new[1] - qi).mul_(LR)
    stages = {
        "gather p[u], q[i]": lambda: (params.p[u], params.q[i]),
        "ranks for the metrics (2 x effective_ranks)": lambda: torch.minimum(
            effective_ranks(pu, trainer.t_p), effective_ranks(qi, trainer.t_q)),
        "fused_mf_sgd kernel": lambda: ops.fused_mf_sgd(
            pu, qi, r, trainer.t_p, trainer.t_q, lr=1.0, lam=LAM),
        "deltas ((new - old) * lr * dim_mask, 2 tables)": lambda: (
            (new[0] - pu).mul_(LR).mul_(dim_mask), (new[1] - qi).mul_(LR).mul_(dim_mask)),
        "scatter (2 x add_rows, batch order)": lambda: (
            scatter.add_rows(params.p, u, dp), scatter.add_rows(params.q, i, dq)),
        "scatter as before (2 x index_add_, atomics)": lambda: (
            params.p.index_add_(0, u, dp), params.q.index_add_(0, i, dq)),
        "whole step (mf.train_step)": lambda: mf.train_step(
            params, trainer.opt_state, batch, trainer.t_p, trainer.t_q, LR, dim_mask,
            opt=opt, lam=LAM, use_fused_kernel=True),
    }
    breakdown = {name: time_ms(fn, 5) for name, fn in stages.items()}
    for name, ms in breakdown.items():
        log(f"  {name}: {ms:.3f} ms")
    t0 = time.perf_counter()
    loader.epoch_permutation(len(train), SEED, 0)
    log(f"  host: epoch_permutation of {len(train)} ratings {(time.perf_counter() - t0) * 1e3:.1f} ms")
    t0 = time.perf_counter()
    trainer.evaluate()
    log(f"  evaluate() on {len(test)} test ratings {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return {"launches": launches, "ranking_eval_ms": eval_ms, "step_breakdown_ms": breakdown}


# ---------------------------------------------------------------------------
# the workloads: implicit (fused_mf_sgd with a weight column) and BPR
# ---------------------------------------------------------------------------


def ranking_batch_against_plain(trainer, what):
    """The trainer's first ranking batch through the pruned_topk kernel, as
    its ranking evaluation launches it, against the plain version on the
    same inputs (comparison launches, after the path's counted run)."""
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.kernels import pruned_topk

    p, q = trainer.params.p, trainer.params.q
    pu = p[trainer._packed_ranking["user"][0]]
    r_u, r_i = effective_ranks(pu, trainer.t_p), effective_ranks(q, trainer.t_q)
    zero_bias = torch.zeros(q.shape[0], device=q.device)
    got_s, got_i = pruned_topk.pruned_topk_ranked(pu, q, r_u, r_i, zero_bias, RANKING_TOPK)
    want_s, want_i = pruned_topk.pruned_topk_plain(pu, q, r_u, r_i, zero_bias, RANKING_TOPK,
                                                   block_n=PLAIN_BLOCK_N)
    compare_topk(got_s, got_i, want_s, want_i,
                 f"{what}: ranking batch of {len(pu)} users x {q.shape[0]} items vs plain")
    del r_i, zero_bias, want_s, want_i
    torch.cuda.empty_cache()


def implicit_phase(dev):
    """DPMFTrainer.run() under the implicit objective at full size: the log
    expanded into positives (confidence 1 + 40 r) and 4 sampled negatives
    each, sgd through fused_mf_sgd with the weight column; the kernels'
    counts set to 0 just before run() and read just after; then one more
    weighted step against the plain masked step on the CPU."""
    from repro_torch.core.trainer import DPMFTrainer, TrainConfig
    from repro_torch.kernels import fused_mf_sgd, pruned_topk
    from repro_torch.workloads import implicit as implicit_wl

    log(f"## implicit-dpmf: dpmf FunkSVD {N_USERS} x {N_ITEMS} x k={K}, objective implicit "
        f"(alpha {IMPLICIT_ALPHA}, {IMPLICIT_NEGATIVES} negatives), sgd + fused kernel, lr "
        f"{IMPLICIT_LR:.6g} (dpmf's {LR} / 201), rate {RATE}, batch {BATCH}, {IMPLICIT_EPOCHS} "
        f"epochs")
    rng = np.random.default_rng(SEED + 7)
    train = dpmf_ratings(rng, TRAIN_STEPS * BATCH)
    test = dpmf_ratings(rng, BATCH)
    cfg = TrainConfig(k=K, epochs=IMPLICIT_EPOCHS, batch_size=BATCH, lr=IMPLICIT_LR, lam=LAM,
                      pruning_rate=RATE, optimizer="sgd", use_fused_kernel=True, seed=SEED,
                      objective="implicit", implicit_alpha=IMPLICIT_ALPHA,
                      implicit_negatives=IMPLICIT_NEGATIVES, eval_batch_size=BATCH,
                      ranking_topk=RANKING_TOPK)
    host = {}
    expand = implicit_wl.implicit_dataset

    def timed_expand(*args, **kwargs):  # the trainer's one call, timed on the host clock
        t0 = time.perf_counter()
        out = expand(*args, **kwargs)
        host["implicit_dataset_s"] = time.perf_counter() - t0
        return out

    torch.cuda.reset_peak_memory_stats()
    implicit_wl.implicit_dataset = timed_expand
    try:
        t0 = time.perf_counter()
        trainer = DPMFTrainer(cfg, train, test)
        torch.cuda.synchronize()
        host["trainer_init_s"] = time.perf_counter() - t0
    finally:
        implicit_wl.implicit_dataset = expand
    rows = len(trainer.train_ds)
    steps = rows // BATCH
    weight = trainer._train_weight
    log(f"  implicit_dataset: {len(train)} interactions -> {rows} rows in "
        f"{host['implicit_dataset_s']:.2f} s (host); trainer built in "
        f"{host['trainer_init_s']:.2f} s; confidence max {float(weight.max()):.0f}, mean "
        f"{float(weight[:len(train)].mean()):.2f} over the positives")

    reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"fused_mf_sgd": fused_mf_sgd.launches, "pruned_topk": pruned_topk.launches,
                "add_rows": scatter_launches()}
    PATH_LAUNCHES["implicit"] = launches
    ranking_steps = trainer._packed_ranking["user"].shape[0]
    log(f"  launches: {launches}; run() {run_s:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for r in history:
        log(f"  epoch {r.epoch}: train err {r.train_abs_err:.6f}, test mae {r.test_mae:.6f}, "
            f"work {r.work_fraction:.6f}, HR@{RANKING_TOPK} {r.hr:.6f}; train {r.wall_time_s:.3f} s "
            f"= {r.wall_time_s / steps * 1e3:.2f} ms a step, {rows / r.wall_time_s / 1e6:.2f} M rows/s")
    check(launches["fused_mf_sgd"] == IMPLICIT_EPOCHS * steps,
          f"implicit: fused_mf_sgd launched {IMPLICIT_EPOCHS * steps} times "
          f"({launches['fused_mf_sgd']})")
    check(launches["pruned_topk"] == IMPLICIT_EPOCHS * ranking_steps,
          f"implicit: pruned_topk launched {IMPLICIT_EPOCHS * ranking_steps} times by the ranking "
          f"evaluation ({launches['pruned_topk']})")
    check(all(math.isfinite(v) for r in history for v in (
        r.train_abs_err, r.test_mae, r.work_fraction, r.hr, r.ndcg, r.recall)),
        "implicit: epoch records finite")
    check(history[0].work_fraction == 1.0 and history[-1].work_fraction < 1.0,
          "implicit: work fraction 1.0 in epoch 0, below 1 after calibration")
    ranking_batch_against_plain(trainer, "implicit")

    log("## implicit: one full-size weighted step against the plain masked step on the CPU")
    take = np.random.default_rng(SEED + 9).choice(rows, BATCH, replace=False)
    ds = trainer.train_ds
    batch = {"user": torch.as_tensor(ds.user[take], dtype=torch.int64).to(dev),
             "item": torch.as_tensor(ds.item[take], dtype=torch.int64).to(dev),
             "rating": torch.as_tensor(ds.rating[take]).to(dev),
             "weight": torch.as_tensor(weight[take]).to(dev)}
    before = fused_mf_sgd.launches
    step_ms = step_against_cpu(trainer, batch, IMPLICIT_LR, "implicit step (weights 1-201)")
    check(fused_mf_sgd.launches == before + 1, "implicit step: one fused_mf_sgd launch")
    log(f"  one weighted step (host clock, synchronized): {step_ms:.2f} ms")
    return {"launches": launches, "step_ms": step_ms, **host,
            "epoch_s": [r.wall_time_s for r in history]}


def bpr_against_plain(params, opt, batch, t_p, t_q, lr, lam, what, exact):
    """One bpr_train_step on the card against the plain bpr_step_ref on the
    CPU over the touched rows only (re-indexed into small tables)."""
    from repro_torch.core import mf
    from repro_torch.kernels import ref
    from repro_torch.workloads import bpr

    u, i, j = batch["user"], batch["pos"], batch["neg"]
    users, u_pos = torch.unique(u, return_inverse=True)
    items, ij_pos = torch.unique(torch.cat([i, j]), return_inverse=True)
    p_small, q_small = params.p[users].cpu(), params.q[items].cpu()
    want_p, want_q, _, want_loss = ref.bpr_step_ref(
        p_small, q_small, u_pos.cpu(), ij_pos[: len(i)].cpu(), ij_pos[len(i):].cpu(),
        float(t_p), float(t_q), lr=lr, lam=lam)
    _, _, metrics = bpr.bpr_train_step(
        params, mf.init_opt_state(params, opt), batch, t_p, t_q, lr,
        torch.ones((K,), device=params.p.device), opt=opt, lam=lam)
    got_p, got_q = params.p[users].cpu(), params.q[items].cpu()
    for name, got, want in (("p", got_p, want_p), ("q", got_q, want_q)):
        err = float((got - want).abs().max())
        ok = torch.equal(got, want) if exact else bool(
            torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        check(ok, f"{what}: {len(want)} updated {name} rows "
                  f"{'exactly equal to' if exact else f'within rtol/atol {RTOL} of'} the plain "
                  f"bpr_step_ref on the CPU (max abs err {err:.3e})")
    loss_err = abs(float(metrics["abs_err"]) - want_loss)
    check(loss_err <= 1e-5, f"{what}: BPR loss {float(metrics['abs_err']):.6f} within 1e-5 of the "
                            f"plain version's ({loss_err:.2e})")


def bpr_phase(dev):
    """One BPR epoch of 8 steps of 2^20 triples through DPMFTrainer at full
    size (masked tensor ops, no kernel, as in the reference), the ranking
    evaluation counted; then one pruned step against the plain
    bpr_step_ref over the touched rows: random factors within 1e-5, and
    1/8-grid rows exactly."""
    from repro_torch.core.trainer import DPMFTrainer, TrainConfig
    from repro_torch.kernels import pruned_topk
    from repro_torch.workloads import bpr

    log(f"## bpr-dpmf: dpmf FunkSVD {N_USERS} x {N_ITEMS} x k={K}, objective bpr, sgd lr {LR}, "
        f"lam {LAM}, one epoch of {TRAIN_STEPS} steps of {BATCH} triples, rate {RATE} after it")
    rng = np.random.default_rng(SEED + 8)
    train = dpmf_ratings(rng, TRAIN_STEPS * BATCH)
    test = dpmf_ratings(rng, BATCH)
    cfg = TrainConfig(k=K, epochs=1, batch_size=BATCH, lr=LR, lam=LAM, pruning_rate=RATE,
                      optimizer="sgd", objective="bpr", seed=SEED, eval_batch_size=BATCH,
                      ranking_topk=RANKING_TOPK)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = DPMFTrainer(cfg, train, test)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sampler = trainer._bpr_sampler
    log(f"  trainer built in {init_s:.2f} s (the sampler's positive set included)")

    reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"pruned_topk": pruned_topk.launches, "add_rows": scatter_launches()}
    PATH_LAUNCHES["bpr"] = launches
    r = history[0]
    log(f"  launches: {launches}; run() {run_s:.2f} s; epoch 0: BPR loss {r.train_abs_err:.6f}, "
        f"work {r.work_fraction:.6f}, HR@{RANKING_TOPK} {r.hr:.6f}; train {r.wall_time_s:.3f} s = "
        f"{r.wall_time_s / TRAIN_STEPS * 1e3:.2f} ms a step (triples drawn and uploaded "
        f"included); T_p {float(trainer.t_p):.6g}, T_q {float(trainer.t_q):.6g} after it; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(len(history) == 1 and math.isfinite(r.train_abs_err) and r.train_abs_err < 0.75
          and math.isnan(r.test_mae) and r.work_fraction == 1.0,
          "bpr: one dense epoch, loss finite near log 2, test MAE NaN")
    check(math.isfinite(r.hr) and launches["pruned_topk"] > 0,
          f"bpr: ranking evaluation through pruned_topk ({launches['pruned_topk']})")
    ranking_batch_against_plain(trainer, "bpr")

    log("## bpr: one pruned step against the plain bpr_step_ref on the CPU (touched rows)")
    t0 = time.perf_counter()
    triples = sampler.epoch_triples_numpy(1)  # the epoch the trainer would draw next
    sample_s = time.perf_counter() - t0
    log(f"  one epoch's {triples['user'].size} triples drawn on the host in {sample_s:.2f} s")
    batch = {key: torch.as_tensor(value[0], dtype=torch.int64).to(dev)
             for key, value in triples.items()}
    params, opt = trainer.params, trainer.opt
    bpr_against_plain(params, opt, batch, trainer.t_p, trainer.t_q, LR, LAM,
                      "bpr step (random factors, rate 0.3)", exact=False)
    ones = torch.ones((K,), device=dev)
    step_ms = time_ms(lambda: bpr.bpr_train_step(
        params, trainer.opt_state, batch, trainer.t_p, trainer.t_q, LR, ones, opt=opt,
        lam=LAM), 5)
    log(f"  one BPR step at rate {RATE}: {step_ms:.3f} ms (CUDA events)")

    # 1/8-grid rows, each negative's row a copy of its positive's: every
    # difference is 0, the sigmoid exactly 0.5, every product and sum exact
    gb = 1 << 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    u = torch.randint(0, N_USERS, (gb,), generator=gen, device=dev)
    i = torch.randint(0, N_ITEMS // 2, (gb,), generator=gen, device=dev)
    j = i + N_ITEMS // 2
    params.p[u] = grid_tensor(gen, (gb, K), dev)
    params.q[i] = grid_tensor(gen, (gb, K), dev)
    params.q[j] = params.q[i]
    bpr_against_plain(params, opt, {"user": u, "pos": i, "neg": j},
                      torch.tensor(1 / 8, device=dev), torch.tensor(1 / 4, device=dev),
                      1 / 16, 1 / 32, "bpr step (1/8-grid rows)", exact=True)
    return {"launches": launches, "step_ms": step_ms, "sampler_s": sample_s,
            "epoch_s": r.wall_time_s}


# ---------------------------------------------------------------------------
# the online freshness loop
# ---------------------------------------------------------------------------


def online_phase(dev):
    """The freshness loop at k = 128, 10M items, 20M users: an sgd
    OnlineUpdater fed a Poisson stream (rated, then clicks through
    implicit_microbatches), a live ServingEngine answering 4 client threads,
    SnapshotPublisher swaps every 4 batches (delta checkpoints to a temp dir
    in the rated half), both prequential evaluators (the ranking one through
    the engine).  Checks: no failed request; after every publish a probe
    batch equals a fresh engine on a copy of the version; a batch started
    before an apply returns its version's answer; every such probe against
    the plain version on the version's own tables; the delta chain folds to
    the live tables; pruned_topk counted under "online".  The clients wait
    at a gate while a check runs, so the check's launches are counted
    exactly and taken off the path's count."""
    import contextlib
    import threading

    from repro_torch.core import mf
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.eval import PrequentialEvaluator, PrequentialRankingEvaluator
    from repro_torch.kernels import pruned_topk
    from repro_torch.online import (EventBatch, OnlineUpdater, PoissonSource, SnapshotPublisher,
                                    fold_deltas, iter_microbatches)
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads import implicit_microbatches, strip_ratings

    log(f"## online-dpmf: k={K}, {N_ITEMS} items, {ONLINE_USERS} users (cut from {N_USERS}: the "
        f"live tables and the served version are two copies), sgd lr {ONLINE_LR}, rate {RATE}; "
        f"{ONLINE_BATCHES} rated then {ONLINE_BATCHES} click batches of {ONLINE_BATCH} events, "
        f"new ids at p = {NEW_ID_PROB}, a publish every {PUBLISH_EVERY}, {CLIENTS} clients at "
        f"top-{RANKING_TOPK}")
    torch.cuda.reset_peak_memory_stats()

    def base_tables():  # drawn again, bitwise, for the fold check
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 6)
        q = decaying_factors(gen, N_ITEMS, dev)
        return mf.MFParams(p=decaying_factors(gen, ONLINE_USERS, dev), q=q, user_bias=None,
                           item_bias=None, global_mean=None, implicit=None)

    params = base_tables()
    t_p, t_q = thresholds_from_matrices(params.p, params.q, RATE)
    engine = ServingEngine(params, t_p, t_q, max_batch=256)
    upd = OnlineUpdater(params, None, t_p, t_q, optimizer="sgd", lr=ONLINE_LR, lam=LAM,
                        pruning_rate=RATE, batch_size=ONLINE_BATCH, seed=SEED)
    del params  # the engine's version 0, shared with the updater until its first write
    ckpt_dir = tempfile.mkdtemp(prefix="online_deltas_")
    # keep every step: no periodic full anchor (a full checkpoint is 15 GB here)
    pub = SnapshotPublisher(engine, upd, checkpoint_dir=ckpt_dir, keep=1 << 20)
    preq = PrequentialEvaluator(upd, window=ONLINE_BATCH)
    rank_eval = PrequentialRankingEvaluator(upd, engine=engine, topk=RANKING_TOPK)
    probe_rng = np.random.default_rng(SEED + 11)
    engine.topk(np.arange(256), RANKING_TOPK)  # warm-up, outside the counted run
    for b in (1, 2, 4, 8):
        engine.topk(np.arange(b), RANKING_TOPK)
    torch.cuda.synchronize()

    stop = threading.Event()
    latencies, failures = [], []
    lock = threading.Lock()
    gate = threading.Condition()  # clients wait here while a check runs
    gate_state = {"closed": False, "in_flight": 0}
    compare_launches = [0]
    plain_rows = []  # (engine scores, engine ids, plain scores, plain ids) of every probe
    out = {"swaps": [], "apply_s": 0.0, "events": 0}

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            with gate:
                while gate_state["closed"] and not stop.is_set():
                    gate.wait(timeout=1.0)
                gate_state["in_flight"] += 1
            user = int(rng.integers(0, ONLINE_USERS))
            t0 = time.perf_counter()
            try:
                s, i = engine.submit(user, RANKING_TOPK, timeout=60.0).result(timeout=120)
                ok = s.shape == (RANKING_TOPK,) and bool(np.isfinite(s).all())
                with lock:
                    latencies.append(time.perf_counter() - t0)
                    if not ok:
                        failures.append(f"user {user}: bad answer")
            except Exception as exc:  # noqa: BLE001 -- every failure fails the phase
                with lock:
                    failures.append(f"user {user}: {exc!r}")
            finally:
                with gate:
                    gate_state["in_flight"] -= 1
                    gate.notify_all()

    @contextlib.contextmanager
    def uncounted():
        """Clients held at the gate with no request in flight, so every
        pruned_topk launch inside is a check's; they are taken off the
        online path's count."""
        with gate:
            gate_state["closed"] = True
            while gate_state["in_flight"]:
                gate.wait()
        before = pruned_topk.launches
        try:
            yield
        finally:
            compare_launches[0] += pruned_topk.launches - before
            with gate:
                gate_state["closed"] = False
                gate.notify_all()

    def against_plain(snap, users, got):
        """The plain version on the version's own tables at its catalog
        size, ranks recomputed from its thresholds (not the engine's patched
        r_i); held against the engine's answer after the loop.  It runs over
        2^21-item slices of the catalog, each slice's list merged after the
        running one (a stable sort: ties to the lower index, as in one call),
        so its (items, k) temporaries stay near 1 GB beside the two copies."""
        p, q = snap.params.p, snap.params.q
        pu = p[torch.as_tensor(users, dtype=torch.int64, device=dev)]
        r_u = effective_ranks(pu, snap.t_p)
        want_s = want_i = None
        for c0 in range(0, q.shape[0], 1 << 21):
            qc = q[c0:c0 + (1 << 21)]
            s, i = pruned_topk.pruned_topk_plain(
                pu, qc, r_u, effective_ranks(qc, snap.t_q), torch.zeros(len(qc), device=dev),
                RANKING_TOPK, block_n=PLAIN_BLOCK_N)
            i = i + c0
            if want_s is not None:
                s, sel = torch.sort(torch.cat([want_s, s], 1), dim=1, descending=True,
                                    stable=True)
                i = torch.gather(torch.cat([want_i, i], 1), 1, sel)
            want_s, want_i = s[:, :RANKING_TOPK], i[:, :RANKING_TOPK]
        plain_rows.append((torch.as_tensor(got[0]), torch.as_tensor(got[1]), want_s.cpu(),
                           want_i.cpu()))

    def probe_check(what):
        """The served version against a fresh engine on a copy of its tables,
        then against the plain version."""
        with uncounted():
            held = engine._snap
            probe = probe_rng.integers(0, held.num_users, PROBE_USERS)
            got = engine.topk(probe, RANKING_TOPK)
            against_plain(held, probe, got)  # before the copy: one of them on the card at a time
            copy = mf.MFParams(*(None if v is None else v.clone() for v in held.params))
            fresh = ServingEngine(copy, held.t_p.clone(), held.t_q.clone(), max_batch=256)
            want = fresh.topk(probe, RANKING_TOPK)
            same = engine._snap is held and all(np.array_equal(a, b) for a, b in zip(got, want))
            del fresh, copy
            gc.collect()
        return same

    served_items = [N_ITEMS]

    def publish(publisher):
        """One publish; its swap is a recalibration's full rebuild, a growth
        rebuild (the catalog grew since the last publish) or a patch."""
        t0 = time.perf_counter()
        report = publisher.publish()
        kind = ("recalibration" if report.full_rebuild
                else "growth" if upd.num_items > served_items[0] else "patch")
        served_items[0] = upd.num_items
        out["swaps"].append(dict(kind=kind, swap_ms=report.swap_s * 1e3,
                                 publish_ms=(time.perf_counter() - t0) * 1e3,
                                 full_rebuild=report.full_rebuild,
                                 touched_users=report.touched_users,
                                 touched_items=report.touched_items, checkpoint=report.kind,
                                 items=upd.num_items, users=upd.num_users))
        return probe_check(kind)

    def apply(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        upd.apply(batch)
        torch.cuda.synchronize()
        out["apply_s"] += time.perf_counter() - t0
        out["events"] += len(batch)

    probes_ok = True
    inflight_ok = None
    engine.start(linger_ms=1.0)
    threads = [threading.Thread(target=client, args=(100 + c,), daemon=True)
               for c in range(CLIENTS)]
    reset_launch_counts()
    t_loop = time.perf_counter()
    for t in threads:
        t.start()
    try:
        # -- rated half: test-then-learn, delta checkpoints ---------------------
        source = PoissonSource(ONLINE_USERS, N_ITEMS, seed=SEED, new_user_prob=NEW_ID_PROB,
                               new_item_prob=NEW_ID_PROB)
        for b, batch in enumerate(iter_microbatches(source, ONLINE_BATCH,
                                                    max_events=ONLINE_BATCH * ONLINE_BATCHES)):
            rank_eval.score(batch)
            preq.score(batch)
            if b == 5:
                # a batch started on the served version before an apply
                # returns that version's answer, bit for bit
                with uncounted():
                    held = engine._snap
                    probe = batch.user[batch.user < held.num_users][:PROBE_USERS]
                    want = engine.topk(probe, RANKING_TOPK)
                    result = {}
                    worker = threading.Thread(
                        target=lambda: result.setdefault("r", engine.topk(probe, RANKING_TOPK)))
                    worker.start()
                    apply(batch)
                    worker.join(timeout=120)
                    again = engine.topk(probe, RANKING_TOPK)
                    inflight_ok = "r" in result and all(
                        np.array_equal(x, y) for r in (result["r"], again)
                        for x, y in zip(r, want))
                    against_plain(held, probe, want)
                    del held  # the version goes when the engine and the updater drop it
            else:
                apply(batch)
            if (b + 1) % PUBLISH_EVERY == 0:
                probes_ok &= publish(pub)
        # batches without new items: touched-rows patch swaps
        patch_source = PoissonSource(upd.num_users, upd.num_items, seed=SEED + 2)
        for batch in iter_microbatches(patch_source, ONLINE_BATCH,
                                       max_events=PATCH_SWAPS * ONLINE_BATCH):
            rank_eval.score(batch)
            preq.score(batch)
            apply(batch)
            probes_ok &= publish(pub)
        pub.close()
        rated_events = out["events"]
        torch.cuda.synchronize()

        # the delta chain folds onto the base tables to the live ones
        base = base_tables()
        folded, f_tp, f_tq, _, last = fold_deltas(ckpt_dir, base, t_p, t_q)
        fold_ok = (all(torch.equal(a, b) for a, b in ((folded.p, upd.params.p),
                                                      (folded.q, upd.params.q)))
                   and float(f_tp) == float(upd.t_p) and last == pub.version)
        chain = len(pub.reports)
        del base, folded

        # -- recalibration: new thresholds and latent order, a full rebuild ---
        info = upd.maybe_recalibrate(force=True)
        pub2 = SnapshotPublisher(engine, upd)  # no checkpoints: a full anchor is 15 GB here
        probes_ok &= publish(pub2)
        log(f"  recalibrated: drift {info['drift']:.4f}, T_p {info['t_p'][0]:.6g} -> "
            f"{info['t_p'][1]:.6g}, T_q {info['t_q'][0]:.6g} -> {info['t_q'][1]:.6g}")

        # -- click half: implicit_microbatches over a rating-free view --------
        clicks = PoissonSource(upd.num_users, upd.num_items, seed=SEED + 1,
                               new_user_prob=NEW_ID_PROB, new_item_prob=NEW_ID_PROB)
        per = 1 + IMPLICIT_NEGATIVES
        for b, conv in enumerate(implicit_microbatches(
                strip_ratings(clicks), ONLINE_BATCH, num_items=upd.num_items,
                alpha=IMPLICIT_ALPHA, negatives=IMPLICIT_NEGATIVES, seed=SEED,
                max_events=ONLINE_BATCH * ONLINE_BATCHES)):
            n = len(conv) // per   # the clicks come first, their negatives after
            rank_eval.score(EventBatch(user=conv.user[:n], item=conv.item[:n], rating=None))
            apply(conv)
            if (b + 1) % PUBLISH_EVERY == 0:
                probes_ok &= publish(pub2)
        loop_s = time.perf_counter() - t_loop
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=180)
        engine.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = {"pruned_topk": pruned_topk.launches - compare_launches[0],
                "add_rows": scatter_launches()}
    PATH_LAUNCHES["online"] = launches
    got_s, got_i, want_s, want_i = (torch.cat(parts) for parts in zip(*plain_rows))
    compare_topk(got_s, got_i, want_s, want_i,
                 f"online: {len(plain_rows)} probes of the served versions ({len(got_s)} users) "
                 "vs plain")

    lat_ms = np.asarray(latencies) * 1e3
    stats, rstats = preq.stats, rank_eval.stats
    by_kind = {}
    for swap in out["swaps"]:
        by_kind.setdefault(swap["kind"], []).append(swap["swap_ms"])
    out.update(
        loop_s=loop_s, requests=len(latencies), failed=len(failures),
        p50_ms=float(np.percentile(lat_ms, 50)) if lat_ms.size else float("nan"),
        p99_ms=float(np.percentile(lat_ms, 99)) if lat_ms.size else float("nan"),
        events_per_s=out["events"] / out["apply_s"], mae=stats.mae, hr=rstats.hit_rate,
        mrr=rstats.mrr, peak_gb=torch.cuda.max_memory_allocated() / 1e9, chain_files=chain,
        swap_ms_by_kind={k: dict(n=len(v), min=min(v), median=float(np.median(v)), max=max(v))
                         for k, v in by_kind.items()},
        launches=launches, users=upd.num_users, items=upd.num_items)
    log(f"  launches: {launches} (comparison launches {compare_launches[0]} not counted); loop "
        f"{loop_s:.2f} s; {out['events']} update rows ({rated_events} rated events) applied in "
        f"{out['apply_s']:.2f} s = {out['events_per_s']:.0f} rows/s; tables grew to "
        f"{upd.num_users} x {upd.num_items}")
    for kind, v in out["swap_ms_by_kind"].items():
        log(f"  swap ({kind}): {v['n']} swaps, min {v['min']:.2f} / median {v['median']:.2f} / "
            f"max {v['max']:.2f} ms (host clock, synchronized)")
    log(f"  clients: {len(latencies)} requests, {len(failures)} failed; p50 {out['p50_ms']:.2f} "
        f"ms, p99 {out['p99_ms']:.2f} ms (submit to result, under the loop)")
    log(f"  prequential: MAE {stats.mae:.4f} over {stats.events} rated events; HR@{RANKING_TOPK} "
        f"{rstats.hit_rate:.4f}, MRR {rstats.mrr:.4f} over {rstats.events} events (cohorts "
        f"{rstats.cohorts}); peak device memory {out['peak_gb']:.2f} GB")
    check(not failures and len(latencies) > 0,
          f"online: {len(latencies)} client requests, none failed or dropped "
          f"({failures[:3]})")
    check(probes_ok, f"online: after each of {len(out['swaps'])} publishes a probe of "
                     f"{PROBE_USERS} users equals a fresh engine on a copy of the version, bit "
                     "for bit")
    check(bool(inflight_ok), "online: a batch started before an apply returns its version's "
                             "answer bit for bit (during and after the apply)")
    check(fold_ok, f"online: the chain of {chain} delta checkpoints folds onto the base tables "
                   "to the live tables bitwise")
    check({"growth", "patch", "recalibration"} <= set(by_kind),
          f"online: growth, patch and recalibration swaps ({sorted(by_kind)})")
    check(launches["pruned_topk"] > 0, f"online: pruned_topk launched on the online path "
                                       f"({launches['pruned_topk']})")
    largest = {name: float(max(-lo, hi)) for name, (lo, hi) in (
        ("p", torch.aminmax(upd.params.p)), ("q", torch.aminmax(upd.params.q)))}
    check(math.isfinite(stats.mae) and math.isfinite(rstats.hit_rate)
          and all(math.isfinite(v) for v in largest.values()),
          f"online: prequential MAE and HR finite, tables finite (max |p|, |q|: {largest})")
    return out


def online_launcher_phase():
    """``python -m repro_torch.launch.online`` on the card at a small size
    with --use-kernel: it must exit 0; its report is printed on one line."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.online", "--use-kernel", "--device", "cuda",
           "--scale", "0.05", "--train-epochs", "3", "--events", "2000", "--batch-events", "64",
           "--swap-every", "4", "--clients", "4", "--source", "poisson"]
    log(f"## online launcher: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    text = proc.stdout
    report = json.loads(text[text.index("{"):]) if "{" in text else {}
    log(f"  exit {proc.returncode} in {wall:.1f} s; report:")
    log("  " + json.dumps(report))
    if proc.returncode != 0:
        log(proc.stderr[-3000:])
    check(proc.returncode == 0 and report.get("requests_failed") == 0
          and report.get("device") == "cuda" and report.get("requests_ok", 0) > 0,
          "online launcher on the card: exit 0, no failed request")
    return report

# ---------------------------------------------------------------------------
# the out-of-core path: the ratings store, streamed training, eviction
# ---------------------------------------------------------------------------


RSS_SOURCES = (("/proc/self/smaps_rollup", "Anonymous"), ("/proc/self/status", "VmRSS"))


def rss_source():
    """Anonymous memory from ``smaps_rollup``, as the reference's
    ``benchmarks/common.py`` reads it, or, where the kernel has no
    ``smaps_rollup``, the whole resident set ``VmRSS`` (which also counts
    the store's file-backed mmap pages, so it can only read higher)."""
    for path, field in RSS_SOURCES:
        try:
            with open(path) as f:
                if any(line.startswith(field + ":") for line in f):
                    return path, field
        except OSError:
            continue
    raise RuntimeError("no resident-memory reading in /proc/self")


def resident_mb(source) -> float:
    """The process's resident memory in MiB from ``source`` (rss_source)."""
    path, field = source
    with open(path) as f:
        for line in f:
            if line.startswith(field + ":"):
                return float(line.split()[1]) / 1024.0
    raise RuntimeError(f"no {field} line in {path}")


def disk_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def store_dpmf_phase(dev, tmp):
    """DPMFTrainer.run() in store mode at full size: 2^25 ratings built into
    a ratings store and dropped from memory, streamed as 8-step slabs of
    2^20 through a 2-deep prefetch queue; sgd through fused_mf_sgd every
    step; a FailureInjector fails the first slab of epoch 1 once under
    max_step_retries 1.  The resident memory (anonymous, where the kernel
    reports it: see rss_source) is read after every slab: over epoch 1 it
    stays within one slab's host bytes plus 64 MB of its value at the end
    of epoch 0 (after its evaluation and calibration)."""
    from repro_torch.core.trainer import DPMFTrainer, TrainConfig
    from repro_torch.distributed.fault_tolerance import FailureInjector
    from repro_torch.kernels import fused_mf_sgd, pruned_topk
    from repro_torch.store import RatingsStore, build_store

    steps = STORE_RATINGS // BATCH
    log(f"## store-dpmf: dpmf FunkSVD {N_USERS} x {N_ITEMS} x k={K}, store mode: "
        f"{STORE_RATINGS} ratings on disk, batch {BATCH}, slabs of {STORE_SLAB_STEPS} steps "
        f"({steps // STORE_SLAB_STEPS} a slab epoch), prefetch {STORE_PREFETCH}; sgd + fused "
        f"kernel, lr {LR}, lam {LAM}, rate {RATE}, {STORE_EPOCHS} epochs")
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    train = dpmf_ratings(rng, STORE_RATINGS)
    test = dpmf_ratings(rng, BATCH)
    make_s = time.perf_counter() - t0
    store_dir = os.path.join(tmp, "store")
    t0 = time.perf_counter()
    build_store(train, store_dir)
    build_s = time.perf_counter() - t0
    del train
    gc.collect()
    store_bytes = disk_bytes(store_dir)
    log(f"  data made in {make_s:.2f} s; build_store {build_s:.2f} s; store on disk "
        f"{store_bytes / 1e6:.1f} MB ({len(RatingsStore(store_dir))} ratings, then dropped "
        "from memory)")

    cfg = TrainConfig(k=K, epochs=STORE_EPOCHS, batch_size=BATCH, lr=LR, lam=LAM,
                      pruning_rate=RATE, optimizer="sgd", use_fused_kernel=True, seed=SEED,
                      eval_batch_size=BATCH, ranking_topk=RANKING_TOPK, store_dir=store_dir,
                      slab_steps=STORE_SLAB_STEPS, prefetch_slabs=STORE_PREFETCH,
                      max_step_retries=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = DPMFTrainer(cfg, None, test)
    torch.cuda.synchronize()
    log(f"  trainer built on {trainer.device} in {time.perf_counter() - t0:.2f} s")
    num_slabs = trainer._loader.num_slabs
    trainer.failure_injector = FailureInjector((num_slabs,))  # epoch 1's first slab, once
    readings, starts = [], {}
    stream = trainer._loader.epoch_slabs
    source = rss_source()
    log(f"  resident memory read from {source[0]} ({source[1]})")

    def watched(seed, epoch, **kwargs):
        """The trainer's slab stream, read after each slab the trainer has
        finished (its step, the metrics' sync and any retry)."""
        starts[epoch] = resident_mb(source)
        for slab in stream(seed, epoch, **kwargs):
            t0 = time.perf_counter()
            yield slab
            readings.append(dict(epoch=epoch, slab=slab.slab_idx,
                                 step_ms=(time.perf_counter() - t0) * 1e3,
                                 rss_mb=resident_mb(source), host_bytes=slab.host_bytes,
                                 **{f"{k}_ms": v for k, v in slab.timings.items()}))

    trainer._loader.epoch_slabs = watched
    reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"fused_mf_sgd": fused_mf_sgd.launches, "pruned_topk": pruned_topk.launches,
                "add_rows": scatter_launches()}
    PATH_LAUNCHES["store"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches on the store path: {launches}; run() {run_s:.2f} s; peak device memory "
        f"{peak_gb:.2f} GB")
    for r in history:
        log(f"  epoch {r.epoch}: train err {r.train_abs_err:.6f}, test mae {r.test_mae:.6f}, "
            f"work {r.work_fraction:.6f}, HR@{RANKING_TOPK} {r.hr:.6f}, retries {r.step_retries}, "
            f"straggler slabs {r.straggler_slabs}; {r.wall_time_s:.3f} s = "
            f"{steps * BATCH / r.wall_time_s / 1e6:.2f} M ratings/s")
    for row in readings:
        log("  slab " + json.dumps({k: round(v, 3) if isinstance(v, float) else v
                                    for k, v in row.items()}))
    ranking_steps = trainer._packed_ranking["user"].shape[0]
    check(launches["fused_mf_sgd"] == STORE_EPOCHS * steps,
          f"store: fused_mf_sgd launched {STORE_EPOCHS * steps} times, once a streamed step "
          f"({launches['fused_mf_sgd']})")
    check(launches["pruned_topk"] == STORE_EPOCHS * ranking_steps,
          f"store: pruned_topk launched {STORE_EPOCHS * ranking_steps} times by the ranking "
          f"evaluation ({launches['pruned_topk']})")
    check([r.step_retries for r in history] == [0, 1] and trainer.failure_injector.failures == 1,
          f"store: the injected failure of epoch 1's first slab retried once "
          f"({[r.step_retries for r in history]})")
    check(all(math.isfinite(v) for r in history for v in (
        r.train_abs_err, r.test_mae, r.work_fraction, r.hr, r.ndcg, r.recall)),
        "store: epoch records finite")
    check(history[0].work_fraction == 1.0 and history[-1].work_fraction < 1.0,
          "store: work fraction 1.0 in epoch 0, below 1 after calibration")
    slab_mb = max(row["host_bytes"] for row in readings) / 2**20
    base = starts[1]
    rise = max(row["rss_mb"] for row in readings if row["epoch"] == 1) - base
    log(f"  {source[1]}: {base:.1f} MiB at the end of epoch 0; epoch 1 after each slab "
        f"{[round(row['rss_mb'], 1) for row in readings if row['epoch'] == 1]} MiB; bound "
        f"+{slab_mb:.1f} + 64 MiB")
    check(rise <= slab_mb + 64.0,
          f"store: {source[1]} over epoch 1 within one slab ({slab_mb:.1f} MiB) + 64 MiB of "
          f"its value at the end of epoch 0 (rose {rise:.1f} MiB)")
    ranking_batch_against_plain(trainer, "store")

    log("## store: one streamed full-size step against the plain masked step on the CPU")
    user, item, rating = RatingsStore(store_dir).gather(np.arange(BATCH))
    batch = {"user": torch.as_tensor(user, dtype=torch.int64).to(dev),
             "item": torch.as_tensor(item, dtype=torch.int64).to(dev),
             "rating": torch.as_tensor(rating).to(dev)}
    step_ms = step_against_cpu(trainer, batch, LR, "store step")
    log(f"  one step (host clock, synchronized): {step_ms:.2f} ms")
    per_slab = {key: float(np.median([row[key] for row in readings]))
                for key in ("perm_ms", "gather_ms", "copy_ms", "step_ms") if key in readings[0]}
    del trainer
    shutil.rmtree(store_dir, ignore_errors=True)
    return {"launches": launches, "build_s": build_s, "store_bytes": store_bytes,
            "epoch_s": [r.wall_time_s for r in history], "peak_gb": peak_gb,
            "rss_rise_mb": rise, "slab_median_ms": per_slab, "step_ms": step_ms}


def store_resume_phase(dev, tmp):
    """Store mode at 2^20 users x 2^17 items x 128 (small checkpoints): an
    uninterrupted run against one killed mid-epoch and resumed (tables and
    the last record within RECORD_RTOL: the scatter's atomics add in another
    order); then a checkpoint.fsync fault aborts one save and the latest
    step stays where it was."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core import mf
    from repro_torch.core.trainer import DPMFTrainer, TrainConfig
    from repro_torch.store import build_store
    from repro_torch.testing import faults

    log(f"## store-resume: {RESUME_USERS} x {RESUME_ITEMS} x k={K}, {RESUME_RATINGS} ratings, "
        f"batch {RESUME_BATCH}, slabs of {RESUME_SLAB_STEPS} steps, a checkpoint every "
        f"{RESUME_CKPT_SLABS} slabs; killed {RESUME_KILL} scans into epoch 1")
    rng = np.random.default_rng(SEED + 21)
    store_dir = build_store(dpmf_ratings(rng, RESUME_RATINGS, RESUME_USERS, RESUME_ITEMS),
                            os.path.join(tmp, "resume_store"))
    ckpt_dir = os.path.join(tmp, "resume_ckpt")

    def make(with_ckpt):
        cfg = TrainConfig(k=K, epochs=2, batch_size=RESUME_BATCH, lr=LR, lam=LAM,
                          pruning_rate=RATE, optimizer="sgd", use_fused_kernel=True, seed=SEED,
                          store_dir=store_dir, slab_steps=RESUME_SLAB_STEPS,
                          checkpoint_dir=ckpt_dir if with_ckpt else None,
                          checkpoint_every_epochs=1, checkpoint_every_slabs=RESUME_CKPT_SLABS)
        return DPMFTrainer(cfg, None, None)

    t0 = time.perf_counter()
    baseline = make(False)
    want = baseline.run()
    clean_s = time.perf_counter() - t0
    num_slabs = baseline._loader.num_slabs
    original, calls = mf.train_epoch_scan, {"n": 0}

    def dying(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > num_slabs + RESUME_KILL:
            raise KeyboardInterrupt
        return original(*args, **kwargs)

    killed = make(True)
    mf.train_epoch_scan = dying
    try:
        killed.run()
        killed_ok = False
    except KeyboardInterrupt:
        killed_ok = killed.epoch == 1
    finally:
        mf.train_epoch_scan = original
        killed._ckpt.wait()
    del killed
    t0 = time.perf_counter()
    resumed = make(True)
    restored = resumed.maybe_restore()
    at = (resumed.epoch, resumed._resume_slab)
    got = resumed.run()
    resume_s = time.perf_counter() - t0
    ckpt_bytes = disk_bytes(ckpt_dir)
    log(f"  uninterrupted run {clean_s:.2f} s; the killed run resumed at (epoch, slab) {at} and "
        f"finished in {resume_s:.2f} s; checkpoints on disk {ckpt_bytes / 1e6:.1f} MB")
    check(killed_ok and restored and at == (1, RESUME_CKPT_SLABS),
          f"store-resume: killed in epoch 1, resumed at slab {RESUME_CKPT_SLABS} ({at})")
    worst = 0.0
    for name in ("p", "q"):
        a, b = getattr(resumed.params, name), getattr(baseline.params, name)
        rel = float((a - b).abs().max()) / float(b.abs().max())
        worst = max(worst, rel)
        log(f"  {name}: max |resumed - uninterrupted| / max |uninterrupted| = {rel:.3e}")
    fields = ("train_abs_err", "work_fraction", "t_p", "t_q")
    rec = max(abs(getattr(got[-1], f) - getattr(want[-1], f)) / max(abs(getattr(want[-1], f)),
                                                                    1e-30) for f in fields)
    log(f"  last record: resumed {got[-1]}; uninterrupted {want[-1]}")
    check(worst <= RECORD_RTOL and rec <= RECORD_RTOL,
          f"store-resume: tables ({worst:.3e}) and the last epoch record ({rec:.3e}) within "
          f"{RECORD_RTOL} of the uninterrupted run")

    latest = ckpt_lib.latest_step(ckpt_dir)
    plan = faults.FaultPlan([faults.FaultAction(site="checkpoint.fsync", op="error", at=0)])
    aborted = False
    with faults.installed(plan):
        resumed.save(latest + 1)
        try:
            resumed._ckpt.wait()
        except OSError as exc:
            aborted = "injected fsync" in str(exc)
    check(aborted and plan.pending == 0 and ckpt_lib.latest_step(ckpt_dir) == latest,
          f"store-resume: an injected checkpoint.fsync error aborts the save and the latest "
          f"step stays {latest} ({ckpt_lib.latest_step(ckpt_dir)})")
    del baseline, resumed
    shutil.rmtree(store_dir, ignore_errors=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"resume_s": resume_s, "clean_s": clean_s, "table_rel": worst, "record_rel": rec,
            "ckpt_bytes": ckpt_bytes}


def plain_topk_rows(p, q, rows, t_p, t_q):
    """Top-RANKING_TOPK of the physical user ``rows`` by the plain
    pruned_topk over 2^21-item slices of the catalog, merged stably (ties
    to the lower index); a comparison, never counted."""
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.kernels import pruned_topk

    dev = p.device
    pu = p[torch.as_tensor(rows, dtype=torch.int64, device=dev)]
    r_u = effective_ranks(pu, t_p)
    want_s = want_i = None
    for c0 in range(0, q.shape[0], 1 << 21):
        qc = q[c0:c0 + (1 << 21)]
        s, i = pruned_topk.pruned_topk_plain(pu, qc, r_u, effective_ranks(qc, t_q),
                                             torch.zeros(len(qc), device=dev), RANKING_TOPK,
                                             block_n=PLAIN_BLOCK_N)
        i = i + c0
        if want_s is not None:
            s, sel = torch.sort(torch.cat([want_s, s], 1), dim=1, descending=True, stable=True)
            i = torch.gather(torch.cat([want_i, i], 1), 1, sel)
        want_s, want_i = s[:, :RANKING_TOPK], i[:, :RANKING_TOPK]
    return want_s.cpu(), want_i.cpu()


def evict_phase(dev, tmp):
    """Eviction at online-dpmf's size (20M users x 10M items x 128): an sgd
    OnlineUpdater with a UserEvictor (max 20M rows, target 20M - 2^21), a
    SnapshotPublisher into a ServingEngine; 16 Poisson batches of 4096
    events (new ids at p = 0.001), maybe_evict and a publish every 4; after
    the first compaction one batch names 4096 spilled users.  The engine's
    probe batches after each publish are the counted path; the comparisons
    (fresh engine, plain version) are counted apart and taken off."""
    from repro_torch.core import mf
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.kernels import pruned_topk
    from repro_torch.data.ratings import RatingsDataset
    from repro_torch.online import (EventBatch, OnlineUpdater, PoissonSource, SnapshotPublisher,
                                    iter_microbatches)
    from repro_torch.serving import ServingEngine
    from repro_torch.store import EvictionConfig, UserEvictor

    target = ONLINE_USERS - EVICT_SPILL
    log(f"## evict-dpmf: k={K}, {N_ITEMS} items, {ONLINE_USERS} users; UserEvictor max "
        f"{ONLINE_USERS}, target {target}; sgd lr {ONLINE_LR}; {EVICT_BATCHES} batches of "
        f"{ONLINE_BATCH} events (new ids at p = {NEW_ID_PROB}), maybe_evict + publish every "
        f"{PUBLISH_EVERY}")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    q = decaying_factors(gen, N_ITEMS, dev)
    params = mf.MFParams(p=decaying_factors(gen, ONLINE_USERS, dev), q=q, user_bias=None,
                         item_bias=None, global_mean=None, implicit=None)
    del q
    t_p, t_q = thresholds_from_matrices(params.p, params.q, RATE)
    engine = ServingEngine(params, t_p, t_q, max_batch=256)
    upd = OnlineUpdater(params, None, t_p, t_q, optimizer="sgd", lr=ONLINE_LR, lam=LAM,
                        pruning_rate=RATE, batch_size=ONLINE_BATCH, seed=SEED)
    del params
    spill_dir = os.path.join(tmp, "spill")
    ev = UserEvictor(EvictionConfig(max_users=ONLINE_USERS, target_users=target,
                                    spill_dir=spill_dir))
    upd.attach_evictor(ev)
    pub = SnapshotPublisher(engine, upd)
    engine.topk(np.arange(256), RANKING_TOPK)  # warm-up, outside the counted run
    probe_rng = np.random.default_rng(SEED + 31)
    compare = [0]
    out = {"evict": [], "publish_ms": []}
    probes_ok = True
    plain_rows = []

    def uncounted(fn, *args):
        before = pruned_topk.launches
        try:
            return fn(*args)
        finally:
            compare[0] += pruned_topk.launches - before

    def probe_check(kind):
        """A probe batch of external ids (spilled ones too) through the
        engine (counted), against a fresh engine on a copy of the version
        and the plain version on its live rows (not counted)."""
        held = engine._snap
        probe = probe_rng.integers(0, held.num_external, PROBE_USERS)
        spilled = ev.spilled_external_ids()
        if spilled.size:
            probe[: PROBE_USERS // 4] = probe_rng.choice(spilled, PROBE_USERS // 4, replace=False)
        got = engine.topk(probe, RANKING_TOPK)

        def compare_fresh():
            copy = mf.MFParams(*(None if v is None else v.clone() for v in held.params))
            fresh = ServingEngine(copy, held.t_p.clone(), held.t_q.clone(), max_batch=256,
                                  user_remap=held.user_remap, remap_epoch=held.remap_epoch)
            return fresh.topk(probe, RANKING_TOPK)

        phys = (probe if held.user_remap is None else held.user_remap[probe]).astype(np.int64)
        live = phys >= 0
        if live.any():
            want_s, want_i = uncounted(plain_topk_rows, held.params.p, held.params.q,
                                       phys[live], held.t_p, held.t_q)
            plain_rows.append((torch.as_tensor(got[0][live]), torch.as_tensor(got[1][live]),
                               want_s, want_i))
        want = uncounted(compare_fresh)
        gc.collect()
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        fallback_ok = True
        if (~live).any():
            s0, i0 = torch.sort(torch.zeros(held.n_items, device=dev), descending=True,
                                stable=True)  # FunkSVD: no biases, every score 0
            fallback_ok = (np.array_equal(got[1][~live], np.broadcast_to(
                i0[:RANKING_TOPK].cpu().numpy(), (int((~live).sum()), RANKING_TOPK)))
                and np.array_equal(got[0][~live], np.zeros_like(got[0][~live])))
        log(f"  probe after the {kind} publish: {int(live.sum())} live and "
            f"{int((~live).sum())} spilled users; fresh engine equal {same}, fallback {fallback_ok}")
        return same and fallback_ok

    def apply(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        upd.apply(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    source = PoissonSource(ONLINE_USERS, N_ITEMS, seed=SEED + 3, new_user_prob=NEW_ID_PROB,
                           new_item_prob=NEW_ID_PROB)
    revive = {}
    checks = {}
    for b, batch in enumerate(iter_microbatches(source, ONLINE_BATCH,
                                                max_events=ONLINE_BATCH * EVICT_BATCHES)):
        apply(batch)
        if (b + 1) % PUBLISH_EVERY:
            continue
        m = upd.num_users
        if m > ONLINE_USERS and not checks:
            # the keys of the victim order, read back before the compaction
            row_ranks = effective_ranks(upd.params.p, upd.t_p).cpu().numpy()
            order = np.lexsort((np.arange(m), row_ranks, ev.last_touched.copy()))
            victims_ext = ev.phys_to_ext[np.sort(order[: m - target])].copy()
            keep = torch.as_tensor(np.sort(order[m - target:]), device=dev)
            remap_before = ev.remap.as_array()
            p_old, q_old = upd.params.p, upd.params.q.clone()
            held = engine._snap
            inflight_probe = probe_rng.integers(0, held.num_external, PROBE_USERS)
            inflight_want = engine.topk(inflight_probe, RANKING_TOPK)
            report = ev.maybe_evict()
            out["evict"].append(report)
            log(f"  maybe_evict: {json.dumps(report)}")
            # the version served before the compaction answers as before
            phys, evicted = engine._translate_ids(held, inflight_probe)
            again = engine._apply_fallback(held, evicted, RANKING_TOPK,
                                           *engine._run_chunked(held, phys, RANKING_TOPK))
            checks["inflight"] = all(np.array_equal(x, y) for x, y in zip(again, inflight_want))
            del held
            p_new = upd.params.p
            checks["shape"] = upd.num_users == target and torch.equal(upd.params.q, q_old)
            checks["survivors"] = all(
                torch.equal(p_new[c:c + (1 << 20)], p_old[keep[c:c + (1 << 20)]])
                for c in range(0, len(keep), 1 << 20))
            gone = np.flatnonzero((remap_before >= 0) & (ev.remap.ext_to_phys < 0))
            spilled = ev.spilled_external_ids()
            checks["vanished"] = np.array_equal(spilled, gone)
            checks["lexsort"] = np.array_equal(np.sort(victims_ext), spilled)
            del p_old, q_old, keep, p_new
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = pub.publish()
            out["publish_ms"].append((time.perf_counter() - t0) * 1e3)
            out["full_publish_ms"] = out["publish_ms"][-1]
            checks["full"] = (rep.kind == "full" and rep.full_rebuild
                              and engine.remap_epoch == ev.remap.epoch == 1)
            log(f"  publish after the compaction: kind {rep.kind}, full rebuild "
                f"{rep.full_rebuild}, {out['publish_ms'][-1]:.2f} ms; engine remap epoch "
                f"{engine.remap_epoch}")
            probes_ok &= probe_check("compaction")

            # one batch naming 4096 spilled users revives them
            ids = probe_rng.choice(spilled, ONLINE_BATCH, replace=False).astype(np.int32)
            records = [ev._spilled[int(e)] for e in ids]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = upd.resolve_users(ids)
            torch.cuda.synchronize()
            revive["ms"] = (time.perf_counter() - t0) * 1e3
            with np.load(records[0][0]) as data:
                want_rows = data["p"][[row for _, row in records]]
            checks["revived"] = bool(np.array_equal(
                upd.params.p[torch.as_tensor(rows, dtype=torch.int64, device=dev)].cpu().numpy(),
                want_rows))
            revive["apply_ms"] = apply(EventBatch(
                user=ids, item=probe_rng.integers(0, 1000, ONLINE_BATCH).astype(np.int32),
                rating=probe_rng.uniform(1, 5, ONLINE_BATCH).astype(np.float32)))
            log(f"  revival of {len(ids)} spilled users: resolve {revive['ms']:.2f} ms, then "
                f"their batch {revive['apply_ms']:.2f} ms; revived rows bitwise the spilled "
                f"rows {checks['revived']}")
        else:
            info = ev.maybe_evict()
            if info:
                out["evict"].append(info)
            t0 = time.perf_counter()
            pub.publish()
            out["publish_ms"].append((time.perf_counter() - t0) * 1e3)
            probes_ok &= probe_check("later")
    launches = {"pruned_topk": pruned_topk.launches - compare[0], "add_rows": scatter_launches()}
    PATH_LAUNCHES["evict"] = launches
    got_s, got_i, want_s, want_i = (torch.cat(parts) for parts in zip(*plain_rows))
    compare_topk(got_s, got_i, want_s, want_i,
                 f"evict: {len(plain_rows)} probes' live users ({len(got_s)}) vs plain")

    rng = np.random.default_rng(SEED + 32)
    test = RatingsDataset(rng.integers(0, ev.remap.num_external, 1 << 16).astype(np.int32),
                          rng.integers(0, N_ITEMS, 1 << 16).astype(np.int32),
                          rng.integers(1, 6, 1 << 16).astype(np.float32),
                          ev.remap.num_external, N_ITEMS)
    mae = upd.evaluate(test)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches: {launches} (comparison launches {compare[0]} not counted); evaluate "
        f"under the remap: MAE {mae:.4f} over {len(test)} ratings; spill on disk "
        f"{disk_bytes(spill_dir) / 1e6:.1f} MB; peak device memory {peak_gb:.2f} GB")
    check(bool(checks) and checks["shape"],
          f"evict: after the compaction {target} users and q unchanged bitwise")
    check(checks.get("survivors", False), "evict: every survivor's row bitwise its row before")
    check(checks.get("vanished", False), "evict: the spilled ids are exactly the rows that "
                                         "vanished")
    check(checks.get("lexsort", False), "evict: the victims equal np.lexsort over (index, rank, "
                                        "last touched) read back to the host")
    check(checks.get("full", False), "evict: the publish after the bump is kind=full and the "
                                     "engine's remap epoch follows")
    check(checks.get("inflight", False), "evict: the version served before the compaction "
                                         "answers as before, bit for bit")
    check(checks.get("revived", False), "evict: the revived rows are bitwise the spilled rows")
    check(probes_ok, "evict: every probe equals a fresh engine on a copy of the version, "
                     "spilled users the bias-only fallback")
    check(math.isfinite(mae), f"evict: evaluate under the remap finite ({mae})")
    check(launches["pruned_topk"] > 0, f"evict: pruned_topk launched on the evict path "
                                       f"({launches['pruned_topk']})")
    first = out["evict"][0] if out["evict"] else {}
    return {"launches": launches, "evict_ms": {k: first.get(k) for k in (
                "ranks_ms", "sort_ms", "spill_ms", "compact_ms")},
            "spill_bytes": first.get("spill_bytes"), "revive_ms": revive.get("ms"),
            "full_publish_ms": out.get("full_publish_ms"), "publish_ms": out["publish_ms"], "peak_gb": peak_gb, "mae": mae}


def store_launchers_phase(tmp):
    """``launch.train --store-dir --build-store --use-fused-kernel`` on the
    card (exit 0), then again with one more epoch (it resumes); then
    ``launch.online --use-kernel --evict-max-users`` (exit 0, an eviction
    round, no failed request)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    store_dir, ckpt = os.path.join(tmp, "launch_store"), os.path.join(tmp, "launch_ckpt")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda", "--scale",
            "0.1", "--k", "32", "--batch-size", "256", "--optimizer", "sgd",
            "--use-fused-kernel", "--lr", "0.01", "--store-dir", store_dir, "--build-store",
            "--slab-steps", "2", "--ckpt", ckpt, "--ckpt-every-slabs", "2"]
    runs = []
    for epochs in (2, 3):
        cmd = base + ["--epochs", str(epochs)]
        log(f"## store launcher: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        log(f"  exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
        log("  " + " | ".join(proc.stdout.strip().splitlines()[:8]))
        if proc.returncode:
            log(proc.stderr[-3000:])
        runs.append(proc)
    check(runs[0].returncode == 0 and "built store" in runs[0].stdout,
          "store launcher on the card: builds the store and trains, exit 0")
    check(runs[1].returncode == 0 and "resumed from checkpoint at epoch 2" in runs[1].stdout,
          "store launcher run again: resumes from its checkpoint, exit 0")

    cmd = [sys.executable, "-m", "repro_torch.launch.online", "--use-kernel", "--device", "cuda",
           "--scale", "0.05", "--train-epochs", "3", "--events", "2000", "--batch-events", "64",
           "--swap-every", "4", "--clients", "4", "--source", "poisson", "--new-id-prob", "0.02",
           "--evict-max-users", "60", "--evict-target-users", "45"]
    log(f"## online launcher with eviction: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    text = proc.stdout
    report = json.loads(text[text.index("{"):]) if "{" in text else {}
    log(f"  exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; eviction "
        f"{report.get('eviction')}; requests ok {report.get('requests_ok')}, failed "
        f"{report.get('requests_failed')}")
    if proc.returncode:
        log(proc.stderr[-3000:])
    check(proc.returncode == 0 and report.get("requests_failed") == 0
          and report.get("eviction", {}).get("rounds", 0) >= 1 and report.get("device") == "cuda",
          "online launcher with --evict-max-users on the card: exit 0, an eviction round, no "
          "failed request")
    shutil.rmtree(store_dir, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return report.get("eviction")


# ---------------------------------------------------------------------------
# the SLO controller and the serving fleet
# ---------------------------------------------------------------------------


def stats64(t, chunk=1 << 20):
    """(mean, population std) of a table in float64, by row blocks."""
    n = t.numel()
    total = torch.zeros((), dtype=torch.float64, device=t.device)
    for lo in range(0, t.shape[0], chunk):
        total += t[lo:lo + chunk].double().sum()
    mu = total / n
    sq = torch.zeros((), dtype=torch.float64, device=t.device)
    for lo in range(0, t.shape[0], chunk):
        sq += (t[lo:lo + chunk].double() - mu).square().sum()
    return float(mu), float((sq / n).sqrt())


class LoadClients:
    """``n`` threads sending single-user top-k requests through ``submit``
    until stopped; every completion is kept as (time done, latency s)."""

    def __init__(self, submit, num_users, topk, n=CLIENTS, seed=0):
        import threading

        self.samples, self.failures = [], []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(submit, num_users, topk,
                                                                  seed + c), daemon=True)
                         for c in range(n)]

    def _run(self, submit, num_users, topk, seed):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            user = int(rng.integers(0, num_users))
            t0 = time.perf_counter()
            try:
                s, i = submit(user, topk, timeout=60.0).result(timeout=120)
                ok = len(s) == topk and bool(np.isfinite(np.asarray(s)).all())
                done = time.perf_counter()
                with self._lock:
                    self.samples.append((done, done - t0))
                    if not ok:
                        self.failures.append(f"user {user}: bad answer")
            except Exception as exc:  # noqa: BLE001 -- every failure fails the phase
                with self._lock:
                    self.failures.append(f"user {user}: {exc!r}")

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=180)
        return sum(t.is_alive() for t in self._threads)

    def percentiles(self, since=0.0, until=float("inf")):
        """(count, p50 ms, p99 ms) of the completions in [since, until)."""
        with self._lock:
            lat = np.asarray([s for t, s in self.samples if since <= t < until]) * 1e3
        if not lat.size:
            return 0, float("nan"), float("nan")
        return int(lat.size), float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def slo_path(dev, params, t_p, t_q):
    """slo-dpmf: the served dpmf model (100M x 10M x 128, rate 0.3) behind
    its request queue with an SLOController, 4 client threads at top-100.
    The budget is set at half the p99 measured at the trained rate, so the
    controller degrades (to max_rate 0.8); then raised tenfold, so it
    relaxes to the floor.  Per apply: the solve's and the swap's ms; p50/p99
    while the floor and the top rate are served; pruned_topk at both rates.
    Checks: thresholds within 1e-4 relative of the solve on float64
    statistics; after each apply the served top-k bitwise a fresh engine's
    at the applied thresholds; no failed request.  Counts under "slo"."""
    import dataclasses

    from repro_torch.core.ranks import effective_ranks
    from repro_torch.core.threshold import MatrixStats, threshold_for_rate
    from repro_torch.kernels import pruned_topk
    from repro_torch.serving import ServingEngine, SLOConfig, SLOController

    log(f"## slo-dpmf: the served model ({N_USERS} x {N_ITEMS} x {K}, rate {RATE}) behind its "
        f"queue with an SLOController, {CLIENTS} clients at top-{TOPK}")
    engine = ServingEngine(params, t_p, t_q, max_batch=256)
    for b in (1, 2, 4, 8):
        engine.topk(np.arange(b), TOPK)
    queue = engine.start(linger_ms=1.0)
    clients = LoadClients(engine.submit, N_USERS, TOPK, seed=SEED + 30)
    out = {}
    reset_launch_counts()
    clients.start()
    try:
        time.sleep(SLO_BASELINE_S)
        base_n, base_p50, base_p99 = clients.percentiles()
        budget = base_p99 / 2
        ctl = SLOController(engine, config=SLOConfig(p99_budget_ms=budget, max_rate=0.8,
                                                     tick_interval_s=SLO_TICK_S), queue=queue)
        applies = ctl.swap_timings   # per swap: rate, thresholds, solve and apply ms
        snaps = []
        decisions = []

        def run_ticks(until_rate, max_ticks):
            for _ in range(max_ticks):
                time.sleep(SLO_TICK_S)
                d = ctl.tick()
                decisions.append(d)
                if d.swapped:
                    snaps.append(engine._snap)
                if abs(ctl.base_rate - until_rate) < 1e-9:
                    return True
            return False

        reached_max = run_ticks(0.8, 24)
        t0 = time.perf_counter()
        time.sleep(SLO_HOLD_S)
        at_max = clients.percentiles(t0)
        ctl.config = dataclasses.replace(ctl.config, p99_budget_ms=budget * 10)
        reached_floor = run_ticks(ctl.floor_rate, 40)
        t0 = time.perf_counter()
        time.sleep(SLO_HOLD_S)
        at_floor = clients.percentiles(t0)
    finally:
        stuck = clients.stop()
        engine.stop()
    launches = {"pruned_topk": pruned_topk.launches}
    PATH_LAUNCHES["slo"] = launches
    actions = [d.action for d in decisions]
    log(f"  baseline at the trained rate: {base_n} requests, p50 {base_p50:.2f} ms, p99 "
        f"{base_p99:.2f} ms -> budget {budget:.2f} ms; floor rate {ctl.floor_rate:.4f}")
    log(f"  ticks: {' '.join(f'{d.action}@{d.applied_rate:.2f}' for d in decisions)}")
    for a in applies:
        log(f"  apply rate {a['rate']:.4f}: T_p {a['t_p']:.6g}, T_q {a['t_q']:.6g}; solve "
            f"{a['solve_ms']:.2f} ms, swap {a['apply_ms']:.2f} ms (host clock)")
    log(f"  p50/p99 at rate {decisions[-1].applied_rate:.2f} (floor): {at_floor[1]:.2f} / "
        f"{at_floor[2]:.2f} ms over {at_floor[0]} requests; at the top rate: {at_max[1]:.2f} / "
        f"{at_max[2]:.2f} ms over {at_max[0]} requests; launches {launches}")

    # -- checks, after the counted run ------------------------------------------
    mu_p, sd_p = stats64(params.p)
    mu_q, sd_q = stats64(params.q)
    worst = 0.0
    for a in applies:
        for got, (mu, sd) in ((a["t_p"], (mu_p, sd_p)), (a["t_q"], (mu_q, sd_q))):
            want = float(threshold_for_rate(MatrixStats(torch.tensor(mu, dtype=torch.float32),
                                                        torch.tensor(sd, dtype=torch.float32)),
                                            a["rate"]))
            worst = max(worst, abs(got - want) / max(abs(want), 1e-30))
    users = np.random.default_rng(SEED + 31).integers(0, N_USERS, 256)
    bitwise = True
    for snap, a in zip(snaps, applies):
        got = engine._run_chunked(snap, users, TOPK)
        fresh = ServingEngine(params, np.float32(a["t_p"]), np.float32(a["t_q"]), max_batch=256)
        want = fresh.topk(users, TOPK)
        bitwise &= all(np.array_equal(x, y) for x, y in zip(got, want))
        del fresh
    kernel_ms = {}
    pu = params.p[torch.as_tensor(users, device=dev)]
    zero = torch.zeros(N_ITEMS, device=dev)
    for rate in (RATE, 0.8):
        a = min(applies, key=lambda x: abs(x["rate"] - rate))
        r_u, r_i = effective_ranks(pu, a["t_p"]), effective_ranks(params.q, a["t_q"])
        kernel_ms[f"rate {a['rate']:.4f}"] = time_ms(
            lambda: pruned_topk.pruned_topk_ranked(pu, params.q, r_u, r_i, zero, TOPK), 5)
    del pu, zero, snaps
    log(f"  thresholds vs float64 statistics: worst relative difference {worst:.3e}; "
        f"pruned_topk (256 users, top-{TOPK}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in kernel_ms.items()))
    check(not clients.failures and not stuck and base_n > 0,
          f"slo-dpmf: {len(clients.samples)} requests, none failed ({clients.failures[:3]})")
    check(reached_max and reached_floor and "degrade" in actions and "relax" in actions,
          f"slo-dpmf: the controller degraded to 0.8 and relaxed to the floor ({actions})")
    check(worst <= 1e-4, f"slo-dpmf: every applied threshold within 1e-4 relative of the solve "
                         f"on float64 statistics ({worst:.3e})")
    check(bitwise and len(applies) >= 2,
          f"slo-dpmf: after each of {len(applies)} applies the served top-{TOPK} equals a fresh "
          "engine at the applied thresholds, bit for bit")
    check(launches["pruned_topk"] > 0, f"slo-dpmf: pruned_topk launched ({launches})")
    out.update(budget_ms=budget, baseline_p50_ms=base_p50, baseline_p99_ms=base_p99,
               floor_rate=ctl.floor_rate, applies=applies, actions=actions,
               floor_p50_ms=at_floor[1], floor_p99_ms=at_floor[2], max_p50_ms=at_max[1],
               max_p99_ms=at_max[2], pruned_topk_ms=kernel_ms, threshold_rel_err=worst,
               launches=launches, requests=len(clients.samples))
    return out


def fleet_local_phase(dev):
    """fleet-local: 3 LocalReplicas at k = 128 and the full catalog, users
    cut to FLEET_USERS, behind the affinity router; an sgd updater's
    publisher (its defaults) subscribed to it; 32 Poisson batches of 4096
    events without new ids (every message a delta), a publish every 4, 4
    clients at top-10; one SLO degrade and relax rolled out through
    router.apply_thresholds.  Checks: no failed request, every publish a
    delta, every replica at the last version and bitwise a fresh engine on
    the updater's state at the pinned thresholds.  Counts under
    "fleet_local"."""
    from repro_torch.core import mf
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.kernels import pruned_topk
    from repro_torch.online import OnlineUpdater, PoissonSource, SnapshotPublisher, iter_microbatches
    from repro_torch.serving import LatencyWindow, ServingEngine, SLOConfig, SLOController
    from repro_torch.serving.fleet import ServingFleet

    copy_gb = (FLEET_USERS + N_ITEMS) * K * 4 / 1e9
    log(f"## fleet-local: {FLEET_REPLICAS} local replicas, {FLEET_USERS} users (cut from "
        f"{N_USERS}) x {N_ITEMS} items x {K}; memory reckoned: {copy_gb:.2f} GB a copy, "
        f"{FLEET_REPLICAS} replica copies + the updater's + one copy-on-write transient = "
        f"{(FLEET_REPLICAS + 2) * copy_gb:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)
    params = mf.MFParams(p=decaying_factors(gen, FLEET_USERS, dev),
                         q=decaying_factors(gen, N_ITEMS, dev), user_bias=None, item_bias=None,
                         global_mean=None, implicit=None)
    t_p, t_q = thresholds_from_matrices(params.p, params.q, RATE)
    fleet = ServingFleet(params, t_p, t_q, replicas=FLEET_REPLICAS,
                         engine_kwargs={"max_batch": 256}, queue_kwargs={"linger_ms": 1.0},
                         router_kwargs={"policy": "affinity"})
    upd = OnlineUpdater(params, None, t_p, t_q, optimizer="sgd", lr=ONLINE_LR, lam=LAM,
                        batch_size=ONLINE_BATCH, seed=SEED)
    del params
    pub = SnapshotPublisher(None, upd)
    pub.subscribe(fleet.router)
    window = LatencyWindow(64)
    ctl = SLOController(config=SLOConfig(p99_budget_ms=50.0, max_rate=0.8, tick_interval_s=0.0),
                        window=window, depth_fn=lambda: 0, expired_fn=lambda: 0,
                        router=fleet.router, publisher=pub, params_fn=lambda: upd.params)
    applies = ctl.swap_timings
    for rep in fleet.replicas:
        for b in (1, 2, 4, 8):
            rep.engine.topk(np.arange(b), RANKING_TOPK)
    publishes, actions = [], []
    clients = LoadClients(fleet.submit, FLEET_USERS, RANKING_TOPK, seed=SEED + 41)
    source = PoissonSource(FLEET_USERS, N_ITEMS, seed=SEED + 42)
    reset_launch_counts()
    clients.start()
    t_loop = time.perf_counter()
    try:
        for b, batch in enumerate(iter_microbatches(source, ONLINE_BATCH,
                                                    max_events=ONLINE_BATCH * FLEET_BATCHES)):
            upd.apply(batch)
            if (b + 1) % PUBLISH_EVERY:
                continue
            before = {r["replica_id"]: r["apply_ms"] for r in fleet.stats()["replicas"]}
            report = pub.publish()
            after = {r["replica_id"]: r["apply_ms"] for r in fleet.stats()["replicas"]}
            publishes.append(dict(kind=report.kind, wire_bytes=report.wire_bytes,
                                  raw_bytes=report.wire_raw_bytes, publish_ms=report.swap_s * 1e3,
                                  encode_ms=report.encode_s * 1e3,
                                  apply_ms={rid: after[rid] - before[rid] for rid in after}))
            # the SLO loop: the first tick applies the floor, then one
            # degrade (a slow window) and one relax (a fast one)
            if b + 1 in (8, 16, 24):
                for _ in range(64):
                    window.record(0.2 if b + 1 == 16 else 0.001)
                actions.append(ctl.tick().action)
        loop_s = time.perf_counter() - t_loop
    finally:
        stuck = clients.stop()
    launches = {"pruned_topk": pruned_topk.launches, "add_rows": scatter_launches()}
    PATH_LAUNCHES["fleet_local"] = launches
    stats = fleet.stats()
    n, p50, p99 = clients.percentiles()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, pb in enumerate(publishes):
        log(f"  publish {i + 1} ({pb['kind']}): wire {pb['wire_bytes']} B of {pb['raw_bytes']} B "
            f"raw ({pb['wire_bytes'] / pb['raw_bytes']:.3f}); encode {pb['encode_ms']:.1f} ms; "
            f"rolling apply " + ", ".join(f"{k} {v:.1f}" for k, v in pb["apply_ms"].items())
            + f" ms; publish {pb['publish_ms']:.1f} ms")
    for a in applies:
        log(f"  SLO apply rate {a['rate']:.4f}: solve {a['solve_ms']:.2f} ms, rollout over "
            f"{FLEET_REPLICAS} replicas {a['apply_ms']:.2f} ms")
    log(f"  loop {loop_s:.2f} s; clients {n} requests, p50 {p50:.2f} ms, p99 {p99:.2f} ms; "
        f"affinity hits {stats['affinity_hits']} of {stats['routed']} routed; SLO {actions}; "
        f"launches {launches}; peak device memory {peak:.2f} GB")

    users = np.random.default_rng(SEED + 43).integers(0, FLEET_USERS, 1024)
    served_t = ctl.applied
    fresh = ServingEngine(upd.params, np.float32(served_t[0]), np.float32(served_t[1]),
                          max_batch=256)
    want = fresh.topk(users, RANKING_TOPK)
    bitwise = all(all(np.array_equal(x, y) for x, y in zip(rep.engine.topk(users, RANKING_TOPK),
                                                            want)) for rep in fleet.replicas)
    versions = [rep.version for rep in fleet.replicas]
    del fresh
    fleet.close()
    check(not clients.failures and not stuck and n > 0,
          f"fleet-local: {n} client requests, none failed ({clients.failures[:3]})")
    check(len(publishes) == FLEET_BATCHES // PUBLISH_EVERY
          and all(pb["kind"] == "delta" for pb in publishes),
          f"fleet-local: {len(publishes)} publishes, every message a delta")
    check(versions == [pub.version] * FLEET_REPLICAS and pub.lag() == 0,
          f"fleet-local: every replica at the last version ({versions}, publisher {pub.version})")
    check(bitwise, "fleet-local: every replica serves bitwise as a fresh engine on the updater's "
                   "published state at the pinned thresholds")
    check(actions[1:] == ["degrade", "relax"] and len(applies) == 3,
          f"fleet-local: one SLO degrade and relax rolled out ({actions}, {len(applies)} applies)")
    check(launches["pruned_topk"] > 0, f"fleet-local: pruned_topk launched ({launches})")
    return dict(publishes=publishes, slo_applies=applies, p50_ms=p50, p99_ms=p99, requests=n,
                affinity_hits=stats["affinity_hits"], routed=stats["routed"], peak_gb=peak,
                loop_s=loop_s, launches=launches)


def fleet_process_phase(dev):
    """fleet-process: a ServingFleet of 2 process replicas on the card at
    2^19 users x 2^18 items x 128, supervised and fed by a publisher as
    launch.online builds them (``fleet.supervise(probe_interval_s=0.5)``,
    ``SnapshotPublisher`` defaults), with clients running; a seeded
    FaultPlan kills r0 at its Nth submit, it respawns from a healthy peer's
    kind=full state and is readmitted; then one corrupted delivery to r1 is
    NAKed and healed by a kind=full publish.  Full states cross raw, their
    large leaves through files; deltas are compressed.  The codec's rate on
    this host is measured apart.
    Reports MTTR and the respawned child's bootstrap by part, and each
    child's pruned_topk launches (its own counter, under
    "fleet_process").  Checks: no dropped request; every replica serves
    bitwise as a fault-free in-process shadow fed the same messages."""
    from repro_torch.core import mf
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.distributed.compression import compress_array, decompress_array
    from repro_torch.online import OnlineUpdater, PoissonSource, SnapshotPublisher, iter_microbatches
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.fleet import EngineDeltaSink, ServingFleet, bus
    from repro_torch.testing import faults

    log(f"## fleet-process: 2 process replicas on the card, {PROC_USERS} users x {PROC_ITEMS} "
        f"items x {K}, a supervisor, {CLIENTS} clients at top-{RANKING_TOPK}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 50)
    params = mf.MFParams(p=decaying_factors(gen, PROC_USERS, dev),
                         q=decaying_factors(gen, PROC_ITEMS, dev), user_bias=None,
                         item_bias=None, global_mean=None, implicit=None)
    t_p, t_q = thresholds_from_matrices(params.p, params.q, RATE)

    # the codec on this host, both ways, over a 32 MB slice of p
    piece = params.p[: 1 << 16].cpu().numpy()
    t0 = time.perf_counter()
    blob = compress_array(piece)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = decompress_array(blob)
    dec_s = time.perf_counter() - t0
    codec = dict(mb=piece.nbytes / 1e6, ratio=blob.nbytes / piece.nbytes,
                 encode_mb_s=piece.nbytes / 1e6 / enc_s, decode_mb_s=piece.nbytes / 1e6 / dec_s)
    check(np.array_equal(back, piece), "fleet-process: the codec's round trip is bitwise")
    del piece, back, blob
    state_mb = (PROC_USERS + PROC_ITEMS) * K * 4 / 1e6
    log(f"  codec on this host ({codec['mb']:.1f} MB of factors): encode "
        f"{codec['encode_mb_s']:.1f} MB/s, decode {codec['decode_mb_s']:.1f} MB/s, ratio "
        f"{codec['ratio']:.3f}; a {state_mb:.0f} MB full state would take "
        f"{state_mb / codec['encode_mb_s']:.1f} s to encode")

    try:
        fleet = ServingFleet(params, t_p, t_q, replicas=2, backend="process",
                             engine_kwargs={"device": dev.type, "max_batch": 256},
                             queue_kwargs={"linger_ms": 1.0},
                             router_kwargs={"policy": "affinity"},
                             start_timeout=PROC_START_TIMEOUT)
    except Exception as exc:  # noqa: BLE001 -- a failed check, reported at exit
        check(False, f"fleet-process: both replicas start on the card ({exc!r})")
        return {}
    reps = list(fleet.replicas)
    log(f"  boot message {fleet.boot_ms['message']:.1f} ms (raw); 2 children up in "
        f"{fleet.boot_ms['start'] / 1e3:.1f} s; boot by part (ms): "
        + "; ".join(f"{r.replica_id} " + ", ".join(f"{k} {v:.0f}" for k, v in r.boot.items())
                    for r in reps))
    router = fleet.router
    sup = fleet.supervise(probe_interval_s=0.5)   # as launch.online --supervise
    upd = OnlineUpdater(params, None, t_p, t_q, optimizer="sgd", lr=ONLINE_LR, lam=LAM,
                        batch_size=ONLINE_BATCH, seed=SEED)
    shadow = EngineDeltaSink(ServingEngine(params, t_p, t_q, max_batch=256), replica_id="shadow")
    del params
    pub = SnapshotPublisher(None, upd)            # as launch.online: compressed deltas
    pub.subscribe(router)
    pub.subscribe(shadow)   # fault-free: the bus.deliver seam is the router's
    kill_plan = faults.FaultPlan.from_seed(SEED, sites=[("replica.submit", ["r0"], ["kill"])],
                                           n_actions=1, horizon=64)
    source = iter_microbatches(PoissonSource(PROC_USERS, PROC_ITEMS, seed=SEED + 51),
                               ONLINE_BATCH)
    clients = LoadClients(router.submit, PROC_USERS, RANKING_TOPK, seed=SEED + 52)
    kinds = []

    def step():
        upd.apply(next(source))
        report = pub.publish()
        kinds.append((report.kind, round(report.swap_s * 1e3, 1),
                      round(report.encode_s * 1e3, 1), report.wire_bytes, report.wire_raw_bytes))
        return report

    def wait_for(cond, limit):
        deadline = time.perf_counter() + limit
        while not cond() and time.perf_counter() < deadline:
            time.sleep(0.1)
        return cond()

    t_loop = time.perf_counter()
    step()                                        # a delta to both: acks for r0 and r1
    clients.start()
    try:
        with faults.installed(kill_plan):
            died = wait_for(lambda: sup.report()["deaths"] >= 1, 60)
            step()                                # r0 fenced: skipped, a delta
            recovered = wait_for(lambda: sup.report()["recovered"] >= 1,
                                 PROC_START_TIMEOUT + 60)
        healed = step()                           # r0's ack is stale: kind=full
        corrupt_plan = faults.FaultPlan([faults.FaultAction(site="bus.deliver", op="corrupt",
                                                            at=0, target="r1")])
        with faults.installed(corrupt_plan):
            naked = step()                        # r1 NAKs the corrupted delta
        lag_after_nak = pub.lag()
        reheal = step()                           # kind=full heals r1
        step()
        time.sleep(1.0)
        loop_s = time.perf_counter() - t_loop
    finally:
        stuck = clients.stop()
        sup.stop()
    report = sup.report()
    per_child = {}
    for rep in router.replicas:
        st = rep.stats()
        per_child[rep.replica_id] = dict(pid=st["pid"], launches=st["pruned_topk_launches"],
                                         version=st["version"], corrupt=st["updates_corrupt"],
                                         served=st["requests_served"])
    launches = {"pruned_topk": sum(c["launches"] for c in per_child.values())}
    PATH_LAUNCHES["fleet_process"] = launches
    incident = report["incidents"][0] if report["incidents"] else {}
    if sup.incidents and sup.incidents[0].healthy_at is not None:
        first = sup.incidents[0]
        incident.update(heal_and_spawn_s=first.respawned_at - first.detected_at,
                        converge_s=first.healthy_at - first.respawned_at)
    new_r0 = router.replicas[0]
    n, p50, p99 = clients.percentiles()
    users = np.random.default_rng(SEED + 53).integers(0, PROC_USERS, 512)
    want = shadow.engine.topk(users, RANKING_TOPK)
    shadow_state = [(key, np.asarray(val)) for key, val in shadow.state_message().tree.items()]
    bitwise = True
    for rep in router.replicas:
        rows = [f.result(120) for f in [rep.submit(int(u), RANKING_TOPK, timeout=60.0)
                                        for u in users]]
        bitwise &= (np.array_equal(np.stack([r[0] for r in rows]), want[0])
                    and np.array_equal(np.stack([r[1] for r in rows]), want[1]))
    for rep in router.replicas:   # the served tables and thresholds themselves
        served = rep.state_message()
        bitwise &= bus.verify_message(served) and all(
            np.array_equal(np.asarray(served.tree[key]), want_leaf)
            for key, want_leaf in shadow_state)
    versions = [rep.version for rep in router.replicas]
    fleet.close()
    shadow.engine.stop()
    log(f"  kill plan {[(a.site, a.op, a.at, a.target) for a in kill_plan._actions]} fired "
        f"{kill_plan.fired}; incidents {report['incidents']}; respawned r0 boot by part (ms): "
        + ", ".join(f"{k} {v:.0f}" for k, v in new_r0.boot.items()))
    log(f"  publishes (kind, publish ms, encode ms, wire B, raw B) {kinds}; after the corrupted delivery: acks {naked.acked}, lag "
        f"{lag_after_nak}; heal {reheal.kind}, acks {reheal.acked}")
    log(f"  loop {loop_s:.1f} s; clients {n} requests, p50 {p50:.2f} ms, p99 {p99:.2f} ms; "
        f"failovers {router.failovers}; children {per_child}")
    check(not clients.failures and not stuck and n > 0,
          f"fleet-process: {n} client requests through the kill, none failed or dropped "
          f"({clients.failures[:3]})")
    check(died and recovered and report["deaths"] == 1 and report["recovered"] == 1
          and kill_plan.pending == 0,
          f"fleet-process: r0 killed by the seeded plan, respawned from a peer and readmitted "
          f"(MTTR {incident.get('mttr_s')})")
    check(healed.kind == "full", "fleet-process: the first publish after the readmission "
                                 "heals r0's stale ack with kind=full")
    check(naked.kind == "delta" and naked.acked["r1"] < naked.version and reheal.kind == "full"
          and per_child["r1"]["corrupt"] == 1,
          "fleet-process: the corrupted delivery was NAKed and healed with kind=full")
    check(versions == [pub.version] * 2 and bitwise,
          f"fleet-process: both replicas at the last version ({versions}), their served tables, "
          "thresholds and top-k bitwise the fault-free shadow's")
    check(all(c["launches"] > 0 for c in per_child.values()),
          f"fleet-process: pruned_topk launched in each child ({per_child})")
    return dict(codec=codec, boot_message_ms=fleet.boot_ms["message"],
                spawn_s=fleet.boot_ms["start"] / 1e3,
                boot_ms={r.replica_id: r.boot for r in reps}, respawn_boot_ms=new_r0.boot,
                mttr_s=incident.get("mttr_s"), incident=incident, publishes=kinds, p50_ms=p50, p99_ms=p99,
                requests=n, children=per_child, launches=launches, loop_s=loop_s)


def fleet_launchers_phase(tmp):
    """``launch.serve --replicas 2 --replica-backend process --slo-p99-ms``
    and ``launch.online --replicas 2 --supervise --slo-p99-ms`` on the card,
    on a small checkpoint: both must exit 0."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import mf
    from repro_torch.core.threshold import thresholds_from_matrices

    env = dict(os.environ, PYTHONPATH=str(SRC))
    path = os.path.join(tmp, "fleet_ckpt")
    rng = np.random.default_rng(SEED + 60)
    params = mf.params_from_numpy({"p": rng.normal(0, 0.1, (20000, 64)).astype(np.float32),
                                   "q": rng.normal(0, 0.1, (50000, 64)).astype(np.float32)},
                                  device="cpu")
    t_p, t_q = thresholds_from_matrices(params.p, params.q, RATE)
    ckpt.save(path, 1, {"params": params, "t_p": t_p.numpy(), "t_q": t_q.numpy()})
    runs = {}
    for name, cmd in (
        ("serve", [sys.executable, "-m", "repro_torch.launch.serve", "--ckpt", path, "--device",
                   "cuda", "--replicas", "2", "--replica-backend", "process", "--concurrent",
                   "3000", "--clients", "8", "--topk", "10", "--slo-p99-ms",
                   str(LAUNCHER_SLO_MS)]),
        ("online", [sys.executable, "-m", "repro_torch.launch.online", "--use-kernel", "--device",
                    "cuda", "--scale", "0.05", "--train-epochs", "3", "--events", "2000",
                    "--batch-events", "64", "--swap-every", "4", "--clients", "4", "--source",
                    "poisson", "--replicas", "2", "--supervise", "--slo-p99-ms",
                    str(LAUNCHER_SLO_MS)]),
    ):
        log(f"## fleet launcher: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        text = proc.stdout
        if name == "serve":
            report = json.loads(text.strip().splitlines()[-1]) if proc.returncode == 0 else {}
        else:
            report = json.loads(text[text.index("{"):]) if "{" in text else {}
        log(f"  exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; "
            + " | ".join(line for line in text.splitlines() if line.startswith(("#", "concurrent",
                                                                                "slo:"))))
        if proc.returncode:
            log(proc.stderr[-3000:])
        runs[name] = (proc.returncode, report)
    serve_rc, serve = runs["serve"]
    online_rc, online = runs["online"]
    check(serve_rc == 0 and serve.get("slo_violated") is False,
          "serve launcher with 2 process replicas and the SLO controller on the card: exit 0")
    check(online_rc == 0 and online.get("requests_failed") == 0
          and online.get("failures", {}).get("deaths") == 0
          and set(online.get("replica_versions", {}).values()) == {online.get("final_version")},
          "online launcher with a supervised fleet of 2 and the SLO controller on the card: "
          "exit 0, no failed request, every replica at the last version")
    return {"serve": {k: serve.get(k) for k in ("req_per_s", "p50_ms", "p99_ms",
                                               "steady_p99_ms", "slo_violated")},
            "online": {k: online.get(k) for k in ("requests_ok", "latency_ms_p99",
                                                  "replica_versions", "wire_bytes_total",
                                                  "slo_violated")}}


# ---------------------------------------------------------------------------
# multirank-dpmf: 4 ranks on the one card, gloo over CUDA tensors
# ---------------------------------------------------------------------------


def _mr_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mr_peak_gb(dev, reset=False):
    """This rank's peak device memory (0 on the CPU, where the phase is
    rehearsed at a tiny size)."""
    if dev.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _mr_factors(seed, rows, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return decaying_factors(gen, rows, dev)


MR_CHUNK = 1 << 22


def _mr_rows(seed, rows, lo, hi, dev):
    """Rows [lo, hi) of a ``rows``-row table drawn in chunks of up to
    MR_CHUNK rows, each from its own seed, so a rank's block is the same
    rows as in the whole table and no more than one chunk is drawn beside
    the result."""
    size = min(MR_CHUNK, rows)
    out = torch.empty((hi - lo, K), device=dev)
    for c in range(lo // size, -(-hi // size)):
        a, b = max(lo, c * size), min(hi, (c + 1) * size)
        chunk = _mr_factors(seed * 100_003 + c, size, dev)
        out[a - lo:b - lo] = chunk[a - c * size:b - c * size]
        del chunk
    return out


def _mr_full(m, n, seed, dev):
    """The full (m, K) and (n, K) tables of ``seed``."""
    return _mr_rows(seed, m, 0, m, dev), _mr_rows(seed + 1, n, 0, n, dev)


def _mr_blocks(m, n, seed, mesh, dev):
    """This rank's blocks of :func:`_mr_full`'s tables."""
    from repro_torch.distributed import sharding, spmd

    dp = sharding.data_axes(mesh)
    m_loc, n_loc = m // spmd.axis_size(mesh, dp), n // spmd.axis_size(mesh, "model")
    d, j = spmd.axis_index(mesh, dp), spmd.axis_index(mesh, "model")
    return (_mr_rows(seed, m, d * m_loc, (d + 1) * m_loc, dev),
            _mr_rows(seed + 1, n, j * n_loc, (j + 1) * n_loc, dev))


def _mr_batch(rng, count, m, n, n_dp):
    """``count`` ratings under the ownership contract: data shard s's
    contiguous chunk holds users of its own rows; items ~ 1/(i + 10^4)."""
    m_loc = m // n_dp
    users = np.concatenate([rng.integers(s * m_loc, (s + 1) * m_loc, count // n_dp)
                            for s in range(n_dp)]).astype(np.int32)
    ds = dpmf_ratings(rng, count, num_users=m, num_items=n)
    return {"user": users, "item": ds.item, "rating": ds.rating}


def _mr_thresholds(dev, rows=1 << 20):
    """T for rate 0.3 from a ``rows``-row sample of the factors'
    distribution (the same on every rank)."""
    from repro_torch.core.threshold import thresholds_from_matrices

    sample = _mr_factors(SEED + 79, rows, dev)
    return thresholds_from_matrices(sample, sample, RATE)


def _mr_digests(params, mesh):
    """(data index, model index, digest of p's block, digest of q's block):
    replicas of a block must hold the same bits.  A digest is an exact
    integer checksum of the block's bits, position-weighted, taken on the
    card chunk by chunk."""
    from repro_torch.distributed import sharding, spmd

    def digest(t):
        bits = t.contiguous().view(torch.int32).reshape(-1)
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        step = 1 << 26
        for lo in range(0, bits.numel(), step):
            piece = bits[lo:lo + step].to(torch.int64)
            weight = torch.arange(lo, lo + piece.numel(), device=t.device) % 65_521 + 1
            total += (piece * weight).sum()
        return int(total)

    return (spmd.axis_index(mesh, sharding.data_axes(mesh)), spmd.axis_index(mesh, "model"),
            digest(params.p), digest(params.q))


def _mr_finite(*tables) -> bool:
    """Every entry finite, read 2^22 rows at a time (a table may fill most
    of the card)."""
    return all(bool(torch.isfinite(piece).all()) for t in tables for piece in t.split(MR_CHUNK))


def _mr_replicas_agree(digests) -> bool:
    by_data, by_model = {}, {}
    for d, m, p_digest, q_digest in digests:
        by_data.setdefault(d, set()).add(p_digest)
        by_model.setdefault(m, set()).add(q_digest)
    return all(len(v) == 1 for v in (*by_data.values(), *by_model.values()))


def _mr_small(ctx, tmp, sizes):
    """At ``sizes`` (users, items) on the (2, 2) mesh: the sharded step against the
    single-device train_step (sgd and adagrad, T = 0 and rate 0.3), the
    sharded updater against the single-device updater, and a (2, 2)
    checkpoint restored by elastic_load onto (1, 4), bitwise."""
    from repro_torch.checkpoint import checkpoint
    from repro_torch.core import mf
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.distributed import sharding
    from repro_torch.online import EventBatch, OnlineUpdater
    from repro_torch.optim.optimizers import RowOptimizer

    dev = torch.device(ctx.device)
    mesh = ctx.mesh(MR_SHAPE, MR_NAMES)
    m, n = sizes
    p, q = _mr_full(m, n, SEED + 71, dev)
    t_p, t_q = thresholds_from_matrices(p, q, RATE)
    out = {}
    rows = min(1 << 14, m)
    batch = _mr_batch(np.random.default_rng(SEED + 72), rows, m, n, 2)
    batch["weight"] = np.random.default_rng(SEED + 73).uniform(0.3, 1.0, rows).astype(np.float32)
    for opt_name in ("sgd", "adagrad"):
        opt = RowOptimizer(name=opt_name)
        for label, tp, tq in (("T=0", 0.0, 0.0), (f"rate {RATE}", t_p, t_q)):
            single = mf.MFParams(p.clone(), q.clone(), None, None, None, None)
            s_state = mf.init_opt_state(single, opt)
            tree = sharding.shard_tree({"params": single, "opt_state": s_state}, mesh)
            tb = {key: torch.as_tensor(value).to(dev) for key, value in batch.items()}
            tb["user"], tb["item"] = tb["user"].long(), tb["item"].long()
            mf.train_step(single, s_state, tb, torch.as_tensor(tp, device=dev),
                          torch.as_tensor(tq, device=dev), LR, torch.ones(K, device=dev),
                          opt=opt, lam=LAM)
            blk, b_state, _ = mf.train_step_shard_map(
                tree["params"], tree["opt_state"], batch, tp, tq, lr=LR, lam=LAM,
                opt_name=opt_name, mesh=mesh)
            full = sharding.assemble_tree({"params": blk, "opt_state": b_state}, mesh)
            pairs = [(full["params"].p, single.p), (full["params"].q, single.q)]
            if opt_name == "adagrad":
                pairs += [(full["opt_state"].p["acc"], s_state.p["acc"]),
                          (full["opt_state"].q["acc"], s_state.q["acc"])]
            # (max abs err, max of err - 1e-6 |want|): both steps add
            # repeated rows in batch order (add_rows), so the first is 0
            out[f"step {opt_name} {label}"] = (
                max(float((g - w).abs().max()) for g, w in pairs),
                max(float(((g - w).abs() - 1e-6 * w.abs()).max()) for g, w in pairs))
            out[f"digest {opt_name} {label}"] = _mr_digests(blk, mesh)
    # the sharded updater against the single-device one (adagrad, 3 batches)
    rng = np.random.default_rng(SEED + 74)
    base = mf.MFParams(p, q, None, None, None, None)
    single = OnlineUpdater(base, None, t_p, t_q, optimizer="adagrad", lr=0.03, lam=LAM,
                           batch_size=4096, seed=SEED, device=dev)
    sharded = OnlineUpdater(base, None, t_p, t_q, optimizer="adagrad", lr=0.03, lam=LAM,
                            batch_size=4096, seed=SEED, device=dev, mesh=mesh)
    errs = []
    for _ in range(3):
        ev = dpmf_ratings(rng, rows // 4, num_users=m, num_items=n)
        events = EventBatch(user=ev.user, item=ev.item, rating=ev.rating,
                            weight=rng.uniform(0.25, 1.0, rows // 4).astype(np.float32))
        single.apply(events)
        sharded.apply(events)
        got, _ = sharded._assembled(with_state=False)
        errs.append(max(float((got.p - single.params.p).abs().max()),
                        float((got.q - single.params.q).abs().max())))
    out["updater"] = max(errs)
    # elastic restore: a (2, 2) checkpoint onto (1, 4)
    tree = sharding.assemble_tree({"params": sharded.params, "opt_state": sharded.opt_state},
                                  mesh)
    written = {key: value for key, value in checkpoint.flatten_with_paths(tree)}
    if ctx.rank == 0:
        checkpoint.save(tmp, 1, tree)
    torch.distributed.barrier()
    wide = ctx.mesh((1, 4), MR_NAMES)
    blocks, _ = checkpoint.elastic_load(tmp, tree, lambda t: sharding.shard_tree(t, wide, device=dev))
    back = dict(checkpoint.flatten_with_paths(sharding.assemble_tree(blocks, wide)))
    out["restore bitwise"] = set(back) == set(written) and all(
        np.array_equal(back[key], value) for key, value in written.items())
    out["restore q block rows"] = int(blocks["params"].q.shape[0])
    return out


def _mr_train(ctx, mode, steps, m, n, batch_rows):
    """``steps`` sharded steps of ``batch_rows`` ratings in ``mode`` on this
    rank's blocks of (m, n) tables (made on the first call), adagrad at
    rate 0.3: the last step measured,
    collectives by name (bytes this rank sent, host ms with the card
    synchronised around each) and the step's host ms."""
    from repro_torch.core import mf
    from repro_torch.distributed import sharding, spmd

    dev = torch.device(ctx.device)
    mesh = ctx.mesh(MR_SHAPE, MR_NAMES)
    st = ctx.state
    if "params" not in st:
        _mr_peak_gb(dev, reset=True)
        p, q = _mr_blocks(m, n, SEED + 70, mesh, dev)
        st["params"] = mf.MFParams(p, q, None, None, None, None)
        st["state"] = mf.MFOptState(p={"acc": torch.zeros_like(p)}, q={"acc": torch.zeros_like(q)},
                                    user_bias=None, item_bias=None, implicit=None)
        st["t"] = _mr_thresholds(dev, min(1 << 20, m))
    if mode == "int8_ef":
        st["state"] = mf.init_error_feedback_state(st["params"], st["state"], mesh)
    n_dp = spmd.axis_size(mesh, sharding.data_axes(mesh))
    log = spmd.CollectiveLog()
    for step in range(steps):
        batch = _mr_batch(np.random.default_rng(SEED + 75 + step), batch_rows, m, n, n_dp)
        batch = {key: torch.as_tensor(value).to(dev) for key, value in batch.items()}
        measured = step == steps - 1
        _mr_sync(dev)
        t0 = time.perf_counter()
        with spmd.recording(log if measured else spmd.CollectiveLog()):
            _, _, metrics = mf.train_step_shard_map(
                st["params"], st["state"], batch, *st["t"], lr=LR, lam=LAM, opt_name="adagrad",
                grad_compression=mode, mesh=mesh)
            abs_err = float(metrics["abs_err"])
        _mr_sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
    digests = _mr_digests(st["params"], mesh)
    if mode == "int8_ef":
        for side in (st["state"].p, st["state"].q):
            for key in ("ef_psum", "ef_gather"):
                side.pop(key, None)
    coll_ms = sum(log.ms.values())
    return dict(step_ms=step_ms, local_ms=step_ms - coll_ms, collective_ms=dict(log.ms),
                digests=digests,
                collective_bytes=dict(log.bytes_sent), calls=dict(log.calls), abs_err=abs_err,
                finite=_mr_finite(st["params"].p, st["params"].q),
                peak_gb=_mr_peak_gb(dev))


def _mr_release(ctx):
    ctx.state.clear()
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()


def _mr_serve(ctx, users, m, n, slab_rows):
    """The served model at (m, n) x 128 (rate 0.3) behind one engine
    per rank: the counted run (topk_sharded at top-100 for the users, then
    evaluate_engine(mesh=) over 512 users), then, uncounted, rank 0's local
    engine.topk and each rank's kernel against the plain version on a
    slice of its slab."""
    from repro_torch.core import mf
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.eval import ranking
    from repro_torch.kernels import pruned_topk
    from repro_torch.serving import ServingEngine

    dev = torch.device(ctx.device)
    mesh = ctx.mesh(MR_SHAPE, MR_NAMES)
    _mr_peak_gb(dev, reset=True)
    p, q = _mr_full(m, n, SEED + 80, dev)
    t_p, t_q = thresholds_from_matrices(p, q, RATE)
    engine = ServingEngine(mf.MFParams(p, q, None, None, None, None), t_p, t_q, device=dev,
                           max_batch=TOPK_USERS)
    del p, q
    engine._snap.kernel_shard_slab(mesh)   # the slab, built before the counted run
    rng = np.random.default_rng(SEED + 81)
    rel_users = np.arange(2 * TOPK_USERS, dtype=np.int64)
    relevant = np.where(rng.random((len(rel_users), 20)) < 0.5,
                        rng.integers(0, 200, (len(rel_users), 20)),
                        rng.integers(0, n, (len(rel_users), 20))).astype(np.int32)
    relevant.sort(axis=1)
    counts = np.full(len(rel_users), 20, np.int32)
    _mr_sync(dev)
    pruned_topk.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got_s, got_i = engine.topk_sharded(users, TOPK, mesh=mesh)
        times.append((time.perf_counter() - t0) * 1e3)
    report = ranking.evaluate_engine(engine, None, RANKING_TOPK, mesh=mesh,
                                     relevance=(rel_users, relevant, counts))
    launches = pruned_topk.launches
    out = dict(launches=launches, sharded_ms=times, report=report)
    if ctx.rank == 0:
        local = []
        for _ in range(3):
            t0 = time.perf_counter()
            want_s, want_i = engine.topk(users, TOPK)
            local.append((time.perf_counter() - t0) * 1e3)
        out.update(local_ms=local, got=(got_s, got_i), want=(want_s, want_i),
                   local_report=ranking.evaluate_engine(engine, None, RANKING_TOPK,
                                                        relevance=(rel_users, relevant, counts)))
    # this rank's kernel against the plain version on a slice of its slab
    q_slab, r_slab, b_slab, n_loc = engine._snap.kernel_shard_slab(mesh)
    rows = slice(0, slab_rows)
    pu = engine.params.p[torch.as_tensor(users, device=dev)].contiguous()
    r_u = effective_ranks(pu, engine.t_p)
    ks, ki = pruned_topk.pruned_topk_ranked(pu, q_slab[rows].contiguous(), r_u,
                                            r_slab[rows].contiguous(), b_slab[rows].contiguous(),
                                            TOPK)
    ps, pi = pruned_topk.pruned_topk_plain(pu, q_slab[rows], r_u, r_slab[rows], b_slab[rows],
                                           TOPK, block_n=PLAIN_BLOCK_N)
    near = (ks - ps).abs() <= ATOL + RTOL * ps.abs()
    out["slab"] = dict(n_loc=n_loc, err=float((ks - ps).abs().max()), near=bool(near.all()),
                       ids_outside_ties=bool(((ki == pi) | near).all()))
    out["peak_gb"] = _mr_peak_gb(dev)
    del engine
    _mr_release(ctx)
    return out


def _mr_online(ctx, m, n, batch_rows):
    """OnlineUpdater(mesh=) at (m, n) x 128, adagrad: 3 batches of
    ``batch_rows`` events within the tables, then one naming new users and items (growth
    to the mesh multiples: assemble, grow, re-shard); per batch host ms."""
    from repro_torch.core import mf
    from repro_torch.online import EventBatch, OnlineUpdater

    dev = torch.device(ctx.device)
    mesh = ctx.mesh(MR_SHAPE, MR_NAMES)
    p, q = _mr_full(m, n, SEED + 90, dev)
    t_p, t_q = _mr_thresholds(dev, min(1 << 20, m))
    upd = OnlineUpdater(mf.MFParams(p, q, None, None, None, None), None, t_p, t_q,
                        optimizer="adagrad", lr=ONLINE_LR, lam=LAM, batch_size=batch_rows,
                        seed=SEED, device=dev, mesh=mesh)
    del p, q
    rng = np.random.default_rng(SEED + 91)
    ms = []
    for b in range(4):
        ev = dpmf_ratings(rng, batch_rows, num_users=m, num_items=n)
        users, items = ev.user.copy(), ev.item.copy()
        if b == 3:
            users[:8] = m + np.arange(8)
            items[:8] = n + np.arange(8)
        _mr_sync(dev)
        t0 = time.perf_counter()
        upd.apply(EventBatch(user=users, item=items, rating=ev.rating))
        _mr_sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    finite = _mr_finite(upd.params.p, upd.params.q)
    return dict(batch_ms=ms, num_users=upd.num_users, num_items=upd.num_items, finite=finite,
                block_rows=(int(upd.params.p.shape[0]), int(upd.params.q.shape[0])),
                mean_abs_err=upd.mean_abs_err)


def multirank_phase(dev, tmp, sizes=None):
    """multirank-dpmf: 4 ranks spawned on the one card, a (2, 2) ("data",
    "model") mesh, gloo over CUDA tensors (NCCL refuses two ranks on one
    device), dpmf at full width (k = 128, 10M items) with its own
    optimizer, adagrad, and the users cut to MR_USERS so that the four
    ranks' tables fit the card.  Checks at MR_SMALL first (step, updater,
    restore), then the sharded step at B = 2^20 in each gradient mode, the
    served model (topk_sharded at top-100 for 256 users, evaluate_engine
    over 512 users; pruned_topk counted under "multirank", on every rank),
    and OnlineUpdater(mesh=) with new ids.  ``sizes`` overrides the sizes
    (a rehearsal on the CPU passes tiny ones)."""
    from repro_torch.testing.ranks import RankPool

    sz = dict(small=MR_SMALL, users=MR_USERS, items=N_ITEMS, batch=MR_BATCH, topk_users=TOPK_USERS,
              slab_rows=1 << 18, online=MR_ONLINE, online_batch=ONLINE_BATCH)
    sz.update(sizes or {})

    log(f"## multirank-dpmf: 4 ranks on the card, mesh {MR_SHAPE} {MR_NAMES}, gloo over CUDA "
        f"tensors; {sz['users']} users x {sz['items']} items x {K}, adagrad, batch {sz['batch']}")
    t0 = time.perf_counter()
    out = {}
    with RankPool(4, backend="gloo", device=dev.type, timeout_s=120.0) as pool:
        out["spawn_s"] = time.perf_counter() - t0
        small = pool.run(_mr_small, os.path.join(tmp, "multirank_ckpt"), sz["small"])
        for key in small[0]:
            if key.startswith("step"):
                err = max(r[key][0] for r in small)
                excess = max(r[key][1] for r in small)
                check(err == 0.0, f"multirank-dpmf: sharded step {key[5:]} at {sz['small']} "
                                  f"bitwise the single-device train_step (max abs err {err:.3e}, "
                                  f"past 1e-6 |x| {excess:.3e})")
                check(_mr_replicas_agree([r["digest" + key[4:]] for r in small]),
                      f"multirank-dpmf: sharded step {key[5:]}: the replicas of every block "
                      "hold the same bits")
        worst = max(r["updater"] for r in small)
        check(worst <= 2e-7, f"multirank-dpmf: sharded OnlineUpdater within 2e-7 of the "
                             f"single-device updater over 3 batches (max abs err {worst:.3e})")
        check(all(r["restore bitwise"] for r in small)
              and all(r["restore q block rows"] == sz["small"][1] // 4 for r in small),
              "multirank-dpmf: a (2, 2) checkpoint restored by elastic_load onto (1, 4), bitwise")
        out["small"] = small[0]
        train = {}
        for mode in ("none", "int8", "int8_ef"):
            res = pool.run(_mr_train, mode, MR_STEPS, sz["users"], sz["items"], sz["batch"])
            train[mode] = res
            r0 = res[0]
            log(f"  {mode}: step {r0['step_ms']:.1f} ms (local {r0['local_ms']:.1f} ms), "
                f"collectives ms {({k: round(v, 1) for k, v in r0['collective_ms'].items()})}, "
                f"bytes sent by rank 0 {r0['collective_bytes']}, abs err {r0['abs_err']:.4f}, "
                f"peak {[round(r['peak_gb'], 2) for r in res]} GB")
            check(all(r["finite"] for r in res) and len({r["abs_err"] for r in res}) == 1
                  and _mr_replicas_agree([r["digests"] for r in res]),
                  f"multirank-dpmf: {mode} steps finite, metrics equal on every rank, the "
                  "replicas of every block bitwise equal")
        out["train"] = {mode: {k: v for k, v in res[0].items() if k != "digests"}
                        for mode, res in train.items()}
        out["train_peak_gb"] = [r["peak_gb"] for r in train["int8_ef"]]
        pool.run(_mr_release)
        users = np.random.default_rng(SEED + 82).integers(0, sz["users"], sz["topk_users"])
        serve = pool.run(_mr_serve, users, sz["users"], sz["items"], sz["slab_rows"])
        r0 = serve[0]
        compare_topk(torch.as_tensor(r0["got"][0]), torch.as_tensor(r0["got"][1]),
                     torch.as_tensor(r0["want"][0]), torch.as_tensor(r0["want"][1]),
                     f"multirank-dpmf: topk_sharded vs rank 0's engine.topk (top-{TOPK})")
        check(all(np.array_equal(r["got"][1], r0["got"][1]) for r in serve if "got" in r),
              "multirank-dpmf: every rank returns the same answer")
        rep, local = r0["report"], r0["local_report"]
        check(all(r["report"] == rep for r in serve)
              and max(abs(rep.hr - local.hr), abs(rep.ndcg - local.ndcg),
                      abs(rep.recall - local.recall)) <= 2.0 / rep.users,
              f"multirank-dpmf: evaluate_engine(mesh=) {rep} against the local engine {local} "
              "(within one near-tie swap)")
        for rank, r in enumerate(serve):
            check(r["slab"]["near"] and r["slab"]["ids_outside_ties"],
                  f"multirank-dpmf: rank {rank}'s pruned_topk on {sz['slab_rows']} rows of its slab against "
                  f"the plain version (max abs err {r['slab']['err']:.3e})")
        launches = [r["launches"] for r in serve]
        check(all(n > 0 for n in launches),
              f"multirank-dpmf: pruned_topk launched on every rank ({launches})")
        PATH_LAUNCHES["multirank"] = {"pruned_topk": sum(launches)}
        out["serve"] = dict(sharded_ms=r0["sharded_ms"], local_ms=r0["local_ms"],
                            launches=launches, peak_gb=[r["peak_gb"] for r in serve],
                            slab_rows=r0["slab"]["n_loc"],
                            report=(rep.hr, rep.ndcg, rep.recall))
        log(f"  topk_sharded ms {[round(t, 2) for t in r0['sharded_ms']]} vs local engine.topk ms "
            f"{[round(t, 2) for t in r0['local_ms']]}; launches per rank {launches}; peak "
            f"{out['serve']['peak_gb']} GB")
        online = pool.run(_mr_online, *sz["online"], sz["online_batch"])
        o0 = online[0]
        check(all(r["finite"] for r in online) and o0["num_users"] % 2 == 0
              and o0["num_users"] >= sz["online"][0] + 8 and o0["num_items"] >= sz["online"][1] + 8,
              f"multirank-dpmf: OnlineUpdater(mesh=) grew to {o0['num_users']} x "
              f"{o0['num_items']} (mesh multiples), tables finite")
        out["online"] = o0
        log(f"  online: batch ms {[round(t, 1) for t in o0['batch_ms']]}; tables "
            f"{o0['num_users']} x {o0['num_items']}, blocks {o0['block_rows']}")
    out["total_s"] = time.perf_counter() - t0
    log(f"  multirank-dpmf: {out['total_s']:.1f} s (spawn {out['spawn_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# add_rows: the batch-order row scatter of the training path (C7)
# ---------------------------------------------------------------------------


def scatter_launches() -> int:
    from repro_torch.kernels import scatter

    return scatter.launches


def _touched_rows_against_cpu(table, before, idx, rows, what):
    """``table`` after ``add_rows`` against the CPU's ``index_add_`` on CPU
    copies of the touched rows (bitwise), and every other row unchanged."""
    uniq, inv = torch.unique(idx, return_inverse=True)
    want = before[uniq].cpu().index_add_(0, inv.cpu(), rows.cpu())
    got = table[uniq].cpu()
    err = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, want), f"add_rows {what}: the {len(uniq)} touched rows bitwise the "
                                  f"CPU's index_add_ (max abs err {err:.3e})")
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    touched[uniq] = True
    changed = table != before if table.dim() == 1 else (table != before).any(1)
    check(not bool((changed & ~touched).any()), f"add_rows {what}: no other row changed")
    return len(uniq), err


def add_rows_phase(dev):
    """``add_rows`` (csrc/add_rows.cu) at the training step's shape: 2^20
    rows of k = 128 into dpmf's 10M-row ``q`` with the training path's
    skewed items, against the CPU's ``index_add_`` on CPU copies (bitwise)
    and against its plain form in passes on the card (bitwise); a bfloat16
    table and two bias vectors likewise; timed against ``index_add_`` (one
    PyTorch call, atomics) and the passes."""
    from repro_torch.kernels import scatter

    log(f"## add_rows: {BATCH} rows x k={K} into a {N_ITEMS}-row table, items ~ 1/(i + "
        f"{ITEM_OFFSET}), float32")
    rng = np.random.default_rng(SEED + 9)
    idx = torch.as_tensor(dpmf_ratings(rng, BATCH).item.astype(np.int64)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    table = decaying_factors(gen, N_ITEMS, dev)
    rows = decaying_factors(gen, BATCH, dev).mul_(LR)
    before = table.clone()
    n0 = scatter.launches
    scatter.add_rows(table, idx, rows)
    torch.cuda.synchronize()
    check(scatter.launches == n0 + 1, f"add_rows: one launch ({scatter.launches - n0})")
    unique, err = _touched_rows_against_cpu(table, before, idx, rows, "float32")
    passes = scatter.add_rows_in_passes(before.clone(), idx, rows)
    check(torch.equal(passes, table), "add_rows float32: bitwise its plain form in passes on the card")
    del passes
    again = scatter.add_rows(before.clone(), idx, rows)
    check(torch.equal(again, table), "add_rows float32: a second run from the same table, bitwise")
    del again
    # a bias vector of the same table, float32
    bias = torch.randn(N_ITEMS, generator=gen, device=dev)
    bias_before = bias.clone()
    scatter.add_rows(bias, idx, rows[:, 0].contiguous())
    _touched_rows_against_cpu(bias, bias_before, idx, rows[:, 0], "float32 vector")
    del bias, bias_before
    # bfloat16: a (n, k) table sums in float32 and rounds once, a vector rounds each add
    small = 1 << 20
    bidx = torch.as_tensor(dpmf_ratings(rng, BATCH, num_items=small).item.astype(np.int64)).to(dev)
    btab = decaying_factors(gen, small, dev).bfloat16()
    brows = rows.bfloat16()
    bbefore = btab.clone()
    scatter.add_rows(btab, bidx, brows)
    _touched_rows_against_cpu(btab, bbefore, bidx, brows, f"bfloat16 {small} x {K}")
    bvec = btab[:, 3]
    bvec_before = bvec.clone()
    scatter.add_rows(bvec, bidx, brows[:, 0].contiguous())
    _touched_rows_against_cpu(bvec, bvec_before, bidx, brows[:, 0], "bfloat16 column view")
    del btab, bbefore, brows, bvec, bvec_before

    ms = time_ms(lambda: scatter.add_rows(table, idx, rows), 20)
    sort_ms = time_ms(lambda: torch.sort(idx, stable=True), 20)
    lib_ms = time_ms(lambda: table.index_add_(0, idx, rows), 20)
    plain_ms = time_ms(lambda: scatter.add_rows_in_passes(table, idx, rows), 3)
    # rows and indices read once; each touched table row read once and written once
    nbytes = 4.0 * BATCH * K + 8.0 * BATCH + 2 * 4.0 * unique * K
    b_ms, b_by = bound(float(BATCH * K), nbytes)
    log(f"  {unique} distinct rows; add_rows {ms:.3f} ms (its stable sort alone {sort_ms:.3f} ms), "
        f"index_add_ (atomics, any order) {lib_ms:.3f} ms, plain passes {plain_ms:.3f} ms; bound "
        f"{b_ms:.3f} ms ({b_by}: {nbytes / 1e9:.3f} GB); {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    del table, before, rows, idx
    torch.cuda.empty_cache()
    return dict(err=err, ms=ms, sort_ms=sort_ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, unique=unique)


def steps_reproducible(trainer, batch, lr, what):
    """Two full-size fused steps from one state (the touched rows restored
    in between) give the same bits."""
    from repro_torch.core import mf

    params = trainer.params
    users, items = torch.unique(batch["user"]), torch.unique(batch["item"])
    p0, q0 = params.p[users].clone(), params.q[items].clone()
    dim_mask = torch.ones((K,), device=params.p.device)
    outs = []
    for _ in range(2):
        params.p[users], params.q[items] = p0, q0
        mf.train_step(params, trainer.opt_state, batch, trainer.t_p, trainer.t_q, lr, dim_mask,
                      opt=trainer.opt, lam=LAM, use_fused_kernel=True)
        outs.append((params.p[users].clone(), params.q[items].clone()))
    same = torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    check(same, f"{what}: two steps from one state bitwise equal ({len(users)} p rows, "
                f"{len(items)} q rows; max abs difference {err:.3e})")


# ---------------------------------------------------------------------------
# recsys: FM, SASRec (and its sessions through the engine), BST and DLRM
# ---------------------------------------------------------------------------

# the configs' published sizes, copied by hand from src/repro/configs/
# fm_arch.py, sasrec_arch.py, bst_arch.py and dlrm_mlperf.py (and the MLPerf
# vocabularies of src/repro/models/recsys.py), as dpmf's are above
FM_FIELDS, FM_VOCAB, FM_K, FM_T = 39, 1_048_576, 10, 0.02
SR_ITEMS, SR_K, SR_BLOCKS, SR_HEADS, SR_SEQ, SR_T = 1_048_575, 50, 2, 1, 50, 0.002
BST_ITEMS, BST_K, BST_SEQ, BST_BLOCKS, BST_HEADS = 1_048_575, 32, 20, 1, 8
BST_MLP, BST_PROFILE = (1024, 512, 256), 16
DLRM_K, DLRM_BOT, DLRM_TOP, DLRM_T = 128, (512, 256, 128), (1024, 1024, 512, 256, 1), 0.002
DLRM_CAP = 1 << 23  # rows a table keeps on one card: the five larger tables are cut to it
# configs/base.py: serve_p99 512, train_batch 65536, retrieval_cand 1M candidates;
# the ranking models (BST, DLRM) score 2^18 candidates, not 1M (PERF.md section 4)
RS_SERVE, RS_TRAIN, RS_CANDS, RS_RANK_CANDS = 512, 65536, 1_000_000, 1 << 18
RS_SESSIONS, RS_SESSION_TOPK, RS_SLICE, RS_CHECK_ROWS, RS_CHECK_VOCAB = 4096, 100, 4096, 64, 2048


def dlrm_vocabs(cap=DLRM_CAP):
    """dlrm_mlperf's tables (MLPerf's vocabularies, those of 8192 rows or more
    padded to a multiple of 512), each cut to ``cap`` rows."""
    from repro_torch.models import recsys

    return tuple(min(v + (-v) % 512 if v >= 8192 else v, cap) for v in recsys.MLPERF_CRITEO_VOCABS)


def _timer(dev):
    """CUDA events on the card; the host clock on the CPU (a rehearsal)."""
    if dev.type == "cuda":
        return time_ms

    def host_ms(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    return host_ms


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _backward(loss_fn, params, *args):
    """The loss and its gradients by autograd; the parameters' ``grad``s are
    left for the caller (and cleared before)."""
    for t in _leaves(params):
        t.grad = None
        t.requires_grad_(True)
    loss = loss_fn(params, *args)
    loss.backward()
    return loss


def _release(params):
    for t in _leaves(params):
        t.grad = None
        t.requires_grad_(False)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.detach().cpu().float() - want.detach().float()).abs().max()) / max(
        float(want.detach().float().abs().max()), 1e-30)


def _matmul_against_plain(out, p, q, r_u, r_i, add, what, slices):
    """Slices of a ``pruned_matmul`` answer inside a model's output (``add``
    maps the raw product of a slice to the output's columns) against
    ``pruned_matmul_plain`` on the same inputs."""
    from repro_torch.kernels import pruned_matmul

    errs = []
    for sl in slices:
        want = add(pruned_matmul.pruned_matmul_plain(p, q[sl], r_u, r_i[sl]), sl)
        got = out[:, sl]
        errs.append(float((got - want).abs().max()))
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        check(ok, f"{what} columns {sl.start}:{sl.stop} against pruned_matmul_plain within "
                  f"rtol/atol {RTOL} (max abs err {errs[-1]:.3e})")
    return max(errs)


def _card_against_cpu(dev, gen_seed, rs):
    """Each model at its published widths (a small catalog) on a 64-row batch:
    the forward and the loss gradient on the card against the port's CPU run
    from the same weights, within 1e-4 of the largest |value| per tensor."""
    from repro_torch.data import clicks
    from repro_torch.models import recsys

    cpu = torch.device("cpu")
    vocab, rows = rs["check_vocab"], rs["check_rows"]
    gen = torch.Generator().manual_seed(gen_seed)
    cases = {}
    fm_cfg = recsys.FMConfig(n_fields=FM_FIELDS, embed_dim=FM_K, vocab_per_field=vocab)
    fm_b = clicks.fm_batch(rows, n_fields=FM_FIELDS, vocab_per_field=vocab, seed=SEED + 50)
    cases["fm"] = (recsys.init_fm_params(gen, fm_cfg, cpu), fm_b,
                   lambda p, b: recsys.fm_forward(p, b["ids"], fm_cfg, FM_T),
                   lambda p, b: recsys.fm_loss(p, b, fm_cfg, FM_T))
    sr_cfg = recsys.SASRecConfig(n_items=vocab, embed_dim=SR_K, n_blocks=SR_BLOCKS,
                                 n_heads=SR_HEADS, seq_len=SR_SEQ)
    sr_b = clicks.sasrec_batch(rows, seq_len=SR_SEQ, n_items=vocab, seed=SEED + 51)
    cases["sasrec"] = (recsys.init_sasrec_params(gen, sr_cfg, cpu), sr_b,
                       lambda p, b: recsys.sasrec_encode(p, b["seq"], sr_cfg),
                       lambda p, b: recsys.sasrec_loss(p, b, sr_cfg))
    bst_cfg = recsys.BSTConfig(n_items=vocab, embed_dim=BST_K, seq_len=BST_SEQ,
                               n_blocks=BST_BLOCKS, n_heads=BST_HEADS, mlp_dims=BST_MLP,
                               n_profile=BST_PROFILE)
    bst_b = clicks.bst_batch(rows, seq_len=BST_SEQ, n_items=vocab, n_profile=BST_PROFILE,
                             seed=SEED + 52)
    cases["bst"] = (recsys.init_bst_params(gen, bst_cfg, cpu), bst_b,
                    lambda p, b: recsys.bst_forward(p, b["hist"], b["target"], b["profile"],
                                                    bst_cfg),
                    lambda p, b: recsys.bst_loss(p, b, bst_cfg))
    dlrm_cfg = recsys.DLRMConfig(embed_dim=DLRM_K, vocab_sizes=dlrm_vocabs(vocab),
                                 bot_mlp=DLRM_BOT, top_mlp=DLRM_TOP)
    dlrm_b = clicks.criteo_batch(rows, n_dense=dlrm_cfg.n_dense, vocab_sizes=dlrm_cfg.vocab_sizes,
                                 seed=SEED + 53)
    cases["dlrm"] = (recsys.init_dlrm_params(gen, dlrm_cfg, cpu), dlrm_b,
                     lambda p, b: recsys.dlrm_forward(p, b["dense"], b["sparse"], dlrm_cfg, DLRM_T),
                     lambda p, b: recsys.dlrm_loss(p, b, dlrm_cfg, DLRM_T))
    worst = {}
    for name, (params, batch, forward, loss_fn) in cases.items():
        on_card = recsys.recsys_params_from_numpy(recsys.recsys_params_to_numpy(params), dev)
        cb = {key: torch.as_tensor(v) for key, v in batch.items()}
        gb = {key: v.to(dev) for key, v in cb.items()}
        with torch.no_grad():
            f_err = _rel_err(forward(on_card, gb), forward(params, cb))
        _backward(loss_fn, params, cb)
        _backward(loss_fn, on_card, gb)
        g_err = max(_rel_err(g.grad, c.grad) for g, c in zip(_leaves(on_card), _leaves(params)))
        worst[name] = (f_err, g_err)
        check(f_err <= RECORD_RTOL and g_err <= RECORD_RTOL,
              f"recsys {name} at its widths, {rows} rows: forward and loss gradient on the card "
              f"within {RECORD_RTOL} of the CPU (relative to the largest |value|: forward "
              f"{f_err:.3e}, gradients {g_err:.3e})")
    return worst


def recsys_phase(dev, sizes=None):
    """recsys: FM, SASRec, BST and DLRM at their published widths with random
    weights from the seed.  In one counted run: FM's forward at the serving
    batch and ``fm_retrieval`` through ``pruned_matmul`` (k = 10) against 1M
    candidates; ``sasrec_retrieval`` through ``pruned_matmul`` (k = 50) against
    1M candidates; a session engine over 4096 SASRec sessions served at
    top-100 by ``serve_sessions`` (``pruned_topk``); SASRec's loss, its
    backward and one SGD step at 65,536 x 50; BST's forward and loss backward
    at 65,536 and its ranking of 2^18 candidates; DLRM (every table cut to
    2^23 rows) likewise.  Then each kernel answer against its plain version,
    rate 0 against the dense routes, each model on the card against the CPU,
    and the timings.  ``sizes`` overrides the sizes (a rehearsal on the CPU
    passes tiny ones)."""
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.data import clicks
    from repro_torch.eval import ranking
    from repro_torch.kernels import ops, pruned_matmul, pruned_topk
    from repro_torch.models import recsys
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads import sequential

    rs = dict(fm_vocab=FM_VOCAB, sr_items=SR_ITEMS, bst_items=BST_ITEMS, dlrm_cap=DLRM_CAP,
              serve=RS_SERVE, train=RS_TRAIN, cands=RS_CANDS, rank_cands=RS_RANK_CANDS,
              sessions=RS_SESSIONS, topk=RS_SESSION_TOPK, slice=RS_SLICE,
              check_rows=RS_CHECK_ROWS, check_vocab=RS_CHECK_VOCAB, max_batch=256)
    rs.update(sizes or {})
    ms_of = _timer(dev)
    vocabs = dlrm_vocabs(rs["dlrm_cap"])
    full_vocabs = dlrm_vocabs(1 << 62)
    dlrm_bytes = 4.0 * DLRM_K * sum(vocabs)
    log(f"## recsys: FM {FM_FIELDS} x {rs['fm_vocab']} x k={FM_K} (T {FM_T}), SASRec "
        f"{rs['sr_items']} x k={SR_K} (T {SR_T}), BST {rs['bst_items']} x k={BST_K}, DLRM "
        f"k={DLRM_K} with {sum(vocabs)} rows = {dlrm_bytes / 1e9:.2f} GB of tables (uncut "
        f"{sum(full_vocabs)} rows = {4.0 * DLRM_K * sum(full_vocabs) / 1e9:.2f} GB), float32")
    out = {"dlrm_rows": sum(vocabs), "dlrm_table_gb": dlrm_bytes / 1e9}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    fm_cfg = recsys.FMConfig(name="fm", n_fields=FM_FIELDS, embed_dim=FM_K,
                             vocab_per_field=rs["fm_vocab"])
    fm = recsys.init_fm_params(gen, fm_cfg, dev)
    fm_ids = torch.as_tensor(clicks.fm_batch(rs["serve"], n_fields=FM_FIELDS,
                                             vocab_per_field=rs["fm_vocab"], seed=SEED)["ids"]).to(dev)
    fm_ctx = fm_ids[:, :FM_FIELDS - 1]
    fm_cands = torch.as_tensor(rng.integers(0, rs["fm_vocab"], rs["cands"])).to(dev)
    sr_cfg = recsys.SASRecConfig(name="sasrec", n_items=rs["sr_items"], embed_dim=SR_K,
                                 n_blocks=SR_BLOCKS, n_heads=SR_HEADS, seq_len=SR_SEQ)
    sr = recsys.init_sasrec_params(gen, sr_cfg, dev)
    sr_seq = torch.as_tensor(clicks.sasrec_batch(rs["serve"], seq_len=SR_SEQ,
                                                 n_items=rs["sr_items"], seed=SEED + 1)["seq"]).to(dev)
    sr_cands = torch.as_tensor(rng.integers(1, rs["sr_items"] + 1, rs["cands"])).to(dev)
    sessions = clicks.sasrec_batch(rs["sessions"], seq_len=SR_SEQ, n_items=rs["sr_items"],
                                   seed=SEED + 2)["seq"]
    sr_train = {key: torch.as_tensor(v).to(dev) for key, v in clicks.sasrec_batch(
        rs["train"], seq_len=SR_SEQ, n_items=rs["sr_items"], seed=SEED + 3).items()}
    bst_cfg = recsys.BSTConfig(name="bst", n_items=rs["bst_items"], embed_dim=BST_K,
                               seq_len=BST_SEQ, n_blocks=BST_BLOCKS, n_heads=BST_HEADS,
                               mlp_dims=BST_MLP, n_profile=BST_PROFILE)
    bst = recsys.init_bst_params(gen, bst_cfg, dev)
    bst_train = {key: torch.as_tensor(v).to(dev) for key, v in clicks.bst_batch(
        rs["train"], seq_len=BST_SEQ, n_items=rs["bst_items"], n_profile=BST_PROFILE,
        seed=SEED + 4).items()}
    bst_cands = torch.as_tensor(rng.integers(1, rs["bst_items"] + 1, rs["rank_cands"])).to(dev)
    dlrm_cfg = recsys.DLRMConfig(name="dlrm-mlperf", embed_dim=DLRM_K, vocab_sizes=vocabs,
                                 bot_mlp=DLRM_BOT, top_mlp=DLRM_TOP)
    dlrm = recsys.init_dlrm_params(gen, dlrm_cfg, dev)
    dlrm_train = {key: torch.as_tensor(v).to(dev) for key, v in clicks.criteo_batch(
        rs["train"], n_dense=dlrm_cfg.n_dense, vocab_sizes=vocabs, seed=SEED + 5).items()}
    dlrm_cands = torch.as_tensor(rng.integers(0, vocabs[0], rs["rank_cands"])).to(dev)
    _sync(dev)
    out["setup_s"] = time.perf_counter() - t0
    log(f"  weights and batches made in {out['setup_s']:.2f} s")

    # -- the counted run ---------------------------------------------------------
    reset_launch_counts()
    wall = {}

    def run(name, fn):
        t = time.perf_counter()
        res = fn()
        _sync(dev)
        wall[name] = (time.perf_counter() - t) * 1e3
        return res

    with torch.no_grad():
        fm_logits = run("fm forward", lambda: recsys.fm_forward(fm, fm_ids, fm_cfg, FM_T))
        fm_scores = run("fm retrieval", lambda: recsys.fm_retrieval(
            fm, fm_ctx, fm_cands, fm_cfg, FM_T, use_kernel=True))
        sr_scores = run("sasrec retrieval", lambda: recsys.sasrec_retrieval(
            sr, sr_seq, sr_cfg, SR_T, use_kernel=True, cand_ids=sr_cands))
        engine = run("session engine", lambda: sequential.session_engine(
            sr, sessions, sr_cfg, 0.0, SR_T, device=dev, max_batch=rs["max_batch"]))
        sess_ids = np.arange(rs["sessions"])
        sess_s, sess_i = run("serve sessions", lambda: sequential.serve_sessions(
            engine, sess_ids, rs["topk"]))
    sr_loss = run("sasrec loss + backward", lambda: _backward(recsys.sasrec_loss, sr, sr_train,
                                                              sr_cfg))
    with torch.no_grad():
        bst_logits = run("bst forward", lambda: recsys.bst_forward(
            bst, bst_train["hist"], bst_train["target"], bst_train["profile"], bst_cfg))
    bst_loss = run("bst loss + backward", lambda: _backward(recsys.bst_loss, bst, bst_train, bst_cfg))
    _release(bst)
    with torch.no_grad():
        bst_ranked = run("bst ranking", lambda: recsys.bst_forward(
            bst, bst_train["hist"][:1].expand(len(bst_cands), -1), bst_cands,
            bst_train["profile"][:1].expand(len(bst_cands), -1), bst_cfg))
        dlrm_logits = run("dlrm forward", lambda: recsys.dlrm_forward(
            dlrm, dlrm_train["dense"], dlrm_train["sparse"], dlrm_cfg, DLRM_T))
    dlrm_loss = run("dlrm loss + backward", lambda: _backward(recsys.dlrm_loss, dlrm, dlrm_train,
                                                              dlrm_cfg, DLRM_T))
    _release(dlrm)
    with torch.no_grad():
        dlrm_ranked = run("dlrm ranking", lambda: recsys.dlrm_retrieval(
            dlrm, dlrm_train["dense"][:1], dlrm_train["sparse"][:1], dlrm_cands, dlrm_cfg, DLRM_T))
    launches = {"pruned_matmul": pruned_matmul.launches, "pruned_topk": pruned_topk.launches}
    PATH_LAUNCHES["recsys"] = launches
    out["launches"] = launches
    out["wall_ms"] = wall
    log(f"  launches on the recsys path: {launches}; host ms (synchronized, first calls): "
        + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    chunks = -(-rs["sessions"] // rs["max_batch"])
    check(launches["pruned_matmul"] == 2,
          f"pruned_matmul launched twice on the recsys path, by fm_retrieval and "
          f"sasrec_retrieval ({launches['pruned_matmul']})")
    check(launches["pruned_topk"] == chunks,
          f"pruned_topk launched once per {rs['max_batch']}-session chunk by serve_sessions "
          f"({launches['pruned_topk']} of {chunks})")

    # -- what came out -------------------------------------------------------------
    finite = {name: bool(torch.isfinite(v).all()) for name, v in (
        ("fm logits", fm_logits), ("fm retrieval", fm_scores), ("sasrec retrieval", sr_scores),
        ("bst logits", bst_logits), ("bst ranking", bst_ranked), ("dlrm logits", dlrm_logits),
        ("dlrm ranking", dlrm_ranked))}
    finite["losses"] = all(math.isfinite(v) for v in (sr_loss.item(), bst_loss.item(),
                                                      dlrm_loss.item()))
    check(all(finite.values()) and fm_scores.shape == (rs["serve"], rs["cands"])
          and sr_scores.shape == (rs["serve"], rs["cands"])
          and bst_ranked.shape == (rs["rank_cands"],) and dlrm_ranked.shape == (rs["rank_cands"],),
          f"recsys outputs finite and of the expected shapes ({finite})")
    check(sess_i.shape == (rs["sessions"], rs["topk"]) and sess_i.min() >= 1
          and sess_i.max() <= rs["sr_items"] and bool((sess_s[:, :-1] >= sess_s[:, 1:]).all()),
          "serve_sessions: item ids in [1, n_items], scores descending")
    out["losses"] = dict(sasrec=sr_loss.item(), bst=bst_loss.item(), dlrm=dlrm_loss.item())
    del fm_logits, bst_logits, bst_ranked, dlrm_logits, dlrm_ranked
    for t in _leaves(dlrm):
        t.grad = None
    for t in _leaves(bst):
        t.grad = None

    # -- kernels against their plain versions ------------------------------------
    n = rs["cands"]
    width = min(rs["slice"], n)
    slices = [slice(0, width), slice(n - width, n)]
    offsets = recsys._offsets(fm_cfg, fm_ctx)
    s_u, const_u = recsys._fm_context(fm, fm_ctx, fm_cfg, FM_T)
    v_c = fm["v"][fm_cands + offsets[FM_FIELDS - 1]]
    w_c = fm["w"][fm_cands + offsets[FM_FIELDS - 1]]
    fm_ru, fm_ri = effective_ranks(s_u, 0.0), effective_ranks(v_c, FM_T)
    err_fm = _matmul_against_plain(
        fm_scores, s_u, v_c, fm_ru, fm_ri,
        lambda cross, sl: const_u[:, None] + cross + w_c[sl][None, :], "fm_retrieval", slices)
    with torch.no_grad():
        h = recsys.sasrec_encode(sr, sr_seq, sr_cfg)[:, -1]
    table = sr["item_embed"].detach()[sr_cands]
    sr_ru, sr_ri = effective_ranks(h, 0.0), effective_ranks(table, SR_T)
    err_sr = _matmul_against_plain(sr_scores, h, table, sr_ru, sr_ri, lambda cross, sl: cross,
                                   "sasrec_retrieval", slices)
    del fm_scores, sr_scores
    # the session engine's top-100 against the plain top-k on its own tables
    view = engine.params
    first = min(rs["max_batch"], rs["sessions"])
    pu = view.p[:first].float().contiguous()
    r_u = effective_ranks(pu, engine.t_p)
    zero_bias = torch.zeros(view.q.shape[0], device=dev)
    want_s, want_i = pruned_topk.pruned_topk_plain(pu, view.q.float().contiguous(), r_u,
                                                   engine.r_i, zero_bias, rs["topk"],
                                                   block_n=min(PLAIN_BLOCK_N, view.q.shape[0]))
    err_topk = compare_topk(torch.as_tensor(sess_s[:first]).to(dev),
                            torch.as_tensor(sess_i[:first] - 1).to(dev), want_s, want_i,
                            f"serve_sessions (first {first} sessions) vs pruned_topk_plain")
    out["max_abs_err"] = dict(fm=err_fm, sasrec=err_sr, sessions=err_topk)
    # SASRec's one SGD step (lr 0.01, configs/base.py's recsys train cell), taken
    # after the checks that read the weights it changes
    with torch.no_grad():
        for t in _leaves(sr):
            t -= 0.01 * t.grad
        out["losses"]["sasrec_after_step"] = recsys.sasrec_loss(sr, sr_train, sr_cfg).item()
    _release(sr)
    check(math.isfinite(out["losses"]["sasrec_after_step"]), "SASRec's loss finite after its step")
    log(f"  losses: {out['losses']}")

    # -- rate 0 is the dense model -------------------------------------------------
    sub = slice(0, min(1 << 16, n))
    with torch.no_grad():
        for name, fn in (
            ("fm_retrieval", lambda k: recsys.fm_retrieval(fm, fm_ctx, fm_cands[sub], fm_cfg, 0.0,
                                                           use_kernel=k)),
            ("sasrec_retrieval", lambda k: recsys.sasrec_retrieval(
                sr, sr_seq, sr_cfg, 0.0, use_kernel=k, cand_ids=sr_cands[sub])),
        ):
            got, want = fn(True), fn(False)
            err = float((got - want).abs().max())
            check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)),
                  f"{name} at T = 0: the kernel route within rtol/atol {RTOL} of the dense route "
                  f"(max abs err {err:.3e})")
    # 1/8-grid operands at both widths: the two routes' scoring, bitwise
    for name, k_w in (("fm", FM_K), ("sasrec", SR_K)):
        gp = torch.randint(-16, 17, (rs["serve"], k_w), generator=gen, device=dev).float() / 8
        gq = torch.randint(-16, 17, (sub.stop, k_w), generator=gen, device=dev).float() / 8
        got = ops.pruned_matmul(gp, gq, 0.0, 0.0, device=dev)
        want = torch.matmul(gp, recsys._mask_by_rank(gq, 0.0).T)
        check(torch.equal(got, want), f"{name} scoring at T = 0 on 1/8-grid operands (k = {k_w}): "
                                      "the kernel route bitwise the dense route")
    # serve_sessions at thresholds 0 against dense_topk (score everything, stable sort)
    dense_engine = sequential.session_engine(sr, sessions[:2 * first], sr_cfg, 0.0, 0.0, device=dev,
                                             max_batch=rs["max_batch"])
    ids0 = np.arange(2 * first if rs["sessions"] >= 2 * first else first)
    got_s, got_i = sequential.serve_sessions(dense_engine, ids0, rs["topk"])
    want_s, want_i = ranking.dense_topk(dense_engine.params, ids0, rs["topk"])
    compare_topk(torch.as_tensor(got_s), torch.as_tensor(got_i - 1), torch.as_tensor(want_s),
                 torch.as_tensor(want_i), f"serve_sessions at T = 0 vs dense_topk "
                 f"({len(ids0)} sessions)")
    same_ids = int((got_i - 1 == want_i).all(axis=1).sum())
    log(f"  serve_sessions at T = 0: {same_ids} of {len(ids0)} sessions with ids identical to "
        "dense_topk's")
    # and on a 1/8-grid session view the ids and scores are exactly dense_topk's
    grid_view = mf_grid_view(dense_engine.params)
    grid_engine = ServingEngine(grid_view, 0.0, 0.0, device=dev,
                                           max_batch=rs["max_batch"])
    got_s, got_i = sequential.serve_sessions(grid_engine, ids0, rs["topk"])
    want_s, want_i = ranking.dense_topk(grid_view, ids0, rs["topk"])
    check(np.array_equal(got_i - 1, want_i) and np.array_equal(got_s, want_s),
          "serve_sessions at T = 0 on a 1/8-grid session view: ids and scores exactly dense_topk's")
    del dense_engine, grid_engine, grid_view
    out["card_vs_cpu"] = _card_against_cpu(dev, SEED + 54, rs)

    # -- timings -------------------------------------------------------------------
    log("## recsys timings (CUDA events)")
    ms = {}
    with torch.no_grad():
        ms["fm forward"] = ms_of(lambda: recsys.fm_forward(fm, fm_ids, fm_cfg, FM_T), 5)
        ms["fm retrieval"] = ms_of(lambda: recsys.fm_retrieval(fm, fm_ctx, fm_cands, fm_cfg, FM_T),
                                   3)
        ms["sasrec encode"] = ms_of(lambda: recsys.sasrec_encode(sr, sr_seq, sr_cfg), 5)
        ms["sasrec retrieval"] = ms_of(lambda: recsys.sasrec_retrieval(
            sr, sr_seq, sr_cfg, SR_T, cand_ids=sr_cands), 3)
        t = time.perf_counter()
        sequential.serve_sessions(engine, sess_ids, rs["topk"])
        ms["serve sessions (host clock)"] = (time.perf_counter() - t) * 1e3
        ms["sasrec loss forward"] = ms_of(lambda: recsys.sasrec_loss(sr, sr_train, sr_cfg), 2)
        ms["bst forward"] = ms_of(lambda: recsys.bst_forward(
            bst, bst_train["hist"], bst_train["target"], bst_train["profile"], bst_cfg), 3)
        ms["bst ranking"] = ms_of(lambda: recsys.bst_forward(
            bst, bst_train["hist"][:1].expand(len(bst_cands), -1), bst_cands,
            bst_train["profile"][:1].expand(len(bst_cands), -1), bst_cfg), 3)
        ms["dlrm forward"] = ms_of(lambda: recsys.dlrm_forward(
            dlrm, dlrm_train["dense"], dlrm_train["sparse"], dlrm_cfg, DLRM_T), 3)
        ms["dlrm ranking"] = ms_of(lambda: recsys.dlrm_retrieval(
            dlrm, dlrm_train["dense"][:1], dlrm_train["sparse"][:1], dlrm_cands, dlrm_cfg,
            DLRM_T), 3)
    for name, fn in (("sasrec loss + backward", lambda: _backward(recsys.sasrec_loss, sr, sr_train,
                                                                   sr_cfg)),
                     ("bst loss + backward", lambda: _backward(recsys.bst_loss, bst, bst_train,
                                                                bst_cfg)),
                     ("dlrm loss + backward", lambda: _backward(recsys.dlrm_loss, dlrm, dlrm_train,
                                                                 dlrm_cfg, DLRM_T))):
        ms[name] = ms_of(fn, 2)
    for params in (sr, bst, dlrm):
        _release(params)
    log("  " + "; ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    out["ms"] = ms

    # the two pruned_matmul shapes and the session top-k, against bounds and yardsticks
    kernels = {}
    for name, mp, mq, m_ru, m_ri in (("k=10 (fm)", s_u, v_c, fm_ru, fm_ri),
                                     ("k=50 (sasrec)", h, table, sr_ru, sr_ri)):
        mp, mq = mp.contiguous(), mq.contiguous()
        k_w = mp.shape[1]
        kms = ms_of(lambda: pruned_matmul.pruned_matmul_ranked(mp, mq, m_ru, m_ri), 5)
        plain_ms = ms_of(lambda: pruned_matmul.pruned_matmul_plain(mp, mq, m_ru, m_ri), 2)
        pm = mp * (torch.arange(k_w, device=dev) < m_ru[:, None])
        qm = mq * (torch.arange(k_w, device=dev) < m_ri[:, None])
        lib_ms = ms_of(lambda: torch.matmul(pm, qm.T), 3)
        del pm, qm
        flops = pair_flops(m_ru, m_ri, k_w)
        nbytes = factor_bytes(m_ru, m_ri, 4) + 4.0 * mp.shape[0] * mq.shape[0]
        b_ms, b_by = bound(flops, nbytes)
        kernels[name] = dict(ms=kms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                             mean_r_i=float(m_ri.float().mean()))
        log(f"  pruned_matmul {name}: {mp.shape[0]} x {mq.shape[0]}, mean r_i "
            f"{kernels[name]['mean_r_i']:.3f}; kernel {kms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"torch.matmul on pre-masked rows {lib_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}: "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.3f} GB)")
    q_all = view.q.float().contiguous()
    kms = ms_of(lambda: pruned_topk.pruned_topk_ranked(pu, q_all, r_u, engine.r_i, zero_bias,
                                                       rs["topk"]), 5)
    plain_ms = ms_of(lambda: pruned_topk.pruned_topk_plain(
        pu, q_all, r_u, engine.r_i, zero_bias, rs["topk"],
        block_n=min(PLAIN_BLOCK_N, q_all.shape[0])), 2)
    flops = pair_flops(r_u, engine.r_i, SR_K)
    nbytes = factor_bytes(r_u, engine.r_i, 4) + 4.0 * q_all.shape[0] + 8.0 * first * rs["topk"]
    b_ms, b_by = bound(flops, nbytes)
    kernels["pruned_topk k=50"] = dict(ms=kms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       mean_r_i=float(engine.r_i.float().mean()))
    log(f"  pruned_topk k=50 (sessions): {first} x {q_all.shape[0]}, top-{rs['topk']}, mean r_i "
        f"{kernels['pruned_topk k=50']['mean_r_i']:.3f}; kernel {kms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by})")
    out["kernels"] = kernels
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  peak device memory (max_memory_allocated) {out['peak_gb']:.2f} GB")
    return out


def mf_grid_view(view):
    """A copy of an MF view with each table scaled to unit spread and rounded
    to the 1/8 grid in [-2, 2]: every product and sum of the scoring exact."""
    from repro_torch.core import mf

    def grid(t):
        scale = 8.0 / max(float(t.std()), 1e-30)
        return torch.clamp(torch.round(t * scale), -16, 16) / 8.0
    return mf.MFParams(p=grid(view.p), q=grid(view.q), user_bias=None, item_bias=None,
                       global_mean=None, implicit=None)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout (no src/repro_torch here)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"# device {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32=False (matmul and cudnn)")

    t0 = time.perf_counter()
    build.build_all()
    log(f"# built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name in build.SOURCES:
        log(f"# ptxas {name}:")
        for line in build.ptxas_report(name):
            log(f"#   {line}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"# phase {name}: {time.perf_counter() - t0:.1f} s; device memory still "
            f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        return out

    rows, served = phase("serving", serving_path, dev)
    slo = phase("slo-dpmf", slo_path, dev, *served)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    fused = phase("fused_mf_sgd kernel", fused_kernel_phase, dev)
    scatter_stats = phase("add_rows kernel", add_rows_phase, dev)
    phase("small trainer", small_trainer_phase)
    train = phase("training main path", training_main_path, dev)
    phase("ranking evaluation", ranking_eval_phase, dev)
    repairs = phase("repairs (C5, C6)", repairs_phase, dev)
    implicit = phase("implicit-dpmf", implicit_phase, dev)
    bpr_stats = phase("bpr-dpmf", bpr_phase, dev)
    online = phase("online-dpmf", online_phase, dev)
    launcher = phase("online launcher", online_launcher_phase)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        store = phase("store-dpmf", store_dpmf_phase, dev, tmp)
        resume = phase("store-resume", store_resume_phase, dev, tmp)
        evict = phase("evict-dpmf", evict_phase, dev, tmp)
        store_launchers = phase("store and eviction launchers", store_launchers_phase, tmp)
        fleet_local = phase("fleet-local", fleet_local_phase, dev)
        fleet_process = phase("fleet-process", fleet_process_phase, dev)
        multirank = phase("multirank-dpmf", multirank_phase, dev, tmp)
        fleet_launchers = phase("fleet and SLO launchers", fleet_launchers_phase, tmp)
        recsys_stats = phase("recsys", recsys_phase, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_label = f"rate {RATE}"
    rows.append({
        "name": "fused_mf_sgd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mf_sgd.cu",
        "replaces": "src/repro/kernels/fused_mf_sgd.py:75",
        "max_abs_err": fused["err"],
        "ms": fused[main_label]["ms"], "plain_ms": fused[main_label]["plain_ms"],
        "bound_ms": fused[main_label]["bound_ms"], "bound_by": fused[main_label]["bound_by"],
        "library_ms": None, "dense_ms": fused["T=0"]["ms"],
        "dense_bound_ms": fused["T=0"]["bound_ms"],
    })
    rows.append({
        "name": "add_rows", "route": "cuda", "source": "src/repro_torch/kernels/csrc/add_rows.cu",
        "replaces": "none (the reference's XLA scatter .at[].add, src/repro/core/mf.py:276)",
        "max_abs_err": scatter_stats["err"], "ms": scatter_stats["ms"],
        "plain_ms": scatter_stats["plain_ms"], "bound_ms": scatter_stats["bound_ms"],
        "bound_by": scatter_stats["bound_by"], "library_ms": scatter_stats["lib_ms"],
        "library": "Tensor.index_add_ (atomics, repeats in any order)",
        "sort_ms": scatter_stats["sort_ms"], "distinct_rows": scatter_stats["unique"],
        "step_scatter_ms": {name: ms for name, ms in train["step_breakdown_ms"].items()
                            if name.startswith("scatter")},
    })
    for row in rows:
        # launches: the sum over the main paths' counted runs
        by_path = {path: counts[row["name"]] for path, counts in PATH_LAUNCHES.items()
                   if row["name"] in counts}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["name"] in repairs:
            row["wide"] = repairs[row["name"]]
    rows[0]["ranking_eval_ms"] = train["ranking_eval_ms"]
    rows[2]["implicit_step_ms"] = implicit["step_ms"]
    rows[0]["recsys_k50"] = recsys_stats["kernels"]["pruned_topk k=50"]
    rows[1]["recsys"] = {name: recsys_stats["kernels"][name] for name in ("k=10 (fm)",
                                                                           "k=50 (sasrec)")}
    workloads = {
        "implicit": {k: v for k, v in implicit.items() if k != "launches"},
        "bpr": {k: v for k, v in bpr_stats.items() if k != "launches"},
        "online": {k: v for k, v in online.items() if k not in ("launches", "swaps")},
        "online_launcher": {k: launcher.get(k) for k in (
            "event_rate_per_s", "swap_ms_p50", "latency_ms_p50", "latency_ms_p99",
            "requests_ok", "requests_failed")},
        "store": {k: v for k, v in store.items() if k != "launches"},
        "store_resume": resume,
        "evict": {k: v for k, v in evict.items() if k != "launches"},
        "store_launchers": {"online_eviction": store_launchers},
        "slo": {k: v for k, v in slo.items() if k != "launches"},
        "fleet_local": {k: v for k, v in fleet_local.items() if k != "launches"},
        "fleet_process": {k: v for k, v in fleet_process.items() if k != "launches"},
        "fleet_launchers": fleet_launchers,
        "multirank": {k: v for k, v in multirank.items() if k != "small"},
        "recsys": {k: v for k, v in recsys_stats.items() if k not in ("launches", "kernels")},
    }
    log("# workloads " + json.dumps(workloads))
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    if failures:
        log(f"# {len(failures)} check(s) failed:")
        for what in failures:
            log(f"#   {what}")
        return 1
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
