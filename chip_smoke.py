#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: drives its serving path on one card.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA card

Imports nothing of JAX or of the ``repro`` package.  In one process it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a`` and prints each one's registers, shared memory and spills;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, without and with pruning (T = 0 and T for rate 0.3),
   plus an exact case on 1/8-grid factors, and times kernel, plain version
   and a PyTorch yardstick with CUDA events (TF32 off);
4. builds the dpmf model at full size (FunkSVD, k = 128, 100M users x 10M
   items, float32, random factors from a seed) with thresholds for rate 0.3,
   and serves it through ``ServingEngine``: ``topk`` for 1024 users at
   top-100, ``recommend`` for 3 users, 32 single-user requests through the
   queue, and ``predict_all_items`` for 64 users, with every kernel's launch
   count read just after;
5. prints a ``kernels`` JSON line and, last, the device JSON line.

Scores are held to rtol 1e-5 and atol 1e-5 (fp32 sums in another order);
indices must be identical except where the two compared scores lie within
that tolerance; the 1/8-grid case must agree exactly.  Any failed check
exits non-zero without the last line.  Without a card, or outside a checkout,
it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
RTOL = ATOL = 1e-5
SEED = 0
N_USERS, N_ITEMS, K = 100_000_000, 10_000_000, 128   # src/repro/configs/dpmf.py
RATE = 0.3
TOPK = 100
TOPK_USERS, MATMUL_USERS = 256, 64
PLAIN_BLOCK_N = 65536

failures: list = []


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout (no src/repro_torch here)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import mf
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.core.threshold import thresholds_from_matrices
    from repro_torch.kernels import build, pruned_matmul, pruned_topk
    from repro_torch.serving import ServingEngine

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"# device {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32=False (matmul and cudnn)")

    # -- build -----------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    log(f"# built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name in build.SOURCES:
        log(f"# ptxas {name}:")
        for line in build.ptxas_report(name):
            log(f"#   {line}")

    # -- helpers ---------------------------------------------------------------
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
        """Factor elements the pruned product needs: each row's prefix up to
        its own rank, cut at the other side's largest rank."""
        need_u = torch.clamp(r_u, max=int(r_i.max())).double().sum()
        need_i = torch.clamp(r_i, max=int(r_u.max())).double().sum()
        return itemsize * float(need_u + need_i) + 4.0 * (r_u.numel() + r_i.numel())

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # front-loaded significance: N(0, sigma_t^2) per latent column
    sigma = 0.1 * torch.exp(-2.0 * torch.arange(K, device=dev, dtype=torch.float32) / K)

    def factors(rows):
        out = torch.randn((rows, K), generator=gen, device=dev)
        return out.mul_(sigma)

    q = factors(N_ITEMS)
    p_topk = factors(TOPK_USERS)
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
    log("## pruned_topk breakdown: the same launch at top-1 and top-1024, and the "
        "scores alone (pruned_matmul writing the 256 x 10M matrix)")
    for label, t_p, t_q in (("T=0", 0.0, 0.0), (f"rate {RATE}", t_p30, t_q30)):
        r_u, r_i = effective_ranks(p_topk, t_p), effective_ranks(q, t_q)
        times = {
            f"top-{n}": time_ms(lambda n=n: pruned_topk.pruned_topk_ranked(
                p_topk, q, r_u, r_i, zero_bias, n), 3)
            for n in (1, 1024)
        }
        times["scores only"] = time_ms(
            lambda: pruned_matmul.pruned_matmul_ranked(p_topk, q, r_u, r_i), 3)
        torch.cuda.empty_cache()
        log(f"  {label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))

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
        log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul on "
            f"pre-masked operands {lib_ms:.3f} ms; bound {b_ms:.3f} ms "
            f"({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB)")
        st = stats["pruned_matmul"]
        st["err"] = max(st["err"], err)
        st[label] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
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

    # -- main path: the dpmf model at full size ---------------------------------
    log(f"## main path: dpmf FunkSVD {N_USERS} users x {N_ITEMS} items x k={K}, float32")
    torch.cuda.reset_peak_memory_stats()
    p = factors(N_USERS)
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

    pruned_topk.launches = 0
    pruned_matmul.launches = 0
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
    served = len(users) + len(recs) + len(queued)
    log(f"  launches on the main path: {launches}")
    log(f"  engine.topk: {len(users)} users in {t_topk:.3f} s ({len(users) / t_topk:.1f} req/s); "
        f"queue: {len(queued)} single-user requests in {t_queue:.3f} s "
        f"({len(queued) / t_queue:.1f} req/s); predict_all_items {MATMUL_USERS} users in "
        f"{t_mm:.3f} s")
    log(f"  requests served {served} in {wall:.3f} s ({served / wall:.1f} req/s)")
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the main path ({count})")

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
                 want_s, want_i, "main path: 32 users vs plain")
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

    # -- report ----------------------------------------------------------------
    main_label = f"rate {RATE}"
    rows = []
    for name, replaces, source in (
        ("pruned_topk", "src/repro/kernels/pruned_topk.py:157",
         "src/repro_torch/kernels/csrc/pruned_topk.cu"),
        ("pruned_matmul", "src/repro/kernels/pruned_matmul.py:97",
         "src/repro_torch/kernels/csrc/pruned_matmul.cu"),
    ):
        st = stats[name][main_label]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": stats[name]["err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st.get("lib_ms"),
            "dense_ms": stats[name]["T=0"]["ms"], "dense_bound_ms": stats[name]["T=0"]["bound_ms"],
        }
        if name == "pruned_topk":
            row["yardstick_ms"] = st["yard_ms"]
            row["yardstick"] = "torch.addmm + torch.topk on pre-masked operands (two calls)"
        rows.append(row)
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
