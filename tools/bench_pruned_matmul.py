#!/usr/bin/env python3
"""Time builds of the pruned_matmul CUDA kernel on one card, at the serving
path's shape (64 users x 10M items x k = 128, float32 in and out), dense
(T = 0) and at pruning rate 0.3, each against the plain version's result.

    python3 tools/bench_pruned_matmul.py SOURCE NAME:FLAGS [NAME:FLAGS ...]

SOURCE is a CUDA file with the C entry point ``pruned_matmul_launch`` (the
port's ``src/repro_torch/kernels/csrc/pruned_matmul.cu`` or a variant of it);
each NAME:FLAGS builds it with extra ``nvcc`` flags (``_`` for none, e.g.
``base:_ nostore:-DNO_STORE``).  The factors are those of ``chip_smoke.py``
(same seed and draws), the first variant runs again at the end, and every
time is the mean of 10 launches by CUDA events.  Imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.ranks import effective_ranks  # noqa: E402
from repro_torch.core.threshold import thresholds_from_matrices  # noqa: E402
from repro_torch.kernels import build, pruned_matmul  # noqa: E402

USERS, ITEMS, K, RATE, SEED = 64, 10_000_000, 128, 0.3, 0


def build_variants(source: Path, variants):
    out_dir = ROOT / "build" / "bench_pruned_matmul"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = []
    for name, flags in variants:
        so = out_dir / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *([] if flags == "_" else flags.split()),
               "-I", str(build.CSRC), "-o", str(so), str(source)]
        running.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, so, proc in running:
        log, _ = proc.communicate()
        regs = [line.split(":")[-1].strip() for line in log.splitlines() if "registers" in line]
        print(f"build {name}: exit {proc.returncode}; {regs[:1]}", flush=True)
        if proc.returncode:
            print(log[-3000:])
            continue
        fn = ctypes.CDLL(str(so)).pruned_matmul_launch
        fn.argtypes, fn.restype = build._SIGNATURES["pruned_matmul"]["pruned_matmul_launch"]
        fns[name] = fn
    return fns


def time_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if len(sys.argv) < 3 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    fns = build_variants(Path(sys.argv[1]), [v.split(":", 1) for v in sys.argv[2:]])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sigma = 0.1 * torch.exp(-2.0 * torch.arange(K, device=dev, dtype=torch.float32) / K)
    q = torch.randn((ITEMS, K), generator=gen, device=dev).mul_(sigma)
    p_all = torch.randn((256, K), generator=gen, device=dev).mul_(sigma)  # chip_smoke's draws
    p = p_all[:USERS].contiguous()
    t_p, t_q = thresholds_from_matrices(p_all, q, RATE)
    out = torch.empty((USERS, ITEMS), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(fns.items()) + [(f"{name} (again)", fn) for name, fn in list(fns.items())[:1]]
    for label, (tp, tq) in (("T=0", (0.0, 0.0)), (f"rate {RATE}", (t_p, t_q))):
        r_u, r_i = effective_ranks(p, tp), effective_ranks(q, tq)
        want = pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i)

        def run(fn):
            err = fn(p.data_ptr(), q.data_ptr(), r_u.data_ptr(), r_i.data_ptr(), out.data_ptr(),
                     USERS, ITEMS, K, K, 0, 0, stream)  # width, row stride
            if err:
                raise RuntimeError(f"launch failed with cudaError_t {err}")

        for name, fn in order:
            run(fn)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            print(f"{label:9s} {name:28s} {time_ms(lambda: run(fn)):8.3f} ms  "
                  f"max abs err {err:.3e}", flush=True)
        del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
