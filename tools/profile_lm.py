#!/usr/bin/env python3
"""Where the transformers' LM cells spend their time on one card: one step
each of qwen3-4b's ``train_4k``, gemma-7b's ``prefill_32k``, qwen1.5-4b's
``decode_32k`` and qwen3-4b's ``long_500k``, then the MoE archs'
deepseek-v2-lite-16b ``train_4k``, ``decode_32k`` and ``long_500k`` and
granite-moe-1b-a400m's ``decode_32k``, at the published widths with
``chip_smoke.LM_CUTS``' or ``MOE_CUTS``' depth and batch, in bfloat16 with
random weights.

    python3 tools/profile_lm.py [arch::shape ...]   # e.g. deepseek-v2-lite-16b::train_4k

Each step runs twice untimed, then once under ``torch.profiler`` (CPU and
CUDA activities), as ``tools/profile_gnn.py`` does: the step's wall time
(synchronized), the summed device time of its kernels, the device's idle
share, then the kernels by device time.  Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from profile_gnn import traced  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.optimizers import Adam  # noqa: E402

CASES = (("qwen3-4b", "train_4k"), ("gemma-7b", "prefill_32k"), ("qwen1.5-4b", "decode_32k"),
         ("qwen3-4b", "long_500k"), ("deepseek-v2-lite-16b", "train_4k"),
         ("deepseek-v2-lite-16b", "decode_32k"), ("deepseek-v2-lite-16b", "long_500k"),
         ("granite-moe-1b-a400m", "decode_32k"))


def lm_step(dev, arch, sid):
    full = configs.get_config(arch)
    layers, batch = {**chip_smoke.LM_CUTS, **chip_smoke.MOE_CUTS}[arch][sid]
    seq = {"train_4k": 4096, "prefill_32k": 32768, "decode_32k": 32768,
           "long_500k": 524288}[sid]
    cfg = dataclasses.replace(full, n_layers=layers)
    restore = chip_smoke._configs_at({arch: cfg})
    try:
        cell = configs.build_cell(arch, sid)
    finally:
        restore()
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    params = tfm.init_params(gen, cfg, dev)
    if cell.kind == "train":
        tokens = chip_smoke._lm_tokens(gen, cfg, batch, seq, dev)
        data = {"tokens": tokens, "labels": chip_smoke._lm_labels(tokens)}
        opt = Adam().init(params)

        def step():
            return cell.step_fn(params, opt, data)
    elif cell.kind == "prefill":
        tokens = chip_smoke._lm_tokens(gen, cfg, batch, seq, dev)

        def step():
            return cell.step_fn(params, tokens)
    else:
        state = tfm.init_decode_state(cfg, batch, seq, length=seq - 1, device=dev)
        for t in chip_smoke._state_tensors(state):
            t.normal_(generator=gen)
        tokens = chip_smoke._lm_tokens(gen, cfg, batch, 1, dev)

        def step():
            return cell.step_fn(params, state, tokens)

    n = sum(t.numel() for t in tree.leaves(params))
    traced(f"{arch}::{sid} at {layers} layers, batch {batch}, {seq} positions ({n / 1e9:.2f}B "
           "parameters)", step, rows=14)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lm.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"# {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    wanted = sys.argv[1:]  # "arch::shape" names, or none for every case
    for arch, sid in CASES:
        if wanted and f"{arch}::{sid}" not in wanted:
            continue
        lm_step(dev, arch, sid)
        gc.collect()  # the step's weights, cache and optimizer state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
