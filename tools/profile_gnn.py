#!/usr/bin/env python3
"""Where a GAT training step spends its time on one card: gat-cora's cells
at their published counts, on the batches ``chip_smoke.py`` makes from
``data/graphs.py``, and SASRec's loss with its backward at 65,536 x 50 (the
item gathers through ``gather_rows``).  It traces ogb_products and
minibatch_lg, then SASRec.

    python3 tools/profile_gnn.py

Each step runs twice untimed, then once under ``torch.profiler`` (CPU and
CUDA activities): it prints the step's wall time (synchronized), the summed
device time of its kernels and the device's idle share, then the kernels by
device time.  Imports no JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch import configs, tree  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim.optimizers import Adam  # noqa: E402


def traced(label, fn, rows=12):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the device's own events (kernels, copies, sets), as the table sums them
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    print(f"## {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{max(0.0, 1 - busy / wall):.1%}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=rows, max_name_column_width=60),
          flush=True)


def gnn_step(dev, sid):
    cell = configs.build_cell("gat-cora", sid)
    cfg = chip_smoke._gat_config(cell)
    sz = dict(chip_smoke.GNN_GRAPHS, reddit=chip_smoke.REDDIT_GRAPH, seeds=chip_smoke.GNN_SEEDS,
              fanouts=chip_smoke.GNN_FANOUTS, molecules=chip_smoke.MOLECULES,
              mol_nodes=chip_smoke.MOLECULE_NODES, mol_edges=chip_smoke.MOLECULE_EDGES)
    batch = {key: torch.as_tensor(value).to(dev) for key, value in chip_smoke.gnn_batch(
        sid, cfg, sz, chip_smoke.SEED).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    params = gnn.init_params(gen, cfg, dev)
    start = (params, Adam().init(params))

    def step():
        state = tree.map_leaves(lambda t: t.clone(), start)
        return cell.step_fn(*state, batch)

    traced(f"gat-cora::{sid} step ({batch['edges'].shape[0]} edges)", step)
    del batch, start
    torch.cuda.empty_cache()


def sasrec_backward(dev):
    from repro_torch.data import clicks
    from repro_torch.models import recsys

    cfg = chip_smoke.SR_ARCH.CONFIG
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    params = recsys.init_sasrec_params(gen, cfg, dev)
    batch = {key: torch.as_tensor(value).to(dev) for key, value in clicks.sasrec_batch(
        chip_smoke.RS_TRAIN, seq_len=cfg.seq_len, n_items=cfg.n_items, seed=chip_smoke.SEED).items()}
    traced("sasrec loss + backward (65,536 x 50, gather_rows)",
           lambda: chip_smoke._backward(recsys.sasrec_loss, params, batch, cfg))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_gnn.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    for sid in ("ogb_products", "minibatch_lg"):
        gnn_step(dev, sid)
    sasrec_backward(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
