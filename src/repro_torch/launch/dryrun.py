"""The dry run: every (arch x shape) cell's step partitioned on the
production meshes and counted per device on meta tensors at its published
widths and depth, with its roofline terms on the H100's peaks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fm --shape train_batch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell with ``jax.jit(in_shardings=...)`` on 256 or 512 placeholder devices
and reads one device's program.  Here the mesh is a ``DeviceMesh`` of the
same shape over torch's fake process group, this process its rank 0
(:func:`repro_torch.launch.mesh.fake_mesh`), and the step runs once on
meta tensors under :func:`repro_torch.roofline.analysis.count` (no device
bytes, no kernel build; the hand-written kernels record their formulas):

* a step that takes its mesh (dpmf's owner-compute ``_sm`` cells) runs on
  rank 0's blocks of its arguments (``sharding.shard_tree``), and its
  collectives are the port's own;
* every other step runs on DTensors laid out by the cell's
  ``in_shardings`` (``sharding.distribute_tree``) under
  ``implicit_replication()`` (the tensors a step makes are replicated), and
  DTensor's sharding propagation partitions it, as XLA's SPMD partitioner
  partitions the reference's; where it stops (a hand-written kernel, an
  in-place write, the MoE layer) the rules of
  :mod:`repro_torch.launch.partition` take over: a kernel runs on the
  replicas of its inputs, and the gathers show in ``redistributions``;
  the MoE layer reads its mesh from its DTensor input and runs
  ``moe_ffn_shard_map`` on the blocks.

The record is one device's, in the reference's keys: ``memory``
(argument, output and temp bytes), ``cost``, ``collectives`` (result bytes
and calls by kind), ``redistributions``, ``op_histogram``, ``kernels`` and
``roofline`` with the collective term.

Records are JSON files under ``build/dryrun_torch/``, keyed by (arch,
shape, mesh, variant, calibration depth); an existing one is kept unless
``--force``.  ``--debug-mesh`` (the (2, 2) and (2, 2, 2) meshes) writes
none.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import inspect
import json
import math
import os
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

from repro_torch import configs as cfg_lib
from repro_torch import tree
from repro_torch.configs import base as cfg_base
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.launch import partition
from repro_torch.launch.mesh import (LayoutMesh, fake_mesh, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models.transformer import TransformerConfig
from repro_torch.roofline import analysis

RESULTS_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun_torch"))

# the reference's config variants of the LM cells (--variant)
_VARIANTS = {
    "moe_sm": lambda cfg: dataclasses.replace(cfg, moe_shard_map=True),
    "attn_bf16": lambda cfg: dataclasses.replace(cfg, attn_softmax_dtype="bf16"),
    "remat_dots": lambda cfg: dataclasses.replace(cfg, remat_policy="dots"),
    "mem_lean": lambda cfg: dataclasses.replace(cfg, mem_lean=True),
    "mem_opt": lambda cfg: dataclasses.replace(
        cfg, attn_softmax_dtype="bf16", remat_policy="dots", mem_lean=True),
    "moe_sm2": lambda cfg: dataclasses.replace(
        cfg, moe_shard_map=True, attn_softmax_dtype="bf16", mem_lean=True),
}


def is_lm_arch(arch: str) -> bool:
    return isinstance(cfg_lib.get_config(arch), TransformerConfig)


def lm_config(arch: str, variant: str = "", calib_depth: int = 0) -> TransformerConfig:
    """``arch``'s config with ``variant`` applied and, at ``calib_depth``,
    its leading dense layers and that many stacked ones."""
    cfg = cfg_lib.get_config(arch)
    if variant:
        cfg = _VARIANTS[variant](cfg)
    if calib_depth:
        cfg = dataclasses.replace(cfg, n_layers=cfg.first_dense_layers + calib_depth)
    return cfg


def build(arch: str, shape_id: str, *, variant: str = "", calib_depth: int = 0):
    """The cell, and its LM config (None for another arch)."""
    if not (variant or calib_depth):
        cell = cfg_lib.build_cell(arch, shape_id)
        return cell, cfg_lib.get_config(arch) if is_lm_arch(arch) else None
    if not is_lm_arch(arch):
        raise ValueError(f"--variant and --calib apply to the LM archs, not {arch!r}")
    cfg = lm_config(arch, variant, calib_depth)
    return cfg_base.lm_cells(arch, cfg)[shape_id](), cfg


def takes_mesh(cell) -> bool:
    """A step that takes its mesh (and this rank's blocks)."""
    return "mesh" in inspect.signature(cell.step_fn).parameters


def partitioned(cell, mesh, args: Optional[Tuple] = None) -> Tuple[Callable, Tuple]:
    """``(step, args)``: the cell's step on ``mesh`` (a ``DeviceMesh``) and
    its arguments (default: its abstract ones; every rank gives the same)
    laid out there by ``in_shardings(mesh)`` after ``sanitize_shardings``:
    this rank's blocks for a step that takes its mesh (the arguments of
    ``cell.whole_args`` whole), else DTensors, the step run under
    ``implicit_replication()`` with the dry run's rules installed
    (:mod:`repro_torch.launch.partition`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = cell.abstract_args if args is None else args
    if takes_mesh(cell):
        specs = cell.in_shardings(mesh)
        return functools.partial(cell.step_fn, mesh=mesh), tuple(
            a if i in cell.whole_args else shd.shard_tree(
                a, mesh, layouts=shd.sanitize_shardings(spec, a, mesh))
            for i, (a, spec) in enumerate(zip(args, specs)))
    layouts = shd.sanitize_shardings(cell.in_shardings(mesh), args, mesh)

    def step(*args):
        with implicit_replication(), partition.installed():
            return cell.step_fn(*args)

    return step, shd.distribute_tree(args, layouts, mesh)


def device_argument_bytes(cell, mesh) -> float:
    """The bytes of one device's blocks of the cell's arguments, laid out by
    ``in_shardings(mesh)`` after ``sanitize_shardings``."""
    layouts = shd.sanitize_shardings(cell.in_shardings(mesh), cell.abstract_args, mesh)

    def one(leaf, spec):
        parts = math.prod(spmd.axis_size(mesh, entry) for entry in spec)
        return leaf.numel() // parts * leaf.element_size()

    return float(sum(tree.leaves(tree.map_leaves(one, cell.abstract_args, layouts))))


def global_bytes(out) -> float:
    """The bytes of a step's outputs at their global shapes (a DTensor's
    whole tensor)."""
    return float(sum(t.numel() * t.element_size() for t in tree.leaves(out)
                     if hasattr(t, "numel")))


def model_flops(arch: str, shape_id: str, kind: str) -> Optional[float]:
    """The LM cells' useful FLOPs (``analysis.lm_model_flops``); None for
    another arch."""
    if not is_lm_arch(arch):
        return None
    cfg, shape = cfg_lib.get_config(arch), cfg_base.LM_SHAPES[shape_id]
    tokens = shape["global_batch"] * (1 if kind == "decode" else shape["seq_len"])
    return analysis.lm_model_flops(cfg.param_count(), cfg.active_param_count(), tokens, kind)


def count_partitioned(cell, mesh) -> Tuple[analysis.Count, float]:
    """The per-device :class:`~repro_torch.roofline.analysis.Count` of the
    cell's step partitioned on ``mesh``, and its outputs' global bytes."""
    step, args = partitioned(cell, mesh)
    outputs = []

    def kept(*a):
        out = step(*a)
        outputs.append(global_bytes(out))
        return out

    return analysis.count(kept, *args), outputs[0]


def folded(layout: LayoutMesh) -> LayoutMesh:
    """``layout`` with "pod" and "data" as one "data" dim of their product
    (the mesh a DTensor step is partitioned on): every layout of the cells
    names the two together, in that order, so each lays a tensor out on it
    as on ``layout``, and a collective over both runs as one, as XLA runs
    it.  DTensor's propagation over three mesh dims costs minutes a matrix
    product."""
    names = layout.mesh_dim_names
    if "pod" not in names:
        return layout
    size = dict(zip(names, layout.shape))
    return LayoutMesh((size["pod"] * size["data"], size["model"]), ("data", "model"))


def run_cell(arch: str, shape_id: str, *, multi_pod: bool, debug: bool = False,
             calib_depth: int = 0, variant: str = "") -> Dict:
    """Partition and count one cell; returns its record (per device)."""
    layout = (make_debug_mesh if debug else make_production_mesh)(multi_pod=multi_pod)
    cell, _ = build(arch, shape_id, variant=variant, calib_depth=calib_depth)
    ranks = math.prod(layout.shape)
    record = {
        "arch": arch,
        "shape": shape_id,
        "kind": cell.kind,
        "mesh": "x".join(str(s) for s in layout.shape),
        "axes": list(layout.mesh_dim_names),
        "note": cell.note,
        "variant": variant,
        "calib_depth": calib_depth,
        "device": "meta",
    }
    on = layout if takes_mesh(cell) else folded(layout)
    record["partition"] = ("blocks" if takes_mesh(cell) else "dtensor") + " on " + "x".join(
        str(s) for s in on.shape)
    t0 = time.perf_counter()
    with fake_mesh(on) as mesh:
        rec, out_bytes = count_partitioned(cell, mesh)
    record["count_s"] = time.perf_counter() - t0
    record["memory"] = {
        "argument_size_bytes": rec.argument_bytes,
        "output_size_bytes": rec.output_bytes,
        "temp_size_bytes": rec.temp,
        "global_output_size_bytes": out_bytes,
        "argument_size_per_device_bytes": device_argument_bytes(cell, layout),
    }
    record["cost"] = {"flops": rec.flops, "recompute_flops": rec.recompute_flops,
                      "bytes_accessed": rec.bytes_accessed, "least_bytes": rec.least_bytes}
    record["collectives"] = rec.collectives.record()
    record["collective_names"] = {"bytes_sent": dict(rec.collective_log.bytes_sent),
                                  "calls": dict(rec.collective_log.calls)}
    record["redistributions"] = dict(sorted(rec.redistributions.items(),
                                            key=lambda kv: -kv[1]["bytes"]))
    record["op_histogram"] = dict(sorted(rec.op_histogram.items()))
    record["kernels"] = rec.kernels
    mf = model_flops(arch, shape_id, cell.kind) if not calib_depth else None
    record["roofline"] = analysis.roofline_terms(
        rec.flops, rec.least_bytes, record["collectives"]["total_bytes"], 1,
        model_flops=mf / ranks if mf else None)
    record["status"] = "ok"
    return record


def calibrated(full: Dict, calib1: Dict, calib2: Dict, scan_layers: int) -> Dict:
    """``extrapolate_depth`` of the depth-1 and depth-2 counts beside the
    full-depth count, and their difference (0 when every stacked layer
    costs the same)."""
    est = analysis.extrapolate_depth(calib1, calib2, scan_layers)
    counted = {"flops": full["cost"]["flops"], "bytes_accessed": full["cost"]["bytes_accessed"],
               "collective_bytes": full["collectives"]["total_bytes"]}
    return {"extrapolated": est, "counted": counted,
            "difference": {key: counted[key] - est[key] for key in est}}


def result_path(arch: str, shape_id: str, multi_pod: bool, calib_depth: int = 0,
                variant: str = "") -> str:
    tag = "multipod" if multi_pod else "singlepod"
    if variant:
        tag += f"__v-{variant}"
    if calib_depth:
        tag += f"__calib{calib_depth}"
    safe = arch.replace("/", "_").replace(".", "_")
    return os.path.join(RESULTS_DIR, f"{safe}__{shape_id}__{tag}.json")


def table(targets, meshes, variant: str = "") -> str:
    """A markdown row a cell from its kept records, one value a mesh in
    each column ("a ; b"): per device TFLOP, least GB, collective GB by
    kind (all-gather, all-reduce, reduce-scatter, all-to-all), temp GB, the
    dominant term, and the largest redistribution (op, GB)."""
    lines = ["| cell | TFLOP | least GB | AG / AR / RS / A2A GB | temp GB | dominant | "
             "largest redistribution |", "| --- | --- | --- | --- | --- | --- | --- |"]
    for arch, shape_id in targets:
        cols = [[] for _ in range(6)]
        for multi_pod in meshes:
            path = result_path(arch, shape_id, multi_pod, 0, variant)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                r = json.load(f)
            coll = r["collectives"]
            top = next(iter(r["redistributions"].items()), None)
            cols[0].append(f"{r['cost']['flops'] / 1e12:.3f}")
            cols[1].append(f"{r['cost']['least_bytes'] / 1e9:.3f}")
            cols[2].append(" / ".join(f"{coll[k + '_bytes'] / 1e9:.3f}" for k in
                                      ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")))
            cols[3].append(f"{r['memory']['temp_size_bytes'] / 1e9:.3f}")
            cols[4].append(r["roofline"]["dominant"])
            cols[5].append(f"{top[0]} {top[1]['bytes'] / 1e9:.3f}" if top else "none")
        if cols[0]:
            lines.append(f"| {arch}::{shape_id} | " + " | ".join(" ; ".join(c) for c in cols)
                         + " |")
    return "\n".join(lines)


def _run(arch, shape_id, multi_pod, depth, args) -> Dict:
    try:
        return run_cell(arch, shape_id, multi_pod=multi_pod, debug=args.debug_mesh,
                        calib_depth=depth, variant=args.variant)
    except Exception as exc:  # noqa: BLE001 (reported and counted as a failure)
        return {"arch": arch, "shape": shape_id, "mesh": "multi" if multi_pod else "single",
                "status": "error", "calib_depth": depth, "error": repr(exc),
                "traceback": traceback.format_exc()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--arch", default=None)
    parser.add_argument("--shape", default=None)
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    parser.add_argument("--debug-mesh", action="store_true", help="2x2(x2) mesh; writes no record")
    parser.add_argument("--force", action="store_true", help="count again over a kept record")
    parser.add_argument("--variant", default="", choices=[""] + sorted(_VARIANTS),
                        help="a config variant of the LM cells")
    parser.add_argument("--calib", action="store_true",
                        help="also count the LM cells at depth 1 and 2 and extrapolate")
    parser.add_argument("--table", action="store_true",
                        help="print the kept records as a markdown table; count nothing")
    args = parser.parse_args(argv)

    if args.all:
        targets = cfg_lib.all_cells()
    elif args.arch and args.shape:
        targets = [(args.arch, args.shape)]
    elif args.arch:
        targets = [(args.arch, sid) for sid in cfg_lib.shape_ids(args.arch)]
    else:
        parser.error("pass --all or --arch [--shape]")
    if args.variant:
        targets = [t for t in targets if is_lm_arch(t[0])]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.table:
        print(table(targets, meshes, args.variant))
        return 0
    os.makedirs(RESULTS_DIR, exist_ok=True)

    failures, t_all = 0, time.perf_counter()
    for arch, shape_id in targets:
        for multi_pod in meshes:
            depths = [0] + ([1, 2] if args.calib and is_lm_arch(arch) else [])
            records = {}
            for depth in depths:
                path = result_path(arch, shape_id, multi_pod, depth, args.variant)
                tag = (f"{arch}::{shape_id} multi_pod={multi_pod}"
                       + (f" calib={depth}" if depth else "")
                       + (f" variant={args.variant}" if args.variant else ""))
                if not args.force and not args.debug_mesh and os.path.exists(path):
                    with open(path) as f:
                        records[depth] = json.load(f)
                    print(f"[cached]   {tag}")
                    continue
                print(f"[run]      {tag}", flush=True)
                records[depth] = record = _run(arch, shape_id, multi_pod, depth, args)
                if record["status"] == "error":
                    failures += 1
                    print(f"[FAIL]     {tag}: {record['error']}", flush=True)
                else:
                    cost, roof, mem = record["cost"], record["roofline"], record["memory"]
                    print(f"[ok]       {tag} count={record['count_s']:.2f}s "
                          f"flops={cost['flops']:.3e} least_bytes={cost['least_bytes']:.3e} "
                          f"collective_bytes={record['collectives']['total_bytes']:.3e} "
                          f"args={mem['argument_size_bytes']:.3e} "
                          f"temp={mem['temp_size_bytes']:.3e} "
                          f"{roof['dominant']} {roof['bound_s'] * 1e3:.3f} ms", flush=True)
                if not args.debug_mesh and depth:
                    with open(path, "w") as f:
                        json.dump(record, f, indent=2)
            full = records[0]
            if len(records) == 3 and all(r["status"] == "ok" for r in records.values()):
                full["calib"] = calibrated(full, records[1], records[2],
                                           lm_config(arch, args.variant).scan_layers)
                print(f"[calib]    {arch}::{shape_id} difference "
                      f"{full['calib']['difference']}", flush=True)
            if not args.debug_mesh:
                with open(result_path(arch, shape_id, multi_pod, 0, args.variant), "w") as f:
                    json.dump(full, f, indent=2)
    print(f"dry run: {len(targets)} cells in {time.perf_counter() - t_all:.1f} s host time, "
          f"{failures} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
