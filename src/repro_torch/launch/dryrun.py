"""The dry run: every (arch x shape) cell counted on meta tensors at its
published widths and depth, with its arguments laid out on the production
meshes, and its roofline terms on one H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fm --shape train_batch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on placeholder devices.  Here a cell's step runs once on
meta tensors under :func:`repro_torch.roofline.analysis.count` (no device
bytes, no kernel build; the hand-written kernels record their formulas),
and the mesh is a layout (:mod:`repro_torch.launch.mesh`) that gives each
argument's bytes per device through ``sharding.sanitize_shardings``.  The
step is not run across ranks, and no collective is counted: a cell whose
step needs ranks (dpmf's ``_sm`` cells, the ``moe_sm`` variants of a MoE
arch) is recorded as deferred.

Records are JSON files under ``build/dryrun_torch/``, keyed by (arch,
shape, mesh, variant, calibration depth); an existing one is kept unless
``--force``.  ``--debug-mesh`` (the (2, 2) and (2, 2, 2) meshes) writes
none.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch import configs as cfg_lib
from repro_torch import tree
from repro_torch.configs import base as cfg_base
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
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
DEFERRED = "A8f part 2: the step runs across ranks"


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


def needs_ranks(cell, cfg: Optional[TransformerConfig]) -> bool:
    """A step that takes its mesh, or a MoE layer laid out over ranks."""
    return ("mesh" in inspect.signature(cell.step_fn).parameters
            or (cfg is not None and cfg.moe is not None and cfg.moe_shard_map))


def device_argument_bytes(cell, mesh) -> float:
    """The bytes of one device's blocks of the cell's arguments, laid out by
    ``in_shardings(mesh)`` after ``sanitize_shardings``."""
    layouts = shd.sanitize_shardings(cell.in_shardings(mesh), cell.abstract_args, mesh)

    def one(leaf, spec):
        parts = math.prod(spmd.axis_size(mesh, entry) for entry in spec)
        return leaf.numel() // parts * leaf.element_size()

    return float(sum(tree.leaves(tree.map_leaves(one, cell.abstract_args, layouts))))


def model_flops(arch: str, shape_id: str, kind: str) -> Optional[float]:
    """The LM cells' useful FLOPs (``analysis.lm_model_flops``); None for
    another arch."""
    if not is_lm_arch(arch):
        return None
    cfg, shape = cfg_lib.get_config(arch), cfg_base.LM_SHAPES[shape_id]
    tokens = shape["global_batch"] * (1 if kind == "decode" else shape["seq_len"])
    return analysis.lm_model_flops(cfg.param_count(), cfg.active_param_count(), tokens, kind)


def run_cell(arch: str, shape_id: str, *, multi_pod: bool, debug: bool = False,
             calib_depth: int = 0, variant: str = "") -> Dict:
    """Count one cell; returns its record (``status`` ``ok`` or
    ``deferred``)."""
    mesh = (make_debug_mesh if debug else make_production_mesh)(multi_pod=multi_pod)
    cell, cfg = build(arch, shape_id, variant=variant, calib_depth=calib_depth)
    record = {
        "arch": arch,
        "shape": shape_id,
        "kind": cell.kind,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "axes": list(mesh.mesh_dim_names),
        "note": cell.note,
        "variant": variant,
        "calib_depth": calib_depth,
        "device": "meta",
    }
    if needs_ranks(cell, cfg):
        return dict(record, status="deferred", reason=DEFERRED)
    t0 = time.perf_counter()
    rec = analysis.count(cell.step_fn, *cell.abstract_args)
    record["count_s"] = time.perf_counter() - t0
    record["memory"] = {
        "argument_size_bytes": rec.argument_bytes,
        "output_size_bytes": rec.output_bytes,
        "argument_size_per_device_bytes": device_argument_bytes(cell, mesh),
    }
    record["cost"] = {"flops": rec.flops, "recompute_flops": rec.recompute_flops,
                      "bytes_accessed": rec.bytes_accessed, "least_bytes": rec.least_bytes}
    record["op_histogram"] = dict(sorted(rec.op_histogram.items()))
    record["kernels"] = rec.kernels
    mf = model_flops(arch, shape_id, cell.kind) if not calib_depth else None
    record["roofline"] = analysis.roofline_terms(rec.flops, rec.least_bytes, 0.0, 1,
                                                 model_flops=mf)
    record["status"] = "ok"
    return record


def calibrated(full: Dict, calib1: Dict, calib2: Dict, scan_layers: int) -> Dict:
    """``extrapolate_depth`` of the depth-1 and depth-2 counts beside the
    full-depth count, and their difference (0 when every stacked layer
    costs the same)."""
    est = analysis.extrapolate_depth(calib1, calib2, scan_layers)
    counted = {"flops": full["cost"]["flops"], "bytes_accessed": full["cost"]["bytes_accessed"],
               "collective_bytes": 0.0}
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
                elif record["status"] == "deferred":
                    print(f"[deferred] {tag}: {record['reason']}", flush=True)
                else:
                    cost, roof = record["cost"], record["roofline"]
                    print(f"[ok]       {tag} count={record['count_s']:.2f}s "
                          f"flops={cost['flops']:.3e} least_bytes={cost['least_bytes']:.3e} "
                          f"device_args={record['memory']['argument_size_per_device_bytes']:.3e} "
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
