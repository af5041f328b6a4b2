"""Architecture registry: the reference's 10 assigned archs and the paper's
own (dpmf), every one of them ported.

Counterpart of ``repro/configs/__init__.py``.  ``build_cell(arch, shape)``
makes a :class:`~repro_torch.configs.base.CellSpec` (step function, meta
abstract arguments, layouts); :func:`all_cells` lists the cells.
"""
from __future__ import annotations

import importlib
from typing import List, Tuple

_ARCH_MODULES = {
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe",
    "gat-cora": "repro_torch.configs.gat_cora",
    "fm": "repro_torch.configs.fm_arch",
    "sasrec": "repro_torch.configs.sasrec_arch",
    "bst": "repro_torch.configs.bst_arch",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "dpmf": "repro_torch.configs.dpmf",
}

ASSIGNED_ARCHS: Tuple[str, ...] = tuple(a for a in _ARCH_MODULES if a != "dpmf")
ALL_ARCHS: Tuple[str, ...] = tuple(_ARCH_MODULES)
PORTED_ARCHS: Tuple[str, ...] = ALL_ARCHS


def get_module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str):
    return get_module(arch).CONFIG


def get_smoke_config(arch: str):
    return get_module(arch).smoke_config()


def shape_ids(arch: str) -> List[str]:
    return list(get_module(arch).cells().keys())


def build_cell(arch: str, shape_id: str):
    builders = get_module(arch).cells()
    if shape_id not in builders:
        raise KeyError(
            f"unknown shape {shape_id!r} for {arch!r}; known: {sorted(builders)}"
        )
    return builders[shape_id]()


def all_cells(include_dpmf: bool = True) -> List[Tuple[str, str]]:
    """Every (arch, shape) cell, in the reference's order."""
    archs = PORTED_ARCHS if include_dpmf else tuple(a for a in PORTED_ARCHS if a != "dpmf")
    return [(arch, sid) for arch in archs for sid in shape_ids(arch)]
