"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/repro_torch/<name>-<digest>.so`` at
the root of the checkout, on first use.  The libraries load with ``ctypes``;
every pointer and the stream pass as ``ctypes.c_void_p``.  Every missing
library is compiled at once, one ``nvcc`` per source, all started together.
The digest covers the sources and the flags, so an edited kernel rebuilds.
The build log keeps ``-Xptxas -v``'s registers, shared memory and spills.

Nothing here runs at import: tests on a machine without ``nvcc`` import
every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("add_rows", "fused_mf_sgd", "pruned_matmul", "pruned_topk")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGNATURES = {
    "add_rows": {
        # table, ld, n, k, sorted, order, rows, b, dtype, round_each, stream
        "add_rows_launch": (
            [_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
            ctypes.c_int,
        ),
    },
    "fused_mf_sgd": {
        # p_rows, q_rows, rating, bias_u, bias_i, weight, t_p, t_q, mu, lr, lam,
        # new_p, new_q, new_bu, new_bi, err, b, k, dtype, stream
        "fused_mf_sgd_launch": (
            [_P] * 9 + [_F, _F] + [_P] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, _P],
            ctypes.c_int,
        ),
    },
    "pruned_matmul": {
        # p, q, r_u, r_i, out, m, n, k, ld, in_dtype, out_dtype, stream
        "pruned_matmul_launch": (
            [_P] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
            ctypes.c_int,
        ),
    },
    "pruned_topk": {
        # p, q, r_u, r_i, bias, part_s, part_i, keys, out_s, out_i,
        # m, n, k, topk, items_per_split, splits, stream
        "pruned_topk_launch": (
            [_P] * 10 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P],
            ctypes.c_int,
        ),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    """The build log of ``name``, with ``nvcc``'s and ``ptxas``'s output."""
    return library_path(name).with_suffix(".log")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home is not None and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source in parallel.  Raises with the compiler's output if a
    build fails.  Returns ``{name: library path}``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, cmd, proc, tmp, so))
    failures = []
    for name, cmd, proc, tmp, so in running:
        out, _ = proc.communicate()
        log_path(name).write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{out[-6000:]}")
            continue
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> List[str]:
    """``ptxas -v`` lines of ``name``'s last build: each kernel's registers,
    shared memory and spill bytes."""
    keep = ("Compiling entry", "registers", "spill", "smem")
    return [
        line.split("ptxas info    :")[-1].strip()
        for line in log_path(name).read_text().splitlines()
        if any(word in line for word in keep)
    ]


def check(err: int, what: str) -> None:
    """Raise unless a C entry point returned ``cudaSuccess`` (0)."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")
