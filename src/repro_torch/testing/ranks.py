"""A pool of SPMD ranks for tests and the chip smoke.

:class:`RankPool` spawns ``world_size`` processes that join one process
group (a ``file://`` store in a temporary directory, so concurrent pools
never collide on a port) and then run, all together, whatever function the
parent hands them: ``pool.run(fn, *args)`` calls ``fn(ctx, *args)`` on every
rank and returns the ranks' results in rank order.  ``fn`` must be a
module-level function (it is pickled by its import path); ``ctx`` is a
:class:`RankContext` with the rank, its device and a cache of meshes.

A rank that raises reports its traceback; the collectives of the others
then time out and raise too, and :meth:`RankPool.run` raises
:class:`RankError` with every traceback and closes the pool.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class RankError(RuntimeError):
    """A function failed on at least one rank of a :class:`RankPool`."""


class RankContext:
    """What a pooled function gets besides its arguments."""

    def __init__(self, rank: int, world_size: int, device: str):
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self._meshes: Dict[Tuple, Any] = {}
        self.state: Dict[str, Any] = {}   # kept between calls on this rank

    def mesh(self, shape: Sequence[int], names: Sequence[str]):
        """The mesh of ``shape`` and dim ``names`` over the pool's ranks,
        made on first use (every rank makes it in the same call)."""
        from repro_torch.distributed import spmd

        key = (tuple(shape), tuple(names))
        if key not in self._meshes:
            self._meshes[key] = spmd.init_mesh(shape, names)
        return self._meshes[key]


def _worker(rank: int, world_size: int, backend: str, init_method: str, device: str,
            timeout_s: float, conn) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import spmd

    try:
        import torch

        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        if device.startswith("cuda") and backend == "gloo":
            torch.cuda.set_device(torch.device(device))
        spmd.init_process_group(backend, init_method, world_size, rank, timeout_s=timeout_s)
        ctx = RankContext(rank, world_size, device)
        conn.send(("ready", None))
    except Exception:  # noqa: BLE001 -- reported to the parent, which raises
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                conn.send(("ok", fn(ctx, *args, **kwargs)))
            except Exception:  # noqa: BLE001 -- reported to the parent, which raises
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class RankPool:
    """``world_size`` spawned ranks on ``backend`` (``"gloo"`` or
    ``"nccl"``), each on ``device`` (``"cpu"``, or ``"cuda"``: with gloo
    every rank shares ``cuda:0``; with nccl rank r takes ``cuda:r``).
    Use as a context manager, or call :meth:`close`."""

    def __init__(self, world_size: int, *, backend: str = "gloo", device: str = "cpu",
                 timeout_s: float = 120.0, start_timeout_s: float = 300.0):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
        self.world_size = world_size
        self.timeout_s = timeout_s
        self._tmp = tempfile.mkdtemp(prefix="rank_pool_")
        init_method = "file://" + os.path.join(self._tmp, "store")
        ctx = mp.get_context("spawn")
        self._conns = []
        self._procs = []
        for rank in range(world_size):
            parent, child = ctx.Pipe()
            rank_device = f"cuda:{rank}" if backend == "nccl" else (
                "cuda:0" if device == "cuda" else device)
            proc = ctx.Process(target=_worker, args=(rank, world_size, backend, init_method,
                                                     rank_device, timeout_s, child),
                               daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._closed = False
        self._collect("start", start_timeout_s)

    def _collect(self, what: str, timeout_s: float) -> List[Any]:
        results, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(timeout_s):
                errors.append(f"rank {rank}: no answer within {timeout_s:.0f} s")
                continue
            try:
                status, value = conn.recv()
            except EOFError:
                errors.append(f"rank {rank}: the process died")
                continue
            if status == "err":
                errors.append(f"rank {rank}:\n{value}")
            results.append(value)
        if errors:
            self.close()
            raise RankError(f"{what} failed:\n" + "\n".join(errors))
        return results

    @property
    def closed(self) -> bool:
        """True after :meth:`close`, or after a failed :meth:`run`."""
        return self._closed

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None, **kwargs) -> List[Any]:
        """``fn(ctx, *args, **kwargs)`` on every rank; the results in rank
        order."""
        if self._closed:
            raise RankError("the pool is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        limit = timeout_s if timeout_s is not None else 4 * self.timeout_s
        return self._collect(getattr(fn, "__name__", "call"), limit)

    def close(self) -> None:
        """Stop every rank (terminating any that does not exit)."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(10)
            if proc.is_alive():
                proc.terminate()
                proc.join(5)
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
