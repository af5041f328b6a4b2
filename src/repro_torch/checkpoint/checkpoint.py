"""Checkpoints in the reference trainer's on-disk format.

Counterpart of ``repro/checkpoint/checkpoint.py`` (numpy and the standard
library).  A step lives at
``<dir>/step_<012d>``, a symlink to its payload directory
``step_<012d>.data.<pid>.<usec>``, as ``arrays.npz`` plus ``metadata.json``.

* **Write.** :func:`save` writes and fsyncs the payload, stamps its
  ``payload_crc32``, then publishes by atomically repointing the step
  symlink and fsyncing the directory, so a reader never sees a half-written
  or missing step; keep-N retention follows.  The ``checkpoint.fsync``
  fault seam (:mod:`repro_torch.testing.faults`) sits between the writes
  and the fsync, so an injected error publishes nothing.
* **Read.** :func:`load_raw` checks ``payload_crc32`` before deserializing,
  so corrupt bytes raise :class:`CorruptCheckpointError` instead of becoming
  factors; :func:`restore` falls back to older steps past a corrupt one.
* **Keys.** A state tree of dicts, NamedTuples, lists and tensors flattens
  to ``"__"``-joined paths with dict keys sorted and None fields dropped,
  exactly as the reference's ``jax.tree_util`` flattening names them
  (``params__p``, ``opt_state__p__acc``, ``t_p``), so either package
  restores the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.testing import faults

Tree = Any
_SEP = "__"
# Unreferenced payload dirs and temp files must outlive any reader that
# resolved the step symlink before a re-save superseded them.
_STALE_SECONDS = 3600.0


class CorruptCheckpointError(RuntimeError):
    """A checkpoint payload failed its integrity check (CRC mismatch,
    truncated or unreadable npz)."""


def _file_crc32(path: str, *, chunk: int = 1 << 20) -> int:
    """Streaming CRC-32 of one file (constant memory)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _children(tree: Tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in flattening order, or None for
    a leaf.  Dict keys are sorted, as ``jax.tree_util`` sorts them."""
    if isinstance(tree, dict):
        return [(str(key), tree[key]) for key in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return [(name, getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(j), child) for j, child in enumerate(tree)]
    return None


def _to_numpy(leaf: Any) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _map_leaves(tree: Tree, fn: Callable[[str, Any], Any], path: Tuple[str, ...] = ()) -> Tree:
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; None stays None."""
    if tree is None:
        return None
    children = _children(tree)
    if children is None:
        return fn(_SEP.join(path) or "root", tree)
    mapped = [_map_leaves(child, fn, path + (key,)) for key, child in children]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), mapped))
    if hasattr(tree, "_fields"):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def flatten_with_paths(tree: Tree) -> List[Tuple[str, np.ndarray]]:
    """``[(key, numpy array)]`` in the reference's flattening order and names."""
    out: List[Tuple[str, np.ndarray]] = []
    _map_leaves(tree, lambda key, leaf: out.append((key, _to_numpy(leaf))))
    return out


def _fsync_dir(path: str) -> None:
    """fsync a directory so its entry creations and renames survive a crash."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(
    directory: str,
    step: int,
    tree: Tree,
    *,
    metadata: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Blocking atomic save of ``tree`` as ``step``; returns the published path.

    The payload lands, fsynced, in a uniquely named ``step_X.data.<nonce>``
    directory; then the ``step_X`` symlink is repointed with ``os.replace``
    and the parent directory fsynced.  Re-saving a step never opens a
    missing-checkpoint window, and a reader that already resolved the link
    keeps a complete payload until the retention sweep.
    """
    os.makedirs(directory, exist_ok=True)
    final = step_path(directory, step)
    nonce = f"{os.getpid()}.{int(time.time() * 1e6)}"
    data_name = f"step_{step:012d}.data.{nonce}"
    data_dir = os.path.join(directory, data_name)
    os.makedirs(data_dir, exist_ok=True)

    arrays = dict(flatten_with_paths(tree))
    npz_path = os.path.join(data_dir, "arrays.npz")
    np.savez(npz_path, **arrays)
    meta = {
        "step": step,
        "keys": sorted(arrays),
        "payload_crc32": _file_crc32(npz_path),
        **(metadata or {}),
    }
    with open(os.path.join(data_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    # fsync the payload before publishing, so a crash cannot publish garbage
    if faults._PLAN is not None:
        for act in faults.fire("checkpoint.fsync"):
            if act.op == "error":
                raise OSError("injected fsync failure (chaos harness)")
    for name in ("arrays.npz", "metadata.json"):
        fd = os.open(os.path.join(data_dir, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    _fsync_dir(data_dir)

    if os.path.isdir(final) and not os.path.islink(final):
        # legacy layout: step_X is a real directory; move it aside so the
        # symlink can take the name (the sweep collects the remains)
        os.rename(final, os.path.join(directory, f"{data_name}.legacy"))
    link_tmp = os.path.join(directory, f"step_{step:012d}.lnk.{nonce}")
    os.symlink(data_name, link_tmp)  # relative target: the directory can move
    os.replace(link_tmp, final)      # atomic publish / re-publish
    _fsync_dir(directory)
    _garbage_collect(directory, keep)
    return final


def _remove_step(directory: str, step: int) -> None:
    """Retire one step: the symlink first, then the payload it named."""
    path = step_path(directory, step)
    if os.path.islink(path):
        target = os.path.join(directory, os.readlink(path))
        try:
            os.unlink(path)
        except OSError:
            pass
        shutil.rmtree(target, ignore_errors=True)
    else:
        shutil.rmtree(path, ignore_errors=True)


def _garbage_collect(directory: str, keep: int) -> None:
    """Keep the newest ``keep`` steps; sweep stale leftovers (crashed
    writers' temp links, superseded payloads) once they are old enough that
    no reader can still hold a path into them."""
    for step in all_steps(directory)[:-keep] if keep > 0 else []:
        _remove_step(directory, step)
    live = {
        os.readlink(step_path(directory, step))
        for step in all_steps(directory)
        if os.path.islink(step_path(directory, step))
    }
    now = time.time()
    for name in os.listdir(directory):
        stale = ".tmp." in name or ".lnk." in name or (".data." in name and name not in live)
        if not stale:
            continue
        path = os.path.join(directory, name)
        try:
            age = now - os.lstat(path).st_mtime
        except OSError:
            continue
        if age > _STALE_SECONDS:
            if os.path.islink(path):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            else:
                shutil.rmtree(path, ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    """Published steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp." not in name:
            try:
                steps.append(int(name[len("step_"):]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """The newest published step, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def step_path(directory: str, step: int) -> str:
    """The on-disk directory of one step."""
    return os.path.join(directory, f"step_{step:012d}")


def load_metadata(directory: str, step: int) -> Dict[str, Any]:
    """``metadata.json`` of one step."""
    base = os.path.realpath(step_path(directory, step))
    with open(os.path.join(base, "metadata.json")) as f:
        return json.load(f)


def load_raw(
    directory: str,
    step: Optional[int] = None,
    *,
    metadata: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A step's flat ``{key: array}`` payload and metadata (the latest step
    when ``step`` is None).  A payload that fails its ``payload_crc32`` or
    cannot be read raises :class:`CorruptCheckpointError`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    # resolve the step symlink once so metadata and arrays come from the
    # same payload even while a writer re-publishes the step
    base = os.path.realpath(step_path(directory, step))
    try:
        if metadata is None:
            with open(os.path.join(base, "metadata.json")) as f:
                metadata = json.load(f)
        npz_path = os.path.join(base, "arrays.npz")
        expected = metadata.get("payload_crc32")
        if expected is not None and _file_crc32(npz_path) != int(expected):
            raise CorruptCheckpointError(
                f"step {step}: arrays.npz fails its payload_crc32 check"
            )
        with np.load(npz_path) as data:
            arrays = {key: data[key] for key in data.files}
    except (CorruptCheckpointError, FileNotFoundError):
        raise
    except Exception as exc:
        # zipfile.BadZipFile, json decode errors, OS errors from a torn write
        raise CorruptCheckpointError(
            f"step {step}: unreadable payload ({type(exc).__name__}: {exc})"
        ) from exc
    return arrays, metadata


def restore(directory: str, tree_like: Tree, *, step: Optional[int] = None
            ) -> Tuple[Tree, Dict[str, Any]]:
    """Restore into the structure of ``tree_like`` (numpy leaves); returns
    ``(tree, metadata)``.  With ``step`` None a corrupt newest step falls
    back to the next older one; an explicit ``step`` never falls back."""
    if step is None:
        steps = all_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        last_err: Optional[Exception] = None
        for candidate in reversed(steps):
            try:
                arrays, meta = load_raw(directory, candidate)
                break
            except CorruptCheckpointError as exc:
                last_err = exc
        else:
            raise CorruptCheckpointError(
                f"every retained checkpoint under {directory} is corrupt") from last_err
        return _shape_restore(tree_like, arrays), meta
    arrays, meta = load_raw(directory, step)
    return _shape_restore(tree_like, arrays), meta


def _shape_restore(tree_like: Tree, arrays: Dict[str, np.ndarray]) -> Tree:
    """Unflatten a raw payload into ``tree_like``'s structure, shape-checked."""

    def take(key, like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        want = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} != expected {want}")
        return arr

    return _map_leaves(tree_like, take)


def elastic_load(directory: str, tree_like: Tree, shard_fn: Callable[[Tree], Tree], *,
                 step: Optional[int] = None) -> Tuple[Tree, Dict[str, Any]]:
    """Restore, then re-shard onto the *current* mesh, which may differ from
    the one the checkpoint was written under (elastic scaling):
    ``shard_fn`` takes the restored numpy tree, e.g.
    ``lambda tree: sharding.shard_tree(tree, mesh)`` for this rank's
    blocks.  Returns ``(shard_fn(tree), metadata)``."""
    host_tree, meta = restore(directory, tree_like, step=step)
    return shard_fn(host_tree), meta


class AsyncCheckpointer:
    """Overlap serialization with training; at most one save in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Tree, metadata=None) -> None:
        """Snapshot ``tree`` to host numpy now; write it on a thread."""
        self.wait()
        host_tree = _map_leaves(tree, lambda key, leaf: _to_numpy(leaf).copy())

        def work():
            try:
                save(self.directory, step, host_tree, metadata=metadata, keep=self.keep)
            except Exception as exc:  # noqa: BLE001 -- surfaced on the next wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
