"""Checkpoint reading: the on-disk format of the reference trainer.

Counterpart of the read side of ``repro/checkpoint/checkpoint.py``, numpy
only.  A step lives at ``<dir>/step_<012d>`` (a symlink to its payload
directory) as ``arrays.npz`` plus ``metadata.json``; the metadata's
``payload_crc32`` is checked before the arrays are deserialized, so corrupt
bytes raise :class:`CorruptCheckpointError` instead of becoming factors.
The write side comes with the training slice.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


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
