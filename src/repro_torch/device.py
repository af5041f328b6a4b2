"""The one place the port's device rule lives.

Every entry point runs on ``cuda`` unless its caller passes ``device="cpu"``.
Without a card and without an explicit ``"cpu"`` it raises: the port never
carries on quietly on the CPU.  The functions that only make tensors (the
models' ``init_*``) also take ``device="meta"``: tensors with a shape and a
dtype and no storage, the port's abstract values (``configs``' cells).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None, *, meta_ok: bool = False) -> torch.device:
    """``None`` -> ``cuda``; raises when the requested device has no card.
    ``"meta"`` is accepted only when asked for by name and ``meta_ok``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type == "meta" and meta_ok:
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use \"cuda\" or \"cpu\"")
    return dev


def check_on(device: torch.device, **tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor lies on ``device`` (None is skipped)."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(
                f"{name} lies on {t.device}, but the call runs on {device}"
            )


def device_name(device: DeviceLike) -> str:
    """What a report calls ``device``: the card's name
    (``torch.cuda.get_device_name``) or "the CPU"."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
