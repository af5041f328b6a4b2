"""Deterministic, resumable batch iteration: host-side and device-resident.

Counterpart of ``repro/data/loader.py``.  Shuffle order is a pure function of
``(seed, epoch)``, so a job restored from a checkpoint replays the identical
data order.  Batches are fixed-shape: drop-remainder for training, a padded
tail with a zero ``weight`` column for evaluation.

* :func:`iterate_batches`: numpy slices yielded per step (the trainer's
  ``epoch_mode="python"`` path), the same function as the reference's.
* :class:`PackedRatings` / :func:`pack_eval_batches`: the ratings table is
  uploaded to the device once; each epoch gathers it into ``(steps, B)``
  tensors that ``mf.train_epoch_scan`` loops over.  The order is numpy's
  :func:`epoch_permutation`, uploaded once per epoch: torch cannot draw
  ``jax.random.permutation``'s order, so this path gives the reference's
  *python-mode* batches (the same order as :func:`iterate_batches`), not
  its scan-mode ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.data.ratings import RatingsDataset
from repro_torch.device import DeviceLike, resolve_device


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n)


def iterate_batches(
    ds: RatingsDataset,
    batch_size: int,
    *,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
    start_step: int = 0,
    hist: Optional[np.ndarray] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape numpy batches; resume mid-epoch with ``start_step``."""
    n = len(ds)
    order = epoch_permutation(n, seed, epoch) if shuffle else np.arange(n)
    steps = num_steps(ds, batch_size, drop_remainder)
    for step in range(start_step, steps):
        idx = order[step * batch_size : (step + 1) * batch_size]
        weight = np.ones(batch_size, np.float32)
        if idx.shape[0] < batch_size:  # padded tail (eval only)
            pad = batch_size - idx.shape[0]
            weight[idx.shape[0]:] = 0.0
            idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        batch = {"user": ds.user[idx], "item": ds.item[idx], "rating": ds.rating[idx]}
        if not drop_remainder:
            # train batches are always full: leaving the weight out keeps
            # the weight-free fused route of the step eligible
            batch["weight"] = weight
        if hist is not None:
            batch["hist"] = hist[ds.user[idx]]
        yield batch


def num_steps(ds: RatingsDataset, batch_size: int, drop_remainder: bool = True) -> int:
    n = len(ds)
    return n // batch_size if drop_remainder else -(-n // batch_size)


@dataclasses.dataclass(frozen=True)
class PackedRatings:
    """A ratings table uploaded to the device once.

    ``epoch_batches(seed, epoch)`` returns ``{"user", "item", "rating"}``
    (and ``"weight"`` when given) shaped ``(steps, batch_size)``, in the order
    of ``epoch_permutation(n, seed, epoch)`` with the remainder dropped.
    Only the permutation crosses to the device per epoch (8 bytes a rating).
    """

    user: torch.Tensor     # (N,) int64, device-resident
    item: torch.Tensor     # (N,) int64
    rating: torch.Tensor   # (N,) float32
    batch_size: int
    weight: Optional[torch.Tensor] = None   # (N,) float32

    @property
    def num_examples(self) -> int:
        return int(self.user.shape[0])

    @property
    def num_steps(self) -> int:
        return self.num_examples // self.batch_size

    def epoch_batches(self, seed: int, epoch: int, *, shuffle: bool = True
                      ) -> Dict[str, torch.Tensor]:
        steps, b = self.num_steps, self.batch_size
        if steps == 0:
            raise ValueError(
                f"batch_size {b} exceeds the dataset ({self.num_examples} ratings)")
        order = (epoch_permutation(self.num_examples, seed, epoch) if shuffle
                 else np.arange(self.num_examples))
        take = torch.as_tensor(order[: steps * b]).to(self.user.device)
        out = {"user": self.user, "item": self.item, "rating": self.rating}
        if self.weight is not None:
            out["weight"] = self.weight
        return {key: value[take].reshape(steps, b) for key, value in out.items()}


def pack_ratings(
    ds: RatingsDataset,
    batch_size: int,
    *,
    weight: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> PackedRatings:
    """Upload the ratings table once; see :class:`PackedRatings`."""
    dev = resolve_device(device)
    if weight is not None and weight.shape[0] != len(ds):
        raise ValueError(f"weight length {weight.shape[0]} != dataset size {len(ds)}")
    return PackedRatings(
        user=torch.as_tensor(ds.user, dtype=torch.int64).to(dev),
        item=torch.as_tensor(ds.item, dtype=torch.int64).to(dev),
        rating=torch.as_tensor(ds.rating, dtype=torch.float32).to(dev),
        batch_size=int(batch_size),
        weight=None if weight is None else torch.as_tensor(weight, dtype=torch.float32).to(dev),
    )


def pack_eval_batches(ds: RatingsDataset, batch_size: int, *, device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """Pre-packed ``(steps, B)`` eval batches, built and uploaded once:
    dataset order, the padded tail carried by a zero ``weight`` column."""
    dev = resolve_device(device)
    n = len(ds)
    batch_size = min(batch_size, max(n, 1))
    steps = -(-n // batch_size)
    pad = steps * batch_size - n
    idx = np.concatenate([np.arange(n), np.zeros(pad, np.int64)])
    weight = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])

    def up(values, dtype):
        return torch.as_tensor(values[idx].reshape(steps, batch_size), dtype=dtype).to(dev)

    return {
        "user": up(ds.user, torch.int64),
        "item": up(ds.item, torch.int64),
        "rating": up(ds.rating, torch.float32),
        "weight": torch.as_tensor(weight.reshape(steps, batch_size)).to(dev),
    }
