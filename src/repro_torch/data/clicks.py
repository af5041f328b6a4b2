"""Synthetic click/CTR data for the recsys models (Criteo-shaped for DLRM and
FM, behaviour sequences for SASRec and BST).

The port's own copy of ``repro/data/clicks.py``: the same numpy calls in the
same order, so every batch is bitwise the reference's for the same seed.
Labels come from a planted logistic model over the ids, so the models have
a learnable signal.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def criteo_batch(
    batch: int,
    *,
    n_dense: int = 13,
    vocab_sizes: Sequence[int] = (),
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    dense = rng.normal(0, 1, (batch, n_dense)).astype(np.float32)
    sparse = np.stack(
        [rng.integers(0, v, batch) for v in vocab_sizes], axis=1
    ).astype(np.int32)
    # planted signal: the label correlates with a hash-derived score of the ids
    score = dense[:, 0] * 0.5 + np.sum((sparse % 7) - 3, axis=1) * 0.1
    prob = 1.0 / (1.0 + np.exp(-score))
    label = (rng.random(batch) < prob).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "label": label}


def fm_batch(
    batch: int, *, n_fields: int = 39, vocab_per_field: int = 1_000_000, seed: int = 0
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_per_field, (batch, n_fields)).astype(np.int32)
    score = np.sum((ids % 5) - 2, axis=1) * 0.15
    prob = 1.0 / (1.0 + np.exp(-score))
    label = (rng.random(batch) < prob).astype(np.float32)
    return {"ids": ids, "label": label}


def sasrec_batch(
    batch: int, *, seq_len: int = 50, n_items: int = 1_000_000, seed: int = 0
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, n_items + 1, (batch, seq_len)).astype(np.int32)
    # prefix padding for short histories
    lengths = rng.integers(seq_len // 2, seq_len + 1, batch)
    for row, length in enumerate(lengths):
        seq[row, : seq_len - length] = 0
    pos = np.roll(seq, -1, axis=1)
    pos[:, -1] = rng.integers(1, n_items + 1, batch)
    neg = rng.integers(1, n_items + 1, (batch, seq_len)).astype(np.int32)
    return {"seq": seq, "pos": pos.astype(np.int32), "neg": neg}


def bst_batch(
    batch: int,
    *,
    seq_len: int = 20,
    n_items: int = 1_000_000,
    n_profile: int = 16,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, n_items + 1, (batch, seq_len)).astype(np.int32)
    target = rng.integers(1, n_items + 1, batch).astype(np.int32)
    profile = rng.normal(0, 1, (batch, n_profile)).astype(np.float32)
    score = ((target % 11) - 5) * 0.2 + profile[:, 0] * 0.3
    prob = 1.0 / (1.0 + np.exp(-score))
    label = (rng.random(batch) < prob).astype(np.float32)
    return {"hist": hist, "target": target, "profile": profile, "label": label}
