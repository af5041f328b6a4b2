"""Rating datasets: synthetic planted-low-rank generators shaped like the
paper's four benchmarks, plus a CSV loader for real data.

A copy of ``repro/data/ratings.py`` (numpy only): the port may not import the
reference package, whose ``repro.data`` pulls in JAX.

The container has no network access, so experiments run on synthetic data
whose (users, items, #ratings, rating scale) match Table 1 of the paper; the
generator plants a low-rank structure so MF has signal to recover and MAE
trends are meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RatingsDataset:
    user: np.ndarray    # (N,) int32
    item: np.ndarray    # (N,) int32
    rating: np.ndarray  # (N,) float32
    num_users: int
    num_items: int
    rating_min: float = 1.0
    rating_max: float = 5.0

    def __len__(self) -> int:
        return self.user.shape[0]

    @property
    def global_mean(self) -> float:
        return float(self.rating.mean()) if len(self) else 0.0


def synthetic_ratings(
    num_users: int,
    num_items: int,
    num_ratings: int,
    *,
    k_true: int = 24,
    spectrum_decay: float = 0.7,
    noise: float = 0.35,
    rating_min: float = 1.0,
    rating_max: float = 5.0,
    seed: int = 0,
    integer_ratings: bool = True,
) -> RatingsDataset:
    """Planted low-rank ratings with a power-law item popularity and a
    *decaying factor spectrum* (sigma_j ~ (j+1)^-decay), the shape real
    rating data takes: a few blockbusters, a long tail, and singular values
    that fall off.  The spectral decay is what induces the paper's
    fine-grained structured sparsity in the *learned* factors (Fig. 3) —
    equal-variance planted factors would make per-dim sparsity uniform and
    the early-stopping regime degenerate (verified in EXPERIMENTS.md)."""
    rng = np.random.default_rng(seed)
    spectrum = (np.arange(1, k_true + 1) ** -spectrum_decay).astype(np.float32)
    spectrum *= (k_true / (spectrum ** 2).sum()) ** 0.5  # keep total variance
    scale = spectrum / np.sqrt(k_true)
    p_true = (rng.normal(0.0, 1.0, (num_users, k_true)) * scale).astype(np.float32)
    q_true = (rng.normal(0.0, 1.0, (num_items, k_true)) * scale).astype(np.float32)
    u_bias = rng.normal(0.0, 0.25, num_users).astype(np.float32)
    i_bias = rng.normal(0.0, 0.25, num_items).astype(np.float32)

    users = rng.integers(0, num_users, num_ratings).astype(np.int32)
    pop = rng.zipf(1.3, size=4 * num_ratings)
    pop = pop[pop <= num_items][:num_ratings] - 1
    if pop.shape[0] < num_ratings:  # zipf tail too thin; fill uniformly
        fill = rng.integers(0, num_items, num_ratings - pop.shape[0])
        pop = np.concatenate([pop, fill])
    items = pop.astype(np.int32)

    mid = 0.5 * (rating_min + rating_max)
    spread = 0.5 * (rating_max - rating_min)
    raw = (
        mid
        + spread * np.einsum("nk,nk->n", p_true[users], q_true[items])
        + 0.5 * (u_bias[users] + i_bias[items])
        + rng.normal(0.0, noise, num_ratings)
    )
    r = np.clip(raw, rating_min, rating_max).astype(np.float32)
    if integer_ratings:
        r = np.round(r).astype(np.float32)
    return RatingsDataset(
        user=users,
        item=items,
        rating=r,
        num_users=num_users,
        num_items=num_items,
        rating_min=rating_min,
        rating_max=rating_max,
    )


# The paper's Table 1, reproduced as synthetic datasets of identical shape.
_TABLE1 = {
    "movielens100k": dict(num_users=943, num_items=1682, num_ratings=100000,
                          rating_min=1.0, rating_max=5.0, integer_ratings=True),
    "appliances": dict(num_users=30252, num_items=515650, num_ratings=602777,
                       rating_min=1.0, rating_max=5.0, integer_ratings=True),
    "bookcrossings": dict(num_users=105284, num_items=340554, num_ratings=1149779,
                          rating_min=0.0, rating_max=10.0, integer_ratings=True),
    "jester": dict(num_users=73418, num_items=100, num_ratings=4136210,
                   rating_min=-10.0, rating_max=10.0, integer_ratings=False),
}


def paper_dataset(name: str, *, seed: int = 0, scale: float = 1.0) -> RatingsDataset:
    """One of the paper's four datasets (Table 1) at ``scale`` of its size."""
    spec = dict(_TABLE1[name])
    for key in ("num_users", "num_items", "num_ratings"):
        spec[key] = max(int(spec[key] * scale), 8)
    integer = spec.pop("integer_ratings")
    return synthetic_ratings(seed=seed, integer_ratings=integer, **spec)


def train_test_split(
    ds: RatingsDataset, test_fraction: float = 0.2, seed: int = 0
) -> Tuple[RatingsDataset, RatingsDataset]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    cut = int(len(ds) * (1.0 - test_fraction))
    tr, te = perm[:cut], perm[cut:]

    def take(idx):
        return RatingsDataset(
            user=ds.user[idx],
            item=ds.item[idx],
            rating=ds.rating[idx],
            num_users=ds.num_users,
            num_items=ds.num_items,
            rating_min=ds.rating_min,
            rating_max=ds.rating_max,
        )

    return take(tr), take(te)


def load_csv(
    path: str,
    *,
    delimiter: str = ",",
    num_users: Optional[int] = None,
    num_items: Optional[int] = None,
) -> RatingsDataset:
    """``user,item,rating`` rows (0-indexed ids)."""
    raw = np.loadtxt(path, delimiter=delimiter, dtype=np.float64)
    user = raw[:, 0].astype(np.int32)
    item = raw[:, 1].astype(np.int32)
    rating = raw[:, 2].astype(np.float32)
    return RatingsDataset(
        user=user,
        item=item,
        rating=rating,
        num_users=num_users or int(user.max()) + 1,
        num_items=num_items or int(item.max()) + 1,
        rating_min=float(rating.min()),
        rating_max=float(rating.max()),
    )


def build_user_history(
    ds: RatingsDataset, max_hist: int = 32
) -> np.ndarray:
    """(num_users, max_hist) padded item ids for SVD++'s implicit term.

    Padding value is ``num_items`` — the inert extra row of the implicit
    factor table.
    """
    hist = np.full((ds.num_users, max_hist), ds.num_items, np.int32)
    counts = np.zeros(ds.num_users, np.int32)
    for u, i in zip(ds.user, ds.item):
        c = counts[u]
        if c < max_hist:
            hist[u, c] = i
            counts[u] = c + 1
    return hist
