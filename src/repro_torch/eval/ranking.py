"""Ranking-quality metrics for pruned serving: HR@K / NDCG@K / recall@K.

Counterpart of ``repro/eval/ranking.py``, with the same names and
semantics.  What reaches a user is the engine's top-k, so the cost of
pruning is measured as ranking degradation on every path the engine serves
from:

* :func:`ranking_counts` — batched HR@K / NDCG@K / recall@K sums from
  ``(B, K)`` recommended ids against padded per-user relevance sets, plain
  tensor ops on the ids' device (the body of ``mf.eval_ranking_epoch_scan``
  and of the evaluators below);
* :func:`dense_topk` — the brute-force oracle: ``predict_all_items`` over the
  full catalog and a *stable* descending sort, so ties resolve to the lower
  item index like the engine's merges and the ``pruned_topk`` kernel.  At
  thresholds 0 every engine path returns identical indices, so engine
  metrics equal oracle metrics exactly;
* :func:`evaluate_engine` / :func:`evaluate_oracle` — end to end: relevance
  sets from a held-out :class:`~repro_torch.data.ratings.RatingsDataset`,
  ranked through ``ServingEngine.topk`` or the oracle, reduced to one
  :class:`RankingReport`.

Metric definitions (binary relevance, per evaluated user ``u`` with
held-out item set ``R_u``; users with empty ``R_u`` are excluded):

* ``HR@K``      — 1 if the top-K contains any item of ``R_u``;
* ``recall@K``  — ``|topK ∩ R_u| / |R_u|``;
* ``NDCG@K``    — ``DCG@K / IDCG@K`` with gain ``1 / log2(pos + 2)`` at
  0-based position ``pos``; ``IDCG@K`` places ``min(K, |R_u|)`` hits at the
  head.

The evaluators sum per-batch metrics in Python floats (float64); the epoch
scan sums them in float32 device scalars, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mf
from repro_torch.device import DeviceLike, resolve_device

PAD_ITEM = -1  # relevance padding: never equals a valid item id


# ---------------------------------------------------------------------------
# Metric sums
# ---------------------------------------------------------------------------


def ndcg_discounts(k: int, device=None) -> torch.Tensor:
    """``(K,)`` DCG position discounts ``1 / log2(pos + 2)``, 0-based."""
    pos = torch.arange(k, dtype=torch.float32, device=device)
    return 1.0 / torch.log2(pos + 2.0)


def ranking_counts(
    topk_idx: torch.Tensor,    # (B, K) recommended item ids, best first
    relevant: torch.Tensor,    # (B, R) held-out item ids, PAD_ITEM-padded
    n_valid: torch.Tensor,     # (B,)   |R_u| per row
    weight: Optional[torch.Tensor] = None,  # (B,) 0 masks padding rows
) -> Dict[str, torch.Tensor]:
    """Summed HR@K / NDCG@K / recall@K over a batch, as float32 scalars on
    the ids' device.

    Returns ``{"hr_sum", "ndcg_sum", "recall_sum", "weight_sum"}``; divide
    the metric sums by ``weight_sum`` for per-user means.  Rows with
    ``n_valid == 0`` (or zero ``weight``) contribute nothing.
    """
    k = topk_idx.shape[-1]
    dev = topk_idx.device
    w = (
        torch.ones(topk_idx.shape[:1], dtype=torch.float32, device=dev)
        if weight is None else weight.float()
    )
    w = w * (n_valid > 0).float()
    # (B, K) hit mask: is the j-th recommendation in the user's holdout?
    hits = torch.any(
        topk_idx.long()[:, :, None] == relevant.long()[:, None, :], dim=-1
    ).float()
    disc = ndcg_discounts(k, dev)
    dcg = torch.sum(hits * disc[None, :], dim=-1)
    ideal = torch.cumsum(disc, dim=0)               # (K,) prefix sums
    n_ideal = torch.clamp(n_valid.long(), 1, k)     # clamp(., 1, .): no 0 gather
    idcg = ideal[n_ideal - 1]
    hit_count = torch.sum(hits, dim=-1)
    safe_valid = torch.clamp(n_valid.float(), min=1.0)
    return {
        "hr_sum": torch.sum(w * (hit_count > 0).float()),
        "ndcg_sum": torch.sum(w * dcg / idcg),
        "recall_sum": torch.sum(w * hit_count / safe_valid),
        "weight_sum": torch.sum(w),
    }


# ---------------------------------------------------------------------------
# Relevance sets from a held-out ratings split
# ---------------------------------------------------------------------------


def relevance_from_dataset(
    ds,
    *,
    min_rating: Optional[float] = None,
    max_users: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-user relevance sets from a held-out split.

    Returns ``(users, relevant, counts)``: the evaluated user ids ``(U,)``,
    their held-out items ``(U, R)`` padded with :data:`PAD_ITEM`, and the
    per-user set sizes ``(U,)``.  ``min_rating`` keeps only interactions at
    or above it; users left with no relevant items are excluded.
    ``max_users`` keeps the first U evaluated users (ascending id); None
    (not 0) means no cap.
    """
    if max_users is not None and max_users <= 0:
        raise ValueError(
            f"max_users must be positive (or None for no cap), got {max_users}"
        )
    user = np.asarray(ds.user, np.int64)
    item = np.asarray(ds.item, np.int64)
    if min_rating is not None:
        keep = np.asarray(ds.rating, np.float32) >= min_rating
        user, item = user[keep], item[keep]
    if user.size == 0:
        return (
            np.zeros(0, np.int32),
            np.zeros((0, 1), np.int32),
            np.zeros(0, np.int32),
        )
    order = np.lexsort((item, user))
    user, item = user[order], item[order]
    # unique (user, item) pairs: duplicate interactions are one relevance
    first = np.ones(user.size, bool)
    first[1:] = (user[1:] != user[:-1]) | (item[1:] != item[:-1])
    user, item = user[first], item[first]
    uniq, counts = np.unique(user, return_counts=True)
    if max_users is not None:
        uniq, counts = uniq[:max_users], counts[:max_users]
        keep = user <= uniq[-1]
        user, item = user[keep], item[keep]
    width = int(counts.max())
    relevant = np.full((uniq.size, width), PAD_ITEM, np.int32)
    starts = np.zeros(uniq.size + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    for row, (lo, hi) in enumerate(zip(starts[:-1], starts[1:])):
        relevant[row, : hi - lo] = item[lo:hi]
    return uniq.astype(np.int32), relevant, counts.astype(np.int32)


def pack_ranking_batches(
    ds,
    batch_size: int,
    *,
    min_rating: Optional[float] = None,
    max_users: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Pre-packed ``(steps, B, ...)`` operands for
    ``mf.eval_ranking_epoch_scan``, uploaded to ``device`` once: the
    evaluated users (int64, ready to index), their padded relevance sets and
    set sizes (int32), and a float32 ``weight`` that is 0 on the padded
    tail."""
    dev = resolve_device(device)
    users, relevant, counts = relevance_from_dataset(
        ds, min_rating=min_rating, max_users=max_users
    )
    n_users = users.size
    if n_users == 0:
        raise ValueError("no users with relevant held-out items to evaluate")
    batch_size = min(batch_size, n_users)
    steps = -(-n_users // batch_size)
    pad = steps * batch_size - n_users
    users = np.concatenate([users, np.zeros(pad, np.int32)])
    relevant = np.concatenate(
        [relevant, np.full((pad, relevant.shape[1]), PAD_ITEM, np.int32)]
    )
    counts = np.concatenate([counts, np.zeros(pad, np.int32)])
    weight = np.concatenate(
        [np.ones(n_users, np.float32), np.zeros(pad, np.float32)]
    )

    def up(values, dtype, *shape):
        return torch.as_tensor(values.reshape(steps, batch_size, *shape), dtype=dtype).to(dev)

    return {
        "user": up(users, torch.int64),
        "relevant": up(relevant, torch.int32, relevant.shape[1]),
        "n_valid": up(counts, torch.int32),
        "weight": up(weight, torch.float32),
    }


# ---------------------------------------------------------------------------
# Brute-force oracle
# ---------------------------------------------------------------------------


def dense_topk(
    params: mf.MFParams,
    user_ids,
    topk: int,
    *,
    t_p=0.0,
    t_q=0.0,
    hist: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Score-everything-then-sort reference ranking on the params' device.

    Materializes the full ``(B, n)`` score matrix (deliberately: this is
    the baseline the engine replaces) through ``mf.predict_all_items``
    (``pruned_matmul``: the kernel on CUDA) and takes a *stable* descending
    sort, so ties resolve to the lower item index.  With ``t_p == t_q == 0``
    this is the dense oracle every engine path must reproduce.  Returns
    ``(scores, indices)`` numpy arrays, (B, topk) float32 and int32.
    """
    dev = params.p.device
    ids = np.asarray(user_ids, np.int64)
    users = torch.as_tensor(ids).to(dev)
    h = None if hist is None else torch.as_tensor(
        np.asarray(hist)[ids], dtype=torch.int64).to(dev)
    scores = mf.predict_all_items(params, users, t_p, t_q, hist=h, device=dev)
    top_s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return (
        top_s[:, :topk].cpu().numpy(),
        idx[:, :topk].to(torch.int32).cpu().numpy(),
    )


# ---------------------------------------------------------------------------
# End-to-end evaluation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankingReport:
    """Mean ranking metrics over the evaluated users (see the module
    docstring for the definitions)."""

    topk: int
    users: int      # evaluated users (non-empty relevance sets)
    hr: float
    ndcg: float
    recall: float

    def as_dict(self) -> Dict[str, float]:
        """Flat summary for JSON reports."""
        return {
            "topk": self.topk,
            "users": self.users,
            f"hr_at_{self.topk}": self.hr,
            f"ndcg_at_{self.topk}": self.ndcg,
            f"recall_at_{self.topk}": self.recall,
        }


def report_from_sums(sums: Dict[str, float], topk: int) -> RankingReport:
    """Reduce :func:`ranking_counts`-style metric sums (e.g. the output of
    ``mf.eval_ranking_epoch_scan``, as floats) to a mean
    :class:`RankingReport`."""
    denom = max(sums["weight_sum"], 1.0)
    return RankingReport(
        topk=topk,
        users=int(sums["weight_sum"]),
        hr=sums["hr_sum"] / denom,
        ndcg=sums["ndcg_sum"] / denom,
        recall=sums["recall_sum"] / denom,
    )


def _metrics_over_batches(rank_fn, users, relevant, counts, topk, batch_size):
    """Shared reduction: rank each user batch, accumulate the metric sums in
    Python floats.  The ids come back to the host from every path, so the
    sums reduce there."""
    sums = {"hr_sum": 0.0, "ndcg_sum": 0.0, "recall_sum": 0.0, "weight_sum": 0.0}
    for lo in range(0, users.size, batch_size):
        hi = min(lo + batch_size, users.size)
        _, idx = rank_fn(users[lo:hi], topk)
        out = ranking_counts(
            torch.as_tensor(np.asarray(idx, np.int32)),
            torch.as_tensor(relevant[lo:hi]),
            torch.as_tensor(counts[lo:hi]),
        )
        for key in sums:
            sums[key] += float(out[key])
    return report_from_sums(sums, topk)


def _resolve_relevance(ds, relevance, min_rating, max_users, num_users):
    """Relevance triple for the evaluators: the precomputed one, or built
    from ``ds``; either way filtered to ids the model knows."""
    if relevance is not None:
        users, relevant, counts = relevance
    else:
        users, relevant, counts = relevance_from_dataset(
            ds, min_rating=min_rating, max_users=max_users
        )
    known = users < num_users
    return users[known], relevant[known], counts[known]


def evaluate_engine(
    engine,
    ds=None,
    topk: int = 10,
    *,
    mesh=None,
    batch_size: int = 256,
    min_rating: Optional[float] = None,
    max_users: Optional[int] = None,
    relevance: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> RankingReport:
    """Ranking metrics of a live :class:`~repro_torch.serving.ServingEngine`,
    ranked through its real serving path: ``engine.topk`` (the
    ``pruned_topk`` kernel on CUDA, the streaming merge on the CPU), or
    ``engine.topk_sharded`` on ``mesh`` (SPMD: every rank of the mesh calls
    this with the same arguments and gets the same report).  ``relevance``
    takes a precomputed :func:`relevance_from_dataset` triple."""
    users, relevant, counts = _resolve_relevance(
        ds, relevance, min_rating, max_users, engine.num_users
    )
    if mesh is not None:
        rank_fn = lambda u, k: engine.topk_sharded(u, k, mesh=mesh)  # noqa: E731
    else:
        rank_fn = engine.topk
    return _metrics_over_batches(
        rank_fn, users, relevant, counts, topk, batch_size
    )


def evaluate_oracle(
    params: mf.MFParams,
    ds=None,
    topk: int = 10,
    *,
    t_p=0.0,
    t_q=0.0,
    hist: Optional[np.ndarray] = None,
    batch_size: int = 256,
    min_rating: Optional[float] = None,
    max_users: Optional[int] = None,
    relevance: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> RankingReport:
    """Ranking metrics of the brute-force reference (:func:`dense_topk`) on
    the params' device.  At thresholds 0 it is the dense oracle the engine
    is pinned against; at the trained ``(t_p, t_q)`` it isolates what
    pruning does to ranking quality."""
    users, relevant, counts = _resolve_relevance(
        ds, relevance, min_rating, max_users, params.p.shape[0]
    )

    def rank_fn(u, k):
        return dense_topk(params, u, k, t_p=t_p, t_q=t_q, hist=hist)

    return _metrics_over_batches(
        rank_fn, users, relevant, counts, topk, batch_size
    )
