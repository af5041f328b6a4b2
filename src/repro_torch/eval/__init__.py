"""Evaluation: HR@K / NDCG@K / recall@K through the real serving paths,
pinned against a brute-force dense oracle (:mod:`repro_torch.eval.ranking`).

Counterpart of ``repro/eval``; its prequential evaluators come with the
online slice (ROADMAP A5).
"""
from repro_torch.eval.ranking import (
    PAD_ITEM,
    RankingReport,
    dense_topk,
    evaluate_engine,
    evaluate_oracle,
    ndcg_discounts,
    pack_ranking_batches,
    ranking_counts,
    relevance_from_dataset,
    report_from_sums,
)

__all__ = [
    "PAD_ITEM",
    "RankingReport",
    "dense_topk",
    "evaluate_engine",
    "evaluate_oracle",
    "ndcg_discounts",
    "pack_ranking_batches",
    "ranking_counts",
    "relevance_from_dataset",
    "report_from_sums",
]
