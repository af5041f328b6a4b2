"""Evaluation, counterpart of ``repro/eval``:

* :mod:`repro_torch.eval.ranking`: HR@K / NDCG@K / recall@K through the real
  serving paths, pinned against a brute-force dense oracle;
* :mod:`repro_torch.eval.prequential`: test-then-learn error on the live
  event stream (windowed / decayed MAE and RMSE, drift hooks);
* :mod:`repro_torch.eval.prequential_ranking`: the rating-free variant, "was
  the clicked item in the top-k we served?", with user cohorts.
"""
from repro_torch.eval.prequential import (
    PrequentialEvaluator,
    PrequentialStats,
    recalibration_hook,
)
from repro_torch.eval.prequential_ranking import (
    PrequentialRankingEvaluator,
    PrequentialRankingStats,
)
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
    "PrequentialEvaluator",
    "PrequentialRankingEvaluator",
    "PrequentialRankingStats",
    "PrequentialStats",
    "RankingReport",
    "dense_topk",
    "evaluate_engine",
    "evaluate_oracle",
    "ndcg_discounts",
    "pack_ranking_batches",
    "ranking_counts",
    "recalibration_hook",
    "relevance_from_dataset",
    "report_from_sums",
]
