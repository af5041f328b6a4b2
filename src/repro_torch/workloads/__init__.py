"""Workloads: the objectives the pruned engine serves beyond explicit MF.

Counterpart of ``repro/workloads``:

* :mod:`repro_torch.workloads.implicit`: confidence-weighted implicit MF
  (Hu/Koren/Volinsky 2008); clicks become binary preferences whose
  confidence rides ``train_step``'s ``batch["weight"]`` gate, so the
  objective flows through the epoch loop, the fused kernel and the online
  updater unchanged;
* :mod:`repro_torch.workloads.bpr`: Bayesian Personalized Ranking (Rendle
  2009), a pairwise ``-log sigma(s_ui - s_uj)`` objective whose masked
  gradients apply the same dynamic pruning per (user, item) pair;
* :mod:`repro_torch.workloads.sequential`: SASRec session encodings served
  as user vectors by the unchanged pruned top-k engine (``pruned_topk`` on
  the card).
"""
from repro_torch.workloads.bpr import (  # noqa: F401
    BPRSampler,
    bpr_epoch_scan,
    bpr_train_step,
)
from repro_torch.workloads.implicit import (  # noqa: F401
    PositiveSet,
    binarize_positives,
    confidence_weights,
    implicit_dataset,
    implicit_event_batch,
    implicit_microbatches,
    strip_ratings,
)
from repro_torch.workloads.sequential import (  # noqa: F401
    encode_sessions,
    serve_sessions,
    session_engine,
    session_params,
)
