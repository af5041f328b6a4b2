"""The model zoo of the port, as far as it is ported.

* :mod:`repro_torch.models.layers`: the building blocks the recsys models
  use (``dense``, ``layer_norm``, ``mlp``, ``embed_lookup``, ``init_dense``);
* :mod:`repro_torch.models.recsys`: FM, DLRM (MLPerf config), SASRec and
  BST, with ``embedding_bag``; FM's and SASRec's retrieval score through the
  ``pruned_matmul`` kernel;
* :mod:`repro_torch.models.gnn`: the GAT of gat-cora, its edge gathers and
  segment sums in batch order (``kernels.scatter``).

Still to port from ``repro/models``: ``attention``, ``moe`` and
``transformer`` (with ``layers``' ``rms_norm``, ``rms_norm_lean``,
``gated_mlp``, ``rope_frequencies`` and ``apply_rope``).
"""
from repro_torch.models import gnn  # noqa: F401
from repro_torch.models.layers import (  # noqa: F401
    dense,
    embed_lookup,
    init_dense,
    layer_norm,
    mlp,
)
from repro_torch.models.recsys import (  # noqa: F401
    MLPERF_CRITEO_VOCABS,
    BSTConfig,
    DLRMConfig,
    FMConfig,
    SASRecConfig,
    bst_forward,
    bst_loss,
    dlrm_forward,
    dlrm_loss,
    dlrm_retrieval,
    embedding_bag,
    fm_forward,
    fm_loss,
    fm_retrieval,
    init_bst_params,
    init_dlrm_params,
    init_fm_params,
    init_sasrec_params,
    recsys_params_from_numpy,
    recsys_params_to_numpy,
    sasrec_encode,
    sasrec_loss,
    sasrec_retrieval,
)
