"""The model zoo of the port, as far as it is ported.

* :mod:`repro_torch.models.layers`: the building blocks (``dense``,
  ``layer_norm``, ``mlp``, ``embed_lookup``, ``init_dense``, ``rms_norm``,
  ``rms_norm_lean``, ``gated_mlp``, ``rope_frequencies``, ``apply_rope``);
* :mod:`repro_torch.models.attention`: grouped-query attention, MLA, their
  KV caches and the chunked causal attention, in plain tensor ops;
* :mod:`repro_torch.models.moe`: the mixture-of-experts feed-forward
  (sort-based dispatch, and expert parallelism across ranks);
* :mod:`repro_torch.models.transformer`: the decoder-only transformers
  (gemma-7b, qwen1.5-4b, qwen3-4b, deepseek-v2-lite, granite-moe):
  forward, loss, prefill and in-place decode;
* :mod:`repro_torch.models.recsys`: FM, DLRM (MLPerf config), SASRec and
  BST, with ``embedding_bag``; FM's and SASRec's retrieval score through the
  ``pruned_matmul`` kernel;
* :mod:`repro_torch.models.gnn`: the GAT of gat-cora, its edge gathers and
  segment sums in batch order (``kernels.scatter``).
"""
from repro_torch.models import attention, gnn, moe, transformer  # noqa: F401
from repro_torch.models.layers import (  # noqa: F401
    apply_rope,
    dense,
    embed_lookup,
    gated_mlp,
    init_dense,
    layer_norm,
    mlp,
    rms_norm,
    rms_norm_lean,
    rope_frequencies,
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
