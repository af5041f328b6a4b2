"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM (Criteo 1TB), 13 dense /
26 sparse fields, embed_dim 128, bottom MLP 13-512-256-128, top MLP
1024-1024-512-256-1, dot interaction.

Counterpart of ``repro/configs/dlrm_mlperf.py``.  The dot-interaction
block runs the paper's pruned-factor path (embeddings masked by effective
rank).  ``retrieval_cand`` ranks the candidates through the whole model; no
kernel is involved.  The tables hold 187,770,572 rows (96.14 GB in
float32): the cells' abstract arguments are meta tensors, and a run on one
card cuts the tables (``chip_smoke.py``).
"""
import functools

import torch

from repro_torch.configs import base
from repro_torch.models import recsys

ARCH_ID = "dlrm-mlperf"


def _pad512(v: int) -> int:
    """Round table rows up to a 512 multiple so every table row-shards over
    the full device grid (hash spaces are arbitrary; MLPerf itself caps them)."""
    return v + (-v) % 512


CONFIG = recsys.DLRMConfig(
    name=ARCH_ID,
    vocab_sizes=tuple(
        _pad512(v) if v >= 8192 else v for v in recsys.MLPERF_CRITEO_VOCABS
    ),
)
PRUNE_T = 0.002  # tables init at vocab^-0.5: thresholds live on that scale


def smoke_config() -> recsys.DLRMConfig:
    return recsys.DLRMConfig(
        name=ARCH_ID + "-smoke",
        n_dense=5,
        embed_dim=16,
        vocab_sizes=(50, 60, 70),
        bot_mlp=(32, 16),
        top_mlp=(32, 16, 1),
    )


def _init(generator, device=None):
    return recsys.init_dlrm_params(generator, CONFIG, device)


def _batch_specs(batch: int):
    return {
        "dense": base.abstract((batch, CONFIG.n_dense), torch.float32),
        "sparse": base.abstract((batch, CONFIG.n_sparse), torch.int32),
        "label": base.abstract((batch,), torch.float32),
    }


def cells():
    def train():
        return base.recsys_train_cell(
            ARCH_ID,
            "train_batch",
            init_fn=_init,
            loss_fn=functools.partial(recsys.dlrm_loss, cfg=CONFIG, t_v=PRUNE_T),
            batch_specs=_batch_specs(65536),
            note="MLPerf DLRM; embeddings row-sharded over the full device grid",
        )

    def serve(shape_id, batch):
        cfg = CONFIG

        def forward(params, b):
            return recsys.dlrm_forward(params, b["dense"], b["sparse"], cfg, PRUNE_T)

        return base.recsys_serve_cell(
            ARCH_ID, shape_id, init_fn=_init, forward_fn=forward,
            batch_specs=_batch_specs(batch),
        )

    def retrieval():
        cfg = CONFIG

        def forward(params, b):
            return recsys.dlrm_retrieval(params, b["dense"], b["sparse"], b["cand_ids"], cfg,
                                         PRUNE_T)

        specs = {
            "dense": base.abstract((1, CONFIG.n_dense), torch.float32),
            "sparse": base.abstract((1, CONFIG.n_sparse), torch.int32),
            "cand_ids": base.abstract((1_000_000,), torch.int32),
        }
        return base.recsys_serve_cell(
            ARCH_ID,
            "retrieval_cand",
            init_fn=_init,
            forward_fn=forward,
            batch_specs=specs,
            kind="retrieval",
            note="rank 1M candidates through the full interaction+top-MLP",
        )

    return {
        "train_batch": train,
        "serve_p99": lambda: serve("serve_p99", 512),
        "serve_bulk": lambda: serve("serve_bulk", 262144),
        "retrieval_cand": retrieval,
    }
