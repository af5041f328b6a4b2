"""fm [Rendle ICDM'10]: 39 sparse fields, embed_dim 10, pairwise FM
interaction via the O(nk) sum-square trick.

Counterpart of ``repro/configs/fm_arch.py``.  Every cell runs the
dynamic-pruning path (threshold 0.02 on the factor table; threshold 0
recovers the dense numerics exactly).  ``retrieval_cand`` scores through
the ``pruned_matmul`` kernel route (the reference's cell takes its dense
SPMD route; the port's cells run on one device).
"""
import functools

import torch

from repro_torch.configs import base
from repro_torch.models import recsys

ARCH_ID = "fm"

# vocab 2^20 per field: the nearest device-grid-divisible size to the
# nominal 1M rows (tables row-shard over all 512 devices).
CONFIG = recsys.FMConfig(name=ARCH_ID, n_fields=39, embed_dim=10,
                         vocab_per_field=1_048_576)
PRUNE_T = 0.02


def smoke_config() -> recsys.FMConfig:
    return recsys.FMConfig(name=ARCH_ID + "-smoke", n_fields=8, embed_dim=10,
                           vocab_per_field=100)


def _init(generator, device=None):
    return recsys.init_fm_params(generator, CONFIG, device)


def _batch_specs(batch: int):
    return {
        "ids": base.abstract((batch, CONFIG.n_fields), torch.int32),
        "label": base.abstract((batch,), torch.float32),
    }


def cells():
    def train():
        return base.recsys_train_cell(
            ARCH_ID,
            "train_batch",
            init_fn=_init,
            loss_fn=functools.partial(recsys.fm_loss, cfg=CONFIG, t_v=PRUNE_T),
            batch_specs=_batch_specs(65536),
            note="pruned FM interaction (paper technique, first-class)",
        )

    def serve(shape_id, batch):
        cfg = CONFIG

        def forward(params, b):
            return recsys.fm_forward(params, b["ids"], cfg, PRUNE_T)

        return base.recsys_serve_cell(
            ARCH_ID,
            shape_id,
            init_fn=_init,
            forward_fn=forward,
            batch_specs=_batch_specs(batch),
        )

    def retrieval():
        cfg = CONFIG

        def forward(params, b):
            return recsys.fm_retrieval(params, b["user_ids"], b["cand_ids"], cfg, PRUNE_T,
                                       use_kernel=True)

        specs = {
            "user_ids": base.abstract((1, CONFIG.n_fields - 1), torch.int32),
            "cand_ids": base.abstract((1_000_000,), torch.int32),
        }
        return base.recsys_serve_cell(
            ARCH_ID,
            "retrieval_cand",
            init_fn=_init,
            forward_fn=forward,
            batch_specs=specs,
            kind="retrieval",
            note="FM decomposition: candidate scoring = one (B,k)x(C,k) pruned_matmul",
        )

    return {
        "train_batch": train,
        "serve_p99": lambda: serve("serve_p99", 512),
        "serve_bulk": lambda: serve("serve_bulk", 262144),
        "retrieval_cand": retrieval,
    }
