"""sasrec [arXiv:1808.09781]: embed_dim 50, 2 blocks, 1 head, seq_len 50,
self-attentive sequential recommendation over a 1M-item catalog.

Counterpart of ``repro/configs/sasrec_arch.py``.  Retrieval scoring (user
state x item embedding) is a latent dot product, where the paper's pruning
applies: ``retrieval_cand`` scores through the ``pruned_matmul`` kernel
route.  The serve cells rank the whole catalog with
``base.streaming_topk_scores`` (``pruned_topk`` at threshold 0 on CUDA).
"""
import functools

import torch

from repro_torch.configs import base
from repro_torch.models import recsys

ARCH_ID = "sasrec"

# n_items + 1 (padding row) = 2^20 keeps the catalog table row-shardable
# over the full 512-device grid.
CONFIG = recsys.SASRecConfig(
    name=ARCH_ID, n_items=1_048_575, embed_dim=50, n_blocks=2, n_heads=1,
    seq_len=50,
)
PRUNE_T = 0.002


def smoke_config() -> recsys.SASRecConfig:
    return recsys.SASRecConfig(
        name=ARCH_ID + "-smoke", n_items=500, embed_dim=16, n_blocks=2,
        n_heads=1, seq_len=12,
    )


def _init(generator, device=None):
    return recsys.init_sasrec_params(generator, CONFIG, device)


def cells():
    def train():
        specs = {key: base.abstract((65536, CONFIG.seq_len), torch.int32)
                 for key in ("seq", "pos", "neg")}
        return base.recsys_train_cell(
            ARCH_ID,
            "train_batch",
            init_fn=_init,
            loss_fn=functools.partial(recsys.sasrec_loss, cfg=CONFIG),
            batch_specs=specs,
        )

    def serve(shape_id, batch):
        cfg = CONFIG

        def forward(params, b):
            h = recsys.sasrec_encode(params, b["seq"], cfg)[:, -1]
            return base.streaming_topk_scores(h, params["item_embed"], k=100)

        specs = {"seq": base.abstract((batch, CONFIG.seq_len), torch.int32)}
        return base.recsys_serve_cell(
            ARCH_ID, shape_id, init_fn=_init, forward_fn=forward,
            batch_specs=specs,
            note="catalog-scale top-100 through pruned_topk (no (B, V) scores)",
        )

    def retrieval():
        cfg = CONFIG

        def forward(params, b):
            return recsys.sasrec_retrieval(params, b["seq"], cfg, PRUNE_T, use_kernel=True,
                                           cand_ids=b["cand_ids"])

        specs = {
            "seq": base.abstract((1, CONFIG.seq_len), torch.int32),
            "cand_ids": base.abstract((1_000_000,), torch.int32),
        }
        return base.recsys_serve_cell(
            ARCH_ID, "retrieval_cand", init_fn=_init, forward_fn=forward,
            batch_specs=specs, kind="retrieval",
            note="pruned latent scoring over 1M candidates through pruned_matmul",
        )

    return {
        "train_batch": train,
        "serve_p99": lambda: serve("serve_p99", 512),
        "serve_bulk": lambda: serve("serve_bulk", 262144),
        "retrieval_cand": retrieval,
    }
