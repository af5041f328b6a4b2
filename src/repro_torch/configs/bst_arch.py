"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba),
embed_dim 32, 20-item history + target, 1 block x 8 heads, MLP 1024-512-256.

Counterpart of ``repro/configs/bst_arch.py``.  BST is a ranking model:
``retrieval_cand`` ranks the candidates through the whole transformer and
MLP (the honest serving cost); no kernel is involved.
"""
import functools

import torch

from repro_torch.configs import base
from repro_torch.models import recsys

ARCH_ID = "bst"

# n_items + 1 (padding row) = 2^20: catalog table row-shardable over 512 devs.
CONFIG = recsys.BSTConfig(
    name=ARCH_ID, n_items=1_048_575, embed_dim=32, seq_len=20, n_blocks=1,
    n_heads=8, mlp_dims=(1024, 512, 256), n_profile=16,
)


def smoke_config() -> recsys.BSTConfig:
    return recsys.BSTConfig(
        name=ARCH_ID + "-smoke", n_items=500, embed_dim=16, seq_len=8,
        n_blocks=1, n_heads=4, mlp_dims=(64, 32), n_profile=4,
    )


def _init(generator, device=None):
    return recsys.init_bst_params(generator, CONFIG, device)


def _batch_specs(batch: int):
    return {
        "hist": base.abstract((batch, CONFIG.seq_len), torch.int32),
        "target": base.abstract((batch,), torch.int32),
        "profile": base.abstract((batch, CONFIG.n_profile), torch.float32),
        "label": base.abstract((batch,), torch.float32),
    }


def cells():
    def train():
        return base.recsys_train_cell(
            ARCH_ID,
            "train_batch",
            init_fn=_init,
            loss_fn=functools.partial(recsys.bst_loss, cfg=CONFIG),
            batch_specs=_batch_specs(65536),
        )

    def serve(shape_id, batch):
        cfg = CONFIG

        def forward(params, b):
            return recsys.bst_forward(params, b["hist"], b["target"], b["profile"], cfg)

        return base.recsys_serve_cell(
            ARCH_ID, shape_id, init_fn=_init, forward_fn=forward,
            batch_specs=_batch_specs(batch),
        )

    def retrieval():
        cfg = CONFIG

        def forward(params, b):
            c = b["cand_ids"].shape[0]
            hist = b["hist"].expand(c, cfg.seq_len)
            profile = b["profile"].expand(c, cfg.n_profile)
            return recsys.bst_forward(params, hist, b["cand_ids"], profile, cfg)

        specs = {
            "hist": base.abstract((1, CONFIG.seq_len), torch.int32),
            "profile": base.abstract((1, CONFIG.n_profile), torch.float32),
            "cand_ids": base.abstract((1_000_000,), torch.int32),
        }
        return base.recsys_serve_cell(
            ARCH_ID, "retrieval_cand", init_fn=_init, forward_fn=forward,
            batch_specs=specs, kind="retrieval",
            note="full-model ranking of 1M candidates (BST is a ranker)",
        )

    return {
        "train_batch": train,
        "serve_p99": lambda: serve("serve_p99", 512),
        "serve_bulk": lambda: serve("serve_bulk", 262144),
        "retrieval_cand": retrieval,
    }
