"""gemma-7b [arXiv:2403.08295]: 28L d3072 16H (kv=16) d_ff=24576 GeGLU,
head_dim=256, vocab 256000, tied embeddings scaled by sqrt(d).

Counterpart of ``repro/configs/gemma_7b.py``: the same config, smoke
config and cells."""
import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "gemma-7b"

CONFIG = TransformerConfig(
    name=ARCH_ID,
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="geglu",
        embed_scale=True,
        tie_embeddings=True,
        dtype=torch.float32,
        attn_chunk=8,
    )


def cells():
    return base.lm_cells(ARCH_ID, CONFIG)
