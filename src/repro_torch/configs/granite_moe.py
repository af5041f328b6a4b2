"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L d1024 16H (GQA kv=8) vocab 49155; MoE 32 experts top-8, d_ff=512.

Counterpart of ``repro/configs/granite_moe.py``: the same config, smoke
config and cells."""
import torch

from repro_torch.configs import base
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "granite-moe-1b-a400m"

CONFIG = TransformerConfig(
    name=ARCH_ID,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512, num_shared=0),
    rope_theta=10000.0,
)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=512,
        activation="swiglu",
        tie_embeddings=True,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=32, num_shared=0,
                      capacity_factor=4.0),  # dropless at smoke scale
        dtype=torch.float32,
        attn_chunk=8,
    )


def cells():
    return base.lm_cells(ARCH_ID, CONFIG)
