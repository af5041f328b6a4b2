"""qwen3-4b [hf:Qwen/Qwen3-*]: 36L d2560 32H (GQA kv=8) d_ff=9728,
vocab 151936, per-head qk RMS-norm, head_dim 128.

Counterpart of ``repro/configs/qwen3_4b.py``: the same config, smoke
config and cells."""
import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "qwen3-4b"

CONFIG = TransformerConfig(
    name=ARCH_ID,
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    activation="swiglu",
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="swiglu",
        qk_norm=True,
        tie_embeddings=True,
        dtype=torch.float32,
        attn_chunk=8,
    )


def cells():
    return base.lm_cells(ARCH_ID, CONFIG)
