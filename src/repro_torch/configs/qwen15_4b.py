"""qwen1.5-4b [hf:Qwen/Qwen1.5-*]: 40L d2560 20H (kv=20) d_ff=6912,
vocab 151936, QKV bias, head_dim 128.

Counterpart of ``repro/configs/qwen15_4b.py``: the same config, smoke
config and cells."""
import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "qwen1.5-4b"

CONFIG = TransformerConfig(
    name=ARCH_ID,
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=5e6,
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
        activation="swiglu",
        qkv_bias=True,
        tie_embeddings=False,
        dtype=torch.float32,
        attn_chunk=8,
    )


def cells():
    return base.lm_cells(ARCH_ID, CONFIG)
