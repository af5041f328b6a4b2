"""deepseek-v2-lite-16b [arXiv:2405.04434]: 27L d2048 16H, MLA
(kv_lora=512, nope=128, rope=64, v=128), vocab 102400; MoE: 64 routed
top-6 + 2 shared experts, d_ff=1408 per expert; layer 0 is dense
(d_ff=10944).

Counterpart of ``repro/configs/deepseek_v2_lite.py``: the same config (64
routed experts and 2 shared, as V2-Lite publishes them), smoke config and
cells."""
import torch

from repro_torch.configs import base
from repro_torch.models.attention import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "deepseek-v2-lite-16b"

CONFIG = TransformerConfig(
    name=ARCH_ID,
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    activation="swiglu",
    tie_embeddings=False,
    mla=MLAConfig(
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128
    ),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, num_shared=2),
    first_dense_layers=1,
    first_dense_ff=10944,
    rope_theta=10000.0,
)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=512,
        activation="swiglu",
        tie_embeddings=False,
        mla=MLAConfig(
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16
        ),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32, num_shared=2,
                      capacity_factor=4.0),  # dropless at smoke scale
        first_dense_layers=1,
        first_dense_ff=128,
        dtype=torch.float32,
        attn_chunk=8,
    )


def cells():
    return base.lm_cells(ARCH_ID, CONFIG)
