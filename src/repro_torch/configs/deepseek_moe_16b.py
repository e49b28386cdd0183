"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400, 64 routed experts top-6 + 2 shared, fine-grained
[arXiv:2401.06066; hf].

Faithful details: layer 0 uses a dense FFN (the published model's first
layer is non-MoE; width 8 x d_expert ~= the published 10944); layers 1..27
are MoE with 2 shared experts always-on.
"""
import torch

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    vocab=102_400,
    d_model=2048,
    n_layers=28,
    n_heads=16,
    n_kv=16,
    d_ff=8 * 1408,             # dense layer-0 FFN
    mlp="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  capacity_factor=1.25, group_size=512),
    moe_layers=tuple(range(1, 28)),
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat="full",
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    vocab=512,
    d_model=64,
    n_layers=4,
    n_heads=4,
    n_kv=4,
    d_ff=256,
    mlp="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2,
                  capacity_factor=2.0, group_size=64),
    moe_layers=(1, 2, 3),
    tie_embeddings=False,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = False  # pure full attention
IS_DECODER = True
