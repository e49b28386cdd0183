"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, 8 experts top-2 [hf:xai-org/grok-1; unverified].

Every layer is MoE (8 experts, top-2, no shared), with attention and
logit softcaps of 30.
"""
import torch

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    vocab=131_072,
    d_model=6144,
    n_layers=64,
    n_heads=48,
    n_kv=8,
    d_ff=32768,
    mlp="geglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768, n_shared=0,
                  capacity_factor=1.25, group_size=512),
    moe_layers=tuple(range(64)),
    rope_theta=10_000.0,
    attn_softcap=30.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    embed_scale=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke",
    vocab=512,
    d_model=64,
    n_layers=2,
    n_heads=8,
    n_kv=2,
    d_ff=256,
    mlp="geglu",
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, capacity_factor=2.0,
                  group_size=64),
    moe_layers=(0, 1),
    attn_softcap=30.0,
    logit_softcap=30.0,
    embed_scale=True,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = False  # pure full attention
IS_DECODER = True
