"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256 [arXiv:2403.08295; hf].

MQA (kv=1); the 8 q-heads are zero-padded to 16 (``head_pad_multiple``).
"""
import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    vocab=256_000,
    d_model=2048,
    n_layers=18,
    n_heads=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    mlp="geglu",
    rope_theta=10_000.0,
    embed_scale=True,
    tie_embeddings=True,
    head_pad_multiple=16,
    remat="full",
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke",
    vocab=512,
    d_model=64,
    n_layers=3,
    n_heads=4,
    n_kv=1,
    head_dim=16,
    d_ff=128,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = False  # pure full attention: long_500k skipped
IS_DECODER = True
