"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-architecture small [arXiv:2401.02385; hf]."""
import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    vocab=32_000,
    d_model=2048,
    n_layers=22,
    n_heads=32,
    n_kv=4,
    d_ff=5632,
    mlp="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat="full",
)

SMOKE = ModelConfig(
    name="tinyllama-1.1b-smoke",
    vocab=512,
    d_model=64,
    n_layers=3,
    n_heads=8,
    n_kv=2,
    d_ff=160,
    mlp="swiglu",
    tie_embeddings=False,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = False  # pure full attention
IS_DECODER = True
