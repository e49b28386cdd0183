"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 —
llama-architecture GQA [arXiv:2403.04652; hf].  Yi uses theta=5e6 for its
4k->200k context extension."""
import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    vocab=64_000,
    d_model=7168,
    n_layers=60,
    n_heads=56,
    n_kv=8,
    d_ff=20480,
    mlp="swiglu",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    head_pad_multiple=16,
    remat="full",
)

SMOKE = ModelConfig(
    name="yi-34b-smoke",
    vocab=512,
    d_model=64,
    n_layers=3,
    n_heads=8,
    n_kv=2,
    d_ff=192,
    mlp="swiglu",
    tie_embeddings=False,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = False  # pure full attention
IS_DECODER = True
