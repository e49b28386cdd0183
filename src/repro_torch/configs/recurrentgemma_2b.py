"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention at 1:2 ratio [arXiv:2402.19427; hf].

Griffin pattern: (recurrent, recurrent, local-attention) repeating; the two
trailing layers are recurrent (26 = 8x3 + 2).  Local window 2048; fixed-size
RG-LRU state => runs the long_500k cell.
"""
import torch

from ..models.config import ModelConfig


def _pattern(n_layers: int) -> tuple[str, ...]:
    return tuple(
        "local" if (i % 3) == 2 else "rglru"
        for i in range(n_layers))


CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    vocab=256_000,
    d_model=2560,
    n_layers=26,
    n_heads=10,
    n_kv=1,
    head_dim=256,
    d_ff=7680,
    mlp="geglu",
    block_pattern=_pattern(26),
    window=2048,
    rnn_width=2560,
    conv_width=4,
    rope_theta=10_000.0,
    embed_scale=True,
    tie_embeddings=True,
    head_pad_multiple=16,
    remat="full",
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    vocab=512,
    d_model=64,
    n_layers=6,
    n_heads=4,
    n_kv=1,
    head_dim=16,
    d_ff=128,
    mlp="geglu",
    block_pattern=_pattern(6),
    window=8,
    rnn_width=64,
    embed_scale=True,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = True  # fixed-size recurrent state + windowed attention
IS_DECODER = True
