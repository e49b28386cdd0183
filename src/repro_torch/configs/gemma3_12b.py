"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global interleave, 128k context
[hf:google/gemma-3-1b-pt family; unverified].

Pattern: every 6th layer is global attention (theta=1M), the rest are
1024-window sliding-window layers (theta=10k).  Local runs get window-sized
ring caches, which is what makes the long_500k decode cell feasible:
40 local layers hold 1024-token KV, only 8 global layers hold the full 500k.
"""
import torch

from ..models.config import ModelConfig


def _pattern(n_layers: int, ratio: int = 5) -> tuple[str, ...]:
    return tuple(
        "attn" if (i % (ratio + 1)) == ratio else "local"
        for i in range(n_layers))


CONFIG = ModelConfig(
    name="gemma3-12b",
    vocab=262_144,
    d_model=3840,
    n_layers=48,
    n_heads=16,
    n_kv=8,
    head_dim=240,
    d_ff=15360,
    mlp="geglu",
    block_pattern=_pattern(48),
    window=1024,
    rope_theta=10_000.0,
    global_rope_theta=1_000_000.0,
    embed_scale=True,
    tie_embeddings=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke",
    vocab=512,
    d_model=64,
    n_layers=6,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    mlp="geglu",
    block_pattern=_pattern(6),
    window=8,
    rope_theta=10_000.0,
    global_rope_theta=1_000_000.0,
    embed_scale=True,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = True  # local-dominant (5:1): sub-quadratic in practice
IS_DECODER = True
