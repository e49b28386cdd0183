"""whisper-small [audio]: 12L d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865 — encoder-decoder; conv frontend is a STUB per the assignment
(input_specs() supplies precomputed (B, 1500, 768) frame embeddings)
[arXiv:2212.04356; unverified].

Enc-dec (NOT encoder-only): decode shapes run against the decoder with
cached cross-attention K/V.  RoPE disabled (theta=0) — absolute sinusoidal
positions, as in the published model.
"""
import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    vocab=51_865,
    d_model=768,
    n_layers=12,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    mlp="gelu",
    rope_theta=0.0,            # sinusoidal absolute positions instead
    encoder_layers=12,
    encoder_frames=1500,
    tie_embeddings=True,
    head_pad_multiple=16,
    remat="full",
)

SMOKE = ModelConfig(
    name="whisper-small-smoke",
    vocab=512,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    mlp="gelu",
    rope_theta=0.0,
    encoder_layers=2,
    encoder_frames=24,
    tie_embeddings=True,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = False  # full-attention decoder
IS_DECODER = True
