"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
— M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only per the assignment: the vision tower is a STUB; input_specs()
supplies precomputed patch embeddings (B, 64, 1536) that are prepended to
the text tokens.  M-RoPE sections (16, 24, 24) over the 64-dim half of the
128 head_dim; vision patches get (t=0, h, w) grid ids, text continues
sequentially.
"""
import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    vocab=151_936,
    d_model=1536,
    n_layers=28,
    n_heads=12,
    n_kv=2,
    head_dim=128,
    d_ff=8960,
    mlp="swiglu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    vision_patches=64,
    tie_embeddings=True,
    head_pad_multiple=16,
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    vocab=512,
    d_model=64,
    n_layers=3,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    mlp="swiglu",
    mrope_sections=(4, 2, 2),
    vision_patches=4,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = False  # pure full attention
IS_DECODER = True
