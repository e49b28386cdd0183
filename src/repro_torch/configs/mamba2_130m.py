"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].

d_inner = 2*768 = 1536, headdim 64 => 24 SSD heads, 1 B/C group, conv width
4.  Constant-size state => the cheapest long_500k cell in the fleet.
"""
import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    vocab=50_280,
    d_model=768,
    n_layers=24,
    n_heads=0,
    n_kv=0,
    head_dim=1,
    d_ff=0,
    mlp="none",
    block_pattern=("ssd",) * 24,
    ssm_state=128,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    vocab=512,
    d_model=64,
    n_layers=3,
    n_heads=0,
    n_kv=0,
    head_dim=1,
    d_ff=0,
    mlp="none",
    block_pattern=("ssd",) * 3,
    ssm_state=16,
    ssm_headdim=16,
    ssm_groups=1,
    dtype=torch.float32,
)

LONG_CONTEXT_OK = True  # attention-free constant state
IS_DECODER = True
