"""The language model's configuration, for all ten architectures.

PyTorch counterpart of :mod:`repro.models.config`, field for field: one
``ModelConfig`` describes a decoder-only LM (optionally with a Whisper style
encoder).  Per-layer heterogeneity (local vs global attention, RG-LRU vs
attention, dense vs MoE FFN) is expressed by ``block_pattern`` /
``moe_layers``; the transformer groups consecutive identical layers into
*runs* (``pattern_runs``) whose parameters are stacked along a leading layer
dimension.  ``dtype`` and ``param_dtype`` are ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["MoEConfig", "ModelConfig", "pattern_runs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0                 # shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    group_size: int = 512             # tokens per dispatch group
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # per-layer mixer type: "attn" | "local" | "rglru" | "ssd"
    block_pattern: tuple[str, ...] = ()
    mlp: str = "swiglu"               # "swiglu" | "geglu" | "gelu" | "none"
    moe: MoEConfig | None = None
    moe_layers: tuple[int, ...] = ()  # layer indices whose FFN is the MoE
    window: int = 1024                # sliding window for "local" layers
    rope_theta: float = 10000.0
    global_rope_theta: float = 0.0    # gemma3: distinct theta on global layers
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (empty = off)
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    embed_scale: bool = False         # gemma family: embeddings * sqrt(d)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # SSM (mamba2 / SSD)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    conv_width: int = 4
    # RG-LRU (recurrentgemma)
    rnn_width: int = 0                # 0 -> d_model
    # encoder (whisper): frames arrive pre-embedded (conv frontend is a stub)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # vision stub (qwen2-vl): patch embeddings are prepended to the sequence
    vision_patches: int = 0
    # numerics
    dtype: Any = torch.bfloat16       # compute/activation dtype
    param_dtype: Any = torch.float32
    # embedding table padded up to a multiple (padded ids are masked to -inf)
    vocab_pad_multiple: int = 256
    # zero-pad q-heads up to this quantum when the head count doesn't divide
    # it (exact math: padded wq/wo rows are zero; KV heads are
    # gather-expanded).  0 disables (smoke/CPU configs).
    head_pad_multiple: int = 0
    # attention execution thresholds
    dense_attn_max_seq: int = 2048
    attn_chunk: int = 512
    # flash-style walks for the chunked paths (exact)
    flash_attention: bool = True
    remat: str = "none"               # "none" | "full"

    def __post_init__(self):
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("attn",) * self.n_layers)
        assert len(self.block_pattern) == self.n_layers, (
            len(self.block_pattern), self.n_layers)
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def padded_heads(self) -> int:
        m = self.head_pad_multiple
        if m and self.n_heads % m:
            return ((self.n_heads + m - 1) // m) * m
        return self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kind(self, idx: int) -> tuple[str, bool]:
        """(mixer_type, is_moe) for layer ``idx``."""
        return self.block_pattern[idx], idx in self.moe_layers

    def param_count(self) -> int:
        """Analytic parameter count."""
        d = self.d_model
        n = self.vocab * d                                   # embedding
        if not self.tie_embeddings:
            n += self.vocab * d
        for i in range(self.n_layers):
            kind, is_moe = self.layer_kind(i)
            if kind in ("attn", "local"):
                n += d * self.n_heads * self.head_dim        # wq
                n += 2 * d * self.n_kv * self.head_dim       # wk, wv
                n += self.n_heads * self.head_dim * d        # wo
            elif kind == "rglru":
                w = self.rnn_width
                n += 2 * d * w + self.conv_width * w + 2 * w * w + 3 * w + w * d
            elif kind == "ssd":
                di, g, ns, h = (self.d_inner, self.ssm_groups, self.ssm_state,
                                self.ssm_heads)
                n += d * (2 * di + 2 * g * ns + h)           # in projections
                n += self.conv_width * (di + 2 * g * ns)     # conv
                n += 3 * h + di                              # A, D, dt_bias, norm
                n += di * d                                  # out_proj
            if self.mlp != "none":
                if is_moe and self.moe is not None:
                    m = self.moe
                    n += d * m.n_experts                      # router
                    n += m.n_experts * 3 * d * m.d_expert     # routed experts
                    n += 3 * d * (m.n_shared * m.d_expert)    # shared experts
                else:
                    mult = 3 if self.mlp in ("swiglu", "geglu") else 2
                    n += mult * d * self.d_ff
            n += 2 * d                                       # pre-norms
        n += d                                               # final norm
        if self.encoder_layers:
            n += self.encoder_layers * (4 * d * d + 3 * d * self.d_ff + 2 * d)
            # decoder cross-attention
            n += self.n_layers * (4 * d * d + d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None or not self.moe_layers:
            return self.param_count()
        m = self.moe
        inactive = len(self.moe_layers) * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return self.param_count() - inactive


def pattern_runs(cfg: ModelConfig) -> list[tuple[str, bool, int, int]]:
    """Group consecutive identical layers: [(mixer, is_moe, start, length)].

    A run's parameters are stacked along a leading layer dimension;
    heterogeneous patterns (gemma3's 5 local : 1 global, recurrentgemma's
    R,R,A) become short run sequences.
    """
    runs: list[tuple[str, bool, int, int]] = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if runs and (runs[-1][0], runs[-1][1]) == kind:
            mixer, moe, start, length = runs[-1]
            runs[-1] = (mixer, moe, start, length + 1)
        else:
            runs.append((kind[0], kind[1], i, 1))
    return runs
