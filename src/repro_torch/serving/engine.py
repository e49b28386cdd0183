"""LM serving engine: prefill + batched autoregressive decode.

PyTorch counterpart of :mod:`repro.serving.engine`.  ``generate`` runs the
two-phase serving loop: one full-sequence prefill builds the cache, then
one :func:`~repro_torch.models.transformer.decode_step` per new token.
Sampling is greedy or temperature.  The port does not reproduce
``jax.random``: temperature sampling takes its Gumbel noise as a tensor
(``gumbel=``) or draws it from a ``torch.Generator``; ``jax.random.
categorical`` is ``argmax(gumbel + logits)``, so the same noise gives the
same tokens.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.config import ModelConfig
from ..models.transformer import compute_params, decode_step, forward
from .fleet import resolve_device

__all__ = ["greedy_sample", "temperature_sample", "draw_gumbel", "generate"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The first maximum's index over the last axis, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def draw_gumbel(generator: torch.Generator, shape,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1), on
    the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def temperature_sample(logits: torch.Tensor, temperature: float = 0.8, *,
                       gumbel: torch.Tensor | None = None,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
    """A draw from ``softmax(logits / temperature)`` over the last axis, as
    ``argmax(gumbel + logits / temperature)``; ``gumbel`` has the logits'
    shape, or is drawn from ``generator``."""
    scaled = logits / temperature
    if gumbel is None:
        if generator is None:
            raise ValueError("temperature sampling needs gumbel= or "
                             "generator=")
        gumbel = draw_gumbel(generator, scaled.shape)
    return torch.argmax(gumbel.to(scaled.dtype) + scaled,
                        dim=-1).to(torch.int32)


@torch.no_grad()
def generate(params: dict, cfg: ModelConfig, prompt, max_new: int, *,
             temperature: float = 0.0, gumbel: torch.Tensor | None = None,
             generator: torch.Generator | None = None, device=None,
             cache_margin: int = 0, enc_frames=None, patch_embeds=None,
             on_phase: Callable[[str], None] | None = None) -> torch.Tensor:
    """prompt (B, S) token ids -> (B, max_new) generated int32 tokens.

    The parameters are moved to ``device`` (CUDA by default; it raises
    without one) and cast to ``cfg.dtype`` once, here.  ``enc_frames`` (B,
    encoder_frames, D) feed an encoder config, ``patch_embeds`` (B, P, D)
    go before the prompt.  The cache holds ``S + max_new + cache_margin``
    positions, the reference's rule: the patches are not counted, so with
    a margin under P the decode steps overwrite the first of them.  With a
    temperature,
    ``gumbel`` (max_new, B, padded_vocab) holds each step's noise (the
    reference draws step 0 with its key and step t with
    ``jax.random.split(key, max_new - 1)[t - 1]``), or ``generator`` draws
    it.  ``on_phase("prefill")`` is called once the first token is
    sampled, ``on_phase("decode")`` once the last is.
    """
    dev = resolve_device(device)
    params = compute_params(params, cfg, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    if gumbel is not None:
        gumbel = torch.as_tensor(gumbel, device=dev)
        want = (max_new, b, cfg.padded_vocab)
        if tuple(gumbel.shape) != want:
            raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, "
                             f"expected {want}")

    def sample(logits, t):
        if temperature == 0.0:
            return greedy_sample(logits)
        return temperature_sample(
            logits, temperature, generator=generator,
            gumbel=None if gumbel is None else gumbel[t])

    extra = {k: torch.as_tensor(v, device=dev) for k, v in (
        ("enc_frames", enc_frames), ("patch_embeds", patch_embeds))
        if v is not None}
    logits, cache = forward(params, cfg, prompt, return_cache=True,
                            cache_len=s + max_new + cache_margin, **extra)
    # the first generated token comes from the last prefill logit
    tokens = [sample(logits[:, -1], 0)]
    if on_phase is not None:
        on_phase("prefill")
    for t in range(1, max_new):
        lg, cache = decode_step(params, cfg, cache, tokens[-1][:, None])
        tokens.append(sample(lg[:, 0], t))
    if on_phase is not None:
        on_phase("decode")
    return torch.stack(tokens, dim=1)
