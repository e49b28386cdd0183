"""Deterministic synthetic LM token pipeline.

PyTorch counterpart of :mod:`repro.data.lm`, with the same structure and
its own draws: a fixed "corpus" of template documents (Zipf-distributed
tokens with strong local bigram structure) is drawn from ``seed``, and a
batch is a pure function of ``(task, step)`` — the restart-safety property
the fault-tolerant trainer relies on: after a restore at step k, batch k+1
is the one the interrupted run would have seen.  Both draws run on the CPU
from ``torch.Generator``s seeded from ``seed`` and from ``(seed + 1,
step)``, so a batch does not depend on the device it is moved to.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["LMTask", "lm_batches"]


@dataclasses.dataclass(frozen=True)
class LMTask:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    n_templates: int = 64
    template_len: int = 256


def _generator(*words: int) -> torch.Generator:
    seed = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _templates(task: LMTask) -> torch.Tensor:
    """(n_templates, template_len) Zipf-ish token sequences with bigram
    structure a small model can learn: every odd position is its left
    neighbour plus one, and 5% of all positions are then replaced by
    uniform noise."""
    g = _generator(task.seed)
    shape = (task.n_templates, task.template_len)
    probs = 1.0 / torch.arange(1, task.vocab + 1, dtype=torch.float64)
    base = torch.multinomial(probs / probs.sum(), shape[0] * shape[1],
                             replacement=True, generator=g).reshape(shape)
    shifted = (base + 1) % task.vocab
    odd = (torch.arange(task.template_len) % 2).bool()
    det = torch.where(odd[None, :], torch.roll(shifted, 1, dims=1), base)
    noise = torch.rand(shape, generator=g) < 0.05
    rand = torch.randint(0, task.vocab, shape, generator=g)
    return torch.where(noise, rand, det)


def lm_batches(task: LMTask, step, device=None) -> dict:
    """Batch for ``step``: {"tokens": (B, S+1) int32} on ``device`` (CUDA
    by default, raising without it) — callers slice inputs and labels.
    Each row is a chain of whole templates drawn uniformly, cut to S+1
    tokens (the reference's offset draw is multiplied by 0 there and is
    left out)."""
    from ..serving.fleet import resolve_device
    dev = resolve_device(device)
    tmpl = _templates(task)
    g = _generator(task.seed + 1, int(step))
    n_chunks = -(-(task.seq_len + 1) // task.template_len)
    idx = torch.randint(0, task.n_templates, (task.batch, n_chunks),
                        generator=g)
    seq = tmpl[idx].reshape(task.batch, -1)[:, :task.seq_len + 1].int()
    if dev.type == "cuda":
        # from pinned memory the copy does not wait for the card's queue
        seq = seq.pin_memory().to(dev, non_blocking=True)
    return {"tokens": seq.to(dev)}
