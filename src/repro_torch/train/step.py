"""Train-step factories: plain, microbatched, and coreset-compressed
data-parallel.

PyTorch counterpart of :mod:`repro.train.step`:

* :func:`make_train_step` — forward and backward by autograd (with
  microbatch accumulation in float32 over slices of the batch, in the
  reference's order), then AdamW.
* :func:`make_compressed_train_step` — the paper's C1/C2 applied to the
  data-parallel gradient reduction over a process group: parameters and
  optimizer state replicated on every rank, the batch split over the
  ranks, local grads -> top-k importance-sampling coreset + error feedback
  -> all-gather of the compact payload -> decompress and sum.

Losses are computed in float32 with the standard next-token shift.  The
weights are cast to ``cfg.dtype`` once a step inside the autograd graph
(``compute_params``), so gradients land on the float32 masters as the
reference's casts at each use put them there; the embedding table is
gathered in its own dtype and then cast, as in the reference, so that its
gradient accumulates the repeated tokens in float32.  ``train_state_specs``
waits for the LM sharding rules (ROADMAP Queue 1 item 6.4).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.compression import CompressionConfig, coreset_allreduce
from ..models import compute_params, forward, init_params
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw_init, adamw_update
from ..optim.schedule import warmup_cosine
from ..sharding import all_reduce_sum, group_shard
from ..tree import leaves, tree_map, unflatten_like

__all__ = ["TrainHyper", "cross_entropy", "make_loss_fn", "make_train_step",
           "make_compressed_train_step", "init_train_state",
           "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    microbatch: int = 0               # 0 = no accumulation
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE in float32.  logits (B,S,V), labels (B,S)
    integer; with ``mask`` (B,S) the masked mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def make_loss_fn(cfg: ModelConfig):
    """loss_fn(params, batch) -> (loss, {"loss": loss}); batch holds
    "tokens" (B, S+1) and, for the configs that take them, "enc_frames"
    and "patch_embeds".  With vision patches, only the text positions'
    logits are scored."""

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        extra = {k: batch[k] for k in ("enc_frames", "patch_embeds")
                 if k in batch}
        weights = dict(compute_params(params, cfg), embed=params["embed"])
        logits = forward(weights, cfg, inputs, **extra)
        p = cfg.vision_patches
        if p:
            logits = logits[:, p:]                 # text positions only
        loss = cross_entropy(logits, labels)
        return loss, {"loss": loss}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, aux, grads): ``loss_fn(params, batch)`` and the gradient of
    its loss with respect to every leaf of ``params`` (zeros for a leaf
    the loss does not read), as a tree like ``params``."""
    req = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(unflatten_like(params, req), batch)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(req, grads)]
    return loss.detach(), aux, unflatten_like(params, grads)


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     hyper: TrainHyper,
                     compression: CompressionConfig | None = None) -> dict:
    """Random parameters from ``generator`` (on its device), AdamW's zero
    state, and zero error-feedback residuals ``ef`` where the compression
    keeps them."""
    params = init_params(generator, cfg)
    state = {"params": params, "opt": adamw_init(params, hyper.opt)}
    if compression is not None and compression.error_feedback:
        state["ef"] = tree_map(torch.zeros_like, params)
    return state


def _update(state: dict, grads, loss: torch.Tensor, hyper: TrainHyper):
    lr = warmup_cosine(state["opt"]["step"], hyper.peak_lr, hyper.warmup,
                       hyper.total_steps)
    new_params, new_opt, gnorm = adamw_update(state["params"], grads,
                                              state["opt"], hyper.opt, lr)
    return ({"params": new_params, "opt": new_opt},
            {"loss": loss, "grad_norm": gnorm, "lr": lr})


def make_train_step(cfg: ModelConfig, hyper: TrainHyper):
    """train_step(state, batch) -> (state, metrics); metrics are device
    tensors (``loss``, ``grad_norm``, ``lr``).  With ``hyper.microbatch``
    under the batch, the batch is cut into consecutive microbatches whose
    grads and losses are summed in float32 and divided by their count."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        params = state["params"]
        b = batch["tokens"].shape[0]
        mb = hyper.microbatch
        if mb and mb < b:
            if b % mb:
                raise ValueError(f"batch {b} is no multiple of microbatch "
                                 f"{mb}")
            n_micro = b // mb
            grads = tree_map(lambda p: torch.zeros(p.shape, device=p.device),
                             params)
            loss = 0.0
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _aux, g = value_and_grad(loss_fn, params, micro)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = loss / n_micro
        else:
            loss, _aux, grads = value_and_grad(loss_fn, params, batch)
        return _update(state, grads, loss, hyper)

    return train_step


def make_compressed_train_step(cfg: ModelConfig, hyper: TrainHyper,
                               compression: CompressionConfig, group=None):
    """Seeker gradient-coreset data-parallel step over ``group`` (a
    ``torch.distributed`` process group; None runs one rank, with no
    collective).  Every rank passes the same global batch and state; each
    takes its rank's consecutive rows of the batch, reduces its grads by
    :func:`coreset_allreduce` and the loss by a mean all-reduce, and
    applies the same AdamW update, so the ranks' states stay equal.  The
    error-feedback residuals ``ef`` are each rank's own."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        shard = None if group is None else group_shard(group)
        world = 1 if shard is None else shard.quantum
        rank = 0 if shard is None else shard.index
        b = batch["tokens"].shape[0]
        if b % world:
            raise ValueError(f"batch {b} does not split over {world} ranks")
        rows = slice(rank * (b // world), (rank + 1) * (b // world))
        local = {k: v[rows] for k, v in batch.items()}
        loss, _aux, grads = value_and_grad(loss_fn, state["params"], local)
        grads, new_ef = coreset_allreduce(grads, group, compression,
                                          state.get("ef"))
        if world > 1:
            loss = all_reduce_sum(loss, shard) / world
        new_state, metrics = _update(state, grads, loss, hyper)
        if "ef" in state:
            new_state["ef"] = new_ef
        return new_state, metrics

    return train_step
