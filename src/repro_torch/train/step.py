"""Train-step factories: plain or sharded SPMD, microbatched, and
coreset-compressed data-parallel.

PyTorch counterpart of :mod:`repro.train.step`:

* :func:`make_train_step` — forward and backward by autograd (with
  microbatch accumulation in float32 over slices of the batch, in the
  reference's order), then AdamW.  On a state placed on a
  ``DeviceMesh`` (:func:`repro_torch.sharding.place` by
  :func:`train_state_specs`) it is the reference's SPMD step: it runs
  under ``use_sharding(mesh, rules)`` (FSDP by default), the batch split
  over the ``"batch"`` axes, DTensor's propagation inserting the
  collectives the placements need.
* :func:`make_compressed_train_step` — the paper's C1/C2 applied to the
  data-parallel gradient reduction: the batch split over the data axes,
  local grads -> top-k importance-sampling coreset + error feedback ->
  all-gather of the compact payload -> decompress and sum.  Over a
  ``DeviceMesh`` the remaining axes carry tensor parallelism (DP+TP);
  over a process group every rank holds the whole state.

Losses are computed in float32 with the standard next-token shift.  The
weights are cast to ``cfg.dtype`` once a step inside the autograd graph
(``compute_params``), so gradients land on the float32 masters as the
reference's casts at each use put them there; the embedding table is
gathered in its own dtype and then cast, as in the reference, so that its
gradient accumulates the repeated tokens in float32.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.compression import CompressionConfig, coreset_allreduce
from ..models import (abstract_params, compute_params, forward, init_params,
                      param_specs)
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw_init, adamw_update, opt_state_specs
from ..optim.schedule import warmup_cosine
from ..sharding import (DP_TP_RULES, all_reduce_sum, current_context,
                        group_shard, is_dtensor, named_sharding, place,
                        strip_rules, take_last, use_sharding)
from ..tree import leaves, tree_map, unflatten_like

__all__ = ["TrainHyper", "cross_entropy", "make_loss_fn", "make_train_step",
           "make_compressed_train_step", "init_train_state",
           "abstract_train_state", "train_state_specs", "value_and_grad"]


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
    lse = (_split_logsumexp(logits) if _vocab_split(logits)
           else torch.logsumexp(logits, dim=-1))
    ll = take_last(logits, labels)
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _vocab_split(x) -> bool:
    """Is ``x`` a DTensor with its last dim split?"""
    return is_dtensor(x) and any(p.is_shard(x.ndim - 1)
                                 for p in x.placements)


class _LSE(torch.autograd.Function):
    """The logsumexp of a row split over ``groups``: the local max and sum
    of exponentials meet in all-reduces; the gradient, the softmax, is
    local."""

    @staticmethod
    def forward(ctx, x, groups):
        from torch.distributed import _functional_collectives as funcol
        top = torch.amax(x, dim=-1, keepdim=True)
        for g in groups:
            top = funcol.all_reduce(top, "max", g)
        total = torch.sum(torch.exp(x - top), dim=-1, keepdim=True)
        for g in groups:
            total = funcol.all_reduce(total, "sum", g)
        lse = torch.log(total) + top
        ctx.save_for_backward(x, lse)
        return lse[..., 0]

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad[..., None] * torch.exp(x - lse), None


def _split_logsumexp(x):
    """``logsumexp(x, -1)`` of a DTensor whose last dim is split, each
    rank on its own slice (DTensor alone may gather the batch instead)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, last = x.device_mesh, x.ndim - 1
    groups = [(mesh, j) for j, p in enumerate(x.placements)
              if p.is_shard(last)]
    xp = list(x.placements)
    op = [Replicate() if p.is_shard(last) else p for p in xp]
    return local_map(lambda xl: _LSE.apply(xl, groups), out_placements=op,
                     in_placements=(xp,), redistribute_inputs=True,
                     device_mesh=mesh)(x)


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


def _replicated(x):
    """A DTensor redistributed to be whole on every rank (its Partial sums
    reduced); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _plain(x):
    """A metric as a plain tensor (a DTensor's whole value)."""
    return x.full_tensor() if is_dtensor(x) else x


def _as_placed(g, p):
    """A gradient on its parameter's placements (a DTensor's Partial sums
    reduced and scattered where the parameter is split)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(loss_fn, params, batch):
    """(loss, aux, grads): ``loss_fn(params, batch)`` and the gradient of
    its loss with respect to every leaf of ``params`` (zeros for a leaf
    the loss does not read), as a tree like ``params``.  DTensor leaves
    get their gradients on their own placements."""
    req = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(unflatten_like(params, req), batch)
        loss = _replicated(loss)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _as_placed(g, p)
             for p, g in zip(req, grads)]
    return loss.detach(), aux, unflatten_like(params, grads)


def _train_state(params, hyper: TrainHyper,
                 compression: CompressionConfig | None) -> dict:
    state = {"params": params, "opt": adamw_init(params, hyper.opt)}
    if compression is not None and compression.error_feedback:
        state["ef"] = tree_map(torch.zeros_like, params)
    return state


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     hyper: TrainHyper,
                     compression: CompressionConfig | None = None,
                     shardings=None) -> dict:
    """Random parameters from ``generator`` (on its device), AdamW's zero
    state, and zero error-feedback residuals ``ef`` where the compression
    keeps them.  With ``shardings``, a tree of ``NamedSharding`` like the
    state (``tree_named_shardings`` of :func:`train_state_specs` over
    :func:`abstract_train_state`), every leaf is a DTensor on its
    placements, and each parameter is placed as soon as it is drawn: a
    rank holds one whole leaf at most beside its shards.  The values are
    those of the unplaced draw."""
    params = init_params(generator, cfg,
                         None if shardings is None else shardings["params"])
    state = _train_state(params, hyper, compression)
    return state if shardings is None else place(state, shardings)


def abstract_train_state(cfg: ModelConfig, hyper: TrainHyper,
                         compression: CompressionConfig | None = None
                         ) -> dict:
    """The train state as tensors on the ``meta`` device (the reference's
    ``eval_shape`` of :func:`init_train_state`)."""
    return _train_state(abstract_params(cfg), hyper, compression)


def train_state_specs(cfg: ModelConfig,
                      compression: CompressionConfig | None = None) -> dict:
    """The train state's logical specs: the parameters', the optimizer
    state's (:func:`opt_state_specs`) and, under error feedback, the
    residuals' (the parameters' again)."""
    ps = param_specs(cfg)
    specs = {"params": ps, "opt": opt_state_specs(ps)}
    if compression is not None and compression.error_feedback:
        specs["ef"] = param_specs(cfg)
    return specs


def _update(state: dict, grads, loss: torch.Tensor, hyper: TrainHyper):
    lr = warmup_cosine(state["opt"]["step"], hyper.peak_lr, hyper.warmup,
                       hyper.total_steps)
    new_params, new_opt, gnorm = adamw_update(state["params"], grads,
                                              state["opt"], hyper.opt, lr)
    return ({"params": new_params, "opt": new_opt},
            {"loss": _plain(loss), "grad_norm": _plain(gnorm),
             "lr": _plain(lr)})


# the logical specs of a batch's leaves
_BATCH_SPECS = {"tokens": ("batch", "seq"),
                "enc_frames": ("batch", None, "embed_act"),
                "patch_embeds": ("batch", None, "embed_act")}


def _place_batch(batch: dict, mesh, rules) -> dict:
    """Every rank's copy of the global batch split over the ``"batch"``
    axes (each rank keeps its rows, with no collective)."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            out[k] = v
            continue
        sh = named_sharding(_BATCH_SPECS[k], v.shape, mesh, rules)
        out[k] = distribute_tensor(v, mesh, sh.placements, src_data_rank=None)
    return out


def _sharding(params):
    """The context a step runs under: the caller's ``use_sharding`` context
    for a placed state, None for a plain state.  A placed state outside a
    context raises: nothing falls back to a replicated run."""
    if not any(is_dtensor(p) for p in leaves(params)):
        return None
    ctx = current_context()
    if ctx is None:
        raise ValueError("a placed state runs under "
                         "sharding.use_sharding(mesh, rules)")
    return ctx


def _grads(loss_fn, params, batch, microbatch: int, place=None):
    """(loss, grads) of the batch, with microbatch accumulation in float32
    over consecutive slices of the batch, each placed by ``place``."""
    place = place or (lambda x: x)
    b = batch["tokens"].shape[0]
    if not (microbatch and microbatch < b):
        loss, _aux, grads = value_and_grad(loss_fn, params, place(batch))
        return loss, grads
    if b % microbatch:
        raise ValueError(f"batch {b} is no multiple of microbatch "
                         f"{microbatch}")
    n_micro = b // microbatch
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    loss = 0.0
    for i in range(n_micro):
        rows = slice(i * microbatch, (i + 1) * microbatch)
        micro = {k: v[rows] for k, v in batch.items()}
        l, _aux, g = value_and_grad(loss_fn, params, place(micro))
        grads = tree_map(torch.add, grads, g)
        loss = loss + l
    return loss / n_micro, tree_map(lambda g: g / n_micro, grads)


def make_train_step(cfg: ModelConfig, hyper: TrainHyper):
    """train_step(state, batch) -> (state, metrics); metrics are device
    tensors (``loss``, ``grad_norm``, ``lr``).  With ``hyper.microbatch``
    under the batch, the batch is cut into consecutive microbatches whose
    grads and losses are summed in float32 and divided by their count.

    A state placed on a ``DeviceMesh`` runs sharded, under the caller's
    ``use_sharding(mesh, rules)`` context (the reference's SPMD step).
    Every rank passes the same global batch, which the step splits over
    the ``"batch"`` axes."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        params = state["params"]
        ctx = _sharding(params)
        if ctx is None:
            loss, grads = _grads(loss_fn, params, batch, hyper.microbatch)
            return _update(state, grads, loss, hyper)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            loss, grads = _grads(
                loss_fn, params, batch, hyper.microbatch,
                lambda b: _place_batch(b, ctx.mesh, ctx.rules))
            return _update(state, grads, loss, hyper)

    return train_step


def _split_mesh(mesh, dp_axes: tuple[str, ...]):
    """``(dp_group, tp_mesh, local_view)`` of a ``DeviceMesh``: the process
    group of the calling rank's data-parallel replicas (the mesh dims
    ``dp_axes``, flattened when there are several), the submesh of the
    remaining (tensor-parallel) axes or None, and the map of a placed
    state leaf to its view on that submesh (its local shard; whole when
    there is no such axis)."""
    from torch.distributed.tensor import DTensor

    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in dp_axes if a not in names]
    if missing or not dp_axes:
        raise ValueError(f"dp_axes {dp_axes} are not all dims of the mesh "
                         f"{names}")
    sub = mesh[dp_axes]
    dp_group = (sub._flatten() if len(dp_axes) > 1 else sub).get_group()
    tp_axes = tuple(a for a in names if a not in dp_axes)
    tp_mesh = mesh[tp_axes] if tp_axes else None
    tp_dims = [names.index(a) for a in tp_axes]

    def local_view(x):
        if not is_dtensor(x):
            raise ValueError("the DP+TP step takes a state placed on its "
                             "mesh (sharding.place with train_state_specs)")
        if tp_mesh is None:
            return x.to_local()
        return DTensor.from_local(x.to_local(), tp_mesh,
                                  [x.placements[j] for j in tp_dims],
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    return dp_group, tp_mesh, local_view


def _placed_like(full, like):
    """A whole tensor on the placements of ``like`` (as it is when ``like``
    is a plain tensor)."""
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, like.device_mesh, like.placements,
                             src_data_rank=None)


def make_compressed_train_step(cfg: ModelConfig, hyper: TrainHyper,
                               compression: CompressionConfig, mesh=None,
                               dp_axes: tuple[str, ...] = ("data",)):
    """Seeker gradient-coreset data-parallel step.

    Over a ``DeviceMesh`` (the reference's signature): DP over
    ``dp_axes`` with the coreset all-reduce, TP over the remaining axes,
    on a state placed by :func:`train_state_specs` under ``DP_TP_RULES``
    (or the rules of the caller's :func:`use_sharding` context), stripped
    of ``dp_axes`` inside the step.  Over a ``torch.distributed`` process
    group (None runs one rank, with no collective) every rank holds the
    whole state, as on a ("data",) mesh.

    Every rank passes the same global batch and state; each takes the
    consecutive rows of its data-parallel index, makes each gradient leaf
    whole over the tensor-parallel axes, reduces the grads by
    :func:`coreset_allreduce` and the loss by a mean all-reduce over the
    data-parallel group, and applies the same AdamW update, so the
    replicas' states stay equal.  The error-feedback residuals ``ef`` are
    each replica's own."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication

    loss_fn = make_loss_fn(cfg)
    dp_axes = tuple(dp_axes)
    if isinstance(mesh, DeviceMesh):
        dp_group, tp_mesh, local_view = _split_mesh(mesh, dp_axes)
    else:
        dp_group, tp_mesh, local_view = mesh, None, (lambda x: x)

    def train_step(state, batch):
        shard = None if dp_group is None else group_shard(dp_group)
        n_dp = 1 if shard is None else shard.quantum
        dp_index = 0 if shard is None else shard.index
        b = batch["tokens"].shape[0]
        if b % n_dp:
            raise ValueError(f"batch {b} does not split over {n_dp} "
                             f"data-parallel ranks")
        rows = slice(dp_index * (b // n_dp), (dp_index + 1) * (b // n_dp))
        local = {k: v[rows] for k, v in batch.items()}
        params = tree_map(local_view, state["params"])
        with implicit_replication():
            if tp_mesh is not None:
                ctx = current_context()
                rules = strip_rules(ctx.rules if ctx else DP_TP_RULES,
                                    dp_axes)
                with use_sharding(tp_mesh, rules):
                    loss, _aux, grads = value_and_grad(
                        loss_fn, params, _place_batch(local, tp_mesh, rules))
            else:
                loss, _aux, grads = value_and_grad(loss_fn, params, local)
            ef = (tree_map(lambda e: _plain(local_view(e)), state["ef"])
                  if "ef" in state else None)
            grads, new_ef = coreset_allreduce(tree_map(_plain, grads),
                                              dp_group, compression, ef)
            loss = _plain(loss)
            if n_dp > 1:
                loss = all_reduce_sum(loss, shard) / n_dp
            grads = tree_map(_placed_like, grads, state["params"])
            new_state, metrics = _update(state, grads, loss, hyper)
            if "ef" in state:
                new_state["ef"] = tree_map(_placed_like, new_ef, state["ef"])
        return new_state, metrics

    return train_step
