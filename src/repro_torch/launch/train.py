"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu]``.

Wires together the config, the mesh, the train step, the synthetic token
pipeline and the fault-tolerant loop, on random weights from a seed.  Runs
on CUDA unless ``--device cpu`` is given, and raises when there is no
card.  Under ``torchrun`` the launcher joins the group its environment
describes (NCCL on CUDA, gloo on the CPU); a lone process is a world of
one.  Every rank draws the same state and batches; a sharded run places
each parameter by ``train_state_specs`` as it is drawn, so a rank holds
one whole leaf at most beside its shards (the largest leaf must fit one
card: grok-1-314b's stacked expert weights do not).

* ``--smoke`` (the reduced config; ``--multi-pod`` is ignored, as in the
  reference): ``--compress-grads`` runs the Seeker coreset-compressed
  data-parallel step over the process group; without it a world of one
  runs the plain step and a larger world the FSDP step on a ("data",)
  mesh of the whole group.
* Without ``--smoke``: a world of one runs the unsharded step; a world of
  256 (512 with ``--multi-pod``) builds the production mesh and runs
  ``FSDP_RULES``, or with ``--compress-grads`` ``DP_TP_RULES`` and the
  compressed step over ("data",) (("pod", "data") with ``--multi-pod``);
  any other world raises ``ValueError``.

``torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke --device
cpu`` runs the FSDP step on four gloo ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os

import torch

from .. import sharding as shd
from ..configs import ARCHS, get_config, get_smoke
from ..core.compression import CompressionConfig
from ..data.lm import LMTask, lm_batches
from ..serving.fleet import resolve_device
from ..train import (TrainHyper, TrainLoopConfig, abstract_train_state,
                     init_train_state, make_compressed_train_step,
                     make_train_step, run_training, train_state_specs)
from .mesh import PRODUCTION_SHAPES, make_mesh_for

__all__ = ["main"]


def _group(dev: torch.device):
    """The process group of a ``torchrun`` launch (joined here from its
    environment), or None for a lone process."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.group.WORLD
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dist.group.WORLD


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true",
                    help="Seeker coreset gradient compression over DP")
    ap.add_argument("--budget-source", default=None,
                    help="EH trace gating steps (rf|wifi|piezo|solar)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    group = _group(dev)
    if dev.type == "cuda" and group is not None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = 1 if group is None else _world_size(group)
    layout = _layout(args, world)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    hyper = TrainHyper(peak_lr=args.lr, warmup=max(args.steps // 10, 1),
                       total_steps=args.steps)
    task = LMTask(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    compression = CompressionConfig() if args.compress_grads else None
    g = torch.Generator(device=dev).manual_seed(args.seed)
    ctx = contextlib.nullcontext()
    if layout is None:
        state = init_train_state(g, cfg, hyper, compression)
        step = (make_compressed_train_step(cfg, hyper, compression, group)
                if args.compress_grads else make_train_step(cfg, hyper))
    else:
        mesh = make_mesh_for(*layout[:2], device_type=dev.type)
        rules = shd.DP_TP_RULES if args.compress_grads else shd.FSDP_RULES
        sh = shd.tree_named_shardings(
            train_state_specs(cfg, compression),
            abstract_train_state(cfg, hyper, compression), mesh, rules)
        state = init_train_state(g, cfg, hyper, compression, sh)
        ctx = shd.use_sharding(mesh, rules)
        step = (make_compressed_train_step(cfg, hyper, compression, mesh,
                                           dp_axes=layout[2])
                if args.compress_grads else make_train_step(cfg, hyper))

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=max(args.steps // 4, 1),
                           log_every=max(args.steps // 20, 1),
                           budget_source=args.budget_source)
    with ctx:
        state, log = run_training(state, step, lambda s: lm_batches(
            task, s, device=dev), loop)
    if group is None or _rank(group) == 0:
        for m in log:
            print(m)
    return state, log


def _rank(group) -> int:
    import torch.distributed as dist
    return dist.get_rank(group)


def _world_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _layout(args, world: int):
    """``(shape, axes, dp_axes)`` of the run's mesh, or None for the
    unsharded (or process-group) step; ``ValueError`` for a world that no
    mesh of the run's fits."""
    if args.smoke:
        if world == 1 or args.compress_grads:
            return None
        return (world,), ("data",), ("data",)
    if world == 1:
        return None
    shape, axes = PRODUCTION_SHAPES[bool(args.multi_pod)]
    if math.prod(shape) != world:
        raise ValueError(
            f"the production mesh {shape} holds {math.prod(shape)} ranks, "
            f"and the process group has {world}; run one rank or "
            f"{math.prod(shape)}")
    return shape, axes, ("pod", "data") if args.multi_pod else ("data",)


if __name__ == "__main__":
    main()
