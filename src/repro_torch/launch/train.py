"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu]``.

Wires together the config, the train step, the synthetic token pipeline
and the fault-tolerant loop, on random weights from a seed.  Runs on CUDA
unless ``--device cpu`` is given, and raises when there is no card;
``--smoke`` takes the reduced config.  ``--compress-grads`` runs the
Seeker coreset-compressed data-parallel step over the process group:
under ``torchrun`` the launcher joins the group its environment describes
(NCCL on CUDA, gloo on the CPU), and a lone process is a world of one,
which runs no collective.  A multi-rank run without ``--compress-grads``
(FSDP/TP) and ``--multi-pod`` need the LM sharding rules and
``launch/mesh.py`` (ROADMAP Queue 1 item 6.4) and raise.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..configs import ARCHS, get_config, get_smoke
from ..core.compression import CompressionConfig
from ..data.lm import LMTask, lm_batches
from ..serving.fleet import resolve_device
from ..train import (TrainHyper, TrainLoopConfig, init_train_state,
                     make_compressed_train_step, make_train_step,
                     run_training)

__all__ = ["main"]

_SHARDED = ("the LM sharding rules and launch/mesh.py (ROADMAP Queue 1 "
            "item 6.4)")


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
    if args.multi_pod:
        raise NotImplementedError(f"--multi-pod needs {_SHARDED}")
    dev = resolve_device(args.device)
    group = _group(dev)
    if group is not None and not args.compress_grads:
        raise NotImplementedError(
            f"a multi-rank run without --compress-grads shards the model "
            f"and needs {_SHARDED}")
    if dev.type == "cuda" and group is not None:
        dev = torch.device("cuda", torch.cuda.current_device())

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    hyper = TrainHyper(peak_lr=args.lr, warmup=max(args.steps // 10, 1),
                       total_steps=args.steps)
    task = LMTask(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    compression = CompressionConfig() if args.compress_grads else None
    g = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(g, cfg, hyper, compression)
    if args.compress_grads:
        step = make_compressed_train_step(cfg, hyper, compression, group)
    else:
        step = make_train_step(cfg, hyper)

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=max(args.steps // 4, 1),
                           log_every=max(args.steps // 20, 1),
                           budget_source=args.budget_source)
    state, log = run_training(state, step,
                              lambda s: lm_batches(task, s, device=dev), loop)
    for m in log:
        print(m)
    return state, log


if __name__ == "__main__":
    main()
