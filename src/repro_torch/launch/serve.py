"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Prefill + batched decode with the serving engine on random weights from a
seed (``--smoke`` for the reduced config; whisper's frames and qwen2-vl's
patches are standard-normal draws, as the reference's stubs);
``--edge-host`` runs the Seeker HAR edge-host pipeline instead (the
paper's system, §4).  Runs on CUDA
unless ``--device cpu`` is given, and raises when there is no card.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, get_config, get_smoke
from ..models import init_params
from ..serving.engine import generate
from ..serving.fleet import resolve_device

__all__ = ["serve", "main"]


def serve(params: dict, cfg, prompt: torch.Tensor, max_new: int, *,
          temperature: float = 0.0, generator: torch.Generator | None = None,
          device=None, cache_margin: int = 0, enc_frames=None,
          patch_embeds=None) -> dict:
    """One ``generate`` call, timed on the host clock (synchronised on
    CUDA): the tokens (B, max_new), the prefill's ms (first token
    included), the ms of each later decode step, and tokens per second
    over the whole call.  ``cache_margin``, ``enc_frames`` and
    ``patch_embeds`` go to ``generate``."""
    dev = resolve_device(device)
    marks = []

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append((name, time.perf_counter()))

    mark("start")
    tokens = generate(params, cfg, prompt, max_new, temperature=temperature,
                      generator=generator, device=dev,
                      cache_margin=cache_margin, enc_frames=enc_frames,
                      patch_embeds=patch_embeds, on_phase=mark)
    (_, t0), (_, t1), (_, t2) = marks
    return dict(tokens=tokens, prefill_ms=(t1 - t0) * 1e3,
                decode_ms_per_step=(t2 - t1) * 1e3 / max(max_new - 1, 1),
                tokens_per_s=tokens.numel() / (t2 - t0))


def _edge_host(dev: torch.device, seed: int) -> None:
    from ..configs.seeker_har import HAR
    from ..core.energy import harvest_trace
    from ..core.recovery import init_generator
    from ..data.sensors import class_signatures, har_stream
    from ..models.har import har_init
    from ..serving import seeker_simulate

    g = torch.Generator(device=dev).manual_seed(seed)
    params = har_init(g, HAR)
    gen = init_generator(g, HAR.window, HAR.channels)
    wins, labels = har_stream(g, 64)
    res = seeker_simulate(
        wins, labels, harvest_trace(g, 64, "rf"),
        signatures=class_signatures(device=dev), qdnn_params=params,
        host_params=params, gen_params=gen, har_cfg=HAR, generator=g,
        device=dev)
    print(f"completed {float(res['completed_frac'])*100:.1f}% | "
          f"acc(completed) {float(res['accuracy_completed'])*100:.1f}% | "
          f"mean payload {float(res['payload_bytes'].float().mean()):.1f} B "
          f"vs raw {float(res['raw_bytes'][0]):.0f} B")


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    ap.add_argument("--edge-host", action="store_true",
                    help="run the Seeker HAR edge-host pipeline instead")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.edge_host:
        _edge_host(dev, args.seed)
        return None

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(g, cfg)
    # the stubbed audio front-end's frames and vision tower's patches
    extra = {}
    if cfg.encoder_layers:
        extra["enc_frames"] = torch.randn(
            (args.batch, cfg.encoder_frames, cfg.d_model), generator=g,
            device=dev).to(cfg.dtype)
    if cfg.vision_patches:
        extra["patch_embeds"] = torch.randn(
            (args.batch, cfg.vision_patches, cfg.d_model), generator=g,
            device=dev).to(cfg.dtype)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=g, device=dev)
    out = serve(params, cfg, prompt, args.max_new,
                temperature=args.temperature, generator=g, device=dev,
                **extra)
    print(f"generated {tuple(out['tokens'].shape)}: prefill "
          f"{out['prefill_ms']:.2f} ms, decode {out['decode_ms_per_step']:.3f}"
          f" ms/step ({out['tokens_per_s']:.1f} tok/s) on {dev}")
    print(out["tokens"][:, :16].cpu())
    return out


if __name__ == "__main__":
    main()
