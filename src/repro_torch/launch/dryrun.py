"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on
``meta`` tensors, counted per device.

PyTorch counterpart of :mod:`repro.launch.dryrun`.  The reference lowers
and compiles each cell for 256 or 512 virtual XLA devices and reads the
compiled program.  The port builds the cell's state and inputs on the
``meta`` device (shapes and dtypes, no data), places them on the
production mesh over a fake process group of as many ranks (backend
``"fake"``: every collective returns at once), runs the step once as rank
0 and counts it with :func:`repro_torch.launch.op_analysis.analyze_step`.
Nothing is allocated and no card is touched, so it runs on any host; no
count depends on the device a tensor would sit on.  The world size comes
from the mesh; the module sets up its fake group and tears it down
itself.

Per cell (cached to ``experiments/dryrun_torch/<cell>.json``):
  * ``memory_analysis``: per-device argument, output, temporary (peak live
    less the arguments) and aliased bytes (does the cell fit 80 GB?);
  * ``cost_analysis``: per-device FLOPs and bytes of the op analysis (the
    port has no second, raw count);
  * ``collectives``: bytes and counts by kind (:func:`parse_collectives`);
  * ``op_analysis``: :meth:`OpStats.to_json`;
  * ``timings``: ``build_s`` and ``trace_s``, the seconds the cell's
    placement and its counted step took.

The roofline table is derived from these JSONs by
``python -m repro_torch.launch.roofline``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from .. import sharding as shd
from ..configs import ARCHS, get_config, long_context_ok
from ..models import (abstract_cache, abstract_params, cache_specs,
                      compute_params, decode_step, forward, param_specs)
from ..models.config import ModelConfig
from ..optim import OptConfig
from ..train import (TrainHyper, abstract_train_state,
                     make_compressed_train_step, make_train_step,
                     train_state_specs)
from .mesh import PRODUCTION_SHAPES, make_mesh_for
from .op_analysis import COLLECTIVES, OpStats, analyze_step
from .shapes import SHAPES, ShapeCell

__all__ = ["ARCH_RULES", "ARCH_HYPER", "RESULTS_DIR", "input_specs",
           "build_step", "parse_collectives", "fake_group", "run_cell",
           "cell_path", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

# Per-arch production layouts (the reference's): models too small for
# 16-way tensor parallelism run pure-DP across the whole mesh.
ARCH_RULES = {
    "mamba2-130m": shd.PURE_DP_RULES,
}

# Per-arch step hyper-parameters (the reference's): microbatch counts, and
# bf16 AdamW moments for grok.
ARCH_HYPER = {
    "yi-34b": TrainHyper(microbatch=8),
    "grok-1-314b": TrainHyper(microbatch=8,
                              opt=OptConfig(moment_dtype=torch.bfloat16)),
    "gemma3-12b": TrainHyper(microbatch=16),
    "recurrentgemma-2b": TrainHyper(microbatch=64),
    "whisper-small": TrainHyper(microbatch=64),
    "gemma-2b": TrainHyper(microbatch=64),
    "qwen2-vl-2b": TrainHyper(microbatch=64),
    "deepseek-moe-16b": TrainHyper(microbatch=64),
    "tinyllama-1.1b": TrainHyper(microbatch=64),
}


def parse_collectives(stats: OpStats) -> dict:
    """The reference's collectives table from an :class:`OpStats`: per kind
    ``{"count", "bytes"}`` (output bytes, an all-reduce counted twice) and
    ``total_bytes``."""
    out = {op: {"count": int(stats.collective_counts[op]),
                "bytes": int(stats.collective_bytes[op])}
           for op in COLLECTIVES}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


# ---------------------------------------------------------------------------
# Input specs per (arch, shape)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """``meta`` stand-ins for every model input of the cell, plus their
    logical specs: the reference's keys and shapes, int32 tokens."""
    b, s = cell.global_batch, cell.seq_len

    def t(shape, dtype=None):
        return torch.empty(shape, dtype=dtype or cfg.dtype, device="meta")

    extras, extras_spec = {}, {}
    if cfg.encoder_layers:
        extras["enc_frames"] = t((b, cfg.encoder_frames, cfg.d_model))
        extras_spec["enc_frames"] = ("batch", None, "embed_act")
    if cfg.vision_patches and cell.kind != "decode":
        extras["patch_embeds"] = t((b, cfg.vision_patches, cfg.d_model))
        extras_spec["patch_embeds"] = ("batch", None, "embed_act")
    n_text = s - (cfg.vision_patches if cell.kind != "decode" else 0)
    if cell.kind == "train":
        return {"batch": {"tokens": t((b, n_text + 1), torch.int32),
                          **extras},
                "batch_spec": {"tokens": ("batch", None), **extras_spec}}
    if cell.kind == "prefill":
        return {"tokens": {"tokens": t((b, n_text), torch.int32), **extras},
                "tokens_spec": {"tokens": ("batch", None), **extras_spec}}
    return {"cache": abstract_cache(cfg, b, s),
            "cache_spec": cache_specs(cfg, b, s),
            "tokens": t((b, 1), torch.int32),
            "tokens_spec": ("batch", None)}


def _placed(tree, spec_tree, mesh, rules):
    if mesh is None:
        return tree
    return shd.place(tree, shd.tree_named_shardings(spec_tree, tree, mesh,
                                                    rules))


def build_step(arch: str, shape_name: str, mesh, rules=shd.FSDP_RULES,
               cfg: ModelConfig | None = None,
               hyper: TrainHyper | None = None, compress: bool = False,
               dp_axes: tuple[str, ...] | None = None, compression=None):
    """``(step, args)`` of the cell (a :data:`SHAPES` name or a
    :class:`ShapeCell`): its step function and its inputs on the ``meta``
    device, placed on ``mesh`` by ``rules`` (plain tensors when ``mesh``
    is None, a world of one).  The twin of the reference's
    ``build_lowered``.

    * train: ``make_train_step`` on the placed train state and the global
      batch (the step splits it), or with ``compress`` the coreset-
      compressed DP step over ``dp_axes`` (default: the mesh axes the
      batch shards over) with ``compression`` (default
      ``CompressionConfig()``);
    * prefill: ``forward(..., return_cache=True)`` on the served weights
      (``compute_params``: the one-time cast) and the tokens;
    * decode: ``decode_step`` on the served weights, the cache (written in
      place) and one token a sequence."""
    cfg = cfg or get_config(arch)
    cell = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    hyper = hyper or TrainHyper()
    specs = input_specs(cfg, cell)
    def ctx():
        """The sharding context; plain tensors the model makes (positions,
        masks) join the DTensors replicated, as in the train step."""
        if mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        stack = contextlib.ExitStack()
        stack.enter_context(shd.use_sharding(mesh, rules))
        stack.enter_context(implicit_replication())
        return stack

    if cell.kind == "train":
        from ..core.compression import CompressionConfig
        ccfg = (compression or CompressionConfig()) if compress else None
        state = _placed(abstract_train_state(cfg, hyper, ccfg),
                        train_state_specs(cfg, ccfg), mesh, rules)
        if compress:
            batch_rule = rules.get("batch") or ()
            batch_rule = ((batch_rule,) if isinstance(batch_rule, str)
                          else tuple(batch_rule))
            names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
            dp = dp_axes or tuple(a for a in batch_rule if a in names) or \
                tuple(a for a in ("pod", "data") if a in names)
            inner = make_compressed_train_step(cfg, hyper, ccfg, mesh,
                                               dp_axes=dp or ("data",))
        else:
            inner = make_train_step(cfg, hyper)

        def step(state, batch):
            with ctx():
                return inner(state, batch)

        return step, (state, specs["batch"])

    with ctx():
        params = _placed(abstract_params(cfg), param_specs(cfg), mesh,
                         rules)
        served = compute_params(params, cfg)
    del params
    if cell.kind == "prefill":
        def step(params, batch):
            batch = dict(batch)
            tokens = batch.pop("tokens")
            with ctx():
                return forward(params, cfg, tokens, return_cache=True,
                               cache_len=cell.seq_len, **batch)

        return step, (served, specs["tokens"])

    cache = _placed(specs["cache"], specs["cache_spec"], mesh, rules)
    tokens = specs["tokens"]
    if mesh is not None:
        tokens = shd.place(tokens, shd.named_sharding(
            specs["tokens_spec"], tokens.shape, mesh, rules))

    def step(params, cache, tokens):
        with ctx():
            return decode_step(params, cfg, cache, tokens)

    return step, (served, cache, tokens)


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of ``world`` ranks that moves nothing (backend
    ``"fake"``, this process as rank 0), destroyed on exit.  Nothing may
    hold a default group already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is initialized already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _trace(arch, shape_name, mesh, rules, cfg, hyper, compress, dp_axes):
    """Build the cell on ``meta`` tensors and count one step: ``(stats,
    build seconds, trace seconds)``."""
    t0 = time.perf_counter()
    step, args = build_step(arch, shape_name, mesh, rules=rules, cfg=cfg,
                            hyper=hyper, compress=compress, dp_axes=dp_axes)
    t1 = time.perf_counter()
    stats = analyze_step(step, *args)
    return stats, t1 - t0, time.perf_counter() - t1


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules=shd.FSDP_RULES, tag: str = "", compress: bool = False,
             cfg: ModelConfig | None = None,
             hyper: TrainHyper | None = None,
             dp_axes: tuple[str, ...] | None = None) -> dict:
    """One cell's result dict (the reference's keys; ``op_analysis`` for
    its ``hlo_analysis``)."""
    cell = SHAPES[shape_name]
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    mesh_name = "multi" if multi_pod else "single"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "tag": tag, "status": "ok"}
    cfg = cfg or get_config(arch)
    if rules is shd.FSDP_RULES:
        rules = ARCH_RULES.get(arch, rules)
    if hyper is None and cell.kind == "train":
        hyper = ARCH_HYPER.get(arch)
    if shape_name == "long_500k" and not long_context_ok(arch):
        result["status"] = "skipped"
        result["reason"] = ("pure full-attention arch: long_500k skipped "
                            "(configs.long_context_ok)")
        return result
    world = math.prod(shape)
    try:
        with fake_group(world):
            # the fake group's mesh: no device is touched
            mesh = make_mesh_for(shape, axes, "cpu")
            stats, t_build, t_trace = _trace(arch, shape_name, mesh, rules,
                                             cfg, hyper, compress, dp_axes)
        result["cost_analysis"] = {"flops": stats.flops,
                                   "bytes_accessed": stats.hbm_bytes,
                                   "transcendentals": 0.0}
        result["memory_analysis"] = dict(stats.memory)
        result["collectives"] = parse_collectives(stats)
        result["op_analysis"] = stats.to_json()
        result["timings"] = {"build_s": round(t_build, 2),
                             "trace_s": round(t_trace, 2)}
        result["n_devices"] = world
        result["params"] = cfg.param_count()
        result["active_params"] = cfg.active_param_count()
        result["cell"] = dataclasses.asdict(cell)
    except Exception as e:
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    return result


def cell_path(arch: str, shape_name: str, mesh_name: str, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="fsdp", choices=["fsdp", "dp_tp"])
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--compress", action="store_true",
                    help="Seeker coreset gradient compression (train cells)")
    args = ap.parse_args(argv)

    os.makedirs(RESULTS_DIR, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    rules = {"fsdp": shd.FSDP_RULES, "dp_tp": shd.DP_TP_RULES}[args.rules]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                path = cell_path(arch, shape, mesh_name, args.tag)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached] {arch} {shape} {mesh_name}: "
                              f"{prev['status']}")
                        continue
                print(f"[run]    {arch} {shape} {mesh_name} ...", flush=True)
                res = run_cell(arch, shape, multi, rules=rules, tag=args.tag,
                               compress=args.compress)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] == "ok":
                    n_ok += 1
                    ma = res["memory_analysis"]
                    print(f"  ok: flops/dev={res['cost_analysis']['flops']:.3e}"
                          f" args/dev={ma['argument_bytes'] / 1e9:.3f}GB"
                          f" temp/dev={ma['temp_bytes'] / 1e9:.3f}GB"
                          f" coll/dev={res['collectives']['total_bytes'] / 1e9:.4f}GB"
                          f" trace={res['timings']['trace_s']}s", flush=True)
                elif res["status"] == "skipped":
                    n_skip += 1
                    print(f"  skipped: {res['reason']}")
                else:
                    n_err += 1
                    print(f"  ERROR: {res['error']}")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
