"""Run-structured LM covering all ten configs of the reference.

PyTorch counterpart of :mod:`repro.models.transformer`: layers of
``"attn"`` (global) and ``"local"`` (sliding-window) attention, ``"rglru"``
(Griffin's recurrent block) and ``"ssd"`` (Mamba-2), with a dense or MoE
FFN; whisper-small's encoder, cross-attention and sinusoidal positions;
qwen2-vl-2b's M-RoPE over vision patches put before the text.  Layers are
grouped into *runs* of consecutive identical (mixer, MoE) kinds
(``pattern_runs``); each run's parameters are stacked with a leading layer
dimension, in the reference's tree (``embed``, ``unembed``,
``final_norm``, ``runs[i]`` with ``norm1``, the mixer's leaves, ``xnorm``
and ``xw*`` for cross-attention, ``norm2`` and ``mlp_*`` or the MoE
leaves; ``encoder`` with its own ``runs`` and ``final_norm``), and a run
is a Python loop over that dimension.  ``forward`` is differentiable:
with ``cfg.remat == "full"`` each layer runs under
``torch.utils.checkpoint`` while gradients are on, as the reference
checkpoints its scanned layer body.

* :func:`forward`     — full sequence; ``return_cache=True`` also builds the
  serving cache (prefill).
* :func:`decode_step` — one token against the cache.
* :func:`init_params` / :func:`abstract_params` / :func:`param_specs` /
  :func:`model_param_shapes` — the one source of shapes and logical
  sharding specs, and :func:`init_cache` / :func:`abstract_cache` /
  :func:`cache_specs` for the decode cache.

Under a :func:`repro_torch.sharding.use_sharding` context with DTensor
parameters, the activations are redistributed at the reference's
``constrain`` points; outside one those calls do nothing.

Whisper's encoder and qwen2-vl's vision tower are stubs in the reference:
``forward`` takes their precomputed embeddings, ``enc_frames`` (B,
encoder_frames, D) and ``patch_embeds`` (B, P, D).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, pattern_runs
from .flash import flash_banded_attention, flash_causal_attention
from .layers import (NEG_INF, _pv, _scores, apply_rope, banded_attention,
                     decode_attention, dense_attention, geglu, mrope_sincos,
                     pair_chunked_attention, rms_norm, rope_sincos,
                     sinusoidal_at, sinusoidal_positions, swiglu)
from .moe import moe_apply, moe_param_shapes
from .rglru import (rglru_apply, rglru_decode_step, rglru_param_shapes,
                    rglru_state_shapes)
from .ssd import ssd_apply, ssd_decode_step, ssd_param_shapes, ssd_state_shapes
from ..sharding import constrain, is_dtensor, named_sharding, place

__all__ = ["PSpec", "model_param_shapes", "init_params", "abstract_params",
           "param_specs", "compute_params", "forward", "decode_step",
           "init_cache", "abstract_cache", "cache_specs",
           "build_mrope_positions"]


class PSpec(NamedTuple):
    """Declarative parameter leaf: shape + logical axes + init rule (a
    stacked leaf's first logical axis is ``"layers"``, the run's layer
    index)."""
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"

    @property
    def stacked(self) -> bool:
        return bool(self.logical) and self.logical[0] == "layers"


def _act(cfg: ModelConfig):
    return {"swiglu": swiglu, "geglu": geglu}.get(cfg.mlp, geglu)


# ---------------------------------------------------------------------------
# Parameter shape declarations
# ---------------------------------------------------------------------------

def _mlp_shapes(cfg: ModelConfig, is_moe: bool) -> dict[str, PSpec]:
    d = cfg.d_model
    if is_moe and cfg.moe is not None:
        return {k: PSpec(*v) for k, v in moe_param_shapes(d, cfg.moe).items()}
    sh = {}
    if cfg.mlp in ("swiglu", "geglu"):
        sh["mlp_gate"] = PSpec((d, cfg.d_ff), ("embed", "ff"))
    sh["mlp_up"] = PSpec((d, cfg.d_ff), ("embed", "ff"))
    sh["mlp_down"] = PSpec((cfg.d_ff, d), ("ff", "embed"))
    return sh


# the init rules of the recurrent mixers' leaves that are not weights
_INIT = {"lam": "rglru_lam", "A_log": "ssm_A", "dt_bias": "ssm_dt",
         "D": "ones", "norm_scale": "zeros"}


def _attn_shapes(cfg: ModelConfig) -> dict[str, PSpec]:
    d, dh = cfg.d_model, cfg.head_dim
    return {
        "wq": PSpec((d, cfg.n_heads, dh), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, cfg.n_kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, cfg.n_kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((cfg.n_heads, dh, d), ("heads", "head_dim", "embed")),
    }


def _block_shapes(cfg: ModelConfig, kind: str, is_moe: bool,
                  cross: bool = False) -> dict[str, PSpec]:
    d = cfg.d_model
    sh = {"norm1": PSpec((d,), (None,), "zeros")}
    if kind in ("attn", "local"):
        sh.update(_attn_shapes(cfg))
    else:
        shapes = (rglru_param_shapes(cfg) if kind == "rglru"
                  else ssd_param_shapes(cfg))
        sh.update({k: PSpec(*v, _INIT.get(k, "normal"))
                   for k, v in shapes.items()})
    if cross:
        sh["xnorm"] = PSpec((d,), (None,), "zeros")
        sh.update({f"x{k}": v for k, v in _attn_shapes(cfg).items()})
    if cfg.mlp != "none" and kind != "ssd":
        sh["norm2"] = PSpec((d,), (None,), "zeros")
        sh.update(_mlp_shapes(cfg, is_moe))
    return sh


def _stack(sh: dict[str, PSpec], n: int) -> dict[str, PSpec]:
    return {k: PSpec((n,) + v.shape, ("layers",) + v.logical, v.init)
            for k, v in sh.items()}


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: ``cfg``'s widths (and head padding), full
    multi-head attention, a gelu MLP, no MoE."""
    return dataclasses.replace(
        cfg, n_layers=cfg.encoder_layers, mlp="gelu", moe_layers=(),
        block_pattern=("attn",) * cfg.encoder_layers, n_kv=cfg.n_heads)


def model_param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter tree of ``cfg`` as :class:`PSpec` leaves, in the
    reference's order (that of its ``init_params``): with an encoder,
    every decoder layer also holds cross-attention leaves, and
    ``encoder`` holds one stacked run and its ``final_norm``."""
    d = cfg.d_model
    tree: dict[str, Any] = {
        "embed": PSpec((cfg.padded_vocab, d), ("vocab", "embed")),
        "final_norm": PSpec((d,), (None,), "zeros"),
        "runs": [],
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = PSpec((d, cfg.padded_vocab), ("embed", "vocab"))
    cross = cfg.encoder_layers > 0
    for kind, is_moe, _start, length in pattern_runs(cfg):
        tree["runs"].append(_stack(_block_shapes(cfg, kind, is_moe, cross),
                                   length))
    if cfg.encoder_layers:
        enc = _block_shapes(_encoder_cfg(cfg), "attn", False)
        tree["encoder"] = {"runs": [_stack(enc, cfg.encoder_layers)],
                           "final_norm": PSpec((d,), (None,), "zeros")}
    return tree


def _map_tree(tree, fn, name: str = "", other=None):
    """``fn(name, leaf)`` over a tree of dicts and lists, in its dicts'
    order, ``name`` being the leaf's dict key; with ``other``, a tree like
    ``tree``, ``fn(name, leaf, other's leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, k, None if other is None else other[k])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn, name, None if other is None else other[i])
                for i, v in enumerate(tree)]
    return fn(name, tree) if other is None else fn(name, tree, other)


def _draw(generator: torch.Generator, init: str, shape: tuple,
          fan_in: int, dt: torch.dtype) -> torch.Tensor:
    """One leaf (or one layer of a stacked leaf) by its init rule, drawn in
    float32 and cast to ``dt`` (``ssm_A`` is drawn in ``dt``, as in the
    reference)."""
    dev = generator.device

    def uniform(lo, hi, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev).uniform_(
            lo, hi, generator=generator)

    if init == "ssm_A":
        return torch.log(uniform(1.0, 16.0, dt))
    if init == "ssm_dt":
        u = uniform(1e-3, 1e-1)
        return (u + torch.log(-torch.expm1(-u))).to(dt)  # softplus^-1
    if init == "rglru_lam":
        # exp(-8 softplus(lam)) = a = u^2, u uniform in (0.9, 0.999)
        a = uniform(0.9, 0.999) ** 2
        return torch.log(torch.expm1(-torch.log(a) / 8.0)).to(dt)
    return (torch.randn(shape, generator=generator, device=dev)
            / math.sqrt(max(fan_in, 1.0))).to(dt)


def _init_leaf(generator: torch.Generator, p: PSpec,
               cfg: ModelConfig) -> torch.Tensor:
    dev, dt = generator.device, cfg.param_dtype
    if p.init in ("zeros", "ones"):
        fill = torch.zeros if p.init == "zeros" else torch.ones
        return fill(p.shape, dtype=dt, device=dev)
    # fan-in: product of all-but-last dims, the stacked layer dim excluded
    shape = p.shape[1:] if p.stacked else p.shape
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else shape[-1]
    if not p.stacked:
        return _draw(generator, p.init, shape, fan_in, dt)
    # layer by layer: the float32 draw holds one layer at a time
    out = torch.empty(p.shape, dtype=dt, device=dev)
    for i in range(p.shape[0]):
        out[i] = _draw(generator, p.init, shape, fan_in, dt)
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig,
                shardings=None) -> dict:
    """Random parameters on the generator's device, by the reference's
    laws (not its draws): normal / sqrt(fan_in) weights (an MoE leaf's
    fan-in counts its experts axis), zero norm scales, and the recurrent
    mixers' ``lam``, ``A_log``, ``dt_bias`` and ``D`` rules.  With
    ``shardings``, a tree of ``NamedSharding`` like the parameters, each
    leaf is placed on its mesh as soon as it is drawn (the same values)."""
    if shardings is None:
        return _map_tree(model_param_shapes(cfg),
                         lambda _, p: _init_leaf(generator, p, cfg))
    return _map_tree(model_param_shapes(cfg), lambda _, p, sh: place(
        _init_leaf(generator, p, cfg), sh), other=shardings)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as tensors on the ``meta`` device, of
    ``cfg.param_dtype`` (the reference's ``ShapeDtypeStruct`` tree)."""
    return _map_tree(model_param_shapes(cfg), lambda _, p: torch.empty(
        p.shape, dtype=cfg.param_dtype, device="meta"))


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's logical specs (tuples of axis names)."""
    return _map_tree(model_param_shapes(cfg), lambda _, p: p.logical)


_READ_F32 = ("lam", "A_log", "dt_bias")


def compute_params(params: dict, cfg: ModelConfig, device=None) -> dict:
    """``params`` on ``device`` (where they are, by default) as the model's
    matmuls read them: every weight cast to ``cfg.dtype`` once (the same
    values as the reference's cast at each use), the leaves the reference
    reads in float32 (the norm scales, RG-LRU's ``lam``, SSD's ``A_log``
    and ``dt_bias``) kept as they are."""
    def cast(name, x):
        keep = "norm" in name or name in _READ_F32
        return x.to(device=device, dtype=None if keep else cfg.dtype)

    return _map_tree(params, cast)


# ---------------------------------------------------------------------------
# Blocks (full sequence)
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, chunk: int) -> int:
    return chunk if (s % chunk == 0 and s >= chunk) else s


def _on_mesh(x) -> bool:
    """Is ``x`` a DTensor on a mesh of more than one rank?"""
    return is_dtensor(x) and x.device_mesh.size() > 1


class _SumGradOver(torch.autograd.Function):
    """The identity, whose gradient is summed over the mesh dims
    ``groups`` ((mesh, dim) pairs): Megatron's ``f`` on an input every
    rank reads for its own slice of the columns."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol
        for g in ctx.groups:
            grad = funcol.wait_tensor(funcol.all_reduce(grad, "sum", g))
        return grad, None


class _SumOver(torch.autograd.Function):
    """The sum of each rank's part over the mesh dims ``groups``, whose
    gradient every part takes whole: Megatron's ``g`` after a row split."""

    @staticmethod
    def forward(ctx, x, groups):
        from torch.distributed import _functional_collectives as funcol
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _col_proj(h: torch.Tensor, w: torch.Tensor, axis: str):
    """``h @ w`` over ``h``'s last dim, on a mesh, as each rank's local
    product (Megatron's column split): ``w`` (D, *C) gathered over its FSDP
    split, its first output dim split where the logical ``axis`` divides
    the mesh, the batch rows where ``"batch"`` does.  (Left to itself,
    DTensor may run the whole product on every rank of a free axis, or
    split flattened columns where the unflatten cannot follow, as 4 KV
    heads on a 16-way axis.)  The weight's gradient is each rank's part
    of the sum over the batch; the input's is summed over the split
    columns in the backward, once a product."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    b, s, _ = h.shape
    tail = tuple(w.shape[1:])
    want = named_sharding(("batch", "seq", axis) + (None,) * (len(tail) - 1),
                          (b, s) + tail).placements
    op = [p if p in (Shard(0), Shard(2)) else Replicate() for p in want]
    hp = [Shard(0) if p == Shard(0) else Replicate() for p in op]
    wp = [Shard(1) if p == Shard(2) else Replicate() for p in op]
    wg = [Partial() if p == Shard(0) else q for p, q in zip(op, wp)]
    mesh = h.device_mesh
    split = [(mesh, j) for j, p in enumerate(op) if p == Shard(2)]

    def local(hl, wl):
        return torch.tensordot(_SumGradOver.apply(hl, split), wl, dims=1)

    return local_map(local, out_placements=op, in_placements=(hp, wp),
                     in_grad_placements=(hp, wg), redistribute_inputs=True,
                     device_mesh=mesh)(h, w)


def _embed_local(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype):
    """``table[tokens]`` in ``dtype`` on a mesh, Megatron's vocab-parallel
    lookup: the table gathered over its FSDP split only; each rank looks
    up its rows of ``tokens`` in its own vocab slice (zeros for the tokens
    outside it), and the slices' rows are summed over the vocab split.
    The table's gradient is each rank's part of the sum over the batch.
    (Left to itself, DTensor gathers the activations instead.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = tokens.device_mesh
    tp = [Shard(0) if p == Shard(0) else Replicate()
          for p in tokens.placements]
    wp = [Shard(0) if p == Shard(0) else Replicate()
          for p in table.placements]
    wg = [Partial() if t == Shard(0) else w for t, w in zip(tp, wp)]
    vocab = [j for j, p in enumerate(wp) if p == Shard(0)]

    def local(wl, tl):
        index = 0                  # this rank's vocab slice, major first
        for j in vocab:
            index = index * mesh.size(j) + mesh.get_local_rank(j)
        v = wl.shape[0]
        rel = tl - index * v
        inside = (rel >= 0) & (rel < v)
        rows = wl[rel.clamp(0, v - 1)].to(dtype)
        rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
        return _SumOver.apply(rows, [(mesh, j) for j in vocab])

    return local_map(local, out_placements=tp, in_placements=(wp, tp),
                     in_grad_placements=(wg, tp), redistribute_inputs=True,
                     device_mesh=mesh)(table, tokens)


def _row_proj(x: torch.Tensor, w: torch.Tensor, axis: str):
    """``x`` (B, S, *C) contracted with ``w`` (*C, D) on a mesh, as each
    rank's local product (Megatron's row split): ``C``'s first dim split
    where the logical ``axis`` divides the mesh, ``w`` gathered over its
    FSDP split; each rank's part of the (B, S, D) result is summed over the
    split, once a product, in the compute dtype."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = tuple(w.shape[:-1])
    want = named_sharding(("batch", "seq", axis) + (None,) * (len(lead) - 1),
                          tuple(x.shape)).placements
    xp = [p if p in (Shard(0), Shard(2)) else Replicate() for p in want]
    wp = [Shard(0) if p == Shard(2) else Replicate() for p in xp]
    op = [Replicate() if p == Shard(2) else p for p in xp]
    wg = [Partial() if p == Shard(0) else q for p, q in zip(xp, wp)]
    mesh = x.device_mesh
    split = [(mesh, j) for j, p in enumerate(xp) if p == Shard(2)]

    def local(xl, wl):
        return _SumOver.apply(torch.tensordot(xl, wl, dims=len(lead)), split)

    return local_map(local, out_placements=op, in_placements=(xp, wp),
                     in_grad_placements=(xp, wg), redistribute_inputs=True,
                     device_mesh=mesh)(x, w)


def _project_qkv(p: dict, h: torch.Tensor, wq: torch.Tensor):
    dt = h.dtype
    if _on_mesh(h):
        return (_col_proj(h, wq.to(dt), "heads"),
                _col_proj(h, p["wk"].to(dt), "kv_heads"),
                _col_proj(h, p["wv"].to(dt), "kv_heads"))
    q = torch.einsum("bsd,dhk->bshk", h, wq.to(dt))
    k = torch.einsum("bsd,dgk->bsgk", h, p["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bsgk", h, p["wv"].to(dt))
    return q, k, v


def _attn_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
              rope: tuple[torch.Tensor, torch.Tensor] | None,
              causal: bool = True):
    """Full-sequence attention mixer, causal or not (the encoder's, which
    always takes the dense attention).  ``rope`` is the RoPE or M-RoPE
    sin/cos of the run, or None.  Returns (out, (k, v)).

    When ``cfg.head_pad_multiple`` pads the q-heads (gemma-2b 8 -> 16,
    yi-34b 56 -> 64, whisper and qwen2-vl 12 -> 16), wq/wo are zero-padded
    and KV is gather-expanded to one stream per (padded) q-head, as in the
    reference: the padded heads' zero wo rows keep the math exact."""
    b, s, _ = x.shape
    hp = cfg.padded_heads
    expand = hp != cfg.n_heads
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, F.pad(p["wq"], (0, 0, 0, hp - cfg.n_heads))
                           if expand else p["wq"])
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    if expand:
        # per-q-head KV streams: the padded tail maps to group g-1 (masked
        # by wo's zero rows)
        rep = max(cfg.n_heads // cfg.n_kv, 1)
        kv_map = torch.clamp(torch.arange(hp, device=x.device) // rep,
                             max=cfg.n_kv - 1)
        k_att = constrain(k[:, :, kv_map], "batch", "seq", "heads", "head_dim")
        v_att = constrain(v[:, :, kv_map], "batch", "seq", "heads", "head_dim")
        q5 = q.reshape(b, s, hp, 1, cfg.head_dim)
    else:
        k_att, v_att = k, v
        q5 = (None if _heads_unaligned(q, cfg.n_kv) else q.reshape(
            b, s, cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim))
    window = cfg.window if kind == "local" else None

    def attend(q5, k_att, v_att):
        if not causal:
            return dense_attention(q5, k_att, v_att, causal=False,
                                   softcap=cfg.attn_softcap)
        if s <= cfg.dense_attn_max_seq and (window is None
                                            or not cfg.flash_attention):
            return dense_attention(q5, k_att, v_att, window=window,
                                   softcap=cfg.attn_softcap)
        if window is not None:
            if cfg.flash_attention:
                return flash_banded_attention(
                    q5, k_att, v_att, window, _pick_chunk(s, cfg.attn_chunk),
                    cfg.attn_softcap)
            return banded_attention(q5, k_att, v_att, window=window,
                                    chunk=cfg.attn_chunk,
                                    softcap=cfg.attn_softcap)
        if cfg.flash_attention:
            return flash_causal_attention(q5, k_att, v_att,
                                          _pick_chunk(s, cfg.attn_chunk),
                                          cfg.attn_softcap)
        return pair_chunked_attention(q5, k_att, v_att,
                                      chunk=cfg.attn_chunk,
                                      softcap=cfg.attn_softcap)

    if q5 is None:
        out = _local_gqa(attend, q, k_att, v_att, cfg.n_heads // cfg.n_kv)
    else:
        out = _local_attention(attend, q5, k_att, v_att)
    out = out.reshape(b, s, hp, cfg.head_dim)
    wo = (F.pad(p["wo"], (0, 0, 0, 0, 0, hp - cfg.n_heads)) if expand
          else p["wo"])
    if _on_mesh(out):
        return _row_proj(out, wo.to(x.dtype), "heads"), (k, v)
    return torch.einsum("bshk,hkd->bsd", out, wo.to(x.dtype)), (k, v)


def _local_attention(attend, q5: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """``attend(q5, k, v)`` -> (B, S, G, R, Dh).  On DTensors each rank
    attends on its local tensors (the flash walks and the chunked loops
    run as plain tensor code): its rows of the batch (dim 0) and its KV
    groups (dim 2) or q heads within a group (q5's dim 3), the splits
    attention is independent across; any other split of the inputs is
    gathered first.  Where the q heads within a group are split, every
    rank reads the whole K/V, and its K/V gradient is its heads' part of
    the sum (``Partial``).  Plain tensors go straight through."""
    if not is_dtensor(q5):
        return attend(q5, k, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def keep(p, dims):
        return p if isinstance(p, Shard) and p.dim in dims else Replicate()

    qp = [keep(p, (0, 2, 3)) for p in q5.placements]
    kp = [keep(p, (0, 2)) for p in qp]
    kg = [Partial() if q != k else k for q, k in zip(qp, kp)]
    return local_map(attend, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg),
                     redistribute_inputs=True,
                     device_mesh=q5.device_mesh)(q5, k, v)


def _heads_unaligned(q: torch.Tensor, groups: int) -> bool:
    """Is ``q`` (B, S, H, Dh) a DTensor whose heads are split over more
    ranks than ``groups`` KV groups divide into (tinyllama's 4 groups on a
    16-way model axis)?  Its (G, R) grouping is then no DTensor layout."""
    if not is_dtensor(q):
        return False
    ranks = math.prod(q.device_mesh.size(j) for j, p in
                      enumerate(q.placements) if p.is_shard(2))
    return groups % ranks != 0


def _local_gqa(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               rep: int) -> torch.Tensor:
    """``attend`` on the heads of a DTensor ``q`` (B, S, H, Dh) whose head
    split does not align with the KV groups of ``k``/``v`` (B, S, G, Dh):
    each rank holds whole K/V groups, picks the group of each of its own
    q heads (one KV stream a head, as the padded-heads path expands them)
    and attends locally; the K/V gradient is its heads' part of the sum.
    Returns (B, S, H, Dh) on ``q``'s placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    kp = [p if p == Shard(0) else Replicate() for p in qp]
    kg = [Partial() if a != b else b for a, b in zip(qp, kp)]
    head_dims = [j for j, p in enumerate(qp) if p == Shard(2)]

    def local(ql, kl, vl):
        index = 0                  # this rank's block of heads, major first
        for j in head_dims:
            index = index * mesh.size(j) + mesh.get_local_rank(j)
        hl = ql.shape[2]
        kv_map = torch.arange(index * hl, (index + 1) * hl,
                              device=ql.device) // rep
        return attend(ql.unsqueeze(3), kl[:, :, kv_map],
                      vl[:, :, kv_map]).squeeze(3)

    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg),
                     redistribute_inputs=True, device_mesh=mesh)(q, k, v)


def _cross_attn(p: dict, x: torch.Tensor, enc_kv, cfg: ModelConfig):
    """Cross-attention of x (B, S, D) to the encoder's K/V (B, Tf, G, Dh)
    each, in the unpadded (G, rep) grouping."""
    b, s, _ = x.shape
    g, rep = cfg.n_kv, cfg.n_heads // cfg.n_kv
    h = rms_norm(x, p["xnorm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["xwq"].to(x.dtype))
    out = dense_attention(q.reshape(b, s, g, rep, cfg.head_dim), *enc_kv,
                          causal=False, softcap=cfg.attn_softcap)
    out = out.reshape(b, s, cfg.n_heads, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, p["xwo"].to(x.dtype))


def _enc_kv(p: dict, enc_out: torch.Tensor):
    """A decoder layer's cross-attention K/V (B, Tf, G, Dh) of the
    encoder's output."""
    dt = enc_out.dtype
    return (torch.einsum("btd,dgk->btgk", enc_out, p["xwk"].to(dt)),
            torch.einsum("btd,dgk->btgk", enc_out, p["xwv"].to(dt)))


def _mlp(p: dict, x: torch.Tensor, cfg: ModelConfig,
         is_moe: bool) -> torch.Tensor:
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if is_moe and cfg.moe is not None:
        return moe_apply(p, h, cfg.moe, _act(cfg))
    dt = x.dtype
    mm = (functools.partial(_col_proj, axis="ff") if _on_mesh(h)
          else torch.matmul)
    if cfg.mlp in ("swiglu", "geglu"):
        inner = _act(cfg)(mm(h, p["mlp_gate"].to(dt)),
                          mm(h, p["mlp_up"].to(dt)))
    else:
        inner = F.gelu(mm(h, p["mlp_up"].to(dt)), approximate="tanh")
    if _on_mesh(inner):
        return _row_proj(inner, p["mlp_down"].to(dt), "ff")
    inner = constrain(inner, "batch", "seq", "ff")
    return inner @ p["mlp_down"].to(dt)


def _block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                 is_moe: bool, rope, enc_out: torch.Tensor | None = None,
                 causal: bool = True, want_state: bool = False):
    """One layer; returns (x, aux): for attention a dict of its ``k``,
    ``v`` and, with ``enc_out``, the cross-attention's ``xk``, ``xv``; for
    a recurrent mixer its decode state with ``want_state`` (else None)."""
    if kind in ("attn", "local"):
        mix, (k, v) = _attn_mix(p, x, cfg, kind=kind, rope=rope,
                                causal=causal)
        aux = {"k": k, "v": v}
    else:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if kind == "rglru":
            out = rglru_apply(p, h, return_state=want_state)
        else:
            out = ssd_apply(p, h, cfg, return_state=want_state)
        mix, aux = out if want_state else (out, None)
    x = x + mix
    if enc_out is not None and "xnorm" in p:
        enc_kv = _enc_kv(p, enc_out)
        x = x + _cross_attn(p, x, enc_kv, cfg)
        aux["xk"], aux["xv"] = enc_kv
    if cfg.mlp != "none" and kind != "ssd":
        x = x + _mlp(p, x, cfg, is_moe)
    return constrain(x, "batch", "seq", "embed_act"), aux


def _remat_block(p: dict, x: torch.Tensor, cfg: ModelConfig, remat: str,
                 **kw) -> torch.Tensor:
    """One layer's output; with ``remat == "full"`` and gradients on, under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scanned layer body): the layer saves only its inputs, and the backward
    recomputes its activations."""
    def body(x, p):
        return _block_apply(p, x, cfg, **kw)[0]

    if remat == "full" and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(body, x, p, use_reentrant=False)
    return body(x, p)


def _run_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "attn" and cfg.global_rope_theta > 0:
        return cfg.global_rope_theta
    return cfg.rope_theta


def _run_rope(cfg: ModelConfig, kind: str, positions: torch.Tensor,
              mrope_positions: torch.Tensor | None = None):
    """An attention run's RoPE sin/cos at ``positions`` (B, S), or its
    M-RoPE sin/cos at ``mrope_positions`` (3, B, S) for an M-RoPE config,
    shared by its layers (the reference computes the same values in each
    layer); None for a recurrent run or without RoPE."""
    theta = _run_theta(cfg, kind)
    if kind not in ("attn", "local"):
        return None
    if cfg.mrope_sections and mrope_positions is not None:
        return mrope_sincos(mrope_positions, cfg.mrope_sections,
                            cfg.head_dim, theta)
    if theta <= 0:
        return None
    return rope_sincos(positions, cfg.head_dim, theta)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Unembed + optional softcap + padded-vocab mask.  x: (B, S, D)."""
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    if _on_mesh(x):
        logits = _col_proj(x, unembed.to(cfg.dtype), "vocab")
    else:
        logits = torch.einsum("bsd,dv->bsv", x, unembed.to(cfg.dtype))
    logits = constrain(logits, "batch", "seq", "vocab")
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.padded_vocab != cfg.vocab:
        ids = torch.arange(cfg.padded_vocab, device=x.device)
        pad_mask = torch.where(ids < cfg.vocab, 0.0, -1e30).to(logits.dtype)
        logits = logits + pad_mask
    return logits


def build_mrope_positions(cfg: ModelConfig, batch: int, seq: int,
                          device=None) -> torch.Tensor:
    """(3, B, S) int64 M-RoPE ids: the ``cfg.vision_patches`` patches get a
    (t=0, h, w) grid, the text runs on sequentially after the largest
    patch coordinate (the Qwen2-VL scheme)."""
    p = cfg.vision_patches
    grid = max(int(math.sqrt(max(p, 1))), 1)
    idx = torch.arange(seq, device=device)
    is_text = idx >= p
    text = idx - p + grid
    pos = torch.stack([
        torch.where(is_text, text, 0),
        torch.where(is_text, text, torch.clamp(idx // grid, max=grid - 1)),
        torch.where(is_text, text, idx % grid)])
    return pos[:, None, :].expand(3, batch, seq)


def _embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor | None = None) -> torch.Tensor:
    table = params["embed"]
    if _on_mesh(table) and _on_mesh(tokens):
        x = _embed_local(table, tokens, cfg.dtype)
    else:
        x = table[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # the factor is rounded to the compute dtype first, as in the
        # reference
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.dtype,
                           device=x.device)
    if cfg.rope_theta == 0 and not cfg.mrope_sections and positions is not None:
        # RoPE off (whisper): absolute sinusoidal position embeddings
        x = x + sinusoidal_at(positions, cfg.d_model).to(cfg.dtype)
    return x


def _layer(p_run: dict, i: int) -> dict:
    return {k: v[i] for k, v in p_run.items()}


def _encode(params: dict, cfg: ModelConfig,
            enc_frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, Tf, D):
    the sinusoidal table added, the non-causal blocks, the final norm."""
    enc_cfg = _encoder_cfg(cfg)
    x = enc_frames.to(cfg.dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(cfg.dtype)[None]
    p_run = params["encoder"]["runs"][0]
    for i in range(cfg.encoder_layers):
        x = _remat_block(_layer(p_run, i), x, enc_cfg, cfg.remat,
                         kind="attn", is_moe=False, rope=None, causal=False)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            enc_frames: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None,
            return_cache: bool = False, cache_len: int | None = None):
    """Full-sequence forward.

    tokens: (B, S_text) integer ids.  With ``patch_embeds`` (B, P, D) the
    sequence is the patches, then the text: S = P + S_text.  An encoder
    config needs ``enc_frames`` (B, encoder_frames, D).  ``positions``
    (B, S) defaults to 0..S-1; the text's part feeds the sinusoidal
    embeddings and RoPE reads all of it (M-RoPE reads
    :func:`build_mrope_positions`).  Returns logits (B, S, padded_vocab)
    in ``cfg.dtype``, or (logits, cache) with ``return_cache`` (prefill):
    the cache holds ``cache_len`` (default S) positions per global run and
    ``min(window, cache_len)`` per local run, the last ones of the
    sequence, each local run in the ring layout slot = position % width
    (a global run's slots are not rolled, as in the reference), each
    recurrent run's final states, with an encoder each layer's
    cross-attention ``xk``/``xv`` and ``enc_out``, and ``pos`` = S.  An
    MoE config raises ``ValueError`` unless B*S is a multiple of
    ``min(group_size, B*S)``, an SSD config unless S is a multiple of
    ``min(128, S)``, as the reference asserts.
    """
    b, s_text = tokens.shape
    s = s_text + (0 if patch_embeds is None else patch_embeds.shape[1])
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_tokens(params, cfg, tokens, positions[:, s - s_text:])
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(cfg.dtype), x], dim=1)
    mpos = (build_mrope_positions(cfg, b, s, tokens.device)
            if cfg.mrope_sections else None)
    enc_out = None
    if cfg.encoder_layers:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} has an encoder: pass enc_frames")
        enc_out = _encode(params, cfg, enc_frames)
    x = constrain(x, "batch", "seq", "embed_act")
    run_caches = []
    for run_idx, (kind, is_moe, _start, length) in enumerate(
            pattern_runs(cfg)):
        p_run = params["runs"][run_idx]
        rope = _run_rope(cfg, kind, positions, mpos)
        auxs = []
        for i in range(length):
            if return_cache:
                x, aux = _block_apply(_layer(p_run, i), x, cfg, kind=kind,
                                      is_moe=is_moe, rope=rope,
                                      enc_out=enc_out, want_state=True)
                auxs.append(aux)
            else:
                x = _remat_block(_layer(p_run, i), x, cfg, cfg.remat,
                                 kind=kind, is_moe=is_moe, rope=rope,
                                 enc_out=enc_out)
        if return_cache:
            run_caches.append(_prefill_run_cache(auxs, cfg, kind,
                                                 cache_len or s, s))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    if not return_cache:
        return logits
    pos = torch.full((), s, dtype=torch.int32, device=tokens.device)
    cache = {"pos": pos, "runs": run_caches}
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return logits, cache


def _prefill_run_cache(auxs: list, cfg: ModelConfig, kind: str,
                       cache_len: int, s: int) -> dict:
    """The decode cache of one run from its layers' prefill byproducts:
    k/v (B, S, G, Dh) each (and the cross-attention's xk/xv) for
    attention, the final states otherwise."""
    out = {name: torch.stack([a[name] for a in auxs]) for name in auxs[0]}
    if kind not in ("attn", "local"):
        return out
    k, v = out["k"], out["v"]
    w = min(cfg.window, cache_len) if kind == "local" else cache_len
    if s >= w:
        k, v = k[:, :, s - w:], v[:, :, s - w:]
        if kind == "local":
            # ring layout: slot = pos % w
            k, v = torch.roll(k, s % w, dims=2), torch.roll(v, s % w, dims=2)
    else:
        k = F.pad(k, (0, 0, 0, 0, 0, w - s))
        v = F.pad(v, (0, 0, 0, 0, 0, w - s))
    out["k"], out["v"] = k.contiguous(), v.contiguous()
    return out


# ---------------------------------------------------------------------------
# Cache init / specs
# ---------------------------------------------------------------------------

def _run_cache_shapes(cfg: ModelConfig, kind: str, length: int, batch: int,
                      max_len: int) -> dict[str, tuple]:
    """name -> (shape, logical spec) of one run's cache leaves."""
    g, dh = cfg.n_kv, cfg.head_dim
    if kind in ("attn", "local"):
        w = min(cfg.window, max_len) if kind == "local" else max_len
        # kv_heads shards when divisible; kv_seq (split-KV) otherwise —
        # spec_for's first-win drop keeps one of them on "model"
        kv_spec = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        if g % 16 == 0:
            kv_spec = ("layers", "batch", None, "kv_heads", "head_dim")
        out = {"k": ((length, batch, w, g, dh), kv_spec),
               "v": ((length, batch, w, g, dh), kv_spec)}
        if cfg.encoder_layers:
            cross = (length, batch, cfg.encoder_frames, g, dh)
            out.update(xk=(cross, kv_spec), xv=(cross, kv_spec))
        return out
    base = (rglru_state_shapes(cfg, batch) if kind == "rglru"
            else ssd_state_shapes(cfg, batch))
    return {k: ((length,) + sh, ("layers",) + spec)
            for k, (sh, spec) in base.items()}


def _cache_tree(cfg: ModelConfig, batch: int, max_len: int, fn) -> dict:
    """``fn(shape, spec)`` at each leaf of the cache tree."""
    runs = [{k: fn(*v) for k, v in _run_cache_shapes(
        cfg, kind, length, batch, max_len).items()}
        for kind, _moe, _start, length in pattern_runs(cfg)]
    out = {"pos": fn((), (None,)), "runs": runs}
    if cfg.encoder_layers:
        out["enc_out"] = fn((batch, cfg.encoder_frames, cfg.d_model),
                            ("batch", None, "embed_act"))
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """An empty decode cache on ``device`` in ``cfg.dtype``: per attention
    run k/v (L, B, W, G, Dh) (W = ``max_len``, or ``min(window, max_len)``
    for a local run) and with an encoder xk/xv (L, B, encoder_frames, G,
    Dh), per recurrent run its zero states, with an encoder ``enc_out``
    (B, encoder_frames, D), and an int32 ``pos`` of 0."""
    return _cache_tree(cfg, batch, max_len, lambda sh, _: torch.zeros(
        sh, dtype=torch.int32 if sh == () else cfg.dtype, device=device))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """:func:`init_cache`'s tree as ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, "meta")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache tree's logical specs (``pos``'s is ``(None,)``, as in the
    reference)."""
    return _cache_tree(cfg, batch, max_len, lambda _, spec: spec)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _slot_positions(pos: torch.Tensor, w: int) -> torch.Tensor:
    """Global position held by each of the w ring slots after writing ``pos``
    at slot pos % w.  (-1 where the slot is still empty.)"""
    i = torch.arange(w, device=pos.device)
    p = pos - torch.remainder(pos - i, w)
    return torch.where(p >= 0, p, -1)


def _attn_decode(p: dict, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 x: torch.Tensor, cfg: ModelConfig, *,
                 rope: tuple[torch.Tensor, torch.Tensor] | None,
                 slot: torch.Tensor, slot_pos: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """One token's attention mixer; writes its k/v into the caches (B, W,
    G, Dh) in place at ``slot`` (pos % W).  Decode keeps the unpadded GQA
    grouping."""
    b = x.shape[0]
    g, rep = cfg.n_kv, cfg.n_heads // cfg.n_kv
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, p["wq"])
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    if is_dtensor(k_cache):
        out = _decode_sharded(q, k, v, k_cache, v_cache, pos, cfg)
    else:
        k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
        q5 = q.reshape(b, 1, g, rep, cfg.head_dim)
        out = decode_attention(q5, k_cache, v_cache, slot_pos, pos,
                               softcap=cfg.attn_softcap)
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim)
    if _on_mesh(out):
        return _row_proj(out, p["wo"].to(x.dtype), "heads")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def _decode_sharded(q, k, v, k_cache, v_cache, pos, cfg: ModelConfig):
    """One token's cache write and attention on a cache placed on a mesh
    (B, W, G, Dh): each rank writes the token into its own slice of the
    cache (when the slot falls in it) and attends on its rows of the
    batch, its KV groups and its slice of the sequence.  Where the
    sequence is split (split-KV: the groups do not divide the axis), each
    rank's softmax is over its slice, and the slices meet in all-reduces
    of the running max, the sum and the weighted values.  Returns
    (B, 1, H, Dh)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k_cache.device_mesh
    cp = list(k_cache.placements)
    seq_dims = [j for j, p in enumerate(cp) if p == Shard(1)]
    kp = [p if p in (Shard(0), Shard(2)) else Replicate() for p in cp]
    g, rep = cfg.n_kv, cfg.n_heads // cfg.n_kv
    pos = pos.full_tensor() if is_dtensor(pos) else pos
    w_all = k_cache.shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def local(ql, kl, vl, kc, vc):
        index = 0                   # this rank's sequence slice, major first
        for j in seq_dims:
            index = index * mesh.size(j) + mesh.get_local_rank(j)
        w = kc.shape[1]
        at = torch.remainder(pos, w_all) - index * w     # the ring's slot
        inside = (at >= 0) & (at < w)
        slot = torch.clamp(at, 0, w - 1).reshape(1).long()
        for c, new in ((kc, kl), (vc, vl)):
            c.index_copy_(1, slot, torch.where(
                inside, new.to(c.dtype), c.index_select(1, slot)))
        i = torch.arange(index * w, (index + 1) * w, device=kc.device)
        slot_pos = pos - torch.remainder(pos - i, w_all)
        slot_pos = torch.where(slot_pos >= 0, slot_pos, -1)
        bl = ql.shape[0]
        q5 = ql.reshape(bl, 1, kc.shape[2], rep, cfg.head_dim)
        if not seq_dims:
            out = decode_attention(q5, kc, vc, slot_pos, pos,
                                   softcap=cfg.attn_softcap)
            return out.reshape(bl, 1, -1, cfg.head_dim)
        scores = _scores(q5, kc, scale, cfg.attn_softcap)
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        scores = torch.where(valid, scores, NEG_INF)
        top = torch.amax(scores, dim=-1, keepdim=True)
        for j in seq_dims:
            top = funcol.all_reduce(top, "max", (mesh, j))
        probs = torch.exp(scores - top)
        total = torch.sum(probs, dim=-1, keepdim=True)
        out = _pv(probs.to(ql.dtype), vc).float()
        for j in seq_dims:
            total = funcol.all_reduce(total, "sum", (mesh, j))
            out = funcol.all_reduce(out, "sum", (mesh, j))
        # total (B, G, R, 1, 1) against out (B, 1, G, R, D)
        out = out / total[..., 0].permute(0, 3, 1, 2)[..., None]
        return out.to(ql.dtype).reshape(bl, 1, -1, cfg.head_dim)

    return local_map(local, out_placements=kp,
                     in_placements=(kp, kp, kp, cp, cp),
                     redistribute_inputs=True, device_mesh=mesh)(
        q, k, v, k_cache, v_cache)


def _decode_rows(step, p: dict, state: dict, h: torch.Tensor):
    """``step(p, state, h) -> (mix, new state)``, a recurrent mixer's
    decode step, on a mesh: each rank runs it on its own rows of the batch
    with the layer's weights gathered whole (left to itself, DTensor may
    split the step's small tensors where its reshapes cannot follow)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = h.device_mesh
    rows = [Shard(0) if q == Shard(0) else Replicate() for q in h.placements]
    whole = [Replicate()] * mesh.ndim
    pk, sk = sorted(p), sorted(state)

    def local(hl, *leaves):
        mix, new = step(dict(zip(pk, leaves[:len(pk)])),
                        dict(zip(sk, leaves[len(pk):])), hl)
        return (mix, *[new[k] for k in sk])

    out = local_map(local, out_placements=(rows,) * (1 + len(sk)),
                    in_placements=(rows,) + (whole,) * len(pk)
                    + (rows,) * len(sk), redistribute_inputs=True,
                    device_mesh=mesh)(h, *[p[k] for k in pk],
                                      *[state[k] for k in sk])
    return out[0], dict(zip(sk, out[1:]))


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor):
    """One decoding step.  tokens: (B, 1).  Returns (logits (B, 1, V),
    cache): the returned cache holds ``pos + 1`` and the same tensors, into
    which this step's keys and values, and the recurrent runs' new states,
    were written in place.  The token sits at position ``pos``: its
    sinusoidal embedding, its RoPE, and for M-RoPE all three components
    (the reference's decode step; its prefill gives text tokens other
    M-RoPE ids, see :func:`build_mrope_positions`).  Cross-attention reads
    the cached ``xk``/``xv``."""
    pos = cache["pos"]
    b = tokens.shape[0]
    positions = pos.expand(b, 1)
    x = constrain(_embed_tokens(params, cfg, tokens, positions),
                  "batch", "seq", "embed_act")
    cross = "enc_out" in cache
    for run_idx, (kind, is_moe, _start, length) in enumerate(
            pattern_runs(cfg)):
        p_run, c_run = params["runs"][run_idx], cache["runs"][run_idx]
        if kind in ("attn", "local"):
            rope = _run_rope(cfg, kind, positions, pos.expand(3, b, 1))
            w = c_run["k"].shape[2]
            slot = torch.remainder(pos, w).reshape(1).long()
            slot_pos = _slot_positions(pos, w)
        for i in range(length):
            p_l = _layer(p_run, i)
            if kind in ("attn", "local"):
                mix = _attn_decode(p_l, c_run["k"][i], c_run["v"][i], x, cfg,
                                   rope=rope, slot=slot, slot_pos=slot_pos,
                                   pos=pos)
            else:
                state = _layer(c_run, i)
                h = rms_norm(x, p_l["norm1"], cfg.norm_eps)
                step = (rglru_decode_step if kind == "rglru" else
                        functools.partial(ssd_decode_step, cfg=cfg))
                mix, new = (_decode_rows(step, p_l, state, h)
                            if _on_mesh(h) else step(p_l, state, h))
                for name, t in new.items():
                    state[name].copy_(t)
            x = x + mix
            if cross and "xnorm" in p_l:
                x = x + _cross_attn(p_l, x, (c_run["xk"][i], c_run["xv"][i]),
                                    cfg)
            if cfg.mlp != "none" and kind != "ssd":
                x = x + _mlp(p_l, x, cfg, is_moe)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    return logits, dict(cache, pos=pos + 1)
