"""The paper's edge workload: the HAR 1-D CNN classifier.

PyTorch counterpart of :mod:`repro.models.har`, in the JAX package's
layouts: activations ``(B, T, C)``, conv weights ``(K, Cin, Cout)``, dense
weights ``(in, out)``, and the conv output flattened time-major before the
dense layer.  The convolutions and dense layers are plain PyTorch (the JAX
package leaves them to XLA); the quantizer is the hand-written
:func:`repro_torch.kernels.ops.fake_quant_op`.

The staged and auxiliary-head paths of the intermittent lane are written
batched over nodes: each node's activation takes its own quantizer scale,
as under the JAX fleet's ``vmap``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels.ops import fake_quant_op

__all__ = ["HARConfig", "har_init", "har_apply", "har_apply_quantized",
           "har_apply_quantized_nodes", "quantize_params", "har_stage_sizes",
           "har_act_buffer", "har_apply_stage", "har_apply_staged",
           "har_aux_init", "har_apply_aux"]


@dataclasses.dataclass(frozen=True)
class HARConfig:
    window: int = 60          # samples per window (paper: 60 @ 50 Hz)
    channels: int = 3         # IMU channels per sensor
    n_classes: int = 12       # MHEALTH activities
    conv1: int = 32
    conv2: int = 64
    kernel: int = 5
    hidden: int = 128


def har_init(generator: torch.Generator, cfg: HARConfig) -> dict:
    """Random weights (normal / sqrt(fan_in), zero biases) on the torch
    generator's device."""
    dev = generator.device

    def norm(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / fan_in ** 0.5

    flat = (cfg.window // 4) * cfg.conv2
    return {
        "conv1_w": norm((cfg.kernel, cfg.channels, cfg.conv1),
                        cfg.kernel * cfg.channels),
        "conv1_b": torch.zeros((cfg.conv1,), device=dev),
        "conv2_w": norm((cfg.kernel, cfg.conv1, cfg.conv2),
                        cfg.kernel * cfg.conv1),
        "conv2_b": torch.zeros((cfg.conv2,), device=dev),
        "dense_w": norm((flat, cfg.hidden), flat),
        "dense_b": torch.zeros((cfg.hidden,), device=dev),
        "head_w": norm((cfg.hidden, cfg.n_classes), cfg.hidden),
        "head_b": torch.zeros((cfg.n_classes,), device=dev),
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, T, Cin), w (K, Cin, Cout) -> (B, T, Cout), SAME padding: the
    JAX NWC/WIO convolution, run as an NCW ``conv1d`` and permuted back."""
    k = w.shape[0]
    lo = (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (lo, k - 1 - lo))
    out = F.conv1d(xt, w.permute(2, 1, 0)) + b[:, None]
    return out.transpose(1, 2).contiguous()


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t // 2, 2, c).amax(dim=2)


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    h = h.reshape(h.shape[0], -1)           # time-major flatten, as in JAX
    h = torch.relu(h @ params["dense_w"] + params["dense_b"])
    return h @ params["head_w"] + params["head_b"]


def har_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C) float windows -> (B, n_classes) logits."""
    h = _maxpool2(torch.relu(_conv1d(x, params["conv1_w"], params["conv1_b"])))
    h = _maxpool2(torch.relu(_conv1d(h, params["conv2_w"], params["conv2_b"])))
    return _head(params, h)


def quantize_params(params: dict, bits: int) -> dict:
    """Post-training quantization of every weight tensor (per tensor)."""
    return {k: (fake_quant_op(v, bits) if v.ndim >= 2 else v)
            for k, v in params.items()}


def _quantized_forward(qp: dict, x: torch.Tensor, bits: int,
                       per_sample: bool) -> torch.Tensor:
    def fq(h):
        return fake_quant_op(h, bits, per_sample=per_sample)

    h = torch.relu(_conv1d(fq(x), qp["conv1_w"], qp["conv1_b"]))
    h = fq(_maxpool2(h))
    h = torch.relu(_conv1d(h, qp["conv2_w"], qp["conv2_b"]))
    h = fq(_maxpool2(h))
    return _head(qp, h)


def har_apply_quantized(params: dict, x: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """Quantized inference as :func:`repro.models.har.har_apply_quantized`
    computes it: weights and activations fake-quantized, each activation
    with ONE scale over the whole batch."""
    return _quantized_forward(quantize_params(params, bits), x, bits,
                              per_sample=False)


def har_apply_quantized_nodes(qp: dict, x: torch.Tensor,
                              bits: int) -> torch.Tensor:
    """Quantized inference for a batch of NODES: each node's activations
    get their own scale, which is what the JAX fleet computes by vmapping
    ``har_apply_quantized(params, window[None])`` over nodes.  ``qp`` is
    the pre-quantized weights (:func:`quantize_params`), so a fleet run
    quantizes its weights once.  Three fake-quant launches per call."""
    return _quantized_forward(qp, x, bits, per_sample=True)


# ---------------------------------------------------------------------------
# Staged (intermittent) quantized inference: har_apply_quantized_nodes cut at
# the two pooling boundaries, so a node can run it piecewise across slots.
#
#   stage 0: fq(window) -> conv1 -> relu -> maxpool2 -> fq   ((T/2)·conv1)
#   stage 1:             conv2 -> relu -> maxpool2 -> fq     ((T/4)·conv2)
#   stage 2:             flatten -> dense -> relu -> head    (n_classes,)
#
# Each stage maps an (N, A) buffer of flat activations, zero-padded to the
# common width A = har_act_buffer, to the next.
# ---------------------------------------------------------------------------


def har_stage_sizes(cfg: HARConfig) -> tuple[int, int, int, int]:
    """Flat float counts entering stages 0..2 plus the final logits width:
    (T·C, (T/2)·conv1, (T/4)·conv2, n_classes)."""
    return (cfg.window * cfg.channels,
            (cfg.window // 2) * cfg.conv1,
            (cfg.window // 4) * cfg.conv2,
            cfg.n_classes)


def har_act_buffer(cfg: HARConfig) -> int:
    """Width of the staged-activation buffer: every stage input and output
    zero-padded to one size."""
    return max(har_stage_sizes(cfg))


def _pad_flat(v: torch.Tensor, width: int) -> torch.Tensor:
    v = v.reshape(v.shape[0], -1)
    return F.pad(v, (0, width - v.shape[1]))


def har_apply_stage(qp: dict, buf: torch.Tensor, stage: int, cfg: HARConfig,
                    bits: int) -> torch.Tensor:
    """Run stage ``stage`` (0, 1 or 2) on an (N, A) activation buffer and
    return the next (N, A) buffer.  ``qp`` is the pre-quantized weights
    (:func:`quantize_params`).  Stages 0 and 1 end in a per-node
    fake-quant launch; stage 0 also quantizes its input."""
    n, a = buf.shape
    s_in, s1, s2, _ = har_stage_sizes(cfg)
    if stage == 0:
        x = buf[:, :s_in].reshape(n, cfg.window, cfg.channels).contiguous()
        h = torch.relu(_conv1d(fake_quant_op(x, bits, per_sample=True),
                               qp["conv1_w"], qp["conv1_b"]))
        return _pad_flat(fake_quant_op(_maxpool2(h), bits, per_sample=True),
                         a)
    if stage == 1:
        h = buf[:, :s1].reshape(n, cfg.window // 2, cfg.conv1).contiguous()
        h = torch.relu(_conv1d(h, qp["conv2_w"], qp["conv2_b"]))
        return _pad_flat(fake_quant_op(_maxpool2(h), bits, per_sample=True),
                         a)
    if stage == 2:
        return _pad_flat(_head(qp, buf[:, :s2].contiguous()), a)
    raise ValueError(f"stage must be 0, 1 or 2, got {stage}")


def har_apply_staged(params: dict, x: torch.Tensor, bits: int,
                     cfg: HARConfig) -> torch.Tensor:
    """All three stages over (N, T, C) windows -> (N, n_classes) logits:
    the same numbers as :func:`har_apply_quantized_nodes` on the quantized
    ``params``."""
    qp = quantize_params(params, bits)
    buf = _pad_flat(x, har_act_buffer(cfg))
    for stage in range(3):
        buf = har_apply_stage(qp, buf, stage, cfg, bits)
    return buf[:, :cfg.n_classes]


def har_aux_init(generator: torch.Generator, cfg: HARConfig) -> dict:
    """Early-exit auxiliary heads: one linear head on each intermediate
    stage output (post-stage-0 and post-stage-1 activations -> class
    logits)."""
    dev = generator.device
    _, s1, s2, n_cls = har_stage_sizes(cfg)

    def norm(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / fan_in ** 0.5

    return {
        "aux1_w": norm((s1, n_cls), s1),
        "aux1_b": torch.zeros((n_cls,), device=dev),
        "aux2_w": norm((s2, n_cls), s2),
        "aux2_b": torch.zeros((n_cls,), device=dev),
    }


def har_apply_aux(qa: dict, buf: torch.Tensor, prog: torch.Tensor,
                  cfg: HARConfig) -> torch.Tensor:
    """(N, n_classes) auxiliary-head logits from an (N, A) buffer holding
    the output of ``prog`` (N,) completed stages (1 or 2; both heads run
    and ``prog`` selects).  ``qa`` is the heads quantized at the
    backbone's bits (:func:`quantize_params` of :func:`har_aux_init`), once
    per run, since they are the same for every node."""
    _, s1, s2, _ = har_stage_sizes(cfg)
    a1 = buf[:, :s1] @ qa["aux1_w"] + qa["aux1_b"]
    a2 = buf[:, :s2] @ qa["aux2_w"] + qa["aux2_b"]
    return torch.where((prog == 1)[:, None], a1, a2)
