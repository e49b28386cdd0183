"""RG-LRU recurrent block (Griffin / RecurrentGemma).

PyTorch counterpart of :mod:`repro.models.rglru`: two input branches (a
GeLU gate and a conv1d'd signal path), a Real-Gated Linear Recurrent Unit
over the signal path, and an output projection of the gated product.

RG-LRU recurrence (Griffin eq. 3-6):

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_i x_t + b_i)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence runs the recurrence as the reference's
``jax.lax.associative_scan`` does, log-depth (:func:`associative_scan`);
decode is the single-step update, with a (B, cw-1, W) ring of the conv's
inputs.  The state is stored in the activations' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["rglru_param_shapes", "rglru_state_shapes", "rglru_apply",
           "rglru_decode_step", "associative_scan"]

_C = 8.0


def rglru_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """name -> (shape, logical spec), in the reference's order."""
    d, w, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
    return {
        "w_x": ((d, w), ("embed", "state")),
        "w_g": ((d, w), ("embed", "state")),
        "conv_w": ((cw, w), ("conv", "state")),
        "lam": ((w,), ("state",)),
        "w_a": ((w, w), ("state", None)),
        "b_a": ((w,), ("state",)),
        "w_i": ((w, w), ("state", None)),
        "b_i": ((w,), ("state",)),
        "w_o": ((w, d), ("state", "embed")),
    }


def rglru_state_shapes(cfg: ModelConfig, batch: int) -> dict[str, tuple]:
    """name -> (shape, logical spec) of the decode state."""
    return {"h": ((batch, cfg.rnn_width), ("batch", "state")),
            "conv_buf": ((batch, cfg.conv_width - 1, cfg.rnn_width),
                         ("batch", None, "state"))}


def _gates(p: dict, xt: torch.Tensor):
    dt = xt.dtype
    r = torch.sigmoid(xt @ p["w_a"].to(dt) + p["b_a"].to(dt))
    i = torch.sigmoid(xt @ p["w_i"].to(dt) + p["b_i"].to(dt))
    log_a = -_C * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * (i.float() * xt.float())


def conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1 of (B, S, D); w (cw, D).  The
    taps are summed one after another in ``x``'s dtype, as the reference
    sums them."""
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for j in range(cw):
        out = out + xp[:, j:j + x.shape[1]] * w[j].to(x.dtype)
    return out


def _combine(c1, c2):
    (a1, b1), (a2, b2) = c1, c2
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 with
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the pairs, fill in the even positions, interleave.  Returns the
    scanned (a, b); b is h."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, ev, od in zip((a, b), even, odd):
        x = torch.empty_like(first)
        x[:, 0] = first[:, 0]
        x[:, 2::2] = ev
        x[:, 1::2] = od
        out.append(x)
    return tuple(out)


def _tail(x: torch.Tensor, cw: int) -> torch.Tensor:
    """The last ``cw - 1`` positions of (B, S, D), left-padded with zeros
    when S is shorter: the decode conv ring after a prefill."""
    tail = x[:, max(x.shape[1] - (cw - 1), 0):]
    return F.pad(tail, (0, 0, (cw - 1) - tail.shape[1], 0))


def rglru_apply(p: dict, x: torch.Tensor, return_state: bool = False):
    """Full-sequence Griffin recurrent block.  x: (B, S, D_model).

    With ``return_state`` also returns the decode-resumable state {h: (B,
    W), conv_buf: (B, cw-1, W)} in ``x``'s dtype (prefill)."""
    dt = x.dtype
    gate = F.gelu(x @ p["w_g"].to(dt), approximate="tanh")
    sig_raw = x @ p["w_x"].to(dt)
    a, bx = _gates(p, conv1d_causal(sig_raw, p["conv_w"]))
    _, h = associative_scan(a, bx)
    out = (h.to(dt) * gate) @ p["w_o"].to(dt)
    if not return_state:
        return out
    return out, {"h": h[:, -1].to(dt),
                 "conv_buf": _tail(sig_raw, p["conv_w"].shape[0])}


def rglru_decode_step(p: dict, state: dict, x: torch.Tensor):
    """One-token update.  x: (B, 1, D).  Returns (out (B, 1, D), new
    state), the state in the dtypes of ``state``'s tensors."""
    dt = x.dtype
    xt = x[:, 0]
    gate = F.gelu(xt @ p["w_g"].to(dt), approximate="tanh")
    sig = xt @ p["w_x"].to(dt)
    # temporal conv over the ring buffer + current input
    hist = torch.cat([state["conv_buf"].to(dt), sig[:, None]], dim=1)
    cw = p["conv_w"].shape[0]
    sig_c = torch.einsum("bwd,wd->bd", hist[:, -cw:], p["conv_w"].to(dt))
    a, bx = _gates(p, sig_c)
    h = a * state["h"].float() + bx
    out = (h.to(dt) * gate) @ p["w_o"].to(dt)
    return out[:, None], {"h": h.to(state["h"].dtype),
                          "conv_buf": hist[:, 1:].to(state["conv_buf"].dtype)}
