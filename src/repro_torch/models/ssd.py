"""Mamba-2 SSD (state-space duality) block, chunked and attention-free.

PyTorch counterpart of :mod:`repro.models.ssd`: the SSD "minimal"
algorithm (Mamba-2 paper §6).  The sequence is split into chunks; within a
chunk the quadratic dual form runs as matmuls, across chunks a short
recurrence carries the (H, P, N) state; decode is a constant-time state
update.  ``ssm_groups`` B/C projections are shared by ``heads_per_group``
heads.

Dtypes follow the reference's: JAX promotes a bf16 x float32 einsum to
float32, so the bf16 operands of the chunk einsums are taken to float32
first; the state is stored in the activations' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .rglru import _tail, conv1d_causal

__all__ = ["ssd_param_shapes", "ssd_state_shapes", "ssd_apply",
           "ssd_decode_step"]


def ssd_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """name -> (shape, logical spec), in the reference's order."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return {
        "w_z": ((d, di), ("embed", "state")),
        "w_x": ((d, di), ("embed", "state")),
        "w_B": ((d, g * n), ("embed", None)),
        "w_C": ((d, g * n), ("embed", None)),
        "w_dt": ((d, h), ("embed", None)),
        "dt_bias": ((h,), (None,)),
        "A_log": ((h,), (None,)),
        "D": ((h,), (None,)),
        "norm_scale": ((di,), ("state",)),
        "w_out": ((di, d), ("state", "embed")),
        "conv_w": ((cfg.conv_width, di + 2 * g * n), ("conv", None)),
    }


def ssd_state_shapes(cfg: ModelConfig, batch: int) -> dict[str, tuple]:
    """name -> (shape, logical spec) of the decode state."""
    g, n = cfg.ssm_groups, cfg.ssm_state
    return {
        "ssm": ((batch, g, cfg.ssm_heads // g, cfg.ssm_headdim, n),
                ("batch", None, "heads", None, None)),
        "conv_buf": ((batch, cfg.conv_width - 1, cfg.d_inner + 2 * g * n),
                     ("batch", None, "state")),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., l) -> (..., l, l): seg[i, j] = sum_{j < k <= i} x[k]; -inf
    above the diagonal (masked before any exp, so no inf * 0)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def _ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, chunk: int):
    """Chunked SSD.  xdt (b,s,g,hg,p) is x pre-multiplied by dt; dA
    (b,s,g,hg) is dt*A (float32 log-decays); B, C (b,s,g,n).  Returns (y
    (b,s,g,hg,p), final_state (b,g,hg,p,n)), both float32."""
    b, s, g, hg, p = xdt.shape
    n = B.shape[-1]
    c = s // chunk
    xdt = xdt.reshape(b, c, chunk, g, hg, p).float()
    B = B.reshape(b, c, chunk, g, n).float()
    C = C.reshape(b, c, chunk, g, n).float()
    dA = dA.reshape(b, c, chunk, g, hg).permute(0, 3, 4, 1, 2)  # (b,g,hg,c,l)
    dA_cs = torch.cumsum(dA, dim=-1)

    # 1. intra-chunk (quadratic dual form)
    L = torch.exp(_segsum(dA))                                # (b,g,hg,c,l,l)
    y_diag = torch.einsum("bclgn,bcsgn,bghcls,bcsghp->bclghp", C, B, L, xdt)

    # 2. per-chunk terminal states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)         # (b,g,hg,c,l)
    states = torch.einsum("bclgn,bghcl,bclghp->bcghpn", B, decay_states, xdt)

    # 3. inter-chunk recurrence over the few chunks: the state before each
    chunk_decay = torch.exp(dA_cs[..., -1])                   # (b,g,hg,c)
    s_prev = torch.zeros((b, g, hg, p, n), dtype=states.dtype,
                         device=states.device)
    prev = []
    for i in range(c):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[..., i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                    # (b,c,g,hg,p,n)

    # 4. state -> output within each chunk
    y_off = torch.einsum("bclgn,bcghpn,bghcl->bclghp", C, prev_states,
                         torch.exp(dA_cs))
    return (y_diag + y_off).reshape(b, s, g, hg, p), s_prev


def _gated_norm_out(params: dict, y: torch.Tensor, z: torch.Tensor,
                    cfg: ModelConfig, dt: torch.dtype) -> torch.Tensor:
    """Gated RMSNorm, then the output projection (Mamba-2)."""
    y32 = (y * F.silu(z)).float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps)
         * (1.0 + params["norm_scale"].float())).to(dt)
    return y @ params["w_out"].to(dt)


def ssd_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              chunk: int = 128, return_state: bool = False):
    """Full-sequence Mamba-2 block.  x: (B, S, D_model).  Raises
    ``ValueError`` unless S is a multiple of ``min(chunk, S)``.

    With ``return_state`` also returns {ssm: (B,g,hg,P,N), conv_buf} in
    ``x``'s dtype (prefill)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"SSD needs the sequence length ({s}) to be a "
                         f"multiple of min(chunk, length) = {chunk}")
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    hg, di, dt = h // g, cfg.d_inner, x.dtype

    z = x @ params["w_z"].to(dt)
    xbc_raw = torch.cat([x @ params["w_x"].to(dt), x @ params["w_B"].to(dt),
                         x @ params["w_C"].to(dt)], dim=-1)
    xbc = F.silu(conv1d_causal(xbc_raw, params["conv_w"]))
    xs, Bp, Cp = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dtv = F.softplus((x @ params["w_dt"].to(dt)).float()
                     + params["dt_bias"].float())             # (b,s,h)
    A = -torch.exp(params["A_log"].float())                   # (h,)
    dA = (dtv * A).reshape(b, s, g, hg)

    xh = xs.reshape(b, s, g, hg, p)
    xdt = xh * dtv.reshape(b, s, g, hg)[..., None].to(dt)
    y, final_state = _ssd_scan(xdt, dA, Bp.reshape(b, s, g, n),
                               Cp.reshape(b, s, g, n), chunk)
    y = y + xh * params["D"].to(dt).reshape(g, hg)[None, None, :, :, None]
    out = _gated_norm_out(params, y.reshape(b, s, di), z, cfg, dt)
    if not return_state:
        return out
    return out, {"ssm": final_state.to(dt),
                 "conv_buf": _tail(xbc_raw, params["conv_w"].shape[0])}


def ssd_decode_step(params: dict, state: dict, x: torch.Tensor,
                    cfg: ModelConfig):
    """One-token update.  x (B, 1, D).  Returns (out (B, 1, D), new state),
    the state in the dtypes of ``state``'s tensors."""
    b = x.shape[0]
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    hg, di, dt = h // g, cfg.d_inner, x.dtype
    xt = x[:, 0]

    z = xt @ params["w_z"].to(dt)
    xbc = torch.cat([xt @ params["w_x"].to(dt), xt @ params["w_B"].to(dt),
                     xt @ params["w_C"].to(dt)], dim=-1)      # (b, conv_ch)
    hist = torch.cat([state["conv_buf"].to(dt), xbc[:, None]], dim=1)
    cw = params["conv_w"].shape[0]
    xbc = F.silu(torch.einsum("bwd,wd->bd", hist[:, -cw:],
                              params["conv_w"].to(dt)))
    xs, Bp, Cp = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dtv = F.softplus((xt @ params["w_dt"].to(dt)).float()
                     + params["dt_bias"].float())             # (b,h)
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dtv * A).reshape(b, g, hg)                 # decay

    xh = xs.reshape(b, g, hg, p)
    dx = xh * dtv.reshape(b, g, hg)[..., None].to(dt)
    ssm = (state["ssm"].float() * dA[..., None, None]
           + torch.einsum("bghp,bgn->bghpn", dx, Bp.reshape(b, g, n)).float())
    y = torch.einsum("bgn,bghpn->bghp", Cp.reshape(b, g, n), ssm.to(dt))
    y = y + xh * params["D"].to(dt).reshape(g, hg)[None, :, :, None]
    out = _gated_norm_out(params, y.reshape(b, di), z, cfg, dt)
    return out[:, None], {"ssm": ssm.to(state["ssm"].dtype),
                          "conv_buf": hist[:, 1:].to(state["conv_buf"].dtype)}
