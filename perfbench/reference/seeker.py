"""Plain reference of one Seeker fleet slot and of the host's cluster
recovery, in float32 PyTorch, written out from the paper's decision flow
(Fig. 8) and the port's documented semantics.

It imports nothing of the program.  Every kernel of the program is a plain
expression here: the Pearson correlation as centred sums, the quantizer as
``clamp(round(x / s)) * s``, k-means as Lloyd's iterations with a strided
init, the counter hash as int64 arithmetic.  Frozen copies of the port's
plain paths (``kernels/ref.py``, ``core/coreset.py``, ``core/recovery.py``,
``core/counter_hash.py``, ``core/decision.py``, ``core/energy.py``) serve
where the semantics are the port's own choice (strided init, keyed noise
layout, interpolation guards).

``tf32=True`` computes every product of a convolution, a dense layer and
the sums of the correlation and of k-means with operands rounded to TF32
(10 mantissa bits, round to nearest even): the control, one precision below
the float32 the configurations state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
KEY_SALTS = (0x243F6A88, 0x85A308D3)
ROW_SALT = 0x13198A2E
HOST_SALT = 0x3C6EF372
LATENT = 16
D0_MEMO, D2_DNN_QUANT, D3_CLUSTER, D4_SAMPLING, DEFER = 0, 2, 3, 4, 5
SUPERCAP_CAP_UJ, SUPERCAP_CHARGE_EFF = 200.0, 0.8


# --- precision ---------------------------------------------------------

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _op(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return to_tf32(x) if tf32 else x


# --- counter hash ------------------------------------------------------

def mul32(a, b):
    return (a * b) & MASK32


def fmix32(h):
    """MurmurHash3's 32-bit finalizer on int64 words in [0, 2**32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def counter_words(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) words: element e of row b hashes (keys[b], e)."""
    e = torch.arange(1, n + 1, dtype=torch.int64, device=keys.device)
    return fmix32(keys[:, None] ^ mul32(e, 0x9E3779B1))


def word_uniforms(h: torch.Tensor) -> torch.Tensor:
    return ((h >> 8) + 1).to(torch.float32) * (2.0 ** -24)


def box_muller(u1, u2):
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def node_keys(seed: int, n: int, device) -> torch.Tensor:
    """(n, 2) per-node keys hashed from (seed, node index)."""
    lo = fmix32((seed & MASK32) ^ KEY_SALTS[0])
    hi = fmix32(((seed >> 32) & MASK32) ^ KEY_SALTS[1])
    e = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    k0 = fmix32(mul32(e, 0x9E3779B1) ^ lo)
    return torch.stack([k0, fmix32(k0 ^ hi)], dim=1)


def slot_noise(keys: torch.Tensor, t: int, c: int):
    """One slot's noise of each node from its own key, and the advanced
    keys: Gumbel uniforms u (N, T), ball directions (N, C, T, 2), radii
    (N, C, T, 1), generator latent (N, 16)."""
    n = keys.shape[0]
    n_dir, n_rad = c * t * 2, c * t
    n_norm = n_dir + LATENT
    row = fmix32(fmix32(keys[:, 0] ^ ROW_SALT) ^ keys[:, 1])
    h = counter_words(row, t + 2 * n_norm + n_rad + 2)
    u = word_uniforms(h[:, :-2])
    ug, u1 = u[:, :t], u[:, t:t + n_norm]
    u2, ur = u[:, t + n_norm:t + 2 * n_norm], u[:, t + 2 * n_norm:]
    z = box_muller(u1, u2)
    return ({"u": torch.clamp(1.0 - ug, min=1e-9),
             "dirs": z[:, :n_dir].reshape(n, c, t, 2),
             "radii_u": (1.0 - ur).reshape(n, c, t, 1),
             "latent": z[:, n_dir:]}, h[:, -2:])


# --- the sensor's blocks ------------------------------------------------

def correlate(win: torch.Tensor, sig: torch.Tensor, tf32: bool = False):
    """Mean over channels of the Pearson correlation of each window with
    each signature: (B, T, C) x (L, T, C) -> (B, L)."""
    wm = win - win.mean(dim=1, keepdim=True)
    sm = sig - sig.mean(dim=1, keepdim=True)
    num = torch.einsum("btc,ltc->blc", _op(wm, tf32), _op(sm, tf32))
    wn = torch.sqrt((wm * wm).sum(dim=1))
    sn = torch.sqrt((sm * sm).sum(dim=1))
    den = wn[:, None, :] * sn[None, :, :]
    return (num / torch.clamp(den, min=1e-9)).mean(dim=-1)


def quant_scale(x2d: torch.Tensor, bits: int, rows_per_group: int):
    qmax = 2.0 ** (bits - 1) - 1.0
    amax = x2d.abs().reshape(-1, rows_per_group * x2d.shape[1]).amax(dim=1)
    rq = float(torch.tensor(1.0, dtype=torch.float32)
               / torch.tensor(qmax, dtype=torch.float32))
    return torch.clamp(amax, min=1e-9) * rq


def fake_quant(x: torch.Tensor, bits: int, per_sample: bool) -> torch.Tensor:
    """Symmetric quantize-dequantize: one scale for the tensor, or one per
    leading index (each node's activation its own)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    x2d = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
    rows = x2d.shape[0] // x.shape[0] if per_sample else x2d.shape[0]
    s = quant_scale(x2d, bits, rows).repeat_interleave(rows)[:, None]
    return (torch.clamp(torch.round(x2d / s), -qmax, qmax) * s).reshape(x.shape)


def conv_same(x, w, b, tf32: bool = False):
    """(B, T, Cin) * (K, Cin, Cout) -> (B, T, Cout), zero 'same' padding."""
    k = w.shape[0]
    lo = (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (lo, k - 1 - lo))
    out = F.conv1d(_op(xt, tf32), _op(w.permute(2, 1, 0), tf32)) + b[:, None]
    return out.transpose(1, 2)


def pool2(x):
    b, t, c = x.shape
    return x.reshape(b, t // 2, 2, c).amax(dim=2)


def dense(x, w, b, tf32: bool = False):
    return _op(x, tf32) @ _op(w, tf32) + b


def cnn(params: dict, x: torch.Tensor, tf32: bool = False, quant=None):
    """The HAR CNN: conv-relu-pool twice, dense-relu, head.  ``quant`` (a
    function) fake-quantizes the input and both pooled activations."""
    q = quant or (lambda h: h)
    h = pool2(torch.relu(conv_same(q(x), params["conv1_w"],
                                   params["conv1_b"], tf32)))
    h = pool2(torch.relu(conv_same(q(h), params["conv2_w"],
                                   params["conv2_b"], tf32)))
    h = q(h).reshape(h.shape[0], -1)
    h = torch.relu(dense(h, params["dense_w"], params["dense_b"], tf32))
    return dense(h, params["head_w"], params["head_b"], tf32)


def quantize_weights(params: dict, bits: int) -> dict:
    return {k: fake_quant(v, bits, False) if v.ndim >= 2 else v
            for k, v in params.items()}


def unit_grid(t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.float32, device=device) / (t - 1)


def channel_points(win: torch.Tensor) -> torch.Tensor:
    """(B, T, C) windows -> (B*C, T, 2) clouds of (time scaled by the
    channel's peak-to-peak range, value)."""
    b, t, c = win.shape
    cols = win.transpose(1, 2)[..., None]                       # (B, C, T, 1)
    ptp = cols.amax(dim=(-2, -1)) - cols.amin(dim=(-2, -1))
    tc = unit_grid(t, win.device) * torch.clamp(ptp, min=1e-6)[..., None]
    return torch.cat([tc[..., None], cols], dim=-1).reshape(b * c, t, 2)


def kmeans(points: torch.Tensor, k: int, iters: int, tf32: bool = False):
    """Lloyd's k-means from the strided init ``(i * N) // k``, a fixed
    iteration budget, ties to the lower index; an empty cluster keeps its
    centre.  (B, N, D) -> centres (B, k, D), radii (B, k), counts (B, k)."""
    n = points.shape[1]
    centers = points[:, (torch.arange(k, device=points.device) * n) // k, :]
    for _ in range(iters + 1):
        d2 = ((points[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
        assign = torch.argmin(d2, dim=-1)
        onehot = F.one_hot(assign, k).to(points.dtype)
        counts = onehot.sum(dim=1)
        if _ == iters:
            break
        sums = torch.einsum("bnk,bnd->bkd", _op(onehot, tf32),
                            _op(points, tf32))
        centers = torch.where(counts[..., None] > 0,
                              sums / torch.clamp(counts[..., None], min=1.0),
                              centers)
    dist = torch.sqrt(torch.gather(d2, -1, assign[..., None])[..., 0])
    radii = (onehot * dist[..., None]).amax(dim=1)
    return centers, radii, counts.to(torch.int32)


def _median_flat(x):
    flat = torch.sort(x.flatten(-2), dim=-1).values
    n = flat.shape[-1]
    return (flat[..., (n - 1) // 2] + flat[..., n // 2]) * 0.5


def importance_sample(win: torch.Tensor, m: int, u: torch.Tensor,
                      spread: float = 0.25):
    """Gumbel-top-m sampling by detrended magnitude plus the dominant
    spectral bands' envelope: indices (B, m), values (B, m, C), mean and
    variance (B, C)."""
    t = win.shape[-2]
    detr = win - win.mean(dim=-2, keepdim=True)
    mag = detr.abs().sum(dim=-1)
    spec = torch.fft.rfft(detr, dim=-2).abs()
    med = _median_flat(spec)[..., None, None]
    masked = spec * (spec > med).to(spec.dtype)
    env = torch.fft.irfft(masked.to(torch.complex64), n=t,
                          dim=-2).abs().sum(dim=-1)
    w = mag + env
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    w = (1.0 - spread) * w + spread * torch.full((t,), 1.0 / t,
                                                 device=win.device)
    scores = torch.log(torch.clamp(w, min=1e-12)) - torch.log(-torch.log(u))
    idx = torch.sort(torch.topk(scores, m, dim=-1).indices, dim=-1).values
    vals = win.gather(-2, idx[..., None].expand(idx.shape + win.shape[-1:]))
    mean = win.mean(dim=-2)
    var = ((win - win.mean(dim=-2, keepdim=True)) ** 2).mean(dim=-2)
    return idx, vals, mean, var


# --- the host's recoveries ----------------------------------------------

def _interp(x, xp, fp):
    """``numpy.interp`` of a shared grid ``x`` on batched ``xp``/``fp``."""
    p = xp.shape[-1]
    xq = x.expand(xp.shape[:-1] + x.shape).contiguous()
    i = torch.clamp(torch.searchsorted(xp.contiguous(), xq, right=True),
                    1, p - 1)
    xp_lo, xp_hi = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp_lo, fp_hi = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = xp_hi - xp_lo
    dx0 = dx.abs() <= 2.0 ** -46          # float32's spacing at its eps
    f = torch.where(dx0, fp_lo, fp_lo + ((xq - xp_lo) / torch.where(
        dx0, torch.ones_like(dx), dx)) * (fp_hi - fp_lo))
    f = torch.where(xq < xp[..., :1], fp[..., :1], f)
    return torch.where(xq > xp[..., -1:], fp[..., -1:], f)


def recover_cluster(centers, radii, counts, dirs, radii_u, t: int):
    """Per-channel cluster coresets (B, C, k, 2) -> (B, T, C) windows: T
    points spread over the clusters by their counts, uniform in each
    cluster's ball, sorted by time and interpolated onto the grid."""
    k = centers.shape[-2]
    cnt = counts.to(torch.int64)
    total = torch.clamp(cnt.sum(dim=-1, keepdim=True), min=1)
    cum = torch.cumsum(cnt, dim=-1)
    slots = torch.arange(t, device=cnt.device)
    which = torch.clamp(torch.searchsorted(
        cum.contiguous(), ((slots * total) // t).contiguous(), right=True),
        0, k - 1)
    norm = torch.sqrt((dirs * dirs).sum(dim=-1, keepdim=True))
    offs = dirs / torch.clamp(norm, min=1e-9) * radii_u
    ctr = centers.gather(-2, which[..., None].expand(which.shape + (2,)))
    pts = ctr + offs * radii.gather(-1, which)[..., None]
    order = torch.argsort(pts[..., 0], dim=-1, stable=True)
    pts = pts.gather(-2, order[..., None].expand(pts.shape))
    tc = pts[..., 0]
    src = (tc - tc[..., :1]) / torch.clamp(tc[..., -1:] - tc[..., :1],
                                           min=1e-9)
    col = _interp(unit_grid(t, pts.device), src, pts[..., 1])   # (B, C, T)
    return col.transpose(-1, -2)


def recover_sampling(gen: tuple, idx, vals, mean, var, latent, t: int,
                     tf32: bool = False):
    """The generator's window from (latent, mean, std), with the sent
    samples written back at their indices."""
    w1, b1, w2, b2, w3, b3 = gen
    h = torch.cat([latent, mean, torch.sqrt(torch.clamp(var, min=0.0))], -1)
    h = torch.tanh(dense(h, w1, b1, tf32))
    h = torch.tanh(dense(h, w2, b2, tf32))
    out = dense(h, w3, b3, tf32)
    synth = out.reshape(out.shape[:-1] + (t, mean.shape[-1]))
    return synth.scatter(-2, idx[..., None].expand(vals.shape), vals)


# --- the slot -------------------------------------------------------------

def decision_costs(c: dict) -> torch.Tensor:
    """(6,) µJ of D0..D4 and DEFER (paper Table 2)."""
    return torch.tensor([
        c["sense"] + c["tx_result"], c["dnn_full"] + c["tx_result"],
        c["dnn16"] + c["tx_result"],
        c["sense"] + c["coreset_cluster"] + c["tx_coreset"],
        c["sense"] + c["coreset_sampling"] + c["tx_coreset"], c["sense"]],
        dtype=torch.float32)


def node_slot(state: dict, win, harv, noise, model: dict, knobs: dict,
              tf32: bool = False):
    """One slot of B running nodes.  ``state``: stored (B,), history
    (B, W), pos (B,), prev (B,).  Returns the new state and the node's
    decision, payload bytes, label (-1 when none), host logits, and
    ``tie``: whether the slot's outcome hung on a margin float32 rounding
    decides (the best correlation within 1e-5 of the memo threshold, or,
    for the label it kept, the two best correlations within 1e-5 or the
    edge CNN's two best logits within 1e-4 of its largest)."""
    b, t, c = win.shape
    strict = knobs["brownout"] is not None
    corr = correlate(win, model["signatures"], tf32)
    max_corr = corr.amax(dim=-1)
    memo_label = torch.argmax(corr, dim=-1)
    w = state["history"].shape[-1]
    rows = torch.arange(b, device=win.device)
    history = state["history"].index_put((rows, (state["pos"] % w).long()),
                                         harv)
    pos = state["pos"] + 1
    forecast = history.sum(dim=-1) / torch.clamp(
        torch.clamp(pos, max=w).to(torch.float32), min=1.0)
    budget = state["stored"] + (harv if strict else forecast)
    cost = decision_costs(knobs["costs"]).to(win.device)
    memo_hit = max_corr >= knobs["corr_threshold"]
    if strict:
        memo_hit = memo_hit & (budget >= cost[D0_MEMO])
    offload = torch.where(budget >= cost[D3_CLUSTER], D3_CLUSTER,
                          torch.where(budget >= cost[D4_SAMPLING],
                                      D4_SAMPLING, DEFER))
    local = torch.where(budget >= cost[D2_DNN_QUANT], D2_DNN_QUANT, offload)
    decision = torch.where(memo_hit, D0_MEMO, local)
    spend = cost[decision]
    if strict:
        spend = torch.where(budget >= spend, spend, torch.zeros_like(spend))
        direct = torch.minimum(spend, harv)
        stored = torch.clamp(state["stored"] + SUPERCAP_CHARGE_EFF
                             * (harv - direct) - (spend - direct),
                             0.0, SUPERCAP_CAP_UJ)
    else:
        stored = torch.clamp(state["stored"] + SUPERCAP_CHARGE_EFF * harv
                             - spend, 0.0, SUPERCAP_CAP_UJ)

    bits = knobs["quant_bits"]
    edge = cnn(model["qweights"], win, tf32,
               quant=lambda h: fake_quant(h, bits, True))
    dnn_label = torch.argmax(edge, dim=-1)
    k = knobs["k"]
    centers, radii, counts = kmeans(channel_points(win), k,
                                    knobs["kmeans_iters"], tf32)
    centers = centers.reshape(b, c, k, 2)
    radii, counts = radii.reshape(b, c, k), counts.reshape(b, c, k)
    idx, vals, mean, var = importance_sample(win, knobs["m"], noise["u"])

    samp_bytes = knobs["m"] * (1 + 2 * c) + 4 * c
    table = torch.tensor([2.0, 2.0, 2.0, 0.0, float(samp_bytes), 0.0],
                         device=win.device)
    payload = torch.where(decision == D3_CLUSTER,
                          float((k * 3 + math.ceil(k / 2)) * c),
                          table[decision])
    label = torch.where(decision == D0_MEMO, memo_label,
                        torch.where(decision == D2_DNN_QUANT, dnn_label, -1))
    prev = torch.where(label >= 0, label, state["prev"])

    host = model["host_weights"]
    logit_c = cnn(host, recover_cluster(centers, radii, counts, noise["dirs"],
                                        noise["radii_u"], t), tf32)
    logit_s = cnn(host, recover_sampling(model["gen"], idx, vals, mean, var,
                                         noise["latent"], t, tf32), tf32)
    onehot = F.one_hot(label.clamp(min=0), logit_c.shape[-1]).to(
        torch.float32) * (label >= 0)[:, None] * 8.0
    dec = decision[:, None]
    logits = torch.where(dec == D3_CLUSTER, logit_c,
                         torch.where(dec == D4_SAMPLING, logit_s,
                                     torch.where(dec == DEFER, 0.0, onehot)))
    new = {"stored": stored, "history": history, "pos": pos, "prev": prev}
    top_c = torch.topk(corr, 2, dim=-1).values
    top_e = torch.topk(edge, 2, dim=-1).values
    tie = (((max_corr - knobs["corr_threshold"]).abs() < 1e-5)
           | ((decision == D0_MEMO) & (top_c[:, 0] - top_c[:, 1] < 1e-5))
           | ((decision == D2_DNN_QUANT) & (top_e[:, 0] - top_e[:, 1]
                                            < 1e-4 * edge.abs().amax(-1))))
    return new, {"tie": tie, "decisions": decision, "payload_bytes": payload,
                 "label": label, "logits": logits}


def replay(start: dict, windows, harvest, model: dict, knobs: dict,
           tf32: bool = False):
    """Run B independent nodes through S slots from ``start`` (stored,
    history, pos, prev, keys (B, 2), browned (B,)).  A node browned out
    freezes its state and keys, trickle-charges, and emits DEFER, zero
    bytes and zero logits.  Returns (S, B, ...) traces and the end state."""
    bo = knobs["brownout"]
    state = {k: start[k] for k in ("stored", "history", "pos", "prev")}
    keys, browned = start["keys"], start["browned"]
    t, c = windows.shape[-2:]
    out = []
    for si in range(windows.shape[1]):
        harv = harvest[:, si]
        run = ~browned
        noise, next_keys = slot_noise(keys, t, c)
        new, tr = node_slot(state, windows[:, si], harv, noise, model, knobs,
                            tf32)
        for f in ("history", "pos", "prev"):
            r = run.reshape((-1,) + (1,) * (new[f].ndim - 1))
            new[f] = torch.where(r, new[f], state[f])
        keys = torch.where(run[:, None], next_keys, keys)
        if bo is not None:
            trickle = torch.clamp(state["stored"] + SUPERCAP_CHARGE_EFF * harv,
                                  0.0, SUPERCAP_CAP_UJ)
            new["stored"] = torch.where(run, new["stored"], trickle)
            nxt = torch.where(browned, new["stored"] < bo["restart_uj"],
                              new["stored"] < bo["off_uj"])
        else:
            nxt = browned
        out.append({
            "decisions": torch.where(run, tr["decisions"], DEFER),
            "payload_bytes": torch.where(run, tr["payload_bytes"], 0.0),
            "stored_uj": new["stored"],
            "label": torch.where(run, tr["label"], -1),
            "logits": torch.where(run[:, None], tr["logits"], 0.0),
            "alive": run, "brownout": browned, "tie": run & tr["tie"]})
        state, browned = new, nxt
    traces = {k: torch.stack([o[k] for o in out]) for k in out[0]}
    return traces, dict(state, keys=keys, browned=browned)
