"""The host tier's cells: ``repro_torch.fleet_serve_step`` in queue mode,
one call a slot.  Every alive node's window is clustered per channel and
quantized to a wire frame; the frames are stamped with a deadline ``slot +
qos_slots``, queued, and served in earliest-deadline microbatches through
the recovery cache, the cluster recovery and the host CNN.

The windows and the alive lane are a pool of ``pool_slots`` slots made in
set-up and cycled; the pool is many times the slots' worth of frames the
recovery cache holds, so no frame comes back while an equal one is
cached.  On the kept slots (one in ``keep_every``, from an offset drawn
from the seed) the served rows and the signatures the server keyed their
recovery with are copied out; after the window the plain reference
recomputes each served row from the raw window and replays the queue's
QoS over every slot.
"""
from __future__ import annotations

import torch

from perfbench.harness import pack, unpack
from perfbench.reference import host as href
from perfbench.roofline import model as roof
from perfbench.traffic import sensors

ROW_KEYS = ("node_id", "logits", "deadline", "valid")


class HostCell:
    kind = "host"
    slots_per_step = 1

    def __init__(self, ctx):
        from repro_torch.core.recovery import GeneratorParams
        from repro_torch.host import HostServeConfig, host_server_init
        from repro_torch.models.har import HARConfig

        self.ctx, cfg, mix, spec = ctx, ctx.config, ctx.mix, ctx.spec
        dev = self.dev = ctx.device
        self.n = ctx.nodes or cfg["nodes"]
        self.pool = mix["pool_slots"]
        g = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.windows = sensors.node_streams(
            g, cfg["family"], cfg, self.n, self.pool,
            cfg["stream_dwell"]).transpose(0, 1).contiguous()  # (P, N, T, C)
        self.alive = sensors.alive_traces(
            g, self.n, self.pool, mix["duty"], mix["period"],
            mix["p_glitch"]).T.contiguous()                  # (P, N)
        self.weights = sensors.cnn_weights(g, cfg)
        self.gen = sensors.generator_weights(g, cfg)
        self.serve_cfg = HostServeConfig(
            channels=cfg["channels"], k=cfg["k"], m=cfg["m"],
            t=cfg["window"], n_classes=cfg["n_classes"], n_nodes=self.n,
            **{k: spec[k] for k in ("batch_size", "queue_capacity",
                                    "cache_capacity", "qos_slots",
                                    "telemetry")})
        self.kwargs = dict(
            host_params=self.weights, gen_params=GeneratorParams(*self.gen),
            har_cfg=HARConfig(**{k: cfg[k] for k in (
                "window", "channels", "n_classes", "conv1", "conv2",
                "kernel", "hidden")}),
            k=cfg["k"], serve_cfg=self.serve_cfg, device=dev)
        self.state = host_server_init(self.serve_cfg, dev)
        self.keep_every = spec["keep_every"]
        self.offset = ctx.seed % self.keep_every
        self.steps, self.wire_bytes = 0, 0
        self.kept, self.layout, self.totals = [], None, None

    # --- the timed path ----------------------------------------------------

    def step(self) -> None:
        import repro_torch
        from repro_torch.host.server import counter_noise
        p = self.steps % self.pool
        keep = self.steps % self.keep_every == self.offset
        sigs = []
        cfg = self.serve_cfg

        def noise_fn(s):
            if keep:
                sigs.append(s)
            return counter_noise(s, seed=self.ctx.seed, channels=cfg.channels,
                                 t=cfg.t)

        res = repro_torch.fleet_serve_step(
            self.windows[p], host_state=self.state,
            engine_alive=self.alive[p], noise_fn=noise_fn, **self.kwargs)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.state = res["host_state"]
        self.wire_bytes += res["wire_bytes"]
        if keep:
            out = res["slot_output"]
            parts = {k: getattr(out, k) for k in ROW_KEYS}
            parts["sigs"] = torch.cat(sigs)
            self.layout, flat = pack(parts)
            self.kept.append((self.steps, flat))
        self.steps += 1

    # --- what the metrics read ----------------------------------------------

    @property
    def work_per_step(self) -> int:
        return self.n

    def layer_span(self) -> str:
        return "serving.edge_host.fleet_serve_step"

    def model_flops(self) -> float:
        """Useful model FLOPs so far: the host CNN on every served frame."""
        return int(self.state.served) * roof.cnn_flops(self.ctx.config)

    def kernel_calls(self, steps: int) -> dict:
        cfg = self.ctx.config
        call = roof.kmeans_coreset(self.n * cfg["channels"], cfg["window"],
                                   2, cfg["k"], cfg["kmeans_iters"])
        return {"kmeans_coreset": [tuple(x * steps for x in call)]}

    # --- correctness --------------------------------------------------------

    def release(self) -> None:
        """Read the QoS totals, then free the server's state."""
        st = self.state
        self.totals = {"served": int(st.served),
                       "misses": int(st.deadline_misses),
                       "drops": int(st.queue.drops_overflow),
                       "wire_bytes": self.wire_bytes}
        self.state = None

    def _slot_windows(self, step: int, nodes: torch.Tensor) -> torch.Tensor:
        return self.windows[step % self.pool][nodes]

    def check(self, control: bool = False) -> dict:
        """``qos_off``: the served, missed and dropped totals and the wire
        bytes against the reference queue's, plus, on every kept slot, the
        served rows whose node or deadline the reference does not give.
        ``key_off``: the share of served rows whose recovery key is not the
        signature of the reference's own frame (the k-means kernel's centre
        sums, in another order than the plain ones, move a 16-bit code by
        one on about a fifth of the frames).  ``logit_gap_p99``: the 99th
        percentile over the served rows of the widest gap of a row's
        logits, as a share of the reference row's largest magnitude; the
        reference recovers each row from its own frame with the noise the
        row's key draws.  ``logit_gap`` is the largest of those gaps and
        ``logit_gap_same_key`` the largest on rows whose key is the
        reference's own."""
        cfg, spec = self.ctx.config, self.ctx.spec
        qos, c, k, t = spec["qos_slots"], cfg["channels"], cfg["k"], cfg["window"]
        bq = spec["batch_size"]
        batches = -(-self.n // bq)
        alive = self.alive.cpu().numpy()
        trace = alive[[j % self.pool for j in range(self.steps)]]
        served, totals = href.edf_slots(trace, spec["queue_capacity"], bq,
                                        batches, qos)
        totals["wire_bytes"] = int(trace.sum()) * c * (5 * k + k)
        got_totals = totals if control else self.totals
        qos_off = sum(abs(got_totals[x] - totals[x]) for x in totals)
        rows = key_off = 0
        gaps, same = [], []
        seed = self.ctx.seed
        for step, flat in self.kept:
            want_nodes = torch.tensor(sorted(served[step]), dtype=torch.int64)
            if control:
                nodes = want_nodes.to(self.dev)
                win = self._slot_windows(step, nodes)
                frame = href.wire_frame(win, k, cfg["kmeans_iters"], True)
                sigs = href.signatures(frame, cfg["m"])
                logits = href.serve_logits(frame, sigs, self.weights, seed, t,
                                           True)
            else:
                r = unpack(flat.to(self.dev), self.layout)
                v = r["valid"]
                nodes, sigs, logits = (r["node_id"][v].long(), r["sigs"][v],
                                       r["logits"][v])
                qos_off += int((r["deadline"][v] != step + qos).sum())
                order = torch.argsort(nodes)
                nodes, sigs, logits = nodes[order], sigs[order], logits[order]
                win = self._slot_windows(step, nodes)
            if nodes.shape != want_nodes.shape or not torch.equal(
                    nodes.cpu(), want_nodes):
                qos_off += len(set(nodes.tolist()) ^ set(want_nodes.tolist()))
                continue
            frame = href.wire_frame(win, k, cfg["kmeans_iters"])
            match = (href.signatures(frame, cfg["m"]) == sigs).all(-1)
            key_off += int((~match).sum())
            want = href.serve_logits(frame, sigs, self.weights, seed, t)
            gaps.append((logits - want).abs().amax(-1)
                        / want.abs().amax(-1).clamp(min=1e-6))
            same.append(gaps[-1][match])
            rows += nodes.shape[0]
        gap = torch.cat(gaps) if gaps else torch.zeros(1, device=self.dev)
        same = torch.cat(same) if same else torch.zeros(1, device=self.dev)
        return {"qos_off": qos_off, "key_off": key_off / max(rows, 1),
                "logit_gap_p99": float(torch.quantile(gap.float(), 0.99)),
                "logit_gap": float(gap.max()),
                "logit_off_share": float((gap > 1e-3).float().mean()),
                "logit_gap_same_key": (float(same.max()) if same.numel()
                                       else 0.0),
                "rows": rows, "kept_slots": len(self.kept),
                "served": totals["served"]}


def setup(ctx):
    return HostCell(ctx)

