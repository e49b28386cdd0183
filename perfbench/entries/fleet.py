"""The fleet engine's cells: ``repro_torch.seeker_fleet_simulate`` driven
in steps of ``slots_per_step`` slots, each step resuming the last one's
node state, noise keys and brown-out flags, over per-node window streams
and harvest traces drawn from the seed.

The windows and the harvest are a pool of ``pool_slots`` slots made in
set-up and cycled; the fleet path keeps no cache that could reuse them,
and every slot draws new noise from the nodes' keys.  After the window the
plain reference replays every step of a sample of nodes, each from the
state the program handed to that step (the first from the reference's own
initial state), and the program's traces and end states are held to it.
"""
from __future__ import annotations

import torch

from perfbench.harness import pack, unpack
from perfbench.reference import seeker as ref
from perfbench.roofline import model as roof
from perfbench.traffic import sensors

TRACE_KEYS = ("decisions", "payload_bytes", "stored_uj", "logits", "alive",
              "brownout")
END_KEYS = ("stored", "history", "pos", "prev", "keys", "browned")


class FleetCell:
    kind = "fleet"

    def __init__(self, ctx):
        import repro_torch  # noqa: F401  (the program, loaded with its cell)
        from repro_torch.core.energy import BrownoutConfig, EnergyCosts
        from repro_torch.core.recovery import GeneratorParams
        from repro_torch.models.har import HARConfig

        self.ctx, cfg, mix = ctx, ctx.config, ctx.mix
        dev = self.dev = ctx.device
        self.n = ctx.nodes or cfg["nodes"]
        self.s = self.slots_per_step = ctx.spec["slots_per_step"]
        self.pool = mix["pool_slots"]
        if self.pool % self.s:
            raise ValueError("pool_slots must be a multiple of slots_per_step")
        g = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.windows = sensors.node_streams(g, cfg["family"], cfg, self.n,
                                            self.pool, cfg["stream_dwell"])
        self.harvest = (sensors.harvest_traces(g, self.n, self.pool,
                                               mix["harvest_sources"])
                        * mix["harvest_scale"])
        self.weights = sensors.cnn_weights(g, cfg)
        self.gen = sensors.generator_weights(g, cfg)
        self.signatures = sensors.signature_bank(cfg["family"], cfg, dev)
        self.keys0 = ref.node_keys(ctx.seed, self.n, dev)
        bo = mix.get("brownout")
        self.brownout = bo
        self.kwargs = dict(
            signatures=self.signatures, qdnn_params=self.weights,
            host_params=self.weights, gen_params=GeneratorParams(*self.gen),
            har_cfg=HARConfig(**{k: cfg[k] for k in (
                "window", "channels", "n_classes", "conv1", "conv2",
                "kernel", "hidden")}),
            costs=EnergyCosts(**cfg["costs"]), quant_bits=cfg["quant_bits"],
            k_max=cfg["k"], m_samples=cfg["m"],
            corr_threshold=cfg["corr_threshold"],
            predictor_window=cfg["predictor_window"],
            initial_uj=mix["initial_uj"],
            brownout=None if bo is None else BrownoutConfig(**bo),
            device=dev)
        pick = torch.Generator().manual_seed(ctx.seed)
        k = min(ctx.spec["check_nodes"], self.n)
        self.sample = torch.sort(torch.randperm(self.n, generator=pick)[:k]
                                 ).values.to(dev)
        self.state = self.keys = self.browned = None
        self.steps = 0
        self.kept, self.layout = [], None
        self.hist = torch.zeros(6, dtype=torch.int64, device=dev)

    # --- the timed path ----------------------------------------------------

    def step(self) -> None:
        import repro_torch
        s0 = (self.steps * self.s) % self.pool
        res = repro_torch.seeker_fleet_simulate(
            self.windows[:, s0:s0 + self.s], self.harvest[:, s0:s0 + self.s],
            node_keys=self.keys0 if self.keys is None else self.keys,
            state0=self.state, brownout_state0=self.browned, **self.kwargs)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.state, self.keys = res["final_state"], res["final_keys"]
        self.browned = res["final_brownout"]
        self.steps += 1
        self._keep(res)

    def _keep(self, res) -> None:
        """The sampled nodes' traces and end state of this step, packed and
        copied to the host (the step has already synchronised), so the kept
        record takes no device memory; and the fleet's decision counts,
        kept on the device."""
        i = self.sample
        st = res["final_state"]
        parts = {**{k: res[k][:, i] for k in TRACE_KEYS},
                 "stored": st.stored_uj[i], "history": st.predictor.history[i],
                 "pos": st.predictor.pos[i], "prev": st.prev_label[i],
                 "keys": res["final_keys"][i],
                 "browned": res["final_brownout"][i]}
        self.layout, flat = pack(parts)
        self.kept.append(flat)
        self.hist += res["decision_histogram"][:6].to(torch.int64)

    # --- what the metrics read ----------------------------------------------

    @property
    def work_per_step(self) -> int:
        return self.n * self.s

    def layer_span(self) -> str:
        return "serving.fleet.seeker_fleet_simulate"

    def model_flops(self) -> float:
        """Useful model FLOPs of every step so far: the edge CNN on the
        node-slots that ran D2, the host's cluster recovery into the host
        CNN on D3, the generator and the host CNN on D4."""
        h = self.hist.tolist()
        cfg = self.ctx.config
        cnn, gen = roof.cnn_flops(cfg), roof.generator_flops(cfg)
        return h[2] * cnn + h[3] * cnn + h[4] * (gen + cnn)

    def kernel_calls(self, steps: int) -> dict:
        """(bytes, FLOPs) of every hand-kernel launch ``steps`` steps make."""
        cfg, n, s = self.ctx.config, self.n, self.s
        t, c = cfg["window"], cfg["channels"]
        l = self.signatures.shape[0]
        k = cfg["k"]
        acts = n * (t * c + (t // 2) * cfg["conv1"] + (t // 4) * cfg["conv2"])
        weights = [cfg["kernel"] * c * cfg["conv1"],
                   cfg["kernel"] * cfg["conv1"] * cfg["conv2"],
                   (t // 4) * cfg["conv2"] * cfg["hidden"],
                   cfg["hidden"] * cfg["n_classes"]]
        per_step = {
            "signature_corr": [roof.signature_corr(n, l, t, c)] * s,
            "kmeans_coreset": [roof.kmeans_coreset(
                n * c, t, 2, k, cfg["kmeans_iters"])] * s,
            "fake_quant": ([roof.fake_quant(w) for w in weights]
                           + [roof.fake_quant(acts)] * s),
        }
        return {name: [tuple(x * steps for x in call) for call in calls]
                for name, calls in per_step.items()}

    # --- correctness --------------------------------------------------------

    def _start(self, knobs: dict) -> dict:
        """The reference's own state entering step 0 for the sample."""
        k = self.sample.shape[0]
        dev, w = self.dev, self.ctx.config["predictor_window"]
        stored = torch.full((k,), float(self.ctx.mix["initial_uj"]),
                            device=dev)
        bo = knobs["brownout"]
        return {"stored": stored,
                "history": torch.zeros((k, w), device=dev),
                "pos": torch.zeros((k,), dtype=torch.int64, device=dev),
                "prev": torch.zeros((k,), dtype=torch.int64, device=dev),
                "keys": ref.node_keys(self.ctx.seed, self.n, dev)[self.sample],
                "browned": (stored < bo["off_uj"]) if bo is not None
                else torch.zeros((k,), dtype=torch.bool, device=dev)}

    def knobs(self) -> dict:
        cfg = self.ctx.config
        return {"brownout": self.brownout, "costs": cfg["costs"],
                "corr_threshold": cfg["corr_threshold"],
                "quant_bits": cfg["quant_bits"], "k": cfg["k"], "m": cfg["m"],
                "kmeans_iters": cfg["kmeans_iters"]}

    def model(self) -> dict:
        return {"signatures": self.signatures,
                "qweights": ref.quantize_weights(self.weights,
                                                 self.ctx.config["quant_bits"]),
                "host_weights": self.weights, "gen": self.gen}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.keys = self.browned = None

    def reference(self, tf32: bool = False, block: int = 2048):
        """Replay every kept step of the sampled nodes; returns the
        reference's traces and end states stacked like the program's
        (steps, S, K, ...) and (steps, K, ...)."""
        knobs, model = self.knobs(), self.model()
        j, k = len(self.kept), self.sample.shape[0]
        first = self._start(knobs)
        _, ends = self.program()
        starts = {f: torch.cat([first[f][None].to(ends[f].dtype), ends[f][:-1]])
                  for f in first}                           # (J, K, ...)
        slots = (torch.arange(j, device=self.dev)[:, None] * self.s
                 + torch.arange(self.s, device=self.dev)) % self.pool
        flat = {f: v.reshape((j * k,) + v.shape[2:]) for f, v in starts.items()}
        flat["pos"], flat["prev"] = flat["pos"].long(), flat["prev"].long()
        node = self.sample.repeat(j)                           # (J*K,)
        slot = slots.repeat_interleave(k, dim=0)               # (J*K, S)
        outs, ends = [], []
        for lo in range(0, j * k, block):
            sl = slice(lo, min(j * k, lo + block))
            win = self.windows[node[sl, None], slot[sl]]       # (B, S, T, C)
            harv = self.harvest[node[sl, None], slot[sl]]
            tr, end = ref.replay({f: v[sl] for f, v in flat.items()}, win,
                                 harv, model, knobs, tf32)
            outs.append(tr)
            ends.append(end)
        traces = {f: torch.cat([o[f] for o in outs], dim=1).reshape(
            (self.s, j, k) + outs[0][f].shape[2:]).transpose(0, 1)
            for f in outs[0]}
        end = {f: torch.cat([e[f] for e in ends]).reshape(
            (j, k) + ends[0][f].shape[1:]) for f in ends[0]}
        return traces, end

    def program(self):
        """The program's kept traces (J, S, K, ...) and end states (J, K,
        ...), unpacked onto the device."""
        out = unpack(torch.stack(self.kept).to(self.dev), self.layout)
        return ({f: out[f] for f in TRACE_KEYS},
                {f: out[f] for f in END_KEYS})

    def compare(self, got, want) -> dict:
        """``mismatch_share``: node-steps whose any slot differs in decision,
        payload bytes, on-node label, liveness or brown-out flag, or whose
        stored charge drifts by 1e-3 µJ, or whose end state differs (keys,
        predictor cursor and labels exactly; charge and history within
        1e-3 µJ); a node-step whose outcome hung on a float32 tie in the
        reference (``tie`` of :func:`perfbench.reference.seeker.node_slot`)
        is left out and counted in ``tied_steps``.  ``logit_gap_p99``: the
        99th percentile, over the node-slots both sides offloaded (D3, D4)
        alike, of the host logits' widest gap as a share of the reference
        row's largest magnitude; ``logit_gap`` is their largest, and
        ``logit_off_share`` the share above 1e-3."""
        (gt, ge), (wt, we) = got, want
        dec_g, dec_w = gt["decisions"].long(), wt["decisions"].long()
        onnode = (dec_w == ref.D0_MEMO) | (dec_w == ref.D2_DNN_QUANT)
        label_g = torch.argmax(gt["logits"], dim=-1)
        label_w = torch.argmax(wt["logits"], dim=-1)
        slot_bad = ((dec_g != dec_w)
                    | (gt["payload_bytes"] != wt["payload_bytes"])
                    | (onnode & (label_g != label_w))
                    | (gt["alive"] != wt["alive"])
                    | (gt["brownout"] != wt["brownout"])
                    | ((gt["stored_uj"] - wt["stored_uj"]).abs() > 1e-3))
        end_bad = ((ge["keys"] != we["keys"]).any(-1)
                   | (ge["pos"].long() != we["pos"])
                   | (ge["prev"].long() != we["prev"])
                   | (ge["browned"] != we["browned"])
                   | ((ge["stored"] - we["stored"]).abs() > 1e-3)
                   | ((ge["history"] - we["history"]).abs() > 1e-3).any(-1))
        tied = wt["tie"].any(dim=1)                             # (J, K)
        bad = (slot_bad.any(dim=1) | end_bad) & ~tied
        off = (dec_g == dec_w) & ((dec_w == ref.D3_CLUSTER)
                                  | (dec_w == ref.D4_SAMPLING))
        gap = ((gt["logits"] - wt["logits"]).abs().amax(-1)
               / wt["logits"].abs().amax(-1).clamp(min=1e-6))
        gaps = gap[off]
        worst = (int(dec_w[off][torch.argmax(gaps)]) if gaps.numel()
                 else -1)
        return {"mismatch_share": float(bad.sum() / (~tied).sum().clamp(min=1)),
                "logit_gap_p99": (float(torch.quantile(gaps.float(), 0.99))
                                  if gaps.numel() else 0.0),
                "logit_gap": float(gaps.max()) if gaps.numel() else 0.0,
                "logit_off_share": (float((gaps > 1e-3).float().mean())
                                    if gaps.numel() else 0.0),
                "worst_gap_decision": worst,
                "tied_steps": int(tied.sum()),
                "node_steps": int(bad.numel()),
                "offloaded_node_slots": int(gaps.numel())}

    def check(self, control: bool = False) -> dict:
        """Hold the kept steps to the reference; with ``control`` the
        reference in TF32 stands in the program's place."""
        want = self.reference()
        got = self.reference(tf32=True) if control else self.program()
        return self.compare(got, want)


def setup(ctx):
    return FleetCell(ctx)

