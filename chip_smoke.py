#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. card: requires CUDA, prints ``nvidia-smi``'s name and power limit and
   switches TF32 off for convolutions and matmuls;
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a into
   ``build/repro_torch/``, prints the seconds and every kernel's ptxas
   registers and spills, and fails on a spill;
3. kernels: each kernel against its plain version on the card at the main
   path's shapes, and every kernel also at off-fleet shapes that run every
   instantiation and ragged edge.  ``fake_quant`` (amax and scale included)
   and ``importance_select`` must be bit-equal to their plain versions in
   every case; ``fake_quant`` must launch exactly one kernel per call, in
   every mode.  Two launches of each kernel on the same input must be
   bit-identical.  The bearing config's shapes too: ``signature_corr`` at
   (3000, 120, 1) against a 10-signature bank, ``kmeans_coreset`` on 3000
   clouds of (120, 2) with k = 18, ``importance_select`` at (3000, 120, 1)
   with m = 20, and ``fake_quant`` per channel at 8192 columns.  With each
   kernel's time, the plain version's time, the time of one PyTorch call
   computing the same function where there is one, and the least time the
   card could take (its bound), at the fleet's and the bearing shapes;
4. fleet: ``repro_torch.seeker_fleet_simulate`` at full HAR width, N=3000
   nodes, S=8 slots, per-node streams, counting each kernel's launches; the
   same run on the CPU through the plain versions, with the same noise,
   must agree on at least 99% of the decisions;
5. this slice's paths, each with its launches counted: the importance
   sampler's entry point ``importance_select_op`` on the N=3000 HAR
   windows, checked against its plain version on the CPU; and the
   scarce-harvest fleet of ``benchmarks/fleet_scale.py``'s intermittent
   rows (N=3000, S=32, harvest scaled by 0.04, brown-out at 6/30 µJ from
   12 µJ, the intermittent lane) with churn, whose first 8 slots must agree
   with a CPU run of the plain versions on at least 99% of the decisions
   and within 1% on brown-out events and lane emissions;
6. the mixed HAR and bearing fleet of ``benchmarks/fleet_scale.py``'s
   mixed rows (N=3000, S=32, ``TaskLaneConfig`` round robin, unscaled
   harvest) with per-node streams (HAR windows for task 0, bearing
   vibration resampled to the HAR grid and tiled to 3 channels for task
   1), a host weight tree per task and telemetry: the per-task splits must
   partition the totals, the telemetry lanes must equal the aggregates,
   and the first 8 slots must agree with a CPU run of the plain versions
   on at least 99% of the decisions and within 1% on the per-task
   completions; timed and profiled with telemetry on and off;
7. the streamed driver at ``_streaming_rows``' full point (N=3000, S=32,
   segments of 4 slots, the shared stream plus 1e-3 times the node index)
   with phase 5's lanes, the task lane and telemetry: bitwise equal on the
   card to one materialized run from the same generator seed, with the
   peak device memory of each run and the window bytes each holds;
8. the host tier at HAR's full width (k=12, m=20), N=3000, S=8, each
   against a CPU run of the plain versions on the card's own payloads:
   (a) ``fleet_serve_step`` in queue mode (``HostServeConfig`` batch 256,
   queue and cache 4096, QoS 4 slots, telemetry), fed phase 5's windows and
   its emitted alive lane, one ``kmeans_coreset`` launch a slot; (b) an
   under-provisioned ``host_serve_slot`` (8 batches of 256 a slot, a queue
   of 8192, QoS 2 slots) on lanes of cluster and sampling entries that
   re-send a quarter of the previous slot's frames, so that the run holds
   backlog, deadline misses, overflow drops and cache hits.  QoS counters
   and telemetry must be exactly the CPU run's, logits within 1e-3, the
   ensemble's answers equal on at least 99% of nodes; the edge encode's
   counts exactly equal and its codes within one code; a frame must
   round-trip exactly; each with ms/slot, device time and launches a slot,
   and its synchronisations counted by CUDA's sync debug mode;
9. the sharded fleet driver: (a) at world size 1 on NCCL (a ``FileStore``
   under ``build/``), the card's own layout, at N=3000, S=8 with every lane
   (churn, brown-out, intermittent, task, telemetry, labels):
   ``seeker_fleet_simulate_sharded`` must equal the single-device engine
   with the same generator seed on every integer trace, aggregate and
   telemetry lane and launch the same kernels as often, and
   ``fleet_serve_step(mesh=..., per_shard_host=True)`` must equal the
   single-device queue mode on phase 8's server, and
   ``edge_host_serve_step`` on a (1, 1) ("pod", "data") mesh the direct
   serve step's logits bit for bit; (b) 4 gloo ranks sharing
   the card (this script again, ``--sharded-rank``) on a (2, 2) ("pod",
   "data") mesh at N=3001 (3 padding nodes), S=4, each rank's result equal
   to a one-rank run; with ms/slot, device busy, launches and
   synchronisations a slot, and the collectives' time; (c) per-node keyed
   noise (``fleet_node_keys``, ``node_keys=``): the keys and one slot's
   hash words and uniforms bitwise equal to a CPU run's at N=3000, phase
   4's bare fleet keyed (S=8) against a CPU plain run (decisions on at
   least 99% of node-slots, final keys bitwise), the world-size-1 NCCL
   sharded keyed run with every lane bitwise the single-device keyed run
   (logits included), the streamed driver's two 4-slot segments chained
   through ``final_keys`` bitwise the 8-slot run, and (b)'s 4 gloo ranks
   keyed at N=3001 equal to a one-rank keyed run; with ms/slot keyed
   against the generator and the noise bytes a rank draws (its tile
   against the whole fleet);
10. the paper's per-sensor path: (a) the oracle
   ``seeker_simulate_reference`` at HAR's full width with an AAC table, 3
   sensors on a 128-window stream under the wifi and piezo sources,
   against ``seeker_simulate`` from the same generator seed (decisions, k
   and payloads exactly equal, stored energy within 1e-4, preds on at least
   99% of slots) and against a CPU run of the plain versions with the same
   noise (decisions on at least 99% of slots), with the ms/slot of both,
   the launches of each (one ``signature_corr`` and one ``kmeans_coreset``
   a sensor-slot, three ``fake_quant`` plus four for the weights), and the
   three kernels held against their plain versions at the oracle's
   one-node shapes; (b) one ``seeker_sensor_step`` on N=3000 bearing
   windows at ``BEARING``'s width (120, 1), k=18, m=20, against the CPU
   plain step (decisions on at least 99% of nodes, coreset k and counts
   exactly); (c) the DCT, DWT and Fourier codecs at m=14, the
   deterministic top-m sampler (JAX's indices on a flat window),
   ``memo_decision`` and the single-cloud ``kmeans_coreset`` on 3000 HAR
   windows, each against its CPU run;
11. the LM serving path (bf16 GEMMs reducing in float32): (a)
   tinyllama-1.1b's full config (22 layers, float32 parameters cast once to
   bfloat16, random from a seed) through ``repro_torch.launch.serve``'s
   ``serve`` at batch 8, prompt 512, 64 greedy tokens, with prefill ms,
   decode ms a step, tokens/s, peak device memory, launches a decode step
   (``torch.profiler``) and their bounds; the generated steps replayed and
   held to a teacher-forced float32 forward and a bfloat16 one (RMS
   difference at most 0.1, largest at most 0.5 of the logits' std) and
   the greedy tokens to the float32 argmax wherever its margin rules out a
   flip; (b) the first 2 layers at full width in float32, batch 2, prompt
   32 and 4 decode steps, the card against the CPU within 1e-3; (c) the 22
   layers in float32 on a 4096-token prompt, the flash causal walk against
   the dense attention (which shares no code with it) within 1e-4, end to
   end and alone, and alone against ``scaled_dot_product_attention`` within
   1e-4; (d) gemma3-12b at full width, its first 5:1 period (6 layers):
   prompt 2048 and 32 decode steps through the ring caches against a
   teacher-forced forward, and the flash banded walk against the dense
   windowed attention and the library call under a band mask, each within
   1e-4.  The four hand kernels are not on
   this path: their launches in (a)'s served call must be 0;
12. the MoE, RG-LRU and SSD serving paths, each served through ``serve``
   at batch 8, prompt 512, greedy, with prefill ms, decode ms a step,
   tokens/s, peak device memory, launches, device busy and idle share of
   a decode step and their bounds (an MoE decode step's bound reads only
   the experts it routes to), the generated steps replayed (argmax equal
   to the tokens), and 0 hand-kernel launches: (a) deepseek-moe-16b's
   full config (28 layers, 64 experts top-6 and 2 shared) with bf16
   parameters from a seed, 32 new tokens, the dropped (token, k) share of
   its first MoE layer at the prefill (capacity 60) and a decode step
   (capacity 1); (b) its first 4 layers' bf16 steps against a float32
   decode replay of the same tokens (RMS at most 0.1 of the std, the
   largest difference and the greedy agreement reported), and its first
   2 layers in float32, batch 2, prompt 32 and 4 steps, on the card
   against the CPU within 1e-3 with equal drops; (c) grok-1-314b at full
   width cut to 2 layers, bf16 from a seed, as (a), and its first layer
   as (b); (d) recurrentgemma-2b's full config and (e) mamba2-130m's,
   float32 parameters cast once to bf16, 64 new tokens: decode against a
   teacher-forced bf16 forward and the bf16 steps against a float32 one
   within ``REC_RMS`` and ``REC_MAX``, greedy tokens equal to the float32 argmax where
   the margin rules out a flip, and the card against the CPU in float32
   within 1e-3 (recurrentgemma's first 3 layers at prompt 32, mamba2
   whole at prompt 256);
13. the encoder-decoder and M-RoPE serving paths, each at its full config
   (float32 parameters from a seed cast once to bf16) served through
   ``serve`` at batch 8, greedy, 64 new tokens, with prefill ms, decode ms
   a step, tokens/s, peak device memory, launches, device busy and idle
   share of a decode step and their bounds, the generated steps replayed
   (argmax equal to the tokens), 0 hand-kernel launches, and 2 layers in
   float32 (batch 2, prompt 32, 4 steps) on the card against the CPU
   within 1e-3: (a) whisper-small (12 encoder and 12 decoder layers, 12
   heads padded to 16) over 1500 standard-normal frames, prompt 64, the
   steps against teacher-forced bf16 and float32 forwards with the same
   frames within ``BF16_RMS`` and ``BF16_MAX`` and greedy tokens equal to
   the float32 argmax where the margin rules out a flip, the CPU cut with
   2 encoder layers over all 1500 frames; (b) qwen2-vl-2b (28 layers,
   M-RoPE) after 64 standard-normal patches, prompt 512,
   ``cache_margin=64`` so that no patch is evicted, the prefill logits
   against a float32 forward and the bf16 steps against a float32 decode
   replay of the same tokens (the reference's decode step gives M-RoPE
   other ids than its forward), each within ``BF16_RMS`` and
   ``BF16_MAX``, with the greedy agreement, the CPU cut after all 64
   patches;
14. the LM training path (bf16 GEMMs reducing in float32): (a)
   tinyllama-1.1b's full config (float32 masters from a seed, bf16
   compute, ``remat="full"``) through ``make_train_step`` and
   ``run_training`` on ``lm_batches`` at batch 8 and 4096 tokens (past
   the dense limit: every layer walks the flash causal walk forward, in
   the remat recompute and backward), one warm-up step and 4 timed, with
   step ms, tokens/s, peak device memory, each step's loss and grad norm
   (finite), the synchronisations of a step, device busy, idle share and
   launches of a step (``torch.profiler``) and the step's bound; (b) the
   full model's first step in bf16 against float32 (|loss difference| at
   most ``TRAIN_BF16_LOSS``, the gradient's cosine at least
   ``TRAIN_BF16_COS``), and the first 2 layers at full width in float32,
   one train step on the card against the CPU; (c) both walks' forward
   and backward at phase 11's shapes, dq, dk and dv against autograd
   through the dense attention within 1e-4, timed beside
   ``scaled_dot_product_attention``'s forward and backward; (d) on the
   2-layer cut, 8 steps checkpointed every 4 and preempted at step 6,
   bitwise equal to an uninterrupted run, and the rf harvest gating the
   steps; (e) the coreset-compressed step at world size 1 on NCCL on the
   full model, and on the 2-layer cut as 2 gloo ranks sharing the card
   (the script starts itself as ``chip_smoke.py --train-rank R 2 STORE
   OUT DEVICE``), both ranks' states bitwise equal after each step.  The
   four hand kernels are not on this path: their launches on every
   training path must be 0;
15. the LM sharding rules on a ``DeviceMesh`` (world size 1 on NCCL,
   a (1, 1) ("data", "model") mesh from ``launch/mesh.py``): (a) phase
   14's state, batches and first four steps through ``run_training`` as
   the FSDP step (``FSDP_RULES``, the state placed by
   ``train_state_specs``), losses and grad norms bitwise or within
   ``SHARD_REL`` of phase 14's, with step ms, device busy, idle share,
   launches a step and peak memory beside phase 14's; (b) the DP+TP
   compressed step (``dp_axes=("data",)``) against phase 14 (e)'s
   world-of-one compressed step from the same state, the codec's top-k
   indices of the first step (recorded there) exactly; (c) on the
   2-layer cut, the state drawn onto the mesh leaf by leaf
   (``init_train_state(shardings=)``, as the launcher draws it) equal to
   the placed draw, a checkpoint of the unsharded state restored with
   ``shardings=`` (each local shard its slice) and a preempted sharded
   run bitwise equal to a clean one; (d) four gloo ranks sharing
   the card on a (2, 2) mesh (the script starts itself as
   ``chip_smoke.py --lm-shard-rank R 4 STORE OUT DEVICE``), held to the
   world of one, where gloo carries DTensor's collectives for tensors on
   the card (a probe in each rank decides; otherwise left out, with the
   reason printed); the four hand kernels' launches must be 0 on every
   path;
16. the dry run (``repro_torch.launch.dryrun``, meta tensors on fake
   process groups, no card): (a) four cells, each in a process of its own
   (``python -m repro_torch.launch.dryrun``), all at once: tinyllama-1.1b
   ``decode_32k`` on the (16, 16) mesh, mamba2-130m ``decode_32k`` on the
   (2, 16, 16) mesh, tinyllama-1.1b ``train_4k`` (FSDP) and the same cell
   with ``--rules dp_tp --compress``, each ``ok`` with its per-device
   FLOPs, argument and temporary bytes, collective bytes by kind,
   roofline row (``launch/roofline.py``, the H100's figures) and trace
   seconds, the decode cells within 80 GB a card; and the reference's own
   compression check (its tiny model on an (8,) ("data",) mesh: the
   compressed step's collective bytes under the dense step's all-reduce
   bytes; this script again, ``--dryrun-compress OUT``); (b) phase 14's
   own cell (batch 8 x 4096, world of one) counted in this process and
   held to what phase 14 measured: its FLOPs within ``DRYRUN_FLOPS_REL``
   of ``_train_bounds``' operations, its argument plus temporary bytes
   within ``DRYRUN_MEM_REL`` of phase 14's peak device memory less what
   was resident before the loop (the loop keeps its initial state, the
   restore template, beside the step's own state); no hand kernel runs;
17. the kernel table as one JSON line (each kernel's launches on every
   path, ``per_sensor_oracle``, ``bearing_step``, ``codecs``, ``lm_serve``,
   the ``lm_mixers_*``, ``lm_multimodal_*``, ``lm_train*``,
   ``lm_sharded_*``, ``sharded_keyed`` and ``dryrun`` cells among them),
   then the result line.

``python3 chip_smoke.py --bf16-drift [ARCH ...]`` runs, on the CPU, the
estimate phase 12's bfloat16 bounds were set from (``bf16_drift``), and
``python3 chip_smoke.py --train-drift [LAYERS ...]`` the one phase 14's
were set from (``train_drift``).
"""
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

N_NODES, N_SLOTS = 3000, 8     # the top point and SLOTS of benchmarks/fleet_scale.py
# the intermittent rows of benchmarks/fleet_scale.py: INTERMITTENT_SLOTS,
# INTERMITTENT_SCARCITY, BROWNOUT_CFG, BROWNOUT_INITIAL_UJ, INTERMITTENT_CFG
SCARCE_SLOTS, SCARCITY = 32, 0.04
BROWNOUT_UJ, INITIAL_UJ = (6.0, 30.0), 12.0
COMPARE_SLOTS = 8              # slots of the scarce run replayed on the CPU
# the mixed rows (INTERMITTENT_N, INTERMITTENT_SLOTS, MIXED_TASK_CFG) and the
# streaming rows (STREAM_N, STREAM_SLOTS, STREAM_CHUNK) of
# benchmarks/fleet_scale.py
MIXED_SLOTS = 32
STREAM_SLOTS, STREAM_CHUNK = 32, 4
IMPORTANCE_M = 20              # the HAR sampling points
HOST_K, HOST_SLOTS = 12, 8     # phase 8: HAR's k, and the slots served
# phase 9 (b): gloo ranks sharing the card, a fleet that does not divide
SHARD_RANKS, SHARD_GLOO_N, SHARD_GLOO_SLOTS = 4, 3001, 4
# phase 9 (c): the per-node keys' seed and the streamed driver's segment
KEY_SEED, KEY_CHUNK = 14, 4
# configs/seeker_har.py BEARING: 120-sample windows, 1 channel, and
# SYSTEM.bearing_clusters
BEARING_T, BEARING_K = 120, 18
# phase 10: the per-sensor oracle on the 128-window stream of
# benchmarks/fig11_system.py:40 (fig12_endtoend.py:51), 3 sensors, under
# fig11's wifi source and piezo; the codecs at fig10_commercial.py's m=14
ORACLE_SLOTS, ORACLE_SENSORS = 128, 3
ORACLE_SOURCES = ("wifi", "piezo")
ORACLE_PROFILE_SLOTS = 8       # the profiled head of the stream
CODEC_M = 14
# phase 11: the LM serving path; tinyllama-1.1b's full config at batch 8,
# prompt 512, 64 new tokens; its 2-layer cut on the card and the CPU; the
# flash causal walk at 4096 tokens; gemma3-12b's first 5:1 period
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 2, 32, 4
LM_FLASH_PROMPT, LM_CHUNK = 4096, 512
GEMMA3_LAYERS, GEMMA3_PROMPT, GEMMA3_NEW = 6, 2048, 32
# the bfloat16 tolerance in units of the reference logits' standard
# deviation: RMS and largest difference over the real vocabulary
# (bfloat16 keeps 8 significant bits; PERF.md §6 gives the CPU estimate
# at 1-4 layers of tinyllama's width it was set from)
BF16_RMS, BF16_MAX = 0.1, 0.5
# phase 12: the MoE, RG-LRU and SSD serving paths at batch 8, prompt 512;
# deepseek-moe-16b's first 4 layers in float32 and its first 2 on the CPU;
# grok-1-314b cut to 2 layers (631 GB in bf16 at its 64); the recurrent
# configs' card-against-CPU cuts (recurrentgemma's R, R, L; mamba2 whole)
MIX_BATCH, MIX_PROMPT, MOE_NEW, REC_NEW = 8, 512, 32, 64
DEEPSEEK_F32_LAYERS, DEEPSEEK_CPU_LAYERS, GROK_LAYERS = 4, 2, 2
RG_CPU_LAYERS, MAMBA_CPU_PROMPT = 3, 256
# the recurrent configs' bfloat16 bounds (RMS, largest) over the logits'
# std: about twice the CPU estimate of ``chip_smoke.py --bf16-drift``
# extrapolated to full depth (recurrentgemma 0.075 and 0.48; mamba2,
# measured whole, 0.056 and 0.36; PERF.md §6)
REC_RMS, REC_MAX = 0.15, 1.0
# phase 13 (at phase 12's batch): whisper-small's full config, prompt 64
# over its 1500 frames; qwen2-vl-2b's, its 64 patches and a 512-token prompt,
# with a cache margin of 64 so that no patch is evicted; 64 new tokens each;
# each cut to 2 layers (and 2 encoder layers) for the card against the CPU
MM_NEW, WHISPER_PROMPT, QWEN_PROMPT, QWEN_MARGIN = 64, 64, 512, 64
# phase 14: the LM training path; tinyllama-1.1b's full config at batch 8
# and SHAPES["train_4k"]'s 4096 tokens (its global batch of 256 cut to 8),
# one warm-up step and 4 timed; its 2-layer cut at full width (card against
# CPU, fault tolerance, two gloo ranks) at batch 1 a rank and 512 tokens
# past a dense limit of 256, so that the flash causal walk runs there too
TRAIN_BATCH, TRAIN_STEPS = 8, 5
TRAIN_CUT_LAYERS, TRAIN_CUT_SEQ, TRAIN_CUT_CHUNK = 2, 512, 256
TRAIN_FT_STEPS, TRAIN_FT_EVERY, TRAIN_FT_PREEMPT = 8, 4, (6,)
TRAIN_BUDGET_COST = 25.0       # µJ a step: some rf steps defer
TRAIN_RANKS, TRAIN_RANK_STEPS = 2, 2
# bounds set before the first chip run: the bf16 step against float32 on
# the full model (|loss difference|, and the cosine of the whole gradient),
# from ``chip_smoke.py --train-drift``'s CPU estimate at full width and cut
# depth (PERF.md §6); the card against the CPU in float32 (largest
# gradient difference over its leaf's std, relative loss difference); the
# walks' float32 gradients against the dense attention's
TRAIN_BF16_LOSS, TRAIN_BF16_COS = 0.01, 0.999
TRAIN_CPU_GRAD, TRAIN_CPU_LOSS = 1e-3, 1e-5
WALK_GRAD_TOL = 1e-4
# phase 15: the LM sharding rules on a DeviceMesh; (a) phase 14's first 4
# steps as the FSDP step on a (1, 1) mesh, held to phase 14's losses and
# grad norms bitwise or within SHARD_REL; (b) 2 DP+TP compressed steps
# against the world-of-one compressed step; (d) 4 gloo ranks on a (2, 2)
# mesh, the float32 2-layer cut at batch 4, 2 steps, held to the world of
# one within SHARD_RANK_REL (set from the CPU run of the same ranks:
# PERF.md §6)
SHARD_STEPS, SHARD_REL, SHARD_CMP_STEPS = 4, 1e-6, 2
SHARD_RANKS4, SHARD_RANK_STEPS, SHARD_RANK_BATCH = 4, 2, 4
SHARD_RANK_REL = 1e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# phase 16: the dry run's cells (arch, shape, mesh, flags, tag), each in a
# process of its own, and (b)'s bounds against phase 14's measurement
DRYRUN_CELLS = (
    ("tinyllama-1.1b", "decode_32k", "single", (), "chip"),
    ("mamba2-130m", "decode_32k", "multi", (), "chip"),
    ("tinyllama-1.1b", "train_4k", "single", (), "chip"),
    ("tinyllama-1.1b", "train_4k", "single", ("--rules", "dp_tp",
                                              "--compress"), "chipcmp"),
)
DRYRUN_MEM_REL, DRYRUN_FLOPS_REL = 0.10, 0.15
HBM_CARD_BYTES = 80e9
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 on the tensor cores
REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out"


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _time_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean time of one call from CUDA events around ``reps`` back-to-back
    calls: the device's time, or the host's where launching is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(torch, fn, match: str | None = None, reps: int = 20):
    """Mean device time per call of the kernels ``fn`` launches (only those
    whose name contains ``match``, if given), from ``torch.profiler``; None
    if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and (match is None or match in e.key))
    return total_us / reps / 1e3 if total_us > 0 else None


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if getattr(evt, name, None):
            return float(getattr(evt, name))
    return 0.0


def _timings(torch, kernel_fn, kernel_name, plain_fn, library_fn=None):
    """Device ms per call of the kernel alone, of the plain version and of
    the library call (profiler, falling back to CUDA events where the
    profiler sees nothing), plus each call's event-timed ms."""
    call = {"kernel": _time_ms(torch, kernel_fn),
            "plain": _time_ms(torch, plain_fn, reps=10)}
    dev = {"kernel": _device_ms(torch, kernel_fn, kernel_name),
           "plain": _device_ms(torch, plain_fn)}
    if library_fn is not None:
        call["library"] = _time_ms(torch, library_fn)
        dev["library"] = _device_ms(torch, library_fn)
    source = {k: "profiler" if v is not None else "events"
              for k, v in dev.items()}
    ms = {k: v if v is not None else call[k] for k, v in dev.items()}
    return dict(ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=ms.get("library")), dict(call_ms=call,
                                                    source=source)


def _profile(torch, run, slots: int, secs: float, name: str) -> dict:
    """One more run under the profiler: device busy time and kernel
    launches per slot, the idle share against the host-clock run of
    ``secs``, the top kernels; the tables are written under ``OUT``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    on_device = sorted((e for e in rows if e.device_type == DeviceType.CUDA),
                       key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in on_device) / 1e3 / slots
    summary = dict(
        device_busy_ms_per_slot=busy_ms,
        device_idle_share=1.0 - busy_ms / (secs / slots * 1e3),
        kernel_launches_per_slot=sum(e.count for e in on_device) / slots,
        # the plain scale chain's ops (the max-pool also takes an amax)
        abs_amax_calls_per_slot={e.key: e.count / slots for e in rows
                                 if e.key in ("aten::abs", "aten::amax")},
        top_kernels=[dict(name=e.key[:90], count_per_slot=e.count / slots,
                          ms_per_slot=_self_device_us(e) / 1e3 / slots)
                     for e in on_device[:15]])
    OUT.mkdir(exist_ok=True)
    (OUT / f"{name}_profile.txt").write_text(
        rows.table(sort_by="self_device_time_total", row_limit=60) + "\n"
        + rows.table(sort_by="self_cpu_time_total", row_limit=40))
    print(f"{name} profile: device busy {busy_ms:.3f} ms/slot, "
          f"{summary['kernel_launches_per_slot']:.0f} kernel launches"
          f"/slot, idle share {summary['device_idle_share']:.3f}; "
          f"aten::abs/amax calls per slot {summary['abs_amax_calls_per_slot']}")
    for row in summary["top_kernels"][:8]:
        print(f"  {row['ms_per_slot']:.4f} ms/slot x{row['count_per_slot']:g} "
              f"{row['name']}")
    return summary


def phase_card(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build() -> dict:
    """Build the kernels; print and return ptxas's registers and spills of
    every kernel, and fail on a spill."""
    from repro_torch.kernels import build, ops
    path, log, secs = build.build(ptxas_verbose=True)
    ops.kernel_library()
    print(f"build: {path.name} in {secs:.1f} s")
    report = build.ptxas_report(log)
    for name, row in report.items():
        print(f"  ptxas {name}: {row['registers']} registers, spill stores "
              f"{row['spill_stores']} B, spill loads {row['spill_loads']} B")
    assert len(report) >= len(_SOURCES), report
    spills = [n for n, r in report.items()
              if r["spill_stores"] or r["spill_loads"]]
    assert not spills, f"ptxas reports spills in {spills}"
    return report


def _same_twice(torch, fn) -> None:
    """Two launches on the same input give bit-identical outputs (NaNs
    and signed zeros included)."""
    first, second = fn(), fn()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    bits = [(a.view(torch.int32), b.view(torch.int32))
            if a.dtype == torch.float32 else (a, b)
            for a, b in zip(first, second)]
    assert all(torch.equal(a, b) for a, b in bits)


def _assert_same_bits(torch, got, want, what: str) -> None:
    """NaN where the plain version has NaN; every other element bit for bit
    (``torch.equal``, and signed zeros too)."""
    nan = torch.isnan(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.equal(torch.isnan(got), nan), what
    if not bool(nan.any()):
        assert torch.equal(got, want), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what


def _device_kernels(torch, fn) -> dict:
    """{kernel name: launches} of one call of ``fn``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _fake_quant_plain(ref, x, bits, per_channel=False, per_sample=False):
    """The whole plain function (the scale chain, then the quantizer), and
    each element's scale."""
    x2d = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
    rows = x2d.shape[0] // x.shape[0] if per_sample else x2d.shape[0]
    scale = ref.fake_quant_scale(x2d, bits, per_channel, rows)
    out = ref.fake_quant_ref(x2d, scale, bits, per_channel, rows)
    per_element = (scale[None, :] if per_channel
                   else scale.repeat_interleave(rows)[:, None])
    return out.reshape(x.shape), per_element.expand(x2d.shape).reshape(x.shape)


def _fake_quant_cases(torch, g, dev, acts, weight):
    """(name, tensor, kwargs) for every mode and instantiation of the
    quantizer: the fleet's per-node activations, per-node groups that are
    not whole float4s, unaligned or longer than a warp holds, groups of
    zeros and of inf and NaN, per-tensor weights and tensors, per-channel."""
    def rnd(shape, scale=3.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    unaligned = rnd((3000 * 180 + 1,))[1:].view(3000, 60, 3)
    zero = rnd((3000, 60, 3))
    zero[5] = 0.0
    zero[6] = -0.0
    inf = rnd((3000, 60, 3))
    inf[7, 3, 1] = float("inf")
    inf[8, 0, 2] = float("-inf")
    inf[9, 0, 0] = float("nan")
    node = dict(per_sample=True)
    return [
        ("per node (3000, 60, 3)", acts[0], node),
        ("per node (3000, 30, 32)", acts[1], node),
        ("per node (3000, 15, 64)", acts[2], node),
        ("per node (7, 13, 3)", rnd((7, 13, 3)), node),
        ("per node (3000, 60, 3) unaligned", unaligned, node),
        ("per node (64, 40, 64)", rnd((64, 40, 64)), node),
        ("per node (16, 301, 3)", rnd((16, 301, 3)), node),
        ("per node, groups of zeros", zero, node),
        ("per node, groups with inf and NaN", inf, node),
        ("per tensor (960, 128) weights", weight, {}),
        ("per tensor (5, 32, 64) weights", rnd((5, 32, 64), 0.05), {}),
        ("per tensor (7, 13, 3)", rnd((7, 13, 3)), {}),
        ("per tensor (2048, 4096)", rnd((2048, 4096)), {}),
        ("per tensor zeros", torch.zeros((64, 64), device=dev), {}),
        ("per channel (960, 128) weights", weight, dict(per_channel=True)),
        ("per channel (2048, 4096)", rnd((2048, 4096)), dict(per_channel=True)),
        ("per channel (33, 70)", rnd((33, 70)), dict(per_channel=True)),
        ("per channel (256, 8192)", rnd((256, 8192)), dict(per_channel=True)),
    ]


def _check_kmeans(torch, ops, ref, pts, k, iters) -> float:
    """The kernel against its plain version: counts equal on at least 99.9%
    of the clouds, centres and radii within 1e-4 where they are; two
    launches bit-identical.  Returns the largest difference."""
    kc, kr, kn = ops.kmeans_coreset_op(pts, k, iters)
    pc, pr, pn = ref.kmeans_coreset_ref(pts, k, iters)
    same = (kn == pn).all(dim=-1)
    n_diff = int((~same).sum())
    print(f"kmeans_coreset {tuple(pts.shape)} k={k}: counts differ on "
          f"{n_diff} of {pts.shape[0]} clouds (a point within an ulp of "
          f"equidistant may flip)")
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(kc[same], pc[same], rtol=0, atol=1e-4)
    torch.testing.assert_close(kr[same], pr[same], rtol=0, atol=1e-4)
    _same_twice(torch, lambda: ops.kmeans_coreset_op(pts, k, iters))
    return max(float((kc[same] - pc[same]).abs().max()),
               float((kr[same] - pr[same]).abs().max()))


def phase_kernels(torch, dev) -> dict:
    from repro_torch.core.coreset import points_from_window
    from repro_torch.data.sensors import class_signatures, har_windows
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(1)
    labels = torch.randint(0, 12, (N_NODES,), generator=g, device=dev)
    windows = har_windows(g, labels).contiguous()              # (3000, 60, 3)
    sigs = class_signatures(device=dev).contiguous()           # (12, 60, 3)
    table, extra, bearing = {}, {}, {}

    # --- signature_corr: (3000, 60, 3) x (12, 60, 3) -----------------------
    b, t, c = windows.shape
    l = sigs.shape[0]
    got = ops.signature_corr_op(windows, sigs)
    want = ref.signature_corr_ref(windows, sigs)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert bool((got.abs() <= 1 + 1e-4).all())
    diag = torch.diag(ops.signature_corr_op(sigs, sigs))
    torch.testing.assert_close(diag, torch.ones_like(diag), rtol=0, atol=1e-4)
    _same_twice(torch, lambda: ops.signature_corr_op(windows, sigs))
    corr_err = float((got - want).abs().max())
    # off the fleet: the widest window and bank, a ragged last tile
    w_off = torch.randn((1001, 64, 4), generator=g, device=dev)
    s_off = torch.randn((7, 64, 4), generator=g, device=dev)
    got_off = ops.signature_corr_op(w_off, s_off)
    want_off = ref.signature_corr_ref(w_off, s_off)
    torch.testing.assert_close(got_off, want_off, rtol=1e-4, atol=1e-5)
    _same_twice(torch, lambda: ops.signature_corr_op(w_off, s_off))
    corr_err = max(corr_err, float((got_off - want_off).abs().max()))
    # the bearing config's 120-sample windows against a 10-signature bank
    w_brg = torch.randn((N_NODES, BEARING_T, 1), generator=g, device=dev)
    s_brg = torch.randn((10, BEARING_T, 1), generator=g, device=dev)
    got_brg = ops.signature_corr_op(w_brg, s_brg)
    want_brg = ref.signature_corr_ref(w_brg, s_brg)
    torch.testing.assert_close(got_brg, want_brg, rtol=1e-4, atol=1e-5)
    _same_twice(torch, lambda: ops.signature_corr_op(w_brg, s_brg))
    corr_err = max(corr_err, float((got_brg - want_brg).abs().max()))
    for shape in ((b, l, t, c), (1001, 7, 64, 4), (l, l, t, c),
                  (N_NODES, 10, BEARING_T, 1)):
        print(f"signature_corr geometry {shape}: "
              f"{ops.signature_corr_geometry(*shape)}")
    # one einsum over operands centred and normalised beforehand computes
    # the same (B, L) function: the library yardstick
    wm = windows - windows.mean(1, keepdim=True)
    sm = sigs - sigs.mean(1, keepdim=True)
    a_op = wm / (wm.norm(dim=1, keepdim=True) * c)
    b_op = sm / sm.norm(dim=1, keepdim=True)
    lib = torch.einsum("btc,ltc->bl", a_op, b_op)
    torch.testing.assert_close(lib, want, rtol=1e-4, atol=1e-5)
    bound, by = _bound_ms(4 * (b * t * c + l * t * c + b * l),
                          2 * b * l * t * c + 6 * b * t * c)
    times, extra["signature_corr"] = _timings(
        torch, lambda: ops.signature_corr_op(windows, sigs),
        "signature_corr_kernel", lambda: ref.signature_corr_ref(windows, sigs),
        lambda: torch.einsum("btc,ltc->bl", a_op, b_op))
    table["signature_corr"] = dict(max_abs_err=corr_err, bound_ms=bound,
                                   bound_by=by, **times)
    lb = s_brg.shape[0]
    wm = w_brg - w_brg.mean(1, keepdim=True)
    sm = s_brg - s_brg.mean(1, keepdim=True)
    a_brg, b_brg = wm / wm.norm(dim=1, keepdim=True), sm / sm.norm(
        dim=1, keepdim=True)
    bound, by = _bound_ms(4 * (N_NODES * BEARING_T + lb * BEARING_T
                               + N_NODES * lb),
                          2 * N_NODES * lb * BEARING_T + 6 * N_NODES
                          * BEARING_T)
    times, _ = _timings(
        torch, lambda: ops.signature_corr_op(w_brg, s_brg),
        "signature_corr_kernel", lambda: ref.signature_corr_ref(w_brg, s_brg),
        lambda: torch.einsum("btc,ltc->bl", a_brg, b_brg))
    bearing["signature_corr"] = dict(
        shape=[N_NODES, BEARING_T, 1], bank=lb,
        max_abs_err=float((got_brg - want_brg).abs().max()), bound_ms=bound,
        bound_by=by, **times)

    # --- fake_quant: one slot's three per-node activations, and weights;
    # the whole function (amax, scale, quantize) bit for bit in every mode --
    acts = [torch.randn(shape, generator=g, device=dev) * 3.0
            for shape in ((b, 60, 3), (b, 30, 32), (b, 15, 64))]
    weight = torch.randn((960, 128), generator=g, device=dev) * 0.05
    err, variants = 0.0, {}
    for name, x, kw in _fake_quant_cases(torch, g, dev, acts, weight):
        for bits in (16, 12, 8):
            got = ops.fake_quant_op(x, bits, **kw)
            want, scale = _fake_quant_plain(ref, x, bits, **kw)
            _assert_same_bits(torch, got, want, f"fake_quant {name} {bits}")
            ok = ~torch.isnan(want)
            err = max(err, float((got[ok] - want[ok]).abs().max()))
            if (x is weight or any(x is a for a in acts)) and bits != 8:
                # within half a level of the input
                assert bool(((got - x).abs() <= scale / 2 + 1e-6).all())
        _same_twice(torch, lambda: ops.fake_quant_op(x, 16, **kw))
        cols = x.shape[-1] if x.ndim > 1 else x.numel()
        geo = ops.fake_quant_geometry(
            x.numel(), cols, x.shape[0] if kw.get("per_sample") else 1,
            kw.get("per_channel", False), x.data_ptr() % 16 == 0)
        variants.setdefault(geo.variant, (name, x, kw))
        print(f"fake_quant {name} {kw}: bit-equal at 16, 12 and 8 bits; "
              f"{geo}")
    assert sorted(variants) == list(range(6)), sorted(variants)
    # one launch per call and no PyTorch op, in every instantiation
    for name, x, kw in variants.values():
        seen = _device_kernels(torch, lambda: ops.fake_quant_op(x, 16, **kw))
        print(f"fake_quant {name}: kernels of one call {seen}")
        assert len(seen) == 1 and "fake_quant" in next(iter(seen)), seen
        assert list(seen.values()) == [1], seen

    # one slot's three calls, the whole function in each column: the
    # kernel; the plain scale chain and quantizer; the scale chain and
    # fake_quantize_per_channel_affine (which multiplies by 1 / scale: not
    # bit-equal, a yardstick); and the scale chain alone, which the
    # earlier design ran before its kernel
    def quant_slot():
        for x in acts:
            ops.fake_quant_op(x, 16, per_sample=True)

    def quant_slot_plain():
        for x in acts:
            x2d = x.reshape(-1, x.shape[-1])
            rows = x2d.shape[0] // b
            ref.fake_quant_ref(x2d, ref.fake_quant_scale(x2d, 16, False, rows),
                               16, False, rows)

    zero_points = torch.zeros(b, dtype=torch.int32, device=dev)

    def scale_chain():
        return [ref.fake_quant_scale(x.reshape(-1, x.shape[-1]), 16, False,
                                     x.numel() // (b * x.shape[-1]))
                for x in acts]

    def quant_slot_library():
        for x, scale in zip(acts, scale_chain()):
            torch.fake_quantize_per_channel_affine(
                x.reshape(b, -1), scale, zero_points, 0, -32767, 32767)

    n_act = sum(x.numel() for x in acts)
    # operations per element: abs, max, divide, round, two clamps, multiply
    bound, by = _bound_ms(2 * 4 * n_act, 7 * n_act)
    times, extra["fake_quant"] = _timings(
        torch, quant_slot, "fake_quant", quant_slot_plain, quant_slot_library)
    chain_dev = _device_ms(torch, scale_chain)
    extra["fake_quant"]["scale_chain_ms"] = (
        chain_dev if chain_dev is not None else _time_ms(torch, scale_chain))
    extra["fake_quant"]["scale_chain_launches"] = sum(
        _device_kernels(torch, scale_chain).values())
    print(f"fake_quant: the plain scale chain alone, one slot: "
          f"{extra['fake_quant']['scale_chain_ms']} ms device time, "
          f"{extra['fake_quant']['scale_chain_launches']} kernel launches")
    table["fake_quant"] = dict(max_abs_err=err, bound_ms=bound, bound_by=by,
                               **times)
    wide = torch.randn((256, 8192), generator=g, device=dev) * 3.0
    want_wide, _ = _fake_quant_plain(ref, wide, 16, per_channel=True)
    got_wide = ops.fake_quant_op(wide, 16, per_channel=True)
    _assert_same_bits(torch, got_wide, want_wide, "fake_quant (256, 8192)")
    bound, by = _bound_ms(2 * 4 * wide.numel(), 7 * wide.numel())
    wide_zero_points = torch.zeros(wide.shape[1], dtype=torch.int32,
                                   device=dev)

    def wide_library():
        # the scale chain and fake_quantize_per_channel_affine, as for the
        # per-node calls above (a yardstick: not bit-equal)
        return torch.fake_quantize_per_channel_affine(
            wide, ref.fake_quant_scale(wide, 16, True, wide.shape[0]),
            wide_zero_points, 1, -32767, 32767)

    times, _ = _timings(
        torch, lambda: ops.fake_quant_op(wide, 16, per_channel=True),
        "fake_quant", lambda: _fake_quant_plain(ref, wide, 16,
                                                per_channel=True),
        wide_library)
    bearing["fake_quant"] = dict(shape=[256, 8192], per_channel=True,
                                 max_abs_err=0.0, bound_ms=bound,
                                 bound_by=by, **times)

    # --- kmeans_coreset: the fleet's (3000 * 3, 60, 2) channel clouds -----
    cols = windows.transpose(1, 2)[..., None]                   # (B, C, T, 1)
    pts = points_from_window(cols).reshape(-1, t, 2).contiguous()
    k, iters = 12, 4
    err = _check_kmeans(torch, ops, ref, pts, k, iters)
    # off the fleet: the (32, 4) instantiation at the widest cloud, and a
    # ragged block of clouds whose N is not a multiple of the lane group
    for shape, kk in (((999, 64, 4), 32), ((13, 37, 1), 5),
                      ((99, 128, 4), 32), ((77, 65, 2), 7)):
        off = torch.randn(shape, generator=g, device=dev)
        err = max(err, _check_kmeans(torch, ops, ref, off, kk, iters))
        print(f"kmeans_coreset geometry {shape} k={kk}: "
              f"{ops.kmeans_coreset_geometry(*shape, kk)}")
    geo = ops.kmeans_coreset_geometry(*pts.shape, k)
    print(f"kmeans_coreset geometry {tuple(pts.shape)} k={k}: {geo}, "
          f"{geo.waves} wave(s)")
    nb = pts.shape[0]
    n, d = pts.shape[1:]
    flops = ((iters + 1) * nb * n * k * 3 * d + iters * nb * n * d
             + iters * nb * k * d + nb * n)
    bound, by = _bound_ms(4 * (nb * n * d + nb * k * d + 2 * nb * k), flops)
    times, extra["kmeans_coreset"] = _timings(
        torch, lambda: ops.kmeans_coreset_op(pts, k, iters),
        "kmeans_coreset_kernel", lambda: ref.kmeans_coreset_ref(pts, k, iters))
    table["kmeans_coreset"] = dict(max_abs_err=err, bound_ms=bound,
                                   bound_by=by, **times)
    # the bearing config: one channel of 120 samples a node, k = 18
    pts_brg = points_from_window(w_brg.transpose(1, 2)[..., None]).reshape(
        -1, BEARING_T, 2).contiguous()                  # (3000, 120, 2)
    err_brg = _check_kmeans(torch, ops, ref, pts_brg, BEARING_K, iters)
    geo = ops.kmeans_coreset_geometry(*pts_brg.shape, BEARING_K)
    print(f"kmeans_coreset geometry {tuple(pts_brg.shape)} k={BEARING_K}: "
          f"{geo}, {geo.waves} wave(s)")
    nb, n, d = pts_brg.shape
    kb = BEARING_K
    flops = ((iters + 1) * nb * n * kb * 3 * d + iters * nb * n * d
             + iters * nb * kb * d + nb * n)
    bound, by = _bound_ms(4 * (nb * n * d + nb * kb * d + 2 * nb * kb),
                          flops)
    times, _ = _timings(
        torch, lambda: ops.kmeans_coreset_op(pts_brg, kb, iters),
        "kmeans_coreset_kernel",
        lambda: ref.kmeans_coreset_ref(pts_brg, kb, iters))
    bearing["kmeans_coreset"] = dict(shape=[nb, n, d], k=kb,
                                     max_abs_err=err_brg, bound_ms=bound,
                                     bound_by=by, **times)
    err = max(err, err_brg)

    # --- importance_select: indices, values and weights bit for bit, at
    # the HAR windows and off them: the JAX tests' (13, 64, 5), T=37 with
    # m = 1 and m = T, flat windows with spread=0 (every weight 0), and
    # windows of three levels (many tied weights) ------------------------
    m = IMPORTANCE_M
    small = torch.randn((13, 64, 5), generator=g, device=dev)
    odd = torch.randn((50, 37, 3), generator=g, device=dev)
    levels = torch.randint(0, 3, (300, 60, 3), generator=g,
                           device=dev).float()
    err, variants = 0.0, set()
    for name, x, mm, kw in (
            ("fleet", windows, m, {}), ("fleet m=1", windows, 1, {}),
            ("(13, 64, 5)", small, 8, {}), ("T=37", odd, 5, {}),
            ("T=37 m=1", odd, 1, {}), ("T=37 m=T", odd, 37, {}),
            ("flat", torch.ones((64, 60, 3), device=dev), m,
             dict(spread=0.0)),
            ("flat (8, 64, 5)", torch.ones((8, 64, 5), device=dev), 8,
             dict(spread=0.0)),
            ("three levels", levels, m, {}),
            ("three levels spread=0", levels, m, dict(spread=0.0)),
            ("bearing", w_brg, m, {}), ("bearing m=T", w_brg, BEARING_T, {}),
            ("T=100", torch.randn((50, 100, 3), generator=g, device=dev), m,
             {}),
            ("flat T=128", torch.ones((8, 128, 2), device=dev), 8,
             dict(spread=0.0))):
        got = ops.importance_select_op(x, mm, **kw)
        want = ref.importance_select_ref(x, mm, **kw)
        for part, k_out, p_out in zip(("indices", "values", "weights"), got,
                                      want):
            assert torch.equal(k_out, p_out), (name, part)
        err = max(err, float((got[1] - want[1]).abs().max()),
                  float((got[2] - want[2]).abs().max()))
        _same_twice(torch, lambda: ops.importance_select_op(x, mm, **kw))
        geo = ops.importance_select_geometry(*x.shape, mm, 8)
        variants.add(geo.variant)
        print(f"importance_select {name} {tuple(x.shape)} m={mm} {kw}: "
              f"indices, values and weights equal; {geo}, "
              f"{geo.waves} wave(s)")
    assert variants == {0, 1, 2, 3}, variants
    # bytes: windows in, indices, values and weights out; operations per
    # sample: the box sum, divide, subtract and abs per channel, the channel
    # and time sums, the blend, m argmax comparisons; 3 per output weight
    nbytes = 4 * (b * t * c + b * m * (2 + c))
    flops = b * (t * c * (8 + 3) + t * (c - 1) + t + 3 * t + m * t + 3 * m)
    bound, by = _bound_ms(nbytes, flops)
    times, extra["importance_select"] = _timings(
        torch, lambda: ops.importance_select_op(windows, m),
        "importance_select",
        lambda: ref.importance_select_ref(windows, m))
    # not the same function (no scores, no sort, no gathers): a yardstick
    # for the selection alone
    scores = torch.rand((b, t), generator=g, device=dev)
    extra["importance_select"]["topk_of_scores_ms"] = _time_ms(
        torch, lambda: torch.topk(scores, m, dim=-1))
    table["importance_select"] = dict(max_abs_err=err, bound_ms=bound,
                                      bound_by=by, **times)
    tb, cb = BEARING_T, 1
    nbytes = 4 * (N_NODES * tb * cb + N_NODES * m * (2 + cb))
    flops = N_NODES * (tb * cb * (8 + 3) + tb * (cb - 1) + tb + 3 * tb
                       + m * tb + 3 * m)
    bound, by = _bound_ms(nbytes, flops)
    times, _ = _timings(
        torch, lambda: ops.importance_select_op(w_brg, m),
        "importance_select", lambda: ref.importance_select_ref(w_brg, m))
    bearing["importance_select"] = dict(shape=[N_NODES, tb, cb], m=m,
                                        max_abs_err=0.0, bound_ms=bound,
                                        bound_by=by, **times)

    for name, row in table.items():
        print(f"{name}: device ms: kernel {row['ms']}, plain {row['plain_ms']}"
              f", library {row['library_ms']}, bound {row['bound_ms']} "
              f"({row['bound_by']}); per call with launch: "
              f"{extra[name]['call_ms']}; timed by {extra[name]['source']}; "
              f"max_abs_err {row['max_abs_err']:.3g}")
    for name, row in bearing.items():
        print(f"{name} at the bearing shape {row['shape']}: device ms: "
              f"kernel {row['ms']}, plain {row['plain_ms']}, library "
              f"{row['library_ms']}, bound {row['bound_ms']} "
              f"({row['bound_by']})")
    extra["bearing_shapes"] = bearing
    return table, extra


def _bare_inputs(torch, dev):
    """Phase 4's bare fleet from seed 0: (N, S, T, C) per-node HAR
    streams, the (N, S) harvest, (S, N) labels and the model inputs."""
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.energy import fleet_harvest_traces
    from repro_torch.core.recovery import init_generator
    from repro_torch.data.sensors import class_signatures, har_stream
    from repro_torch.models.har import har_init

    g = torch.Generator(device=dev).manual_seed(0)
    params = har_init(g, HAR)
    inputs = dict(
        signatures=class_signatures(device=dev), qdnn_params=params,
        host_params=params,
        gen_params=init_generator(g, HAR.window, HAR.channels), har_cfg=HAR)
    windows, labels = har_stream(g, N_SLOTS, streams=N_NODES)  # (N, S, T, C)
    harvest = fleet_harvest_traces(g, N_NODES, N_SLOTS)
    return windows, harvest, labels.T.contiguous(), inputs


def phase_fleet(torch, dev) -> tuple[dict, dict]:
    import repro_torch
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.kernels import ops
    from repro_torch.serving.fleet import draw_fleet_noise, to_device

    windows, harvest, labels, inputs = _bare_inputs(torch, dev)

    ops.reset_launch_counts()
    res = repro_torch.seeker_fleet_simulate(
        windows, harvest, labels=labels, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0), **inputs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"signature_corr": N_SLOTS, "kmeans_coreset": N_SLOTS,
            "fake_quant": 3 * N_SLOTS + 4, "importance_select": 0}
    print(f"fleet launches {launches}, expected {want}")
    assert launches == want, (launches, want)

    hist = res["decision_histogram"]
    assert int(hist.sum()) == N_NODES * N_SLOTS
    assert res["logits"].shape == (N_SLOTS, N_NODES, HAR.n_classes)
    assert bool(torch.isfinite(res["logits"]).all())
    assert bool(torch.isfinite(res["stored_uj"]).all())

    # steady-state timing: a second run, same inputs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    repro_torch.seeker_fleet_simulate(
        windows, harvest, labels=labels, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0), **inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0

    profile_summary = _profile(torch, lambda: repro_torch.seeker_fleet_simulate(
        windows, harvest, labels=labels, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0), **inputs),
        N_SLOTS, secs, "fleet")

    # the same noise, drawn again, replays the run exactly on the card ...
    noise = draw_fleet_noise(torch.Generator(device=dev).manual_seed(0),
                             N_SLOTS, N_NODES, HAR.window, HAR.channels)
    again = repro_torch.seeker_fleet_simulate(
        windows, harvest, labels=labels, noise=noise, device=dev, **inputs)
    assert torch.equal(again["decisions"], res["decisions"])

    # ... and on the CPU through the plain versions
    torch.set_num_threads(8)
    t1 = time.perf_counter()
    cpu_inputs = {k: v if k == "har_cfg" else to_device(v, "cpu")
                  for k, v in inputs.items()}
    cpu = repro_torch.seeker_fleet_simulate(
        windows.cpu(), harvest.cpu(), labels=labels.cpu(),
        noise={k: v.cpu() for k, v in noise.items()}, device="cpu",
        **cpu_inputs)
    cpu_secs = time.perf_counter() - t1
    agree = float((cpu["decisions"] == res["decisions"].cpu())
                  .float().mean())
    pred_agree = float((cpu["preds"] == res["preds"].cpu()).float().mean())
    print(f"fleet N={N_NODES} S={N_SLOTS}: decisions agree with the CPU plain "
          f"run on {agree:.6f} of slots, preds on {pred_agree:.6f}")
    print(f"decision histogram (D0..D4, DEFER): card {hist.tolist()}, "
          f"cpu {cpu['decision_histogram'].tolist()}")
    assert agree >= 0.99
    fleet = dict(
        nodes=N_NODES, slots=N_SLOTS, ms_per_slot=secs / N_SLOTS * 1e3,
        windows_per_s=N_NODES * N_SLOTS / secs, decision_agreement=agree,
        pred_agreement=pred_agree, decision_histogram=hist.tolist(),
        completed_frac=float(res["completed_frac"]),
        fleet_accuracy=float(res["fleet_accuracy"]),
        bytes_on_wire=int(res["bytes_on_wire_exact"]),
        cpu_plain_seconds=cpu_secs, profile=profile_summary)
    print(f"fleet: {fleet['ms_per_slot']:.3f} ms/slot, "
          f"{fleet['windows_per_s']:.1f} windows/s on the card; "
          f"cpu plain run {cpu_secs:.1f} s")
    return fleet, launches


def phase_importance(torch, dev) -> dict:
    """The importance sampler's path: its entry point on the N=3000 HAR
    windows, with its launches counted, checked against the plain version
    on the CPU."""
    from repro_torch.data.sensors import har_windows
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(3)
    labels = torch.randint(0, 12, (N_NODES,), generator=g, device=dev)
    windows = har_windows(g, labels).contiguous()              # (3000, 60, 3)
    ops.reset_launch_counts()
    idx, vals, weights = ops.importance_select_op(windows, IMPORTANCE_M)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"signature_corr": 0, "fake_quant": 0, "kmeans_coreset": 0,
            "importance_select": 1}
    print(f"importance launches {launches}, expected {want}")
    assert launches == want, (launches, want)
    assert bool((idx[:, 1:] > idx[:, :-1]).all())          # distinct, ascending
    assert bool(torch.isfinite(weights).all() & (weights > 0).all())
    cpu = ref.importance_select_ref(windows.cpu(), IMPORTANCE_M)
    assert torch.equal(idx.cpu(), cpu[0])
    torch.testing.assert_close(vals.cpu(), cpu[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(weights.cpu(), cpu[2], rtol=1e-4, atol=1e-5)
    print(f"importance_select_op {tuple(windows.shape)} m={IMPORTANCE_M}: "
          f"indices equal to the CPU plain run on all windows")
    return launches


def phase_scarce_fleet(torch, dev) -> dict:
    """The scarce-harvest fleet: churn, brown-out and the intermittent
    lane at full HAR width, N=3000, S=32."""
    import repro_torch
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.decision import (D6_PARTIAL, D7_EARLY_EXIT,
                                           D8_STAGED_FULL, IntermittentConfig)
    from repro_torch.core.energy import (BrownoutConfig, fleet_alive_traces,
                                         fleet_harvest_traces)
    from repro_torch.core.recovery import init_generator
    from repro_torch.data.sensors import class_signatures, har_stream
    from repro_torch.kernels import ops
    from repro_torch.models.har import har_aux_init, har_init
    from repro_torch.serving.fleet import draw_fleet_noise, to_device

    n, s, cmp = N_NODES, SCARCE_SLOTS, COMPARE_SLOTS
    g = torch.Generator(device=dev).manual_seed(2)
    params = har_init(g, HAR)
    inputs = dict(
        signatures=class_signatures(device=dev), qdnn_params=params,
        host_params=params,
        gen_params=init_generator(g, HAR.window, HAR.channels), har_cfg=HAR,
        aux_params=har_aux_init(g, HAR), initial_uj=INITIAL_UJ,
        brownout=BrownoutConfig(*BROWNOUT_UJ),
        intermittent=IntermittentConfig(min_exit_stage=1, exit_threshold=0.0))
    windows, labels = har_stream(g, s, streams=n)             # (N, S, T, C)
    labels = labels.T.contiguous()                             # (S, N)
    harvest = fleet_harvest_traces(g, n, s) * SCARCITY
    alive = fleet_alive_traces(g, n, s)
    noise = draw_fleet_noise(g, s, n, HAR.window, HAR.channels)

    def run():
        return repro_torch.seeker_fleet_simulate(
            windows, harvest, labels=labels, alive=alive, noise=noise,
            device=dev, **inputs)

    ops.reset_launch_counts()
    res = run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # per slot: D2's three activations, stage 0's two and stage 1's one;
    # per run: four backbone and two auxiliary-head weight tensors
    want = {"signature_corr": s, "kmeans_coreset": s,
            "fake_quant": 6 * s + 6, "importance_select": 0}
    print(f"scarce fleet launches {launches}, expected {want}")
    assert launches == want, (launches, want)

    hist = res["decision_histogram"]
    assert int(hist.sum()) == int(res["alive_slots"])
    assert int((~alive).sum()) > 0 and int(res["brownout_events"]) > 0
    assert all(int(hist[code]) > 0
               for code in (D6_PARTIAL, D7_EARLY_EXIT, D8_STAGED_FULL))
    assert bool(torch.isfinite(res["logits"]).all())
    assert bool(torch.isfinite(res["stored_uj"]).all())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    profile_summary = _profile(torch, run, s, secs, "scarce_fleet")

    # the first slots again, on the CPU through the plain versions
    t1 = time.perf_counter()
    cpu_inputs = {k: to_device(v, "cpu")
                  if isinstance(v, (dict, tuple, torch.Tensor)) else v
                  for k, v in inputs.items()}
    cpu = repro_torch.seeker_fleet_simulate(
        windows[:, :cmp].cpu(), harvest[:, :cmp].cpu(),
        labels=labels[:cmp].cpu(), alive=alive[:, :cmp].cpu(),
        noise={k: v[:cmp].cpu() for k, v in noise.items()}, device="cpu",
        **cpu_inputs)
    cpu_secs = time.perf_counter() - t1
    card = {k: v[:cmp].cpu() for k, v in res.items()
            if k in ("decisions", "alive", "it_emit")}
    bo = res["brownout"][:cmp + 1].cpu()
    card_counts = {
        "brownout_events": int((bo[1:] & ~bo[:-1]).sum()),
        "it_full": int(((card["it_emit"] == 2) & card["alive"]).sum()),
        "it_early": int(((card["it_emit"] == 1) & card["alive"]).sum())}
    cpu_counts = {k: int(cpu[k]) for k in card_counts}
    agree = float((cpu["decisions"] == card["decisions"]).float().mean())
    print(f"scarce fleet N={n}: the first {cmp} slots' decisions agree with "
          f"the CPU plain run on {agree:.6f} of node-slots; counts card "
          f"{card_counts}, cpu {cpu_counts}")
    assert agree >= 0.99
    for k, v in cpu_counts.items():
        assert abs(card_counts[k] - v) <= 0.01 * max(v, 1), (k, card_counts)
    fleet = dict(
        nodes=n, slots=s, ms_per_slot=secs / s * 1e3,
        windows_per_s=n * s / secs, decision_agreement_first_slots=agree,
        compared_slots=cmp, card_counts_first_slots=card_counts,
        cpu_counts_first_slots=cpu_counts, decision_histogram=hist.tolist(),
        dead_slots=int((~alive).sum()),
        brownout_slots=int(res["brownout_slots"]),
        brownout_events=int(res["brownout_events"]),
        it_full=int(res["it_full"]), it_early=int(res["it_early"]),
        completed_frac=float(res["completed_frac"]),
        fleet_accuracy=float(res["fleet_accuracy"]),
        bytes_on_wire=int(res["bytes_on_wire_exact"]),
        launches=launches, cpu_plain_seconds=cpu_secs,
        profile=profile_summary)
    print(f"scarce fleet: {fleet['ms_per_slot']:.3f} ms/slot, "
          f"{fleet['windows_per_s']:.1f} windows/s on the card; histogram "
          f"D0..D8 {hist.tolist()}; cpu plain run of {cmp} slots "
          f"{cpu_secs:.1f} s")
    # what phase 8 serves: the first slots' windows and the engine's
    # emitted alive lane (brown-outs folded into the churn), kept on the
    # host so that they do not add to phase 7's peak device memory
    feed = dict(windows=windows[:, :HOST_SLOTS].cpu(),
                alive=res["alive"][:HOST_SLOTS].cpu(), params=params,
                gen_params=inputs["gen_params"])
    return fleet, feed


def phase_task_fleet(torch, dev) -> dict:
    """The mixed HAR and bearing fleet: the task lane with a host tree per
    task, and telemetry, at full HAR width, N=3000, S=32."""
    import repro_torch
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.decision import DEFER
    from repro_torch.core.energy import fleet_harvest_traces
    from repro_torch.core.recovery import init_generator
    from repro_torch.data.sensors import (bearing_stream, class_signatures,
                                          har_stream)
    from repro_torch.kernels import ops
    from repro_torch.models.har import har_init
    from repro_torch.obs import categorical_counts, counter_value
    from repro_torch.serving import TaskLaneConfig, fleet_task_assignment
    from repro_torch.serving.fleet import draw_fleet_noise, to_device

    n, s, cmp = N_NODES, MIXED_SLOTS, COMPARE_SLOTS
    t, c = HAR.window, HAR.channels
    g = torch.Generator(device=dev).manual_seed(4)
    params = har_init(g, HAR)
    hosts = tuple(har_init(torch.Generator(device=dev).manual_seed(seed), HAR)
                  for seed in (10, 11))
    task = TaskLaneConfig(per_task_host=True)
    tasks = fleet_task_assignment(n, task.n_tasks, dev)
    bearing = tasks == 1
    n_b = int(bearing.sum())
    har_w, har_l = har_stream(g, s, streams=n - n_b)        # (N0, S, T, C)
    brg_w, brg_l = bearing_stream(g, s, t=t, streams=n_b)   # (N1, S, T, 1)
    windows = torch.empty((n, s, t, c), device=dev)
    windows[~bearing] = har_w
    windows[bearing] = brg_w.expand(-1, -1, -1, c)
    labels = torch.empty((s, n), dtype=torch.int64, device=dev)
    labels[:, ~bearing] = har_l.T
    labels[:, bearing] = brg_l.T
    harvest = fleet_harvest_traces(g, n, s)
    noise = draw_fleet_noise(g, s, n, t, c)
    inputs = dict(signatures=class_signatures(device=dev), qdnn_params=params,
                  host_params=hosts,
                  gen_params=init_generator(g, t, c), har_cfg=HAR, task=task)

    def run(telemetry=True):
        return repro_torch.seeker_fleet_simulate(
            windows, harvest, labels=labels, noise=noise,
            telemetry=telemetry or None, device=dev, **inputs)

    ops.reset_launch_counts()
    res = run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"signature_corr": s, "kmeans_coreset": s,
            "fake_quant": 3 * s + 4, "importance_select": 0}
    print(f"task fleet launches {launches}, expected {want}")
    assert launches == want, (launches, want)

    done, miss = res["completed_by_task"], res["deadline_miss_by_task"]
    assert int(done.sum()) == int(res["completed"])
    assert int((done + miss).sum()) == int(res["alive_slots"])
    assert bool((done > 0).all()) and bool((miss > 0).all())
    tel = res["telemetry"]
    assert counter_value(tel, "fleet.wire_bytes") == int(
        res["bytes_on_wire_exact"])
    assert counter_value(tel, "fleet.completed") == int(res["completed"])
    assert counter_value(tel, "fleet.alive_slots") == int(res["alive_slots"])
    assert tel["fleet.decisions"].tolist() == res[
        "decision_histogram"].tolist()
    assert tel["fleet.task_completed"].tolist() == done.tolist()
    assert bool(torch.isfinite(res["logits"]).all())
    print(f"task fleet: completed_by_task {done.tolist()}, "
          f"deadline_miss_by_task {miss.tolist()}, correct_by_task "
          f"{res['correct_by_task'].tolist()}: the splits partition "
          f"completed {int(res['completed'])} and alive slots "
          f"{int(res['alive_slots'])}; the telemetry lanes equal the "
          f"aggregates")

    # host clock and profile, telemetry on and off in turns
    timing = {True: [], False: []}
    for on in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(on)
        torch.cuda.synchronize()
        timing[on].append(time.perf_counter() - t0)
    profiles = {on: _profile(torch, lambda on=on: run(on), s,
                             min(timing[on]),
                             "task_fleet" if on else "task_fleet_no_telemetry")
                for on in (True, False)}

    # the first slots again, on the CPU through the plain versions
    t1 = time.perf_counter()
    cpu_inputs = dict(inputs, host_params=tuple(to_device(h, "cpu")
                                                for h in hosts),
                      signatures=inputs["signatures"].cpu(),
                      qdnn_params=to_device(params, "cpu"),
                      gen_params=to_device(inputs["gen_params"], "cpu"))
    cpu = repro_torch.seeker_fleet_simulate(
        windows[:, :cmp].cpu(), harvest[:, :cmp].cpu(),
        labels=labels[:cmp].cpu(),
        noise={k: v[:cmp].cpu() for k, v in noise.items()}, telemetry=True,
        device="cpu", **cpu_inputs)
    cpu_secs = time.perf_counter() - t1
    dec = res["decisions"][:cmp].cpu()
    agree = float((cpu["decisions"] == dec).float().mean())
    sent = (dec != DEFER) & res["alive"][:cmp].cpu()
    card_done = categorical_counts(tasks.cpu()[None].expand(sent.shape),
                                   task.n_tasks, sent)
    print(f"task fleet N={n}: the first {cmp} slots' decisions agree with "
          f"the CPU plain run on {agree:.6f} of node-slots; completed_by_task "
          f"card {card_done.tolist()}, cpu "
          f"{cpu['completed_by_task'].tolist()}")
    assert agree >= 0.99
    for a, b in zip(card_done.tolist(), cpu["completed_by_task"].tolist()):
        assert abs(a - b) <= 0.01 * max(b, 1), (card_done, cpu)
    out = dict(
        nodes=n, slots=s, per_task_host=True,
        ms_per_slot={"telemetry": [x / s * 1e3 for x in timing[True]],
                     "no_telemetry": [x / s * 1e3 for x in timing[False]]},
        decision_agreement_first_slots=agree, compared_slots=cmp,
        completed_by_task=done.tolist(), deadline_miss_by_task=miss.tolist(),
        correct_by_task=res["correct_by_task"].tolist(),
        accuracy_by_task=res["accuracy_by_task"].tolist(),
        card_completed_by_task_first_slots=card_done.tolist(),
        cpu_completed_by_task_first_slots=cpu["completed_by_task"].tolist(),
        decision_histogram=res["decision_histogram"].tolist(),
        completed_frac=float(res["completed_frac"]),
        bytes_on_wire=int(res["bytes_on_wire_exact"]), launches=launches,
        cpu_plain_seconds=cpu_secs,
        profile={"telemetry": profiles[True],
                 "no_telemetry": profiles[False]})
    print(f"task fleet: ms/slot with telemetry "
          f"{out['ms_per_slot']['telemetry']}, without "
          f"{out['ms_per_slot']['no_telemetry']}; cpu plain run of "
          f"{cmp} slots {cpu_secs:.1f} s")
    return out


def _flat(tree) -> list:
    """The tensors of a nested NamedTuple or dict, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def phase_streamed(torch, dev) -> dict:
    """The streamed driver against one materialized run, bitwise, with
    phase 5's lanes, the task lane and telemetry, N=3000, S=32."""
    import repro_torch
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.decision import IntermittentConfig
    from repro_torch.core.energy import (BrownoutConfig, fleet_alive_traces,
                                         fleet_harvest_traces)
    from repro_torch.core.recovery import init_generator
    from repro_torch.data.sensors import class_signatures, har_stream
    from repro_torch.kernels import ops
    from repro_torch.models.har import har_aux_init, har_init
    from repro_torch.serving import TaskLaneConfig
    from repro_torch.serving.fleet import _active_lanes
    from repro_torch.serving.fleet_lanes import fleet_counter_keys

    n, s, chunk = N_NODES, STREAM_SLOTS, STREAM_CHUNK
    t, c = HAR.window, HAR.channels
    g = torch.Generator(device=dev).manual_seed(5)
    params = har_init(g, HAR)
    task, intermittent = TaskLaneConfig(), IntermittentConfig(1, 0.0)
    brownout = BrownoutConfig(*BROWNOUT_UJ)
    inputs = dict(
        signatures=class_signatures(device=dev), qdnn_params=params,
        host_params=params, gen_params=init_generator(g, t, c), har_cfg=HAR,
        aux_params=har_aux_init(g, HAR), initial_uj=INITIAL_UJ,
        brownout=brownout, intermittent=intermittent, task=task,
        telemetry=True)
    shared, shared_labels = har_stream(g, s)                  # (S, T, C)
    bias = 1e-3 * torch.arange(n, dtype=torch.float32,
                               device=dev)[:, None, None, None]

    def node_windows(a, b):
        """(N, b - a, T, C): one segment of the fleet's per-node streams."""
        return shared[a:b][None].expand(n, b - a, t, c) + bias

    labels = shared_labels[:, None].expand(s, n).contiguous()
    harvest = fleet_harvest_traces(g, n, s) * SCARCITY
    alive = fleet_alive_traces(g, n, s)
    kw = dict(labels=labels, alive=alive, device=dev, **inputs)
    seed = 6

    def measured(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, ops.launch_counts(),
                torch.cuda.max_memory_allocated())

    active = _active_lanes(intermittent, task, brownout)
    keys = (["decisions", "payload_bytes", "stored_uj", "alive", "brownout",
             "it_emit", "it_label", "it_conf", "it_src", "it_stage",
             "bytes_on_wire_exact", "final_brownout", "correct_by_task",
             "it_correct_full", "it_correct_early"]
            + list(fleet_counter_keys(active)))

    def keep(res):
        """What the comparison reads, moved off the card (the run's own
        memory is freed before the next run's peak is taken)."""
        return ({k: res[k].cpu() for k in keys},
                [x.cpu() for x in _flat((res["final_state"],
                                         res["final_intermittent"],
                                         res["telemetry"]))])

    mat, mat_secs, mat_launches, mat_peak = measured(
        lambda: repro_torch.seeker_fleet_simulate(
            node_windows(0, s), harvest,
            generator=torch.Generator(device=dev).manual_seed(seed), **kw))
    mat_kept = keep(mat)
    del mat
    torch.cuda.empty_cache()
    st, st_secs, st_launches, st_peak = measured(
        lambda: repro_torch.seeker_fleet_simulate_streamed(
            node_windows, harvest, chunk=chunk,
            generator=torch.Generator(device=dev).manual_seed(seed), **kw))
    n_chunks = st["n_chunks"]
    st_kept = keep(st)
    del st
    torch.cuda.empty_cache()
    want = {"signature_corr": s, "kmeans_coreset": s,
            "fake_quant": 6 * s + 6, "importance_select": 0}
    want_st = dict(want, fake_quant=6 * s + 6 * n_chunks)
    print(f"streamed: launches materialized {mat_launches}, expected {want}; "
          f"streamed {st_launches}, expected {want_st} (the weights are "
          f"quantized once per segment, {n_chunks} segments)")
    assert mat_launches == want, (mat_launches, want)
    assert st_launches == want_st, (st_launches, want_st)
    for k in keys:
        assert torch.equal(mat_kept[0][k], st_kept[0][k]), k
    assert len(mat_kept[1]) == len(st_kept[1])
    for a, b in zip(mat_kept[1], st_kept[1]):
        assert torch.equal(a, b)
    window_bytes = {"materialized": 4 * n * s * t * c,
                    "streamed": 4 * n * chunk * t * c}
    peaks = {"materialized": mat_peak, "streamed": st_peak}
    print(f"streamed N={n} S={s} chunk={chunk}: bitwise equal to the "
          f"materialized run on {len(keys)} traces and counters and "
          f"{len(mat_kept[1])} final-state and telemetry tensors; "
          f"torch.cuda.max_memory_allocated materialized {mat_peak} B, "
          f"streamed {st_peak} B (ratio {mat_peak / st_peak:.3f}); window "
          f"bytes held {window_bytes}; seconds materialized {mat_secs:.3f}, "
          f"streamed {st_secs:.3f}")
    hist = mat_kept[0]["decision_histogram"]
    assert int(hist.sum()) == int(mat_kept[0]["alive_slots"])

    # the materialized run once more, profiled, for its launches and
    # device time a slot beside phase 5's
    secs = mat_secs
    profile = _profile(torch, lambda: repro_torch.seeker_fleet_simulate(
        node_windows(0, s), harvest,
        generator=torch.Generator(device=dev).manual_seed(seed), **kw),
        s, secs, "streamed_materialized")
    return dict(
        nodes=n, slots=s, chunk=chunk, n_chunks=n_chunks,
        bitwise_equal_keys=keys, peak_bytes=peaks,
        peak_ratio=mat_peak / st_peak, window_bytes=window_bytes,
        seconds={"materialized": mat_secs, "streamed": st_secs},
        launches={"materialized": mat_launches, "streamed": st_launches},
        decision_histogram=hist.tolist(),
        completed_by_task=mat_kept[0]["completed_by_task"].tolist(),
        brownout_events=int(mat_kept[0]["brownout_events"]),
        it_full=int(mat_kept[0]["it_full"]), profile=profile)


_SOURCES = {
    "signature_corr": ("src/repro_torch/kernels/csrc/signature_corr.cu",
                       "src/repro/kernels/signature_corr.py:56"),
    "fake_quant": ("src/repro_torch/kernels/csrc/fake_quant.cu",
                   "src/repro/kernels/fake_quant.py:58"),
    "kmeans_coreset": ("src/repro_torch/kernels/csrc/kmeans_coreset.cu",
                       "src/repro/kernels/kmeans_coreset.py:84"),
    "importance_select": ("src/repro_torch/kernels/csrc/importance_select.cu",
                          "src/repro/kernels/importance_select.py:91"),
}


def _host_cfg(torch, **kw):
    """Phase 8's server: ``HostServeConfig(channels=3, k=12, m=20, t=60,
    n_classes=12, n_nodes=3000, batch_size=256, queue_capacity=4096,
    cache_capacity=4096, qos_slots=4, telemetry=True)``, fields in ``kw``
    replaced."""
    from repro_torch.host import HostServeConfig
    base = dict(channels=3, k=HOST_K, m=IMPORTANCE_M, t=60, n_classes=12,
                n_nodes=N_NODES, batch_size=256, queue_capacity=4096,
                cache_capacity=4096, qos_slots=4, telemetry=True)
    return HostServeConfig(**{**base, **kw})


def _host_checks(torch, card_state, card_outs, cpu_state, cpu_outs, cfg,
                 what: str) -> dict:
    """A card serve run against the CPU plain run on the same payloads:
    integer QoS and telemetry exactly equal, logits within 1e-3, the
    ensemble's answers on at least 99% of nodes."""
    from repro_torch.host import host_ensemble, host_server_stats
    card = host_server_stats(card_state, cfg)
    cpu = host_server_stats(cpu_state, cfg)
    for key in ("slot", "served", "deadline_misses", "drops_overflow",
                "backlog", "cache_hits", "cache_misses"):
        assert card[key] == cpu[key], (what, key, card[key], cpu[key])
    for name in card_state.metrics:
        assert torch.equal(card_state.metrics[name].cpu(),
                           cpu_state.metrics[name]), (what, name)
    for a, b in zip(card_outs, cpu_outs):
        for f in ("node_id", "deadline", "cache_hit", "valid"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (what, f)
    err = max(float((a.logits.cpu() - b.logits).abs().max())
              for a, b in zip(card_outs, cpu_outs))
    assert err <= 1e-3, (what, err)
    ec, ep = host_ensemble(card_state), host_ensemble(cpu_state)
    agree = {k: float((ec[k].cpu() == ep[k]).float().mean())
             for k in ("pred_vote", "pred_mean")}
    assert all(v >= 0.99 for v in agree.values()), (what, agree)
    assert torch.equal(ec["counts"].cpu(), ep["counts"])
    # the summed logits: 1e-3 for each payload a node summed (the card adds
    # a node's rows of one batch in an unspecified order)
    ens_err = float((card_state.ensemble_logits.cpu()
                     - cpu_state.ensemble_logits).abs().max())
    assert ens_err <= 1e-3 * max(1, int(ep["counts"].max())), (what, ens_err)
    print(f"host serve {what}: QoS and telemetry equal to the CPU plain run "
          f"({ {k: card[k] for k in ('served', 'deadline_misses', 'drops_overflow', 'backlog', 'cache_hits', 'cache_misses')} }); "
          f"logits within {err:.3g}, summed logits within {ens_err:.3g}; "
          f"ensemble agreement {agree}")
    return dict(stats={k: v for k, v in card.items() if k != "telemetry"},
                max_logit_err=err, max_ensemble_logit_err=ens_err,
                ensemble_agreement=agree)


def _count_syncs(torch, fn):
    """``fn()`` under CUDA's synchronisation debug mode: the number of
    synchronising operations it issued, and its seconds on the host clock
    (the warnings cost only at the synchronisations)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen), secs


def phase_host_serve(torch, dev, feed) -> dict:
    """The host tier at HAR's full width, N=3000, S=8: (a) the fleet's serve
    step in queue mode, fed phase 5's windows and emitted alive lane; (b) an
    under-provisioned server (8 batches of 256 a slot) on a lane of cluster
    and sampling entries that re-sends a quarter of the previous slot's
    frames.  Each against a CPU run of the plain versions on the card's own
    payloads."""
    import dataclasses
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.coreset import importance_coreset
    from repro_torch.host import (HostPayload, cluster_entries,
                                  host_serve_slot, host_server_init,
                                  sampling_entries, serve_fleet_payloads)
    from repro_torch.kernels import ops
    from repro_torch.serving import (encode_wire_samples, fleet_serve_step,
                                     wire_payload_from_bytes,
                                     wire_payload_nbytes,
                                     wire_payload_to_bytes)
    from repro_torch.serving.edge_host import _edge_encode_coresets
    from repro_torch.serving.fleet import to_device

    n, s = N_NODES, HOST_SLOTS
    windows = feed["windows"][:, :s].to(dev).contiguous()    # (N, S, T, C)
    alive = feed["alive"][:s].to(dev)                        # (S, N)
    params, gen = feed["params"], feed["gen_params"]
    cpu_params, cpu_gen = to_device(params, "cpu"), to_device(gen, "cpu")
    out = {}

    # --- (a) fleet_serve_step, queue mode ----------------------------------
    cfg_a = _host_cfg(torch)

    def run_a():
        state, outs, wire_bytes = host_server_init(cfg_a, dev), [], 0
        for t in range(s):
            r = fleet_serve_step(
                windows[:, t], host_params=params, har_cfg=HAR,
                k=HOST_K, host_state=state, serve_cfg=cfg_a,
                gen_params=gen, engine_alive=alive[t], device=dev)
            state = r["host_state"]
            outs.append(r["slot_output"])
            wire_bytes += r["wire_bytes"]
        return state, outs, wire_bytes

    ops.reset_launch_counts()
    state_a, outs_a, wire_bytes = run_a()
    torch.cuda.synchronize()
    launches_a = ops.launch_counts()
    # the steady state: a second run, timed, its synchronisations counted
    syncs_a, secs_a = _count_syncs(torch, run_a)
    want = {"signature_corr": 0, "fake_quant": 0, "kmeans_coreset": s,
            "importance_select": 0}
    print(f"host serve (a) launches {launches_a}, expected {want}; "
          f"synchronisations {syncs_a} in {s} slots")
    assert launches_a == want, (launches_a, want)
    frames = int(alive.sum())
    assert wire_bytes == frames * wire_payload_nbytes(HOST_K, 3), \
        (wire_bytes, frames)
    prof_a = _profile(torch, run_a, s, secs_a, "host_serve_fleet")

    # the card's payloads, encoded again (the kernel is bit-identical from
    # launch to launch), against the plain encode on the CPU, and served
    # on the CPU
    cards = [_edge_encode_coresets(windows[:, t], HOST_K) for t in range(s)]
    frame = wire_payload_to_bytes(cards[0])
    back = wire_payload_from_bytes(frame)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(cards[0], back))
    enc = {"counts_equal": True, "c_codes_pm1_share": 0.0,
           "r_codes_pm1_share": 0.0}
    for t in range(s):
        plain = _edge_encode_coresets(windows[:, t].cpu(), HOST_K)
        assert torch.equal(cards[t].n_codes.cpu(), plain.n_codes), t
        for f in ("c_codes", "r_codes"):
            d = (getattr(cards[t], f).cpu().int()
                 - getattr(plain, f).int()).abs()
            assert int(d.max()) <= 1, (t, f, int(d.max()))
            enc[f"{f}_pm1_share"] = max(enc[f"{f}_pm1_share"],
                                        float((d == 1).float().mean()))
    print(f"host serve edge encode: counts equal to the CPU plain encode in "
          f"all {s} slots; share of codes off by one {enc}; a frame of "
          f"{len(frame)} B round-trips exactly")
    cpu_state, cpu_outs = host_server_init(cfg_a, "cpu"), []
    for t in range(s):
        cpu_state, o = serve_fleet_payloads(
            cpu_state, type(cards[t])(*(x.cpu() for x in cards[t])),
            torch.arange(n, dtype=torch.int32), cfg=cfg_a,
            host_params=cpu_params, gen_params=cpu_gen,
            mask=alive[t].cpu())
        cpu_outs.append(o)
    out["fleet_queue_mode"] = dict(
        nodes=n, slots=s, frames=frames, wire_bytes=wire_bytes,
        launches=launches_a, syncs_per_slot=syncs_a / s,
        ms_per_slot=secs_a / s * 1e3, profile=prof_a, edge_encode=enc,
        **_host_checks(torch, state_a, outs_a, cpu_state, cpu_outs, cfg_a,
                       "(a) fleet_serve_step"))

    # --- (b) an under-provisioned server on a mixed, re-sending lane -------
    # 2048 rows served a slot against about 3750 arrivals; a queue of four
    # slots' service and deadlines two slots out, so the backlog outgrows
    # the deadlines (misses) and then the ring (overflow drops)
    cfg_b = _host_cfg(torch, batches_per_slot=8, queue_capacity=8192,
                      qos_slots=2)
    resend = torch.arange(0, n, 4, device=dev)               # a fixed quarter
    half = n // 2
    g = torch.Generator(device=dev).manual_seed(8)
    u = torch.rand((s, n - half, 60), generator=g, device=dev) * (
        1.0 - 1e-9) + 1e-9

    def lane(t, prev):
        """Slot t's lane: the quarter re-sent from slot t-1 first, then the
        first half of the nodes' cluster frames and the rest's sampling
        frames; every fresh frame is sent."""
        w = windows[:, t]
        ce = cluster_entries(_edge_encode_coresets(w[:half], HOST_K),
                             IMPORTANCE_M)
        sc = importance_coreset(w[half:], IMPORTANCE_M, u[t])
        se = sampling_entries(encode_wire_samples(
            sc.indices, sc.values, sc.mean, sc.var), HOST_K)
        fresh = HostPayload(*(torch.cat([a, b]) for a, b in zip(ce, se)))
        nid = torch.arange(n, dtype=torch.int32, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        if prev is None:
            prev = (fresh, nid, torch.zeros_like(mask))
        entries = HostPayload(*(torch.cat([b[resend], a])
                                for a, b in zip(fresh, prev[0])))
        return (entries, torch.cat([prev[1][resend], nid]),
                torch.cat([prev[2][resend], mask]), (fresh, nid, mask))

    def run_b(keep=None):
        state, outs, prev = host_server_init(cfg_b, dev), [], None
        for t in range(s):
            entries, nid, mask, prev = lane(t, prev)
            if keep is not None:
                keep.append((entries, nid, mask))
            state, o = host_serve_slot(state, entries, nid, mask, cfg=cfg_b,
                                       host_params=params, gen_params=gen)
            outs.append(o)
        return state, outs

    lanes = []
    ops.reset_launch_counts()
    state_b, outs_b = run_b(lanes)
    torch.cuda.synchronize()
    launches_b = ops.launch_counts()
    syncs_b, secs_b = _count_syncs(torch, run_b)
    print(f"host serve (b) launches {launches_b}, expected {want}; "
          f"synchronisations {syncs_b} in {s} slots; lane width "
          f"{lanes[0][0].kind.shape[0]} of queue capacity "
          f"{cfg_b.queue_capacity}")
    assert launches_b == want, (launches_b, want)
    prof_b = _profile(torch, run_b, s, secs_b, "host_serve_underprovisioned")
    cpu_state, cpu_outs = host_server_init(cfg_b, "cpu"), []
    for entries, nid, mask in lanes:
        cpu_state, o = host_serve_slot(
            cpu_state, HostPayload(*(x.cpu() for x in entries)), nid.cpu(),
            mask.cpu(), cfg=cfg_b, host_params=cpu_params,
            gen_params=cpu_gen)
        cpu_outs.append(o)
    checks = _host_checks(torch, state_b, outs_b, cpu_state, cpu_outs, cfg_b,
                          "(b) under-provisioned")
    st = checks["stats"]
    assert st["deadline_misses"] > 0 and st["drops_overflow"] > 0
    assert st["cache_hits"] > 0 and st["backlog"] > 0
    out["underprovisioned"] = dict(
        nodes=n, slots=s, lane_width=int(lanes[0][0].kind.shape[0]),
        rows_served_per_slot=cfg_b.batches_per_slot * cfg_b.batch_size,
        launches=launches_b, syncs_per_slot=syncs_b / s,
        ms_per_slot=secs_b / s * 1e3, profile=prof_b, **checks)
    for key, row in out.items():
        print(f"host serve {key}: {row['ms_per_slot']:.3f} ms/slot, device "
              f"busy {row['profile']['device_busy_ms_per_slot']:.4f} ms/slot,"
              f" idle share {row['profile']['device_idle_share']:.3f}, "
              f"{row['profile']['kernel_launches_per_slot']:.1f} launches/slot,"
              f" {row['syncs_per_slot']:g} synchronisations/slot")
    out["config"] = dataclasses.asdict(cfg_a)
    return out


def _sharded_inputs(torch, dev, n: int, s: int):
    """Phase 9's fleet, the same on every rank from seed 9: per-node HAR
    streams with labels, phase 5's scarce harvest, churn, brown-out and
    intermittent lane, the task lane (round robin) and telemetry."""
    import repro_torch
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.decision import IntermittentConfig
    from repro_torch.core.energy import (BrownoutConfig, fleet_alive_traces,
                                         fleet_harvest_traces)
    from repro_torch.core.recovery import init_generator
    from repro_torch.data.sensors import class_signatures, har_stream
    from repro_torch.models.har import har_aux_init, har_init

    g = torch.Generator(device=dev).manual_seed(9)
    params = har_init(g, HAR)
    windows, labels = har_stream(g, s, streams=n)             # (N, S, T, C)
    harvest = fleet_harvest_traces(g, n, s) * SCARCITY
    kw = dict(
        signatures=class_signatures(device=dev), qdnn_params=params,
        host_params=params,
        gen_params=init_generator(g, HAR.window, HAR.channels), har_cfg=HAR,
        aux_params=har_aux_init(g, HAR), initial_uj=INITIAL_UJ,
        brownout=BrownoutConfig(*BROWNOUT_UJ),
        intermittent=IntermittentConfig(min_exit_stage=1, exit_threshold=0.0),
        task=repro_torch.TaskLaneConfig(), telemetry=True,
        labels=labels.T.contiguous(), alive=fleet_alive_traces(g, n, s),
        device=dev)
    return windows, harvest, kw


def _sharded_ints(res) -> dict:
    """What phase 9 holds equal across layouts: the integer and energy
    traces, the aggregates and the telemetry lanes, on the CPU."""
    keys = ("decisions", "payload_bytes", "stored_uj", "k_trace", "alive",
            "brownout", "it_emit", "it_stage", "preds", "bytes_on_wire_exact",
            "decision_histogram", "completed", "alive_slots",
            "brownout_slots", "brownout_events", "it_full", "it_early",
            "correct", "completed_by_task", "deadline_miss_by_task",
            "final_brownout")
    out = {k: res[k].cpu() for k in keys}
    out.update({f"telemetry/{k}": v.cpu()
                for k, v in res["telemetry"].items()})
    out["final_stored_uj"] = res["final_state"].stored_uj.cpu()
    return out


def _collectives(torch, run, secs: float) -> dict:
    """``run()`` under the profiler: the host time of the collectives
    (``c10d::`` ops) and the device time of NCCL's kernels, and the host
    time's share of ``secs``, the run's host clock without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    on_device = [e for e in rows if e.device_type == DeviceType.CUDA]
    host = sum(e.cpu_time_total for e in rows if e.key.startswith("c10d::"))
    dev = sum(_self_device_us(e) for e in on_device
              if "nccl" in e.key.lower())
    return dict(collective_host_ms=host / 1e3,
                collective_device_ms=dev / 1e3,
                collective_host_share=host / 1e6 / secs,
                device_busy_ms=sum(map(_self_device_us, on_device)) / 1e3,
                kernel_launches=sum(e.count for e in on_device),
                ops={e.key: e.count for e in rows
                     if e.key.startswith(("c10d::", "nccl:", "gloo:"))})


def _sharded_rank(argv) -> int:
    """One of phase 9's gloo ranks sharing the card (started by
    :func:`phase_sharded` as ``chip_smoke.py --sharded-rank R WORLD STORE
    OUT DEVICE``): the N=3001 fleet on a (2, WORLD/2) ("pod", "data") mesh
    on DEVICE, twice (the second timed and profiled), and once more with
    per-node keyed noise, written to OUT."""
    import torch
    import torch.distributed as dist
    rank, world, store, out, dev = argv[:5]
    rank, world, dev = int(rank), int(world), torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.sharding import make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((2, world // 2), ("pod", "data"), dev.type)
        windows, harvest, kw = _sharded_inputs(torch, dev, SHARD_GLOO_N,
                                               SHARD_GLOO_SLOTS)

        def run():
            return repro_torch.seeker_fleet_simulate_sharded(
                windows, harvest, mesh=mesh, node_block=None,
                generator=torch.Generator(device=dev).manual_seed(10), **kw)

        ops.reset_launch_counts()
        res = run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        dist.barrier()
        syncs, secs = _count_syncs(torch, run)
        dist.barrier()
        coll = _collectives(torch, run, secs)
        # (c) the same fleet drawing from per-node keys: each rank hashes
        # only its tile's keys
        keyed = repro_torch.seeker_fleet_simulate_sharded(
            windows, harvest, mesh=mesh, node_block=None,
            node_keys=repro_torch.fleet_node_keys(KEY_SEED, SHARD_GLOO_N,
                                                  dev), **kw)
        torch.save(dict(ints=_sharded_ints(res), launches=launches,
                        seconds=secs, syncs=syncs, collectives=coll,
                        padded_nodes=res["padded_nodes"],
                        node_axes=res["node_axes"],
                        keyed=dict(_sharded_ints(keyed),
                                   final_keys=keyed["final_keys"].cpu())),
                   out)
    finally:
        dist.destroy_process_group()
    return 0


def _noise_bytes_per_node() -> int:
    """The float32 noise one node draws a slot: D4's uniforms, the
    recovery's directions and radii, the generator's latent."""
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.serving.fleet import LATENT
    t, c = HAR.window, HAR.channels
    return 4 * (t + c * t * 2 + c * t + LATENT)


def _sharded_keyed(torch, dev, mesh, windows, harvest, kw, world1) -> dict:
    """Phase 9 (c): per-node keyed noise on the card.  The keys and one
    slot's hash words and uniforms bitwise a CPU run's; phase 4's bare
    fleet keyed against a CPU plain run; at world size 1 the sharded keyed
    run with every lane bitwise the single-device keyed run; the streamed
    driver chained through ``final_keys`` bitwise one run."""
    import repro_torch
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.kernels import ops
    from repro_torch.serving.fleet import draw_slot_noise_keyed, to_device

    n, s = harvest.shape
    t, c = HAR.window, HAR.channels
    keys = repro_torch.fleet_node_keys(KEY_SEED, n, dev)
    cpu_keys = repro_torch.fleet_node_keys(KEY_SEED, n, "cpu")
    assert torch.equal(keys.cpu(), cpu_keys)
    nz, nxt = draw_slot_noise_keyed(keys, t, c)
    cnz, cnxt = draw_slot_noise_keyed(cpu_keys, t, c)
    assert torch.equal(nxt.cpu(), cnxt)
    for k in ("u", "radii_u"):             # integers times 2**-24: exact
        assert torch.equal(nz[k].cpu(), cnz[k]), k
    normal_err = max(float((nz[k].cpu() - cnz[k]).abs().max())
                     for k in ("dirs", "latent"))

    # phase 4's bare fleet, keyed, against the CPU plain run
    bw, bh, blabels, binputs = _bare_inputs(torch, dev)
    bare = repro_torch.seeker_fleet_simulate(
        bw, bh, labels=blabels, node_keys=keys, device=dev, **binputs)
    cpu_inputs = {k: v if k == "har_cfg" else to_device(v, "cpu")
                  for k, v in binputs.items()}
    cpu = repro_torch.seeker_fleet_simulate(
        bw.cpu(), bh.cpu(), labels=blabels.cpu(), node_keys=cpu_keys,
        device="cpu", **cpu_inputs)
    agree = float((cpu["decisions"] == bare["decisions"].cpu())
                  .float().mean())
    assert agree >= 0.99, agree
    assert torch.equal(bare["final_keys"].cpu(), cpu["final_keys"])
    del bw, bh, blabels, binputs, bare, cpu

    def single():
        return repro_torch.seeker_fleet_simulate(
            windows, harvest, node_keys=keys, **kw)

    def sharded():
        return repro_torch.seeker_fleet_simulate_sharded(
            windows, harvest, mesh=mesh, node_keys=keys, **kw)

    ops.reset_launch_counts()
    got = sharded()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = single()
    a, b = _sharded_ints(got), _sharded_ints(want)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["final_keys"], want["final_keys"])
    streamed = repro_torch.seeker_fleet_simulate_streamed(
        windows, harvest, chunk=KEY_CHUNK, node_keys=keys, **kw)
    c_ = _sharded_ints(streamed)
    for k in b:
        assert torch.equal(c_[k], b[k]), ("streamed", k)
    assert torch.equal(streamed["logits"], want["logits"])
    assert torch.equal(streamed["final_keys"], want["final_keys"])
    assert streamed["n_chunks"] == -(-s // KEY_CHUNK)
    syncs, secs = _count_syncs(torch, single)
    print(f"sharded (c) keyed noise: keys and one slot's hash words and "
          f"uniforms bitwise the CPU's at N={n} (normals within "
          f"{normal_err:.3g}); bare fleet S={s} keyed: decisions agree with "
          f"the CPU plain run on {agree:.6f} of node-slots, final keys "
          f"bitwise; world size 1 sharded keyed run with every lane: "
          f"{len(b)} integer traces, aggregates and telemetry lanes, logits "
          f"and final keys bitwise the single-device keyed run; "
          f"{s // KEY_CHUNK} streamed segments chained through final_keys "
          f"bitwise the {s}-slot run; {secs / s * 1e3:.3f} ms/slot keyed "
          f"against {world1['single_device_ms_per_slot']:.3f} from a "
          f"generator, {syncs / s:g} synchronisations/slot; launches "
          f"{launches}")
    return dict(nodes=n, slots=s, launches=launches, equal_keys=sorted(b),
                decision_agreement=agree, normal_max_err=normal_err,
                ms_per_slot=secs / s * 1e3,
                generator_ms_per_slot=world1["single_device_ms_per_slot"],
                syncs_per_slot=syncs / s, chunk=KEY_CHUNK,
                noise_bytes_per_node=_noise_bytes_per_node())


def phase_sharded(torch, dev) -> dict:
    """The sharded fleet driver: (a) at world size 1 on NCCL, the card's
    own layout, N=3000, S=8 with every lane, against the single-device
    engine with the same generator seed (every output bitwise, the same
    kernel launches), and the per-shard host serve step against the
    single-device queue mode; (b) 4 gloo ranks sharing the card on a
    (2, 2) mesh at N=3001 (3 padding nodes), S=4, against a one-rank run;
    (c) per-node keyed noise (:func:`_sharded_keyed`, and (b)'s ranks
    once more with keys)."""
    import shutil
    import torch.distributed as dist
    import repro_torch
    from repro_torch.host import (host_server_init, host_server_init_stacked,
                                  host_server_stats)
    from repro_torch.kernels import ops
    from repro_torch.sharding import make_mesh

    n, s = N_NODES, N_SLOTS
    store = REPO / "build" / "sharded_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store / "nccl"),
                                                         1),
                            rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1,), ("data",), "cuda")
        windows, harvest, kw = _sharded_inputs(torch, dev, n, s)

        def single():
            return repro_torch.seeker_fleet_simulate(
                windows, harvest,
                generator=torch.Generator(device=dev).manual_seed(10), **kw)

        def sharded():
            return repro_torch.seeker_fleet_simulate_sharded(
                windows, harvest, mesh=mesh,
                generator=torch.Generator(device=dev).manual_seed(10), **kw)

        ops.reset_launch_counts()
        want = single()
        torch.cuda.synchronize()
        single_launches = ops.launch_counts()
        ops.reset_launch_counts()
        got = sharded()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        print(f"sharded (a) launches {launches}, single-device "
              f"{single_launches}")
        assert launches == single_launches, (launches, single_launches)
        assert got["padded_nodes"] == 0 and got["node_axes"] == ("data",)
        a, b = _sharded_ints(got), _sharded_ints(want)
        for k in b:
            assert torch.equal(a[k], b[k]), k
        logit_err = float((got["logits"] - want["logits"]).abs().max())
        hist = b["decision_histogram"]
        syncs, secs = _count_syncs(torch, sharded)
        single_syncs, single_secs = _count_syncs(torch, single)
        profile = _profile(torch, sharded, s, secs, "sharded")
        coll = _collectives(torch, sharded, secs)
        print(f"sharded (a) N={n} S={s} on NCCL, world size 1: {len(b)} "
              f"integer traces, aggregates and telemetry lanes equal to the "
              f"single-device engine's; logits within {logit_err:.3g}; "
              f"{secs / s * 1e3:.3f} ms/slot against "
              f"{single_secs / s * 1e3:.3f} single-device; "
              f"{syncs / s:g} synchronisations/slot "
              f"({single_syncs / s:g} single-device); "
              f"collectives {coll['collective_host_ms']:.3f} ms host "
              f"({coll['collective_host_share']:.4f} of the run), "
              f"{coll['collective_device_ms']:.3f} ms device; histogram "
              f"D0..D8 {hist.tolist()}, brown-out events "
              f"{int(b['brownout_events'])}")
        out["world1"] = dict(
            nodes=n, slots=s, backend="nccl", launches=launches,
            equal_keys=sorted(b), max_logit_err=logit_err,
            ms_per_slot=secs / s * 1e3,
            single_device_ms_per_slot=single_secs / s * 1e3,
            syncs_per_slot=syncs / s,
            single_device_syncs_per_slot=single_syncs / s, profile=profile,
            collectives=coll,
            decision_histogram=hist.tolist())

        # the per-shard host at world size 1 is one server over the fleet:
        # the single-device queue mode's
        cfg = _host_cfg(torch)
        alive = want["alive"]
        wins = windows[:, :HOST_SLOTS]

        def serve(per_shard):
            state = (host_server_init_stacked(cfg, 1, dev) if per_shard
                     else host_server_init(cfg, dev))
            qos, outs = None, []
            for t in range(HOST_SLOTS):
                r = repro_torch.fleet_serve_step(
                    wins[:, t], host_params=kw["host_params"],
                    har_cfg=kw["har_cfg"], k=HOST_K, host_state=state,
                    serve_cfg=cfg, gen_params=kw["gen_params"],
                    engine_alive=alive[t], device=dev,
                    **(dict(mesh=mesh, per_shard_host=True) if per_shard
                       else {}))
                state, qos = r["host_state"], r.get("qos")
                outs.append(r["slot_output"])
            return state, outs, qos, r.get("telemetry")

        ops.reset_launch_counts()
        st_ps, outs_ps, qos, tel = serve(True)
        torch.cuda.synchronize()
        serve_launches = ops.launch_counts()
        st_q, outs_q, _, _ = serve(False)
        row = type(st_q)(*(None if f is None else _first_row(f)
                           for f in st_ps))
        stats = host_server_stats(st_q, cfg)
        assert qos == {k: stats[k] for k in ("served", "deadline_misses",
                                             "drops_overflow")}, (qos, stats)
        for name, lane in st_q.metrics.items():
            assert torch.equal(tel[name], lane), name
            assert torch.equal(row.metrics[name], lane), name
        for x, y in zip(outs_ps, outs_q):
            for a_, b_ in zip(x, y):
                assert torch.equal(a_, b_)
        serve_syncs, serve_secs = _count_syncs(torch, lambda: serve(True))
        print(f"sharded (a) per-shard host, {HOST_SLOTS} slots: QoS {qos} "
              f"and telemetry equal to the single-device queue mode; "
              f"launches {serve_launches}; {serve_secs / HOST_SLOTS * 1e3:.3f}"
              f" ms/slot, {serve_syncs / HOST_SLOTS:g} synchronisations/slot")
        out["per_shard_host"] = dict(
            slots=HOST_SLOTS, qos=qos, launches=serve_launches,
            ms_per_slot=serve_secs / HOST_SLOTS * 1e3,
            syncs_per_slot=serve_syncs / HOST_SLOTS)

        # the pod-paired step on a (1, 1) mesh pairs the pod with itself:
        # fleet_serve_step's direct mode, bit for bit
        pods = make_mesh((1, 1), ("pod", "data"), "cuda")
        win0 = windows[:, 0].contiguous()
        ops.reset_launch_counts()
        paired = repro_torch.edge_host_serve_step(
            win0, mesh=pods, k=HOST_K,
            generator=torch.Generator(device=dev).manual_seed(11),
            **{k: kw[k] for k in ("signatures", "qdnn_params", "host_params",
                                  "gen_params", "har_cfg", "device")})
        torch.cuda.synchronize()
        paired_launches = ops.launch_counts()
        direct = repro_torch.fleet_serve_step(
            win0, host_params=kw["host_params"], har_cfg=kw["har_cfg"],
            k=HOST_K, generator=torch.Generator(device=dev).manual_seed(11),
            device=dev)["host_logits"]
        assert torch.equal(paired, direct)
        assert paired_launches["kmeans_coreset"] == 1, paired_launches
        print(f"sharded (a) edge_host_serve_step on a (1, 1) pod mesh, "
              f"{n} windows: logits bitwise the direct serve step's; "
              f"launches {paired_launches}")
        out["edge_host"] = dict(windows=n, launches=paired_launches)
        out["keyed"] = _sharded_keyed(torch, dev, mesh, windows, harvest, kw,
                                      out["world1"])

        # (b) the one-rank runs the gloo ranks are held to
        gn, gs = SHARD_GLOO_N, SHARD_GLOO_SLOTS
        g_windows, g_harvest, g_kw = _sharded_inputs(torch, dev, gn, gs)
        one = _sharded_ints(repro_torch.seeker_fleet_simulate_sharded(
            g_windows, g_harvest, mesh=mesh,
            generator=torch.Generator(device=dev).manual_seed(10), **g_kw))
        one_keyed = repro_torch.seeker_fleet_simulate_sharded(
            g_windows, g_harvest, mesh=mesh,
            node_keys=repro_torch.fleet_node_keys(KEY_SEED, gn, dev), **g_kw)
        one_keyed = dict(_sharded_ints(one_keyed),
                         final_keys=one_keyed["final_keys"].cpu())
        del g_windows, g_harvest, g_kw
    finally:
        dist.destroy_process_group()

    world = SHARD_RANKS
    files = [store / f"rank{r}.pt" for r in range(world)]
    logs = [open(store / f"rank{r}.log", "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-rank",
         str(r), str(world), str(store / "gloo"), str(files[r]), str(dev)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    wall = time.perf_counter() - t0
    failed = [r for r, p in enumerate(procs) if p.returncode]
    for r in failed:
        print((store / f"rank{r}.log").read_text()[-3000:])
    assert not failed, f"gloo ranks {failed} failed"
    ranks = [torch.load(f, weights_only=False) for f in files]
    for r, res in enumerate(ranks):
        assert res["padded_nodes"] == (-gn) % world, res["padded_nodes"]
        for k in one:
            assert torch.equal(res["ints"][k], one[k]), (r, k)
        for k in one_keyed:
            assert torch.equal(res["keyed"][k], one_keyed[k]), (r, "keyed", k)
    tile = (gn + (-gn) % world) // world
    per_node = _noise_bytes_per_node()
    print(f"sharded (c) {world} gloo ranks keyed, N={gn}: every rank's "
          f"{len(one_keyed)} traces, aggregates, telemetry lanes and final "
          f"keys equal to the one-rank keyed run; noise drawn a rank and "
          f"slot {tile * per_node / 1e6:.3f} MB keyed (its {tile}-node "
          f"tile) against {gn * per_node / 1e6:.3f} MB from a generator "
          f"(the whole fleet)")
    out["keyed"]["gloo_ranks"] = dict(
        ranks=world, nodes=gn, equal_keys=sorted(one_keyed),
        tile_nodes=tile, noise_bytes_per_slot_keyed=tile * per_node,
        noise_bytes_per_slot_generator=gn * per_node)
    launches_b = [res["launches"] for res in ranks]
    colls = [res["collectives"] for res in ranks]
    print(f"sharded (b) {world} gloo ranks on one card, N={gn} S={gs}, "
          f"{ranks[0]['padded_nodes']} padding nodes, mesh "
          f"{ranks[0]['node_axes']}: every rank's {len(one)} traces, "
          f"aggregates and telemetry lanes equal to the one-rank run; "
          f"ms/slot per rank "
          f"{[round(r['seconds'] / gs * 1e3, 3) for r in ranks]}; "
          f"device busy ms/slot "
          f"{[round(c['device_busy_ms'] / gs, 4) for c in colls]}; "
          f"synchronisations/slot {[r['syncs'] / gs for r in ranks]}; "
          f"collectives' host share "
          f"{[round(c['collective_host_share'], 3) for c in colls]}; "
          f"launches {launches_b[0]}; {wall:.1f} s with start-up")
    out["gloo_ranks"] = dict(
        ranks=world, nodes=gn, slots=gs, padded_nodes=ranks[0]["padded_nodes"],
        mesh=list(ranks[0]["node_axes"]), equal_keys=sorted(one),
        launches_per_rank=launches_b,
        ms_per_slot=[r["seconds"] / gs * 1e3 for r in ranks],
        syncs_per_slot=[r["syncs"] / gs for r in ranks],
        device_busy_ms_per_slot=[r["collectives"]["device_busy_ms"] / gs
                                 for r in ranks],
        kernel_launches_per_slot=[r["collectives"]["kernel_launches"] / gs
                                  for r in ranks],
        collectives=[r["collectives"] for r in ranks], wall_seconds=wall)
    return out


def _hold_at(torch, match, kernel_fn, plain_fn, nbytes, flops, exact,
             library_fn=None):
    """One kernel against its plain version on the card at a shape of this
    slice's paths: bit-equal (``exact``) or within 1e-4, integer outputs
    equal; with its device time (the profiler's kernels whose name holds
    ``match``), the plain version's, the library call's (``library_fn``,
    where one computes the same function) and its bound."""
    got, want = kernel_fn(), plain_fn()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0.0
    for g_out, w_out in zip(got, want):
        if exact:
            _assert_same_bits(torch, g_out, w_out, match)
        elif g_out.is_floating_point():
            torch.testing.assert_close(g_out, w_out, rtol=0, atol=1e-4)
            err = max(err, float((g_out - w_out).abs().max()))
        else:
            assert torch.equal(g_out, w_out), match
    _same_twice(torch, kernel_fn)
    times, extra = _timings(torch, kernel_fn, match, plain_fn, library_fn)
    bound, by = _bound_ms(nbytes, flops)
    return dict(max_abs_err=err, bound_ms=bound, bound_by=by,
                call_ms=extra["call_ms"], **times)


def _oracle_shapes(torch, dev, windows, sigs, qp) -> dict:
    """The three kernels at the per-sensor oracle's shapes (one node a
    call): ``signature_corr`` (1, 60, 3) against the 12-signature bank,
    ``kmeans_coreset`` on the window's 3 channel clouds of (60, 2) and
    D2's three per-node ``fake_quant`` activations, each against its plain
    version (``fake_quant`` bit for bit), with the library calls of phase
    3's table: the ``einsum`` and the scale chain with
    ``fake_quantize_per_tensor_affine``."""
    from repro_torch.core.coreset import points_from_window
    from repro_torch.kernels import ops, ref
    from repro_torch.models.har import _conv1d, _maxpool2

    rows = {}
    win = windows[:1].contiguous()                           # (1, 60, 3)
    t, c = win.shape[1:]
    l = sigs.shape[0]
    # the library yardstick of phase 3: one einsum over operands centred
    # and normalised beforehand
    wm = win - win.mean(1, keepdim=True)
    sm = sigs - sigs.mean(1, keepdim=True)
    a_op = wm / (wm.norm(dim=1, keepdim=True) * c)
    b_op = sm / sm.norm(dim=1, keepdim=True)
    torch.testing.assert_close(torch.einsum("btc,ltc->bl", a_op, b_op),
                               ref.signature_corr_ref(win, sigs), rtol=1e-4,
                               atol=1e-5)
    rows["signature_corr (1, 60, 3)"] = _hold_at(
        torch, "signature_corr_kernel",
        lambda: ops.signature_corr_op(win, sigs),
        lambda: ref.signature_corr_ref(win, sigs),
        4 * (t * c + l * t * c + l), 2 * l * t * c + 6 * t * c, exact=False,
        library_fn=lambda: torch.einsum("btc,ltc->bl", a_op, b_op))
    pts = points_from_window(win[0].T[..., None]).contiguous()  # (3, 60, 2)
    nb, n, d = pts.shape
    k, iters = HOST_K, 4
    rows["kmeans_coreset (3, 60, 2)"] = _hold_at(
        torch, "kmeans_coreset_kernel", lambda: ops.kmeans_coreset_op(pts, k),
        lambda: ref.kmeans_coreset_ref(pts, k),
        4 * (nb * n * d + nb * k * d + 2 * nb * k),
        ((iters + 1) * nb * n * k * 3 * d + iters * nb * n * d
         + iters * nb * k * d + nb * n), exact=False)
    # D2's activations of one node, as _quantized_forward feeds them
    h1 = _maxpool2(torch.relu(_conv1d(win, qp["conv1_w"], qp["conv1_b"])))
    h2 = _maxpool2(torch.relu(_conv1d(h1, qp["conv2_w"], qp["conv2_b"])))
    zero_point = torch.zeros((), dtype=torch.int32, device=dev)

    def quant_library(x):
        # one node's scale chain and fake_quantize_per_tensor_affine (a
        # yardstick, as phase 3's: it multiplies by 1 / scale)
        scale = ref.fake_quant_scale(x.reshape(-1, x.shape[-1]), 16, False,
                                     x.numel() // x.shape[-1])
        return torch.fake_quantize_per_tensor_affine(
            x, scale, zero_point, -32767, 32767)

    for x in (win, h1.contiguous(), h2.contiguous()):
        rows[f"fake_quant {tuple(x.shape)}"] = _hold_at(
            torch, "fake_quant",
            lambda x=x: ops.fake_quant_op(x, 16, per_sample=True),
            lambda x=x: _fake_quant_plain(ref, x, 16, per_sample=True)[0],
            2 * 4 * x.numel(), 7 * x.numel(), exact=True,
            library_fn=lambda x=x: quant_library(x))
    for name, row in rows.items():
        print(f"  oracle shape {name}: device ms kernel {row['ms']}, plain "
              f"{row['plain_ms']}, library {row['library_ms']}, bound "
              f"{row['bound_ms']} ({row['bound_by']}), per call with launch "
              f"{row['call_ms']}")
    return rows


def _oracle_inputs(torch, dev):
    """Phase 10 (a)'s system at HAR's full width from seed 10: weights, the
    generator, the signature bank, an AAC table over k = 4, 6, 8, 12 and a
    128-window HAR stream."""
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.aac import make_aac_table
    from repro_torch.core.recovery import init_generator
    from repro_torch.data.sensors import class_signatures, har_stream
    from repro_torch.models.har import har_init

    g = torch.Generator(device=dev).manual_seed(10)
    params = har_init(g, HAR)
    kw = dict(signatures=class_signatures(device=dev), qdnn_params=params,
              host_params=params,
              gen_params=init_generator(g, HAR.window, HAR.channels),
              har_cfg=HAR, n_sensors=ORACLE_SENSORS,
              aac_table=make_aac_table(
                  0.6 + 0.3 * torch.rand((HAR.n_classes, 4), generator=g,
                                         device=dev), [4, 6, 8, 12], dev))
    windows, labels = har_stream(g, ORACLE_SLOTS)
    return g, windows, labels, kw


def _oracle_source(torch, dev, g, windows, labels, kw, source: str,
                   first: bool) -> dict:
    """Phase 10 (a) under one harvest source: the oracle against
    ``seeker_simulate`` from the same generator seed on the card, and
    against a CPU run of the plain versions with the same noise.  The
    ``first`` source warms both up before the timed runs and profiles
    both over the stream's first ``ORACLE_PROFILE_SLOTS`` slots after
    (the profiler's cost grows with the launches it records)."""
    import repro_torch
    from repro_torch.core.energy import harvest_trace
    from repro_torch.kernels import ops
    from repro_torch.serving.fleet import draw_fleet_noise, to_device

    s, n = ORACLE_SLOTS, ORACLE_SENSORS
    t, c = windows.shape[1:]
    harvest = harvest_trace(g, s, source)

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    runs = {}
    for name, fn in (("oracle", repro_torch.seeker_simulate_reference),
                     ("fleet", repro_torch.seeker_simulate)):
        def run(fn=fn, slots=s):
            return fn(windows[:slots], labels[:slots], harvest[:slots],
                      generator=seeded(), device=dev, **kw)

        if first:
            run()
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        runs[name] = dict(res=res, secs=time.perf_counter() - t0,
                          launches=ops.launch_counts())
        if first:
            def head(run=run):
                return run(slots=ORACLE_PROFILE_SLOTS)

            t1 = time.perf_counter()
            head()
            torch.cuda.synchronize()
            runs[name]["profile"] = _profile(
                torch, head, ORACLE_PROFILE_SLOTS, time.perf_counter() - t1,
                f"{name}_{source}")
    oracle, fleet = runs["oracle"]["res"], runs["fleet"]["res"]
    want = {"oracle": {"signature_corr": s * n, "kmeans_coreset": s * n,
                       "fake_quant": 3 * s * n + 4, "importance_select": 0},
            "fleet": {"signature_corr": s, "kmeans_coreset": s,
                      "fake_quant": 3 * s + 4, "importance_select": 0}}
    for name, run in runs.items():
        print(f"  {source} {name} launches {run['launches']}, expected "
              f"{want[name]}")
        assert run["launches"] == want[name], (name, run["launches"])
    for key in ("decisions", "k_trace", "payload_bytes"):
        assert torch.equal(oracle[key], fleet[key]), (source, key)
    stored_err = float((oracle["stored_uj"] - fleet["stored_uj"]).abs().max())
    assert stored_err <= 1e-4, (source, stored_err)
    pred_agree = float((oracle["preds"] == fleet["preds"]).float().mean())
    assert pred_agree >= 0.99, (source, pred_agree)
    assert bool(torch.isfinite(oracle["stored_uj"]).all())

    noise = draw_fleet_noise(seeded(), s, n, t, c)
    cpu_kw = {k: v if k in ("har_cfg", "n_sensors") else to_device(v, "cpu")
              for k, v in kw.items()}
    t1 = time.perf_counter()
    cpu = repro_torch.seeker_simulate_reference(
        windows.cpu(), labels.cpu(), harvest.cpu(),
        noise={k: v.cpu() for k, v in noise.items()}, device="cpu", **cpu_kw)
    cpu_secs = time.perf_counter() - t1
    cpu_agree = float((cpu["decisions"] == oracle["decisions"].cpu())
                      .float().mean())
    assert cpu_agree >= 0.99, (source, cpu_agree)
    hist = torch.bincount(oracle["decisions"].long(), minlength=6).tolist()
    out = dict(
        source=source,
        oracle_ms_per_slot=runs["oracle"]["secs"] / s * 1e3,
        fleet_ms_per_slot=runs["fleet"]["secs"] / s * 1e3,
        cpu_oracle_seconds=cpu_secs, decision_histogram=hist,
        stored_max_abs_diff=stored_err, pred_agreement=pred_agree,
        cpu_decision_agreement=cpu_agree,
        completed_frac=float(oracle["completed_frac"]),
        launches={k: v["launches"] for k, v in runs.items()},
        profile={k: v["profile"] for k, v in runs.items() if "profile" in v})
    print(f"  {source}: oracle {out['oracle_ms_per_slot']:.3f} ms/slot, "
          f"fleet {out['fleet_ms_per_slot']:.3f} ms/slot; decisions, k and "
          f"payloads equal, stored within {stored_err:.3g}, preds agree on "
          f"{pred_agree:.6f}; the CPU plain oracle's decisions on "
          f"{cpu_agree:.6f} ({cpu_secs:.1f} s); histogram (D0..D4, DEFER) "
          f"{hist}")
    return out


def _bearing_step(torch, dev) -> dict:
    """Phase 10 (b): one ``seeker_sensor_step`` on N=3000 bearing windows at
    ``BEARING``'s width (120, 1), k=18, m=20, 16-bit D2, against the same
    step on the CPU through the plain versions."""
    import repro_torch
    from repro_torch.configs.seeker_har import BEARING
    from repro_torch.core.aac import make_aac_table
    from repro_torch.core.energy import EnergyCosts, fleet_harvest_traces
    from repro_torch.data.sensors import bearing_dataset, bearing_windows
    from repro_torch.kernels import ops
    from repro_torch.models.har import har_init, quantize_params
    from repro_torch.serving.fleet import fleet_node_init, to_device

    n = N_NODES
    g = torch.Generator(device=dev).manual_seed(11)
    params = har_init(g, BEARING)
    windows, _ = bearing_dataset(g, n)                         # (3000, 120, 1)
    sigs = bearing_windows(g, torch.arange(BEARING.n_classes, device=dev))
    state = fleet_node_init(n, device=dev)._replace(
        stored_uj=120.0 * torch.rand((n,), generator=g, device=dev),
        prev_label=torch.randint(0, BEARING.n_classes, (n,), generator=g,
                                 device=dev, dtype=torch.int32))
    harvest = fleet_harvest_traces(g, n, 1)[:, 0]
    u = torch.clamp(torch.rand((n, BEARING.window), generator=g, device=dev),
                    min=1e-9)
    inputs = dict(
        signatures=sigs, aac_table=make_aac_table(
            0.6 + 0.3 * torch.rand((BEARING.n_classes, 4), generator=g,
                                   device=dev), [6, 10, 14, BEARING_K], dev))

    def step(d, kw, qp):
        return repro_torch.seeker_sensor_step(
            d["windows"], d["state"], d["harvest"], d["u"],
            signatures=kw["signatures"], qp=qp, aac_table=kw["aac_table"],
            costs=EnergyCosts(), k_max=BEARING_K, m_samples=IMPORTANCE_M,
            quant_bits=16)

    data = dict(windows=windows, state=state, harvest=harvest, u=u)
    qp = quantize_params(params, 16)
    ops.reset_launch_counts()
    out = step(data, inputs, qp)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"signature_corr": 1, "kmeans_coreset": 1, "fake_quant": 3,
            "importance_select": 0}
    print(f"  bearing step launches {launches}, expected {want}")
    assert launches == want, launches
    t0 = time.perf_counter()
    for _ in range(5):
        step(data, inputs, qp)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 5
    cpu = step(to_device(data, "cpu"), to_device(inputs, "cpu"),
               quantize_params(to_device(params, "cpu"), 16))
    agree = float((cpu.decision == out.decision.cpu()).float().mean())
    assert agree >= 0.99, agree
    assert torch.equal(cpu.coreset_k, out.coreset_k.cpu())
    counts_equal = float((cpu.coreset_counts == out.coreset_counts.cpu())
                         .all(dim=-1).all(dim=-1).float().mean())
    assert counts_equal == 1.0, counts_equal
    assert out.coreset_centers.shape == (n, 1, BEARING_K, 2)
    assert bool(torch.isfinite(out.logits).all())
    hist = torch.bincount(out.decision.long(), minlength=6).tolist()
    print(f"  bearing step N={n} (120, 1) k={BEARING_K}: {secs * 1e3:.3f} ms "
          f"a step; decisions agree with the CPU plain step on {agree:.6f}, "
          f"coreset k and counts equal; histogram (D0..D4, DEFER) {hist}")
    return dict(nodes=n, ms_per_step=secs * 1e3, decision_agreement=agree,
                decision_histogram=hist, launches=launches)


def _codecs(torch, dev) -> dict:
    """Phase 10 (c): the classical codecs at m=14, the deterministic top-m
    sampler, ``memo_decision`` and the single-cloud ``kmeans_coreset`` on
    3000 HAR windows, each against its CPU run."""
    from repro_torch.core import classical
    from repro_torch.core.coreset import (kmeans_coreset, points_from_window,
                                          topk_importance_coreset)
    from repro_torch.core.memo import memo_decision
    from repro_torch.data.sensors import class_signatures, har_windows
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(12)
    labels = torch.randint(0, 12, (N_NODES,), generator=g, device=dev)
    windows = har_windows(g, labels).contiguous()             # (3000, 60, 3)
    sigs = class_signatures(device=dev)
    windows[:16] = sigs[labels[:16]]                          # exact hits
    cpu_w, out = windows.cpu(), {}
    for name in ("dct_compress", "dwt_compress", "fourier_compress"):
        fn = getattr(classical, name)
        got = fn(windows, CODEC_M)
        err = float((got.cpu() - fn(cpu_w, CODEC_M)).abs().max())
        assert err <= 1e-4, (name, err)
        out[name] = dict(max_abs_err=err,
                         ms=_time_ms(torch, lambda fn=fn: fn(windows, CODEC_M),
                                     reps=10))
    got = topk_importance_coreset(windows, IMPORTANCE_M)
    want = topk_importance_coreset(cpu_w, IMPORTANCE_M)
    assert torch.equal(got.indices.cpu(), want.indices)
    torch.testing.assert_close(got.weights.cpu(), want.weights, rtol=1e-4,
                               atol=1e-5)
    flat = topk_importance_coreset(torch.ones((60, 3), device=dev),
                                   IMPORTANCE_M)
    assert flat.indices.tolist() == list(range(IMPORTANCE_M)), flat.indices
    out["topk_importance_coreset"] = dict(
        ms=_time_ms(torch, lambda: topk_importance_coreset(windows,
                                                           IMPORTANCE_M),
                    reps=10))
    # the card's launches: memo_decision, then the single-cloud k-means on
    # 16 windows lifted to (60, 4) clouds
    clouds = [points_from_window(windows[i]) for i in range(16)]
    ops.reset_launch_counts()
    memo = memo_decision(windows, sigs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    clustered = [kmeans_coreset(pts, HOST_K) for pts in clouds]
    torch.cuda.synchronize()
    launches_all = ops.launch_counts()
    assert launches == dict(signature_corr=1, fake_quant=0, kmeans_coreset=0,
                            importance_select=0), launches
    assert launches_all["kmeans_coreset"] == 16, launches_all
    cpu_memo = memo_decision(cpu_w, sigs.cpu())
    assert torch.equal(memo.label.cpu(), cpu_memo.label)
    assert torch.equal(memo.hit.cpu(), cpu_memo.hit)
    assert bool(memo.hit[:16].all()) and torch.equal(memo.label[:16],
                                                     labels[:16].int())
    torch.testing.assert_close(memo.max_corr.cpu(), cpu_memo.max_corr,
                               rtol=0, atol=1e-4)
    for i, (pts, a) in enumerate(zip(clouds, clustered)):
        b = kmeans_coreset(pts.cpu(), HOST_K)
        assert torch.equal(a.counts.cpu(), b.counts), i
        torch.testing.assert_close(a.centers.cpu(), b.centers, rtol=0,
                                   atol=1e-4)
    print(f"  codecs at m={CODEC_M} on {tuple(windows.shape)}: "
          + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in out.items())
          + f"; within 1e-4 of the CPU run, top-m indices equal, memo hits "
          f"{int(memo.hit.sum())} equal; launches {launches_all}")
    out["launches"] = launches_all
    return out


def phase_paper_path(torch, dev) -> dict:
    """Phase 10: the paper's per-sensor path.  (a) the oracle
    ``seeker_simulate_reference`` against ``seeker_simulate`` under two
    harvest sources, with its kernels held at the oracle's shapes; (b)
    ``BEARING``'s sensor step at N=3000; (c) the codecs."""
    from repro_torch.models.har import quantize_params

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    g, windows, labels, kw = _oracle_inputs(torch, dev)
    shapes = _oracle_shapes(torch, dev, windows, kw["signatures"],
                            quantize_params(kw["qdnn_params"], 16))
    mark("oracle_shapes")
    sources = []
    for i, src in enumerate(ORACLE_SOURCES):
        sources.append(_oracle_source(torch, dev, g, windows, labels, kw, src,
                                      first=i == 0))
        mark(f"oracle_{src}")
    bearing = _bearing_step(torch, dev)
    mark("bearing_step")
    codecs = _codecs(torch, dev)
    mark("codecs")
    seconds = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    secs = marks[-1][1] - marks[0][1]
    print(f"phase 10: {secs:.1f} s; " + ", ".join(
        f"{name} {v:.1f} s" for name, v in seconds.items()))
    return dict(oracle=sources, oracle_shapes=shapes, bearing_step=bearing,
                codecs=codecs, seconds=secs, seconds_by_part=seconds)


def _lm_diff(torch, got, want, vocab: int) -> dict:
    """The RMS and largest difference of ``got`` from ``want`` over the
    real vocabulary, each over ``want``'s standard deviation."""
    want = want[..., :vocab].float()
    diff = got[..., :vocab].float() - want
    std = float(want.std())
    return dict(rms_over_std=float(diff.pow(2).mean().sqrt()) / std,
                max_over_std=float(diff.abs().max()) / std, std=std)


def _lm_close(torch, got, want, vocab: int, what: str,
              rms_bound: float = BF16_RMS,
              max_bound: float | None = BF16_MAX) -> dict:
    """``got`` within the bfloat16 tolerance of ``want`` over the real
    vocabulary (the largest difference reported only, where ``max_bound``
    is None)."""
    res = _lm_diff(torch, got, want, vocab)
    rms, largest = res["rms_over_std"], res["max_over_std"]
    print(f"  {what}: RMS difference {rms:.4g}, largest {largest:.4g} of "
          f"the logits' std {res['std']:.4g} (bounds {rms_bound}, "
          f"{'reported only' if max_bound is None else max_bound})")
    assert rms <= rms_bound, (what, rms)
    assert max_bound is None or largest <= max_bound, (what, largest)
    return res


def _lm_replay(torch, tt, params, cfg, prompt, tokens, margin: int = 0,
               **extra):
    """The prompt's prefill (with ``extra``'s frames or patches), then the
    generated tokens decoded teacher-forced on the same shapes as
    ``generate`` with ``cache_margin=margin`` (so an MoE config routes the
    same groups): every step's logits (B, new, V) in float32, and the
    attention runs' cache widths after the prefill."""
    new = tokens.shape[1]
    lg, cache = tt.forward(params, cfg, prompt, return_cache=True,
                           cache_len=prompt.shape[1] + new + margin, **extra)
    widths = [run["k"].shape[2] for run in cache["runs"] if "k" in run]
    out = [lg[:, -1].float()]
    del lg
    for i in range(new - 1):
        lg, cache = tt.decode_step(params, cfg, cache, tokens[:, i:i + 1])
        out.append(lg[:, 0].float())
    return torch.stack(out, dim=1), widths


def _lm_greedy(torch, tokens, dec, ref, vocab: int) -> dict:
    """The generated tokens against ``ref``'s argmax wherever ``ref``'s
    top-1/top-2 margin exceeds twice the largest |dec - ref| of that step
    (where no flip is possible); with the agreement over all steps."""
    ref = ref[..., :vocab].float()
    top2 = ref.topk(2, dim=-1).values
    err = (dec[..., :vocab] - ref).abs().amax(dim=-1)
    clear = (top2[..., 0] - top2[..., 1]) > 2 * err
    want = ref.argmax(dim=-1)
    assert torch.equal(tokens.long()[clear], want[clear])
    res = dict(compared=int(clear.sum()), steps=clear.numel(),
               agreement_all_steps=float((tokens.long() == want)
                                         .float().mean()))
    print(f"  greedy tokens equal the float32 argmax on all "
          f"{res['compared']} of {res['steps']} steps whose margin exceeds "
          f"twice their largest difference; on "
          f"{res['agreement_all_steps']:.4f} of all steps")
    return res


def _lm_served(torch, dev, cfg, served, prompt, new: int, name: str, **kw):
    """``repro_torch.launch.serve.serve`` (``kw``: its ``cache_margin``,
    ``enc_frames``, ``patch_embeds``) once to warm up and once timed, with
    the peak device memory of the timed call and the four kernels'
    launches in it."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    serve(served, cfg, prompt, 4, device=dev, **kw)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve(served, cfg, prompt, new, device=dev, **kw)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = out.pop("tokens")
    assert tokens.shape == (prompt.shape[0], new), tokens.shape
    assert tokens.dtype == torch.int32
    assert bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
    out.update(peak_memory_gb=peak / 1e9, resident_before_gb=resident / 1e9,
               launches=launches)
    print(f"  {name}: prefill {out['prefill_ms']:.3f} ms, decode "
          f"{out['decode_ms_per_step']:.4f} ms/step, {out['tokens_per_s']:.1f}"
          f" tokens/s; peak device memory {out['peak_memory_gb']:.3f} GB "
          f"({out['resident_before_gb']:.3f} GB resident before); hand-"
          f"kernel launches {launches}")
    return out, tokens


def _attended(s: int, window: int | None) -> int:
    """Query-key pairs a causal (windowed) attention over ``s`` positions
    must score."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _lm_bounds(cfg, served, batch: int, prompt: int, cache_len: int,
               routed: list | None = None) -> dict:
    """The least time of a prefill and of a decode step: weights read once
    (the embedding table only at the tokens' rows; an MoE decode step only
    the ``routed`` experts each of its layers routes to, the prefill all of
    them), the KV cache read once a step at its full length, a recurrent
    run's state read and written once a step (written once by the
    prefill); the matmuls' operations (``active_param_count``) and the
    (windowed) causal attention's at the bf16 tensor-core peak, the SSD
    chunk scan's float32 einsums at the float32 peak.  An
    encoder-decoder's are :func:`_encdec_bounds`'."""
    import math
    from repro_torch.models.rglru import rglru_state_shapes
    from repro_torch.models.ssd import ssd_state_shapes

    if cfg.encoder_layers:
        return _encdec_bounds(cfg, served, batch, prompt, cache_len)

    def size(t):
        return t.numel() * t.element_size()

    weights = sum(size(v) for k, v in served.items()
                  if k not in ("embed", "runs"))
    weights += sum(size(v) for run in served["runs"] for v in run.values())
    matmul = cfg.active_param_count() - cfg.vocab * cfg.d_model
    if cfg.tie_embeddings:
        weights += size(served["embed"])
        matmul += cfg.vocab * cfg.d_model
    unread = 0
    if routed is not None:
        m, item = cfg.moe, served["embed"].element_size()
        unread = sum(m.n_experts - r for r in routed) * (
            3 * cfg.d_model * m.d_expert * item)
    hd = cfg.n_heads * cfg.head_dim
    windows = [cfg.window if kind == "local" else None
               for kind in cfg.block_pattern if kind in ("attn", "local")]
    kv = sum(2 * batch * min(w or cache_len, cache_len) * cfg.n_kv
             * cfg.head_dim * 2 for w in windows)
    state = f32_prefill = f32_decode = 0
    for kind in cfg.block_pattern:
        if kind in ("rglru", "ssd"):
            shapes = (rglru_state_shapes(cfg, batch) if kind == "rglru"
                      else ssd_state_shapes(cfg, batch))
            state += sum(math.prod(v[0]) for v in shapes.values()) * (
                cfg.dtype.itemsize)
        if kind == "ssd":
            # intra-chunk C.B and its product with x, the chunk states and
            # their read-out; a decode step's state update and read-out
            hp, n = cfg.ssm_heads * cfg.ssm_headdim, cfg.ssm_state
            f32_prefill += 2 * batch * prompt * (
                min(128, prompt) * (cfg.ssm_groups * n + hp) + 2 * hp * n)
            f32_decode += 2 * batch * 2 * hp * n
    attn_prefill = sum(4 * batch * hd * _attended(prompt, w) for w in windows)
    attn_decode = sum(4 * batch * hd * min(w or cache_len, cache_len)
                      for w in windows)
    fp32_in_bf16 = BF16_FLOPS / FP32_FLOPS   # a float32 op's bf16 ops
    prefill = _bound_ms(weights + kv * prompt / cache_len + state,
                        2 * matmul * batch * prompt + attn_prefill
                        + f32_prefill * fp32_in_bf16, BF16_FLOPS)
    decode = _bound_ms(weights - unread + kv + 2 * state,
                       2 * matmul * batch + attn_decode
                       + f32_decode * fp32_in_bf16, BF16_FLOPS)
    return dict(prefill_bound_ms=prefill[0], prefill_bound_by=prefill[1],
                decode_bound_ms=decode[0], decode_bound_by=decode[1],
                weight_bytes=weights, decode_weight_bytes=weights - unread,
                kv_cache_bytes=kv, state_bytes=state)


def _encdec_bounds(cfg, served, batch: int, prompt: int,
                   cache_len: int) -> dict:
    """:func:`_lm_bounds` for an encoder-decoder, with the work counted from
    the parameter tree: the prefill runs the encoder's matmuls and
    non-causal attention over the ``encoder_frames`` of each sequence,
    each decoder layer's cross K/V projections over them, and the
    decoder's other matmuls, causal self-attention and cross-attention
    over the prompt, and the tied unembedding; it reads every weight and
    the frames once and writes both caches.  A decode step reads the
    decoder's weights but the cross K/V projections, the tied embedding,
    the self-attention cache at its full length and the cross K/V cache.
    Matmuls and attention at the bf16 tensor-core peak."""
    def size(t):
        return t.numel() * t.element_size()

    def matmul(run, skip=()):
        return sum(v.numel() for k, v in run.items()
                   if "norm" not in k and k not in skip)

    dec, enc = served["runs"][0], served["encoder"]["runs"][0]
    cross_kv = ("xwk", "xwv")
    item = served["embed"].element_size()
    t, hd, layers = cfg.encoder_frames, cfg.n_heads * cfg.head_dim, cfg.n_layers
    vd = cfg.vocab * cfg.d_model
    weights = (size(served["embed"]) + sum(size(v) for v in dec.values())
               + sum(size(v) for v in enc.values()))
    decode_weights = size(served["embed"]) + sum(
        size(v) for k, v in dec.items() if k not in cross_kv)
    kv = 2 * layers * batch * cache_len * cfg.n_kv * cfg.head_dim * item
    cross = 2 * layers * batch * t * cfg.n_kv * cfg.head_dim * item
    frames = batch * t * cfg.d_model * item
    flops_prefill = (2 * batch * t * (matmul(enc) + matmul(dec) - matmul(
        dec, cross_kv)) + 4 * batch * hd * t * t * cfg.encoder_layers
        + 2 * batch * prompt * (matmul(dec, cross_kv) + vd)
        + 4 * batch * hd * layers * (_attended(prompt, None) + prompt * t))
    flops_decode = (2 * batch * (matmul(dec, cross_kv) + vd)
                    + 4 * batch * hd * layers * (cache_len + t))
    prefill = _bound_ms(weights + frames + kv * prompt / cache_len + cross,
                        flops_prefill, BF16_FLOPS)
    decode = _bound_ms(decode_weights + kv + cross, flops_decode, BF16_FLOPS)
    return dict(prefill_bound_ms=prefill[0], prefill_bound_by=prefill[1],
                decode_bound_ms=decode[0], decode_bound_by=decode[1],
                weight_bytes=weights, decode_weight_bytes=decode_weights,
                kv_cache_bytes=kv, cross_kv_bytes=cross, state_bytes=0,
                prefill_flops=flops_prefill)


def _lm_decode_profile(torch, served, cfg, prompt, tok, new: int,
                       name: str, margin: int = 0, **extra) -> dict:
    """Launches, device busy time and idle share of a decode step: four
    steps after a prefill of ``prompt`` (and ``extra``'s frames or
    patches) into the cache that serving ``new`` tokens with
    ``cache_margin=margin`` builds, timed on the host clock and then
    profiled."""
    from repro_torch.models import transformer as tt

    _, cache = tt.forward(served, cfg, prompt, return_cache=True,
                          cache_len=prompt.shape[1] + new + margin, **extra)
    state = dict(cache=cache)

    def four_steps():
        for _ in range(4):
            _, state["cache"] = tt.decode_step(served, cfg, state["cache"],
                                               tok)

    t0 = time.perf_counter()
    four_steps()
    torch.cuda.synchronize()
    return _profile(torch, four_steps, 4, time.perf_counter() - t0, name)


def _lm_tinyllama(torch, dev, cfg, params, served) -> dict:
    """Phase 11 (a): tinyllama-1.1b's full config served through the
    launcher's ``serve``, launches per decode step from the profiler, and
    the fidelity of the generated steps against teacher-forced forwards."""
    import dataclasses
    from repro_torch.models import transformer as tt

    g = torch.Generator(device=dev).manual_seed(19)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                           device=dev)
    out, tokens = _lm_served(torch, dev, cfg, served, prompt, LM_NEW,
                             "tinyllama-1.1b")
    out.update(_lm_bounds(cfg, served, LM_BATCH, LM_PROMPT,
                          LM_PROMPT + LM_NEW))
    print(f"  bounds: prefill {out['prefill_bound_ms']:.3f} ms "
          f"({out['prefill_bound_by']}), decode step "
          f"{out['decode_bound_ms']:.4f} ms ({out['decode_bound_by']}); "
          f"{out['weight_bytes'] / 1e9:.3f} GB of weights read a step, KV "
          f"cache {out['kv_cache_bytes'] / 1e9:.3f} GB at full length")

    out["profile"] = _lm_decode_profile(torch, served, cfg, prompt,
                                        tokens[:, :1], LM_NEW,
                                        "lm_decode_step")
    # fidelity: the generated steps replayed, against teacher-forced
    # forwards over the prompt and all generated tokens but the last
    dec, _ = _lm_replay(torch, tt, served, cfg, prompt, tokens)
    assert torch.equal(dec.argmax(dim=-1).int(), tokens), "replay differs"
    full = torch.cat([prompt, tokens], dim=1)[:, :-1]
    fwd = tt.forward(served, cfg, full)[:, LM_PROMPT - 1:].float()
    out["decode_vs_forward"] = _lm_close(torch, dec, fwd, cfg.vocab,
                                         "decode_step against forward, bf16")
    del fwd
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    fwd32 = tt.forward(params, cfg32, full)[:, LM_PROMPT - 1:].clone()
    out["bf16_vs_f32"] = _lm_close(torch, dec, fwd32, cfg.vocab,
                                   "generated bf16 steps against a float32 "
                                   "teacher-forced forward")
    out["greedy"] = _lm_greedy(torch, tokens, dec, fwd32, cfg.vocab)
    return out


def _cut_cfg(cfg, n: int):
    """``cfg`` cut to its first ``n`` layers (and encoder layers)."""
    import dataclasses
    return dataclasses.replace(
        cfg, n_layers=n, block_pattern=cfg.block_pattern[:n],
        moe_layers=tuple(i for i in cfg.moe_layers if i < n),
        encoder_layers=min(cfg.encoder_layers, n))


def _lm_cut(cfg, params, n: int):
    """``cfg`` and ``params`` cut to their first ``n`` layers, and the
    encoder to its first ``n`` (the runs' leaves as views of the same
    tensors)."""
    from repro_torch.models.config import pattern_runs
    runs = [{k: v[:n - start] for k, v in run.items()}
            for run, (_, _, start, _) in zip(params["runs"],
                                             pattern_runs(cfg))
            if start < n]
    cut = dict(params, runs=runs)
    if "encoder" in params:
        enc = params["encoder"]
        cut["encoder"] = dict(enc, runs=[{k: v[:n] for k, v in
                                          enc["runs"][0].items()}])
    return _cut_cfg(cfg, n), cut


@contextlib.contextmanager
def _routes():
    """Every ``moe_route`` result of the calls inside, in call order (the
    first is the first MoE layer's)."""
    from repro_torch.models import moe
    seen, route = [], moe.moe_route

    def record(*args, **kw):
        seen.append(route(*args, **kw))
        return seen[-1]

    moe.moe_route = record
    try:
        yield seen
    finally:
        moe.moe_route = route


def _lm_card_vs_cpu(torch, dev, cfg, params, layers: int = LM_CPU_LAYERS,
                    batch: int = LM_CPU_BATCH, prompt: int = LM_CPU_PROMPT,
                    steps: int = LM_CPU_STEPS) -> dict:
    """Phase 11 (b), 12 (b, d, e), 13: the first ``layers`` layers (and
    encoder layers) at full width in float32, a ``prompt``-token prefill
    (after all the config's patches, or over all its frames) and ``steps``
    decode steps, in a cache that holds them all, on the card and on the
    CPU with the same weights and inputs: logits within 1e-3, and each MoE
    layer's dropped assignments equal."""
    import dataclasses
    from repro_torch.models import transformer as tt

    cut, p = _lm_cut(cfg, params, layers)
    cut = dataclasses.replace(cut, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(20)
    toks = torch.randint(0, cfg.vocab, (batch, prompt + steps), generator=g,
                         device=dev)
    extra = _mm_extra(torch, cfg, batch, g)

    def run(p, toks, extra):
        with _routes() as seen:
            lg, cache = tt.forward(p, cut, toks[:, :prompt],
                                   return_cache=True,
                                   cache_len=toks.shape[1]
                                   + cfg.vision_patches, **extra)
            outs = [lg]
            for i in range(prompt, toks.shape[1]):
                lg, cache = tt.decode_step(p, cut, cache, toks[:, i:i + 1])
                outs.append(lg)
        return (torch.cat(outs, dim=1),
                [int((~r.keep).sum()) for r in seen])

    card, card_drops = run(tt.compute_params(p, cut), toks, extra)
    card = card.cpu()
    t0 = time.perf_counter()
    cpu, cpu_drops = run(tt.compute_params(p, cut, "cpu"), toks.cpu(),
                         {k: v.cpu() for k, v in extra.items()})
    cpu_secs = time.perf_counter() - t0
    err = float((card - cpu).abs().max())
    drops = (f"; dropped assignments per MoE call {card_drops} (CPU "
             f"{cpu_drops})" if card_drops else "")
    print(f"  {layers} layers at full width, float32, batch {batch}: "
          f"prefill of {prompt} and {steps} decode steps, the card against "
          f"the CPU ({cpu_secs:.1f} s): max |difference| {err:.3g} (bound "
          f"1e-3){drops}")
    assert err <= 1e-3, err
    assert card_drops == cpu_drops, (card_drops, cpu_drops)
    return dict(max_abs_err=err, cpu_seconds=cpu_secs, drops=card_drops)


def _lm_attention(torch, dev, walk, plain, library, shape_q, shape_kv,
                  flops: float, what: str) -> dict:
    """One flash walk on random float32 inputs against the materialized-
    score attention, which shares no code with it, and against the library
    attention (each within 1e-4), with the device time of all three and
    the walk's bound."""
    g = torch.Generator(device=dev).manual_seed(22)
    q = torch.randn(shape_q, generator=g, device=dev)
    k, v = (torch.randn(shape_kv, generator=g, device=dev) for _ in range(2))
    got = walk(q, k, v)
    err = float((plain(q, k, v) - got).abs().max())
    lib_err = float((library(q, k, v) - got).abs().max())
    print(f"  {what}: flash against dense max |difference| {err:.3g}, "
          f"against the library call {lib_err:.3g} (bound 1e-4 each)")
    assert err <= 1e-4 and lib_err <= 1e-4, (what, err, lib_err)
    bound, by = _bound_ms(4 * (2 * q.numel() + 2 * k.numel()), flops)
    row = dict(max_abs_err=err, library_max_abs_err=lib_err,
               ms=_time_ms(torch, lambda: walk(q, k, v), reps=5, warmup=1),
               plain_ms=_time_ms(torch, lambda: plain(q, k, v), reps=5,
                                 warmup=1),
               library_ms=_time_ms(torch, lambda: library(q, k, v), reps=20),
               bound_ms=bound, bound_by=by)
    print(f"    ms (CUDA events): flash {row['ms']:.3f}, dense "
          f"{row['plain_ms']:.3f}, library {row['library_ms']:.3f}; bound "
          f"{bound:.3f} ({by}, float32)")
    return row


def _sdpa(torch, q, k, v, mask=None):
    """``scaled_dot_product_attention`` on the walks' (B,S,G,R,D) layout:
    causal, or under a boolean ``mask``; the library yardstick."""
    import torch.nn.functional as F
    b, s, g, r, d = q.shape
    out = F.scaled_dot_product_attention(
        q.reshape(b, s, g * r, d).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), attn_mask=mask, is_causal=mask is None,
        enable_gqa=True)
    return out.transpose(1, 2).reshape(b, s, g, r, d)


def _lm_flash_causal(torch, dev, cfg, params) -> dict:
    """Phase 11 (c): tinyllama's 22 layers in float32 on a 4096-token
    prompt (past ``dense_attn_max_seq``), the flash causal walk against
    the dense attention (its limit raised to the prompt), end to end and
    alone."""
    import dataclasses
    from repro_torch.models import layers, transformer as tt
    from repro_torch.models.flash import flash_causal_attention

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(21)
    toks = torch.randint(0, cfg.vocab, (1, LM_FLASH_PROMPT), generator=g,
                         device=dev)
    flash = tt.forward(params, cfg32, toks)
    dense = tt.forward(params, dataclasses.replace(
        cfg32, dense_attn_max_seq=LM_FLASH_PROMPT), toks)
    err = float((flash - dense).abs().max())
    del flash, dense
    print(f"  tinyllama-1.1b, float32, prompt {LM_FLASH_PROMPT}: forward "
          f"through flash_causal_attention against dense_attention, "
          f"max |difference| {err:.3g} (bound 1e-4)")
    assert err <= 1e-4, err
    s, c, h, dh = LM_FLASH_PROMPT, LM_CHUNK, cfg.n_heads, cfg.head_dim
    row = _lm_attention(
        torch, dev, lambda q, k, v: flash_causal_attention(q, k, v, c),
        lambda q, k, v: layers.dense_attention(q, k, v),
        lambda q, k, v: _sdpa(torch, q, k, v),
        (1, s, cfg.n_kv, h // cfg.n_kv, dh), (1, s, cfg.n_kv, dh),
        4 * h * dh * _attended(s, None), f"flash_causal_attention (1, {s}, "
        f"{cfg.n_kv}, {h // cfg.n_kv}, {dh}), chunk {c}")
    return dict(forward_max_abs_err=err, attention=row)


def _lm_gemma3(torch, dev) -> dict:
    """Phase 11 (d): gemma3-12b at full width cut to its first 5:1 period
    (6 layers): a 2048-token prompt and 32 decode steps through the ring
    caches, decode against a teacher-forced forward; the flash banded walk
    against the dense windowed attention in float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, transformer as tt
    from repro_torch.models.flash import flash_banded_attention

    cfg = _cut_cfg(get_config("gemma3-12b"), GEMMA3_LAYERS)
    g = torch.Generator(device=dev).manual_seed(23)
    served = tt.compute_params(tt.init_params(g, cfg), cfg)
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab, (1, GEMMA3_PROMPT), generator=g,
                           device=dev)
    out, tokens = _lm_served(torch, dev, cfg, served, prompt, GEMMA3_NEW,
                             f"gemma3-12b, {GEMMA3_LAYERS} layers")
    out.update(_lm_bounds(cfg, served, 1, GEMMA3_PROMPT,
                          GEMMA3_PROMPT + GEMMA3_NEW))
    out["profile"] = _lm_decode_profile(torch, served, cfg, prompt,
                                        tokens[:, :1], GEMMA3_NEW,
                                        "gemma3_decode_step")
    dec, widths = _lm_replay(torch, tt, served, cfg, prompt, tokens)
    w = cfg.window
    assert widths == [w, GEMMA3_PROMPT + GEMMA3_NEW], widths
    assert torch.equal(dec.argmax(dim=-1).int(), tokens), "replay differs"
    full = torch.cat([prompt, tokens], dim=1)[:, :-1]
    fwd = tt.forward(served, cfg, full)[:, GEMMA3_PROMPT - 1:].float()
    out["decode_vs_forward"] = _lm_close(
        torch, dec, fwd, cfg.vocab,
        "gemma3 decode_step through the ring caches against forward, bf16")
    out["cache_widths"] = widths
    del served, fwd, dec
    torch.cuda.empty_cache()
    s, c, h, dh = GEMMA3_PROMPT, LM_CHUNK, cfg.n_heads, cfg.head_dim
    idx = torch.arange(s, device=dev)
    band = (idx[:, None] >= idx[None, :]) & (idx[:, None] - idx[None, :] < w)
    out["attention"] = _lm_attention(
        torch, dev, lambda q, k, v: flash_banded_attention(q, k, v, w, c),
        lambda q, k, v: layers.dense_attention(q, k, v, window=w),
        lambda q, k, v: _sdpa(torch, q, k, v, band),
        (1, s, cfg.n_kv, h // cfg.n_kv, dh), (1, s, cfg.n_kv, dh),
        4 * h * dh * _attended(s, w), f"flash_banded_attention (1, {s}, "
        f"{cfg.n_kv}, {h // cfg.n_kv}, {dh}), window {w}, chunk {c}")
    return out


def phase_lm_serve(torch, dev) -> dict:
    """Phase 11: the LM serving path (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    t0 = time.perf_counter()
    # the bf16 GEMMs reduce in float32, as XLA's do
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = False
    print("cuda.matmul.allow_bf16_reduced_precision_reduction="
          f"{matmul.allow_bf16_reduced_precision_reduction}")
    cfg = get_config("tinyllama-1.1b")
    g = torch.Generator(device=dev).manual_seed(18)
    with torch.no_grad():
        params = tt.init_params(g, cfg)                    # float32
        served = tt.compute_params(params, cfg)            # bf16 weights
        print(f"  tinyllama-1.1b: {cfg.param_count() / 1e9:.3f} B "
              f"parameters, {cfg.n_layers} layers")
        tiny = _lm_tinyllama(torch, dev, cfg, params, served)
        del served
        card_cpu = _lm_card_vs_cpu(torch, dev, cfg, params)
        flash = _lm_flash_causal(torch, dev, cfg, params)
        del params
        torch.cuda.empty_cache()
        gemma3 = _lm_gemma3(torch, dev)
    secs = time.perf_counter() - t0
    print(f"phase 11: {secs:.1f} s")
    return dict(tinyllama=tiny, card_vs_cpu=card_cpu, flash_causal=flash,
                gemma3=gemma3, seconds=secs)


def _moe_drops(torch, tt, served, cfg, prompt, tok, new: int) -> dict:
    """The share of (token, k) assignments dropped in the first MoE layer
    at the prefill of ``prompt`` and at the decode step of ``tok`` after
    it (and over all MoE layers), with the capacities, and the experts
    each MoE layer's decode step routes to."""
    from repro_torch.models.moe import moe_capacity

    with _routes() as pre:
        _, cache = tt.forward(served, cfg, prompt, return_cache=True,
                              cache_len=prompt.shape[1] + new)
    with _routes() as dec:
        tt.decode_step(served, cfg, cache, tok)

    def share(routes):
        return float(sum(int((~r.keep).sum()) for r in routes)
                     / sum(r.keep.numel() for r in routes))

    m, tokens = cfg.moe, prompt.numel()
    res = dict(prefill_capacity=moe_capacity(m, min(m.group_size, tokens)),
               decode_capacity=moe_capacity(m, min(m.group_size,
                                                   prompt.shape[0])),
               prefill_drop_share=share(pre[:1]),
               decode_drop_share=share(dec[:1]),
               prefill_drop_share_all_layers=share(pre),
               decode_drop_share_all_layers=share(dec),
               decode_experts_routed=[int(torch.unique(r.top_e[r.keep])
                                          .numel()) for r in dec])
    print(f"  dropped (token, k) assignments in the first MoE layer: "
          f"{res['prefill_drop_share']:.4f} at the prefill (capacity "
          f"{res['prefill_capacity']}), {res['decode_drop_share']:.4f} at a "
          f"decode step (capacity {res['decode_capacity']}); over all "
          f"{len(pre)} MoE layers {res['prefill_drop_share_all_layers']:.4f}"
          f" and {res['decode_drop_share_all_layers']:.4f}; a decode step "
          f"routes to {sum(res['decode_experts_routed']) / len(dec):.1f} of "
          f"{m.n_experts} experts a layer")
    return res


def _mix_serve(torch, dev, cfg, served, new: int, name: str, seed: int,
               prompt_len: int = MIX_PROMPT, margin: int = 0):
    """Phases 12, 13: ``cfg`` served through the launcher's ``serve`` at
    batch ``MIX_BATCH``, greedy, after its frames or patches (standard
    normal from the seed) with ``cache_margin=margin``, with the MoE drop
    shares, the bounds, a decode step's profile, and the generated steps
    replayed (their argmax must be the tokens).  Returns (row, prompt,
    the frames or patches, tokens, the replayed logits)."""
    from repro_torch.models import transformer as tt

    g = torch.Generator(device=dev).manual_seed(seed)
    extra = _mm_extra(torch, cfg, MIX_BATCH, g)
    prompt = torch.randint(0, cfg.vocab, (MIX_BATCH, prompt_len),
                           generator=g, device=dev)
    out, tokens = _lm_served(torch, dev, cfg, served, prompt, new, name,
                             cache_margin=margin, **extra)
    routed = None
    if cfg.moe_layers:
        out["moe"] = _moe_drops(torch, tt, served, cfg, prompt, tokens[:, :1],
                                new)
        routed = out["moe"]["decode_experts_routed"]
    out.update(_lm_bounds(cfg, served, MIX_BATCH,
                          prompt_len + cfg.vision_patches,
                          prompt_len + new + margin, routed))
    cross = out.get("cross_kv_bytes")
    print(f"  bounds: prefill {out['prefill_bound_ms']:.3f} ms "
          f"({out['prefill_bound_by']}), decode step "
          f"{out['decode_bound_ms']:.4f} ms ({out['decode_bound_by']}); "
          f"{out['decode_weight_bytes'] / 1e9:.3f} GB of weights read a "
          f"step ({out['weight_bytes'] / 1e9:.3f} GB by the prefill), KV "
          f"cache {out['kv_cache_bytes'] / 1e9:.3f} GB at full length, "
          + (f"cross K/V {cross / 1e9:.3f} GB" if cross else
             f"recurrent state {out['state_bytes'] / 1e6:.3f} MB"))
    out["profile"] = _lm_decode_profile(
        torch, served, cfg, prompt, tokens[:, :1], new,
        f"{cfg.name.split('-')[0]}_decode_step", margin, **extra)
    dec, _ = _lm_replay(torch, tt, served, cfg, prompt, tokens, margin,
                        **extra)
    assert torch.equal(dec.argmax(dim=-1).int(), tokens), "replay differs"
    return out, prompt, extra, tokens, dec


def _mix_vs_f32(torch, cfg, params, prompt, tokens, what: str,
                max_bound: float | None) -> dict:
    """The bf16 steps of ``cfg`` (a cut of a served MoE model) against a
    float32 decode replay of the same tokens with the same weights: the
    same groups route, so routing flips near a bf16 tie are the only
    difference in kind; with the greedy agreement."""
    import dataclasses
    from repro_torch.models import transformer as tt

    dec16, _ = _lm_replay(torch, tt, params, cfg, prompt, tokens)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    dec32, _ = _lm_replay(torch, tt, tt.compute_params(params, cfg32), cfg32,
                          prompt, tokens)
    res = _lm_close(torch, dec16, dec32, cfg.vocab, what,
                    max_bound=max_bound)
    res["greedy_agreement"] = float(
        (dec16[..., :cfg.vocab].argmax(-1) == dec32[..., :cfg.vocab]
         .argmax(-1)).float().mean())
    print(f"    greedy agreement of the bf16 and float32 steps "
          f"{res['greedy_agreement']:.4f}")
    return res


def _mix_moe(torch, dev, arch: str, layers: int | None, f32_layers: int,
             seed: int) -> dict:
    """Phase 12 (a)-(c): an MoE config (cut to ``layers``, if given) with
    bf16 parameters drawn from a seed, served; its first ``f32_layers``
    against float32; deepseek's first 2 layers on the card against the
    CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    full = get_config(arch)
    layers = layers or full.n_layers
    cfg = _cut_cfg(dataclasses.replace(full, param_dtype=torch.bfloat16),
                   layers)
    g = torch.Generator(device=dev).manual_seed(seed)
    served = tt.init_params(g, cfg)    # bf16: the served values
    print(f"  {arch}: {cfg.param_count() / 1e9:.3f} B parameters "
          f"({cfg.active_param_count() / 1e9:.3f} B active), {layers} "
          f"layers, bf16 from a seed")
    name = arch if layers == full.n_layers else f"{arch}, {layers} layers"
    out, prompt, _, tokens, dec = _mix_serve(torch, dev, cfg, served,
                                             MOE_NEW, name, seed + 1)
    del dec
    cut, p = _lm_cut(cfg, served, f32_layers)
    # the largest difference is reported only: a routing flip near a bf16
    # tie moves a token by a whole expert's output
    out["bf16_vs_f32"] = _mix_vs_f32(
        torch, cut, p, prompt, tokens, f"{arch}, first {f32_layers} of "
        f"{layers} layers: the bf16 steps against a float32 decode replay",
        max_bound=None)
    torch.cuda.empty_cache()
    if arch == "deepseek-moe-16b":
        out["card_vs_cpu"] = _lm_card_vs_cpu(torch, dev, cfg, served,
                                             DEEPSEEK_CPU_LAYERS)
    return out


def _mix_recurrent(torch, dev, arch: str, cpu_layers: int | None,
                   cpu_prompt: int, seed: int) -> dict:
    """Phase 12 (d), (e): a recurrent config, float32 parameters cast once
    to bf16, served; the replayed steps against teacher-forced bf16 and
    float32 forwards; greedy tokens where no flip is possible; the card
    against the CPU.  An SSD forward runs whole chunks, so the teacher-
    forced sequence is padded with its last token to a chunk multiple
    (the compared positions do not see the padding: the block is
    causal)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    cfg = get_config(arch)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = tt.init_params(g, cfg)                        # float32
    served = tt.compute_params(params, cfg)                # bf16 weights
    print(f"  {arch}: {cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers")
    out, prompt, _, tokens, dec = _mix_serve(torch, dev, cfg, served,
                                             REC_NEW, arch, seed + 1)
    full = _teacher_forced(torch, cfg, prompt, tokens)
    steps = slice(MIX_PROMPT - 1, MIX_PROMPT + REC_NEW - 1)
    fwd = tt.forward(served, cfg, full)[:, steps].float()
    out["decode_vs_forward"] = _lm_close(
        torch, dec, fwd, cfg.vocab, f"{arch} decode_step against forward, "
        "bf16", REC_RMS, REC_MAX)
    del fwd, served
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    fwd32 = tt.forward(params, cfg32, full)[:, steps].clone()
    out["bf16_vs_f32"] = _lm_close(
        torch, dec, fwd32, cfg.vocab, "generated bf16 steps against a "
        "float32 teacher-forced forward", REC_RMS, REC_MAX)
    out["greedy"] = _lm_greedy(torch, tokens, dec, fwd32, cfg.vocab)
    del fwd32, dec
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _lm_card_vs_cpu(torch, dev, cfg, params,
                                         cpu_layers or cfg.n_layers,
                                         prompt=cpu_prompt)
    return out


def _teacher_forced(torch, cfg, prompt, tokens):
    """The prompt and all generated tokens but the last, padded with the
    last of them to a multiple of SSD's 128-token chunk for an SSD
    config."""
    full = torch.cat([prompt, tokens], dim=1)[:, :-1]
    pad = (-full.shape[1]) % 128 if "ssd" in cfg.block_pattern else 0
    return torch.cat([full, full[:, -1:].expand(-1, pad)], dim=1)


def phase_lm_mixers(torch, dev) -> dict:
    """Phase 12: the MoE, RG-LRU and SSD serving paths (module
    docstring)."""
    t0 = time.perf_counter()
    # the bf16 GEMMs reduce in float32, as in phase 11
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    with torch.no_grad():
        out["deepseek"] = _mix_moe(torch, dev, "deepseek-moe-16b", None,
                                   DEEPSEEK_F32_LAYERS, 24)
        torch.cuda.empty_cache()
        out["grok"] = _mix_moe(torch, dev, "grok-1-314b", GROK_LAYERS, 1, 26)
        torch.cuda.empty_cache()
        out["recurrentgemma"] = _mix_recurrent(
            torch, dev, "recurrentgemma-2b", RG_CPU_LAYERS, LM_CPU_PROMPT, 28)
        torch.cuda.empty_cache()
        out["mamba2"] = _mix_recurrent(torch, dev, "mamba2-130m", None,
                                       MAMBA_CPU_PROMPT, 30)
        torch.cuda.empty_cache()
    for name, cell in out.items():
        assert not any(cell["launches"].values()), (name, cell["launches"])
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12: {out['seconds']:.1f} s")
    return out


def _mm_extra(torch, cfg, batch: int, g) -> dict:
    """An encoder config's frames (batch, encoder_frames, D) or a vision
    config's patches (batch, vision_patches, D), standard normal in float32
    from ``g`` on its device, as the launcher draws them; {} otherwise."""
    shape = None
    if cfg.encoder_layers:
        name, shape = "enc_frames", (batch, cfg.encoder_frames, cfg.d_model)
    elif cfg.vision_patches:
        name, shape = "patch_embeds", (batch, cfg.vision_patches, cfg.d_model)
    if shape is None:
        return {}
    return {name: torch.randn(shape, generator=g, device=g.device)}


def _tree_numel(tree) -> int:
    """The elements of a parameter tree's leaves (``param_count`` counts
    whisper's encoder MLP as gated)."""
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_numel(v) for v in tree)
    return tree.numel()


def _mm_whisper(torch, dev) -> dict:
    """Phase 13 (a): whisper-small's full config, float32 parameters cast
    once to bf16, served over 1500 frames; the replayed steps against
    teacher-forced bf16 and float32 forwards with the same frames, greedy
    tokens where no flip is possible, and 2 encoder and 2 decoder layers
    on the card against the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    cfg = get_config("whisper-small")
    g = torch.Generator(device=dev).manual_seed(32)
    params = tt.init_params(g, cfg)                        # float32
    served = tt.compute_params(params, cfg)                # bf16 weights
    print(f"  whisper-small: {_tree_numel(params) / 1e9:.3f} B parameters, "
          f"{cfg.encoder_layers} encoder and {cfg.n_layers} decoder layers, "
          f"{cfg.n_heads} heads padded to {cfg.padded_heads}")
    out, prompt, extra, tokens, dec = _mix_serve(
        torch, dev, cfg, served, MM_NEW, cfg.name, 33, WHISPER_PROMPT)
    full = torch.cat([prompt, tokens], dim=1)[:, :-1]
    steps = slice(WHISPER_PROMPT - 1, None)
    fwd = tt.forward(served, cfg, full, **extra)[:, steps].float()
    out["decode_vs_forward"] = _lm_close(
        torch, dec, fwd, cfg.vocab, "whisper decode_step against forward, "
        "bf16")
    del fwd, served
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    fwd32 = tt.forward(params, cfg32, full, **extra)[:, steps].clone()
    out["bf16_vs_f32"] = _lm_close(
        torch, dec, fwd32, cfg.vocab, "generated bf16 steps against a "
        "float32 teacher-forced forward")
    out["greedy"] = _lm_greedy(torch, tokens, dec, fwd32, cfg.vocab)
    del fwd32, dec
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _lm_card_vs_cpu(torch, dev, cfg, params)
    return out


def _mm_qwen(torch, dev) -> dict:
    """Phase 13 (b): qwen2-vl-2b's full config, float32 parameters cast
    once to bf16, served after 64 patches with a cache margin of 64; the
    prefill logits against a float32 forward, the bf16 steps against a
    float32 decode replay of the same tokens (its decode step gives M-RoPE
    other ids than a forward, so no teacher-forced forward is held), and
    2 layers on the card against the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    cfg = get_config("qwen2-vl-2b")
    g = torch.Generator(device=dev).manual_seed(34)
    params = tt.init_params(g, cfg)                        # float32
    served = tt.compute_params(params, cfg)                # bf16 weights
    print(f"  qwen2-vl-2b: {_tree_numel(params) / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers, {cfg.vision_patches} patches")
    out, prompt, extra, tokens, dec = _mix_serve(
        torch, dev, cfg, served, MM_NEW, cfg.name, 35, QWEN_PROMPT,
        QWEN_MARGIN)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    out["prefill_vs_f32"] = _lm_close(
        torch, tt.forward(served, cfg, prompt, **extra),
        tt.forward(params, cfg32, prompt, **extra), cfg.vocab,
        "qwen2-vl prefill logits, bf16 against a float32 forward")
    del served
    torch.cuda.empty_cache()
    dec32, _ = _lm_replay(torch, tt, params, cfg32, prompt, tokens,
                          QWEN_MARGIN, **extra)
    out["bf16_vs_f32"] = _lm_close(
        torch, dec, dec32, cfg.vocab, "qwen2-vl bf16 steps against a "
        "float32 decode replay")
    out["greedy"] = _lm_greedy(torch, tokens, dec, dec32, cfg.vocab)
    del dec32, dec
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _lm_card_vs_cpu(torch, dev, cfg, params)
    return out


def phase_lm_multimodal(torch, dev) -> dict:
    """Phase 13: the encoder-decoder and M-RoPE serving paths (module
    docstring)."""
    t0 = time.perf_counter()
    # the bf16 GEMMs reduce in float32, as in phase 11
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    with torch.no_grad():
        out["whisper"] = _mm_whisper(torch, dev)
        torch.cuda.empty_cache()
        out["qwen2vl"] = _mm_qwen(torch, dev)
        torch.cuda.empty_cache()
    for name, cell in out.items():
        assert not any(cell["launches"].values()), (name, cell["launches"])
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13: {out['seconds']:.1f} s")
    return out


def _train_cut(cfg, dtype=None):
    """``cfg`` cut to its first ``TRAIN_CUT_LAYERS`` layers, with the dense
    limit under ``TRAIN_CUT_SEQ`` so that the flash causal walk runs (and
    ``dtype`` for its compute, where given)."""
    import dataclasses
    cut = dataclasses.replace(_cut_cfg(cfg, TRAIN_CUT_LAYERS),
                              dense_attn_max_seq=TRAIN_CUT_CHUNK,
                              attn_chunk=TRAIN_CUT_CHUNK)
    return cut if dtype is None else dataclasses.replace(cut, dtype=dtype)


def _train_bounds(cfg, batch: int, seq: int) -> dict:
    """The least time of a train step: its inputs (the float32 parameters
    and both moments) read once and its outputs written once; the matmuls'
    operations 8·N·T (forward, the remat recompute, a backward of twice
    the forward; N the matmul parameters, the embedding gather left out)
    and the causal attention's four products a forward, four again in the
    recompute and eight in the backward, at the bf16 tensor-core peak."""
    n_all = cfg.param_count()
    matmul = cfg.active_param_count() - (0 if cfg.tie_embeddings
                                         else cfg.vocab * cfg.d_model)
    tokens = batch * seq
    attn = 16 * batch * cfg.n_heads * cfg.head_dim * _attended(seq, None) \
        * cfg.n_layers
    flops = 8 * matmul * tokens + attn
    nbytes = 24 * n_all          # params, m, v in float32, read and written
    bound, by = _bound_ms(nbytes, flops, BF16_FLOPS)
    return dict(bound_ms=bound, bound_by=by, operations=flops,
                state_bytes=nbytes, matmul_params=matmul)


def _launches_zero(launches: dict, what: str) -> dict:
    assert not any(launches.values()), (what, launches)
    return launches


def _tree_cos(a, b) -> tuple[float, float]:
    """The cosine of two gradient trees as whole vectors (float64 sums),
    and the smallest cosine of one leaf."""
    from repro_torch.tree import leaves
    dot = na = nb = 0.0
    worst = 1.0
    for x, y in zip(leaves(a), leaves(b)):
        x, y = x.double(), y.double()
        d, sx, sy = float((x * y).sum()), float((x * x).sum()), float(
            (y * y).sum())
        dot, na, nb = dot + d, na + sx, nb + sy
        if sx > 0 and sy > 0:
            worst = min(worst, d / (sx * sy) ** 0.5)
    return dot / (na * nb) ** 0.5, worst


def _train_bf16_vs_f32(torch, cfg, params, batch) -> dict:
    """Phase 14 (b): the full model's first step, its loss and gradient in
    bf16 (``cfg``'s compute) against float32 on the same masters and
    batch."""
    import dataclasses
    from repro_torch.train import make_loss_fn, value_and_grad

    t0 = time.perf_counter()
    l16, _, g16 = value_and_grad(make_loss_fn(cfg), params, batch)
    torch.cuda.synchronize()
    secs16 = time.perf_counter() - t0
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    t0 = time.perf_counter()
    l32, _, g32 = value_and_grad(make_loss_fn(cfg32), params, batch)
    torch.cuda.synchronize()
    secs32 = time.perf_counter() - t0
    cos, worst = _tree_cos(g16, g32)
    dl = abs(float(l16) - float(l32))
    print(f"  (b) full model, first step, bf16 against float32: loss "
          f"{float(l16):.6f} / {float(l32):.6f}, |difference| {dl:.4g} "
          f"(bound {TRAIN_BF16_LOSS}); gradient cosine {cos:.6f} (bound "
          f"{TRAIN_BF16_COS}), smallest leaf cosine {worst:.6f}; loss and "
          f"grads {secs16:.2f} s in bf16, {secs32:.2f} s in float32")
    assert dl <= TRAIN_BF16_LOSS, dl
    assert cos >= TRAIN_BF16_COS, cos
    return dict(loss_bf16=float(l16), loss_f32=float(l32), loss_diff=dl,
                grad_cos=cos, min_leaf_cos=worst, seconds_bf16=secs16,
                seconds_f32=secs32)


def _train_main(torch, dev, cfg, hyper, task, state, first_loss) -> dict:
    """Phase 14 (a): ``make_train_step`` through ``run_training``, one
    warm-up step and the rest timed on the host clock (each step ends at
    the log step's read of its metrics), launches of the four kernels,
    peak memory, then one more step each for the synchronisations and
    the profile."""
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import (TrainLoopConfig, make_train_step,
                                   run_training)

    step = make_train_step(cfg, hyper)
    marks = []

    def batch_fn(s):
        marks.append(time.perf_counter())
        return lm_batches(task, s, device=dev)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, log = run_training(state, step, batch_fn,
                              TrainLoopConfig(total_steps=TRAIN_STEPS,
                                              log_every=1))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    launches = _launches_zero(ops.launch_counts(), "lm_train")
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in log]
    norms = [m["grad_norm"] for m in log]
    assert len(losses) == TRAIN_STEPS, log
    assert all(math.isfinite(x) for x in losses + norms), log
    assert losses[0] == first_loss, (losses[0], first_loss)
    step_s = [b - a for a, b in zip(marks[1:-1], marks[2:])]
    step_ms = sum(step_s) / len(step_s) * 1e3
    tokens = task.batch * task.seq_len
    batch = lm_batches(task, TRAIN_STEPS, device=dev)
    syncs, sync_secs = _count_syncs(torch, lambda: step(state, batch))
    profile = _profile(torch, lambda: step(state, batch), 1, step_ms / 1e3,
                       "lm_train_step")
    out = dict(steps=TRAIN_STEPS, timed_steps=len(step_s), batch=task.batch,
               seq=task.seq_len, step_ms=step_ms,
               step_ms_each=[x * 1e3 for x in step_s],
               warmup_step_ms=(marks[1] - marks[0]) * 1e3,
               tokens_per_s=tokens / (step_ms / 1e3), losses=losses,
               grad_norms=norms, lrs=[m["lr"] for m in log],
               peak_memory_gb=peak / 1e9, resident_before_gb=resident / 1e9,
               launches=launches, syncs_per_step=syncs,
               sync_run_ms=sync_secs * 1e3, profile=profile,
               wall_seconds=marks[-1] - t0,
               **_train_bounds(cfg, task.batch, task.seq_len))
    print(f"  (a) tinyllama-1.1b train step, batch {task.batch} x "
          f"{task.seq_len}: {step_ms:.1f} ms/step over {len(step_s)} steps "
          f"(warm-up {out['warmup_step_ms']:.1f} ms), {out['tokens_per_s']:.0f}"
          f" tokens/s; bound {out['bound_ms']:.1f} ms ({out['bound_by']}, "
          f"{out['operations']:.4g} operations); peak memory "
          f"{out['peak_memory_gb']:.3f} GB ({out['resident_before_gb']:.3f} "
          f"GB resident before); {syncs} synchronisations in a step; losses "
          f"{[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 5) for x in norms]}; hand-kernel launches {launches}")
    return out


def _train_walk(torch, dev, walk, dense, library, shape_q, shape_kv,
                attended: int, what: str) -> dict:
    """Phase 14 (c): a flash walk's forward and backward on random float32
    inputs: dq, dk and dv against autograd through the materialized-score
    attention within ``WALK_GRAD_TOL``, and the device time of a forward
    and backward of the walk, of the dense attention and of
    ``scaled_dot_product_attention`` (the library call), with the bound
    (two products forward, four backward)."""
    g = torch.Generator(device=dev).manual_seed(26)
    q = torch.randn(shape_q, generator=g, device=dev)
    k, v = (torch.randn(shape_kv, generator=g, device=dev) for _ in range(2))
    dout = torch.randn(shape_q, generator=g, device=dev)

    def grads(fn):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        fn(*xs).backward(dout)
        return [x.grad for x in xs]

    got, want = grads(walk), grads(dense)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    lib_errs = [float((a - b).abs().max())
                for a, b in zip(got, grads(library))]
    print(f"  (c) {what}: dq, dk, dv against autograd through the dense "
          f"attention max |difference| {[f'{e:.3g}' for e in errs]} (bound "
          f"{WALK_GRAD_TOL}); against the library call "
          f"{[f'{e:.3g}' for e in lib_errs]}")
    assert max(errs) <= WALK_GRAD_TOL, (what, errs)
    hd = shape_q[2] * shape_q[3] * shape_q[4]
    # forward: q, k, v read, out written; backward: q, k, v, out, dout
    # read, dq, dk, dv written
    bound, by = _bound_ms(4 * 6 * (q.numel() + k.numel()),
                          12 * hd * attended)
    row = dict(max_abs_err=max(errs), grad_errs=errs,
               library_grad_errs=lib_errs,
               ms=_time_ms(torch, lambda: grads(walk), reps=3, warmup=1),
               plain_ms=_time_ms(torch, lambda: grads(dense), reps=3,
                                 warmup=1),
               library_ms=_time_ms(torch, lambda: grads(library), reps=10),
               bound_ms=bound, bound_by=by)
    print(f"    forward+backward ms (CUDA events): flash {row['ms']:.3f}, "
          f"dense {row['plain_ms']:.3f}, library {row['library_ms']:.3f}; "
          f"bound {bound:.3f} ({by}, float32)")
    return row


def _train_walks(torch, dev, cfg) -> dict:
    """Phase 14 (c): both walks at phase 11's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models.flash import (flash_banded_attention,
                                          flash_causal_attention)

    s, c, h, dh = LM_FLASH_PROMPT, LM_CHUNK, cfg.n_heads, cfg.head_dim
    out = {"causal": _train_walk(
        torch, dev, lambda q, k, v: flash_causal_attention(q, k, v, c),
        lambda q, k, v: layers.dense_attention(q, k, v),
        lambda q, k, v: _sdpa(torch, q, k, v),
        (1, s, cfg.n_kv, h // cfg.n_kv, dh), (1, s, cfg.n_kv, dh),
        _attended(s, None), f"flash_causal_attention (1, {s}, {cfg.n_kv}, "
        f"{h // cfg.n_kv}, {dh}), chunk {c}")}
    g3 = get_config("gemma3-12b")
    s, w, h, dh = GEMMA3_PROMPT, g3.window, g3.n_heads, g3.head_dim
    idx = torch.arange(s, device=dev)
    band = (idx[:, None] >= idx[None, :]) & (idx[:, None] - idx[None, :] < w)
    out["banded"] = _train_walk(
        torch, dev, lambda q, k, v: flash_banded_attention(q, k, v, w, c),
        lambda q, k, v: layers.dense_attention(q, k, v, window=w),
        lambda q, k, v: _sdpa(torch, q, k, v, band),
        (1, s, g3.n_kv, h // g3.n_kv, dh), (1, s, g3.n_kv, dh),
        _attended(s, w), f"flash_banded_attention (1, {s}, {g3.n_kv}, "
        f"{h // g3.n_kv}, {dh}), window {w}, chunk {c}")
    return out


def _rel_max(got, want) -> float:
    """The largest |got - want| over ``want``'s std, leaf by leaf, the
    largest of all leaves."""
    from repro_torch.tree import leaves
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        std = float(b.float().std()) if b.numel() > 1 else float(b.abs())
        worst = max(worst, float((a.cpu() - b).abs().max()) / max(std, 1e-30))
    return worst


def _train_card_vs_cpu(torch, dev, cut, params, hyper, task) -> dict:
    """Phase 14 (b): the 2-layer cut at full width in float32, one train
    step and its gradient on the card against the same on the CPU."""
    from repro_torch.data.lm import lm_batches
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_loss_fn, make_train_step, value_and_grad
    from repro_torch.tree import tree_map

    def run(p, d):
        batch = lm_batches(task, 0, device=d)
        loss, _, grads = value_and_grad(make_loss_fn(cut), p, batch)
        state = {"params": p, "opt": adamw_init(p, hyper.opt)}
        _, met = make_train_step(cut, hyper)(state, batch)
        assert float(met["loss"]) == float(loss)
        return float(loss), float(met["grad_norm"]), grads

    card = run(params, dev)
    t0 = time.perf_counter()
    cpu = run(tree_map(lambda x: x.cpu(), params), torch.device("cpu"))
    cpu_secs = time.perf_counter() - t0
    dl = abs(card[0] - cpu[0]) / abs(cpu[0])
    dn = abs(card[1] - cpu[1]) / abs(cpu[1])
    dg = _rel_max(card[2], cpu[2])
    print(f"  (b) {TRAIN_CUT_LAYERS} layers at full width, float32, batch "
          f"{task.batch} x {task.seq_len}, one train step, the card against "
          f"the CPU ({cpu_secs:.1f} s): loss {card[0]:.6f} / {cpu[0]:.6f} "
          f"(relative {dl:.3g}, bound {TRAIN_CPU_LOSS}), grad norm relative "
          f"{dn:.3g}, largest grad difference over its leaf's std "
          f"{dg:.3g} (bound {TRAIN_CPU_GRAD})")
    assert dl <= TRAIN_CPU_LOSS and dn <= TRAIN_CPU_LOSS, (dl, dn)
    assert dg <= TRAIN_CPU_GRAD, dg
    return dict(loss=card[0], cpu_loss=cpu[0], loss_rel=dl,
                grad_norm_rel=dn, grad_max_over_std=dg, cpu_seconds=cpu_secs)


def _train_fault(torch, dev, cut, hyper, task) -> dict:
    """Phase 14 (d): on the 2-layer cut, ``run_training`` preempted at
    step 6 and restored from its step-4 checkpoint against an
    uninterrupted run (final states bitwise equal), and the rf budget
    gating the steps."""
    import shutil
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import (TrainLoopConfig, init_train_state,
                                   make_train_step, run_training)
    from repro_torch.tree import leaves_with_paths, path_name

    root = REPO / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    state0 = init_train_state(torch.Generator(device=dev).manual_seed(27),
                              cut, hyper)
    step = make_train_step(cut, hyper)

    def batch_fn(s):
        return lm_batches(task, s, device=dev)

    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        crash, log = run_training(state0, step, batch_fn, TrainLoopConfig(
            total_steps=TRAIN_FT_STEPS, ckpt_dir=str(root),
            ckpt_every=TRAIN_FT_EVERY, log_every=1,
            preempt_at=TRAIN_FT_PREEMPT))
        torch.cuda.synchronize()
        crash_secs = time.perf_counter() - t0
        launches = _launches_zero(ops.launch_counts(), "lm_train_ft")
        ckpt_gb = sum(f.stat().st_size for f in
                      (root / f"step_{TRAIN_FT_STEPS:010d}").iterdir()) / 1e9
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    clean, _ = run_training(state0, step, batch_fn, TrainLoopConfig(
        total_steps=TRAIN_FT_STEPS, log_every=1))
    torch.cuda.synchronize()
    clean_secs = time.perf_counter() - t0
    events = [(m["event"], m.get("step")) for m in log if "event" in m]
    assert events == [("preempted", None), ("resume", TRAIN_FT_EVERY)], events
    worst, at = 0.0, None
    for (path, a), (_, b) in zip(leaves_with_paths(crash),
                                 leaves_with_paths(clean)):
        if not torch.equal(a, b):
            d = float((a.double() - b.double()).abs().max())
            if d >= worst:
                worst, at = d, path_name(path)
    print(f"  (d) {TRAIN_CUT_LAYERS}-layer cut, {TRAIN_FT_STEPS} steps, "
          f"checkpoints every {TRAIN_FT_EVERY} ({ckpt_gb:.3f} GB each), "
          f"preempted at {TRAIN_FT_PREEMPT}: events {events}; final state "
          f"against the uninterrupted run: "
          f"{'bitwise equal' if at is None else f'largest difference {worst:.3g} at {at}'}"
          f"; {crash_secs:.1f} s with the restart and checkpoints, "
          f"{clean_secs:.1f} s uninterrupted")
    assert at is None, (worst, at)
    _, blog = run_training(state0, step, batch_fn, TrainLoopConfig(
        total_steps=TRAIN_FT_STEPS, log_every=1, budget_source="rf",
        budget_cost_uj=TRAIN_BUDGET_COST))
    deferred = [m["step"] for m in blog if m.get("deferred")]
    ran = [m["step"] for m in blog if "loss" in m]
    assert deferred and ran and sorted(deferred + ran) == list(
        range(TRAIN_FT_STEPS)), blog
    assert all(math.isfinite(m["loss"]) for m in blog if "loss" in m)
    print(f"  (d) rf budget at {TRAIN_BUDGET_COST} µJ a step: steps "
          f"{deferred} deferred, {ran} ran")
    return dict(events=events, bitwise_equal=at is None, launches=launches,
                checkpoint_gb=ckpt_gb, crash_run_seconds=crash_secs,
                clean_run_seconds=clean_secs, budget_deferred=deferred,
                budget_ran=ran)


def _payload_bytes(cfg_c, params) -> dict:
    """What one rank puts on the wire in a compressed step (a kept entry's
    bf16 value and int32 index; a small leaf whole in float32), against the
    bf16 dense gradient and the two wire-byte formulas at 2 ranks."""
    from repro_torch.core.compression import (wire_bytes_dense_psum,
                                              wire_bytes_topk_allgather)
    from repro_torch.tree import leaves
    payload = n = 0
    for p in leaves(params):
        n += p.numel()
        if p.numel() < cfg_c.min_size:
            payload += 4 * p.numel()
        else:
            payload += 6 * max(1, int(p.numel() * cfg_c.topk_ratio))
    return dict(payload_bytes=payload, dense_bf16_bytes=2 * n,
                payload_share=payload / (2 * n),
                wire_bytes_dense_psum_2=wire_bytes_dense_psum(n, 2),
                wire_bytes_topk_allgather_2=wire_bytes_topk_allgather(
                    n, 2, cfg_c.topk_ratio))


def _train_compressed(torch, dev, cfg, hyper, task) -> dict:
    """Phase 14 (e): the compressed step at world size 1 on NCCL with the
    full model and ``CompressionConfig()`` (top-k 1/64, error feedback):
    one warm-up step, whose top-k indices are kept, and two timed."""
    import shutil
    import torch.distributed as dist
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state, make_compressed_train_step
    from repro_torch.tree import leaves

    store = REPO / "build" / "train_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store / "nccl"),
                                                         1),
                            rank=0, world_size=1)
    try:
        cc = CompressionConfig()
        state = init_train_state(torch.Generator(device=dev).manual_seed(28),
                                 cfg, hyper, cc)
        step = make_compressed_train_step(cfg, hyper, cc, dist.group.WORLD)
        ops.reset_launch_counts()
        mets, picked, marks = [], [], [time.perf_counter()]
        for i in range(3):
            with (_topk_recorder(picked) if i == 0
                  else contextlib.nullcontext()):
                state, met = step(state, lm_batches(task, i, device=dev))
            mets.append({k: float(v) for k, v in met.items()})
            marks.append(time.perf_counter())
        launches = _launches_zero(ops.launch_counts(),
                                  "lm_train_compressed")
        ef = sum(float(x.float().square().sum())
                 for x in leaves(state["ef"])) ** 0.5
        wire = _payload_bytes(cc, state["params"])
    finally:
        dist.destroy_process_group()
    step_ms = (marks[-1] - marks[1]) / 2 * 1e3
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in mets), mets
    print(f"  (e) compressed step, world size 1 on NCCL, full model, top-k "
          f"1/64 with error feedback: {step_ms:.1f} ms/step (warm-up "
          f"{(marks[1] - marks[0]) * 1e3:.1f}); losses "
          f"{[round(m['loss'], 5) for m in mets]}, grad norms "
          f"{[round(m['grad_norm'], 5) for m in mets]}; residual norm "
          f"{ef:.4g}; payload {wire['payload_bytes'] / 1e6:.2f} MB a rank "
          f"against {wire['dense_bf16_bytes'] / 1e6:.2f} MB dense bf16 "
          f"({wire['payload_share']:.4f}); launches {launches}")
    return dict(step_ms=step_ms, warmup_step_ms=(marks[1] - marks[0]) * 1e3,
                metrics=mets, residual_norm=ef, launches=launches,
                topk_first_step=picked, **wire)


def _train_rank(argv) -> int:
    """One of phase 14 (e)'s gloo ranks sharing the card (started by
    :func:`_train_gloo` as ``chip_smoke.py --train-rank R WORLD STORE
    OUT DEVICE``): the compressed step on the 2-layer cut over the global
    batch on DEVICE, each step's parameter hashes and metrics written to
    OUT (JSON)."""
    import hashlib
    import torch
    import torch.distributed as dist
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dev = torch.device(argv[4])
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data.lm import LMTask, lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import (TrainHyper, init_train_state,
                                   make_compressed_train_step)
    from repro_torch.tree import leaves_with_paths, path_name
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        cut = _train_cut(get_config("tinyllama-1.1b"))
        hyper = TrainHyper(peak_lr=3e-4, warmup=1, total_steps=10)
        task = LMTask(vocab=cut.vocab, seq_len=TRAIN_CUT_SEQ, batch=world)
        cc = CompressionConfig()
        state = init_train_state(torch.Generator(device=dev).manual_seed(29),
                                 cut, hyper, cc)
        step = make_compressed_train_step(cut, hyper, cc, dist.group.WORLD)
        res = {"hashes": [], "metrics": []}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(TRAIN_RANK_STEPS):
            state, met = step(state, lm_batches(task, i, device=dev))
            res["metrics"].append({k: float(v) for k, v in met.items()})
            res["hashes"].append({
                path_name(p): hashlib.sha256(
                    t.detach().cpu().reshape(-1).view(torch.uint8)
                    .numpy().tobytes()).hexdigest()
                for p, t in leaves_with_paths({"params": state["params"],
                                               "opt": state["opt"]})})
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = ops.launch_counts()
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def _train_gloo(torch, dev) -> dict:
    """Phase 14 (e): two gloo ranks sharing the card on the 2-layer cut;
    after each step both ranks' parameters and optimizer states must be
    bitwise equal."""
    import shutil
    store = REPO / "build" / "train_gloo"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    world = TRAIN_RANKS
    files = [store / f"rank{r}.json" for r in range(world)]
    logs = [open(store / f"rank{r}.log", "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--train-rank",
         str(r), str(world), str(store / "gloo"), str(files[r]), str(dev)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    wall = time.perf_counter() - t0
    failed = [r for r, p in enumerate(procs) if p.returncode]
    for r in failed:
        print((store / f"rank{r}.log").read_text()[-3000:])
    assert not failed, f"gloo ranks {failed} failed"
    ranks = [json.loads(f.read_text()) for f in files]
    for i in range(TRAIN_RANK_STEPS):
        assert ranks[0]["hashes"][i] == ranks[1]["hashes"][i], i
        assert ranks[0]["metrics"][i] == ranks[1]["metrics"][i], i
    for r in ranks:
        _launches_zero(r["launches"], "lm_train_gloo")
    print(f"  (e) {world} gloo ranks on one card, {TRAIN_CUT_LAYERS}-layer "
          f"cut, global batch {world} x {TRAIN_CUT_SEQ}: after each of "
          f"{TRAIN_RANK_STEPS} steps every parameter and optimizer leaf "
          f"bitwise equal across ranks ({len(ranks[0]['hashes'][0])} "
          f"leaves); losses {[m['loss'] for m in ranks[0]['metrics']]}; "
          f"{[round(r['seconds'], 2) for r in ranks]} s a rank, {wall:.1f} s "
          f"with start-up")
    return dict(ranks=world, steps=TRAIN_RANK_STEPS,
                metrics=ranks[0]["metrics"], launches=ranks[0]["launches"],
                seconds=[r["seconds"] for r in ranks], wall_seconds=wall)


def phase_lm_train(torch, dev) -> dict:
    """Phase 14: the LM training path (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import LMTask, lm_batches
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.train import TrainHyper, init_train_state

    t0 = time.perf_counter()
    # the bf16 GEMMs reduce in float32, as in phase 11
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config("tinyllama-1.1b")
    assert cfg.remat == "full" and cfg.dtype == torch.bfloat16
    hyper = TrainHyper(peak_lr=3e-4, warmup=2, total_steps=TRAIN_STEPS)
    task = LMTask(vocab=cfg.vocab, seq_len=SHAPES["train_4k"].seq_len,
                  batch=TRAIN_BATCH)
    print(f"  tinyllama-1.1b: {cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers, float32 masters, {cfg.dtype} compute, "
          f"remat {cfg.remat}; {task.seq_len} tokens > dense limit "
          f"{cfg.dense_attn_max_seq}: the flash causal walk in every layer")
    out = {}
    state = init_train_state(torch.Generator(device=dev).manual_seed(24),
                             cfg, hyper)
    out["bf16_vs_f32"] = _train_bf16_vs_f32(
        torch, cfg, state["params"], lm_batches(task, 0, device=dev))
    torch.cuda.empty_cache()
    out["main"] = _train_main(torch, dev, cfg, hyper, task, state,
                              out["bf16_vs_f32"]["loss_bf16"])
    del state
    torch.cuda.empty_cache()
    out["walks"] = _train_walks(torch, dev, cfg)
    torch.cuda.empty_cache()
    cut_task = LMTask(vocab=cfg.vocab, seq_len=TRAIN_CUT_SEQ, batch=1)
    cut32 = _train_cut(cfg, torch.float32)
    params = init_train_state(torch.Generator(device=dev).manual_seed(30),
                              cut32, hyper)["params"]
    out["card_vs_cpu"] = _train_card_vs_cpu(torch, dev, cut32, params, hyper,
                                            cut_task)
    del params
    out["fault_tolerance"] = _train_fault(torch, dev, _train_cut(cfg), hyper,
                                          cut_task)
    torch.cuda.empty_cache()
    out["compressed"] = _train_compressed(torch, dev, cfg, hyper, task)
    torch.cuda.empty_cache()
    out["gloo_ranks"] = _train_gloo(torch, dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 14: {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def _topk_recorder(store: list):
    """Record the indices of every top-k the gradient codec takes while
    the context is open."""
    from repro_torch.core import compression as tc
    inner = tc.topk_compress

    def wrapped(flat, k):
        vals, idx = inner(flat, k)
        store.append(idx.clone())
        return vals, idx

    tc.topk_compress = wrapped
    try:
        yield store
    finally:
        tc.topk_compress = inner


def _same_or_rel(got: list, want: list, tol: float, what: str) -> dict:
    """Two metric sequences: bitwise equal, or the largest relative
    difference (at most ``tol``)."""
    rel = max((abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)),
              default=0.0)
    assert len(got) == len(want) and rel <= tol, (what, got, want)
    return dict(bitwise=got == want, max_rel=rel)


def _placed_state(cfg, state, mesh, rules, compression=None):
    from repro_torch import sharding as shd
    from repro_torch.train import train_state_specs
    return shd.place(state, shd.tree_named_shardings(
        train_state_specs(cfg, compression), state, mesh, rules))


def _sharded_main(torch, dev, mesh, cfg, hyper, task, ref) -> dict:
    """Phase 15 (a): the FSDP step on the mesh through ``run_training``,
    ``SHARD_STEPS`` steps from phase 14's initial state and batches, held
    to phase 14's losses and grad norms; step ms over all but the first
    step, peak memory, launches of the four kernels, and one more step
    under the profiler."""
    from repro_torch import sharding as shd
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import (TrainLoopConfig, init_train_state,
                                   make_train_step, run_training)

    state = init_train_state(torch.Generator(device=dev).manual_seed(24),
                             cfg, hyper)
    state = _placed_state(cfg, state, mesh, shd.FSDP_RULES)
    step = make_train_step(cfg, hyper)
    marks = []

    def batch_fn(s):
        marks.append(time.perf_counter())
        return lm_batches(task, s, device=dev)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with shd.use_sharding(mesh, shd.FSDP_RULES):
        state, log = run_training(state, step, batch_fn, TrainLoopConfig(
            total_steps=SHARD_STEPS, log_every=1))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    launches = _launches_zero(ops.launch_counts(), "lm_sharded_fsdp")
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in log]
    norms = [m["grad_norm"] for m in log]
    assert all(math.isfinite(x) for x in losses + norms), log
    held = dict(
        loss=_same_or_rel(losses, ref["losses"][:SHARD_STEPS], SHARD_REL,
                          "loss"),
        grad_norm=_same_or_rel(norms, ref["grad_norms"][:SHARD_STEPS],
                               SHARD_REL, "grad_norm"))
    step_s = [b - a for a, b in zip(marks[1:-1], marks[2:])]
    step_ms = sum(step_s) / len(step_s) * 1e3
    placements = {str(p): tuple(str(x) for x in t.placements)
                  for p, t in (("embed", state["params"]["embed"]),
                               ("unembed", state["params"]["unembed"]))}
    with shd.use_sharding(mesh, shd.FSDP_RULES):
        profile = _profile(torch, lambda: step(state, lm_batches(
            task, SHARD_STEPS, device=dev)), 1, step_ms / 1e3,
            "lm_sharded_step")
    out = dict(steps=SHARD_STEPS, step_ms=step_ms,
               step_ms_each=[x * 1e3 for x in step_s],
               warmup_step_ms=(marks[1] - marks[0]) * 1e3,
               tokens_per_s=task.batch * task.seq_len / (step_ms / 1e3),
               losses=losses, grad_norms=norms, held_to_phase14=held,
               peak_memory_gb=peak / 1e9, resident_before_gb=resident / 1e9,
               launches=launches, profile=profile, placements=placements,
               phase14=dict(step_ms=ref["step_ms"],
                            peak_memory_gb=ref["peak_memory_gb"],
                            profile=ref["profile"]))
    print(f"  (a) FSDP step on the {tuple(mesh.shape)} mesh, batch "
          f"{task.batch} x {task.seq_len}: {step_ms:.1f} ms/step (phase 14 "
          f"{ref['step_ms']:.1f}; warm-up {out['warmup_step_ms']:.1f} ms), "
          f"peak memory {out['peak_memory_gb']:.3f} GB (phase 14 "
          f"{ref['peak_memory_gb']:.3f}); launches a step "
          f"{profile['kernel_launches_per_slot']:.0f} (phase 14 "
          f"{ref['profile']['kernel_launches_per_slot']:.0f}), device busy "
          f"{profile['device_busy_ms_per_slot']:.1f} ms (phase 14 "
          f"{ref['profile']['device_busy_ms_per_slot']:.1f}); losses and grad "
          f"norms against phase 14's: "
          f"{'bitwise' if held['loss']['bitwise'] else held['loss']['max_rel']}"
          f" / {'bitwise' if held['grad_norm']['bitwise'] else held['grad_norm']['max_rel']}"
          f"; placements {placements}; hand-kernel launches {launches}")
    return out


def _sharded_compressed(torch, dev, mesh, cfg, hyper, task, ref) -> dict:
    """Phase 15 (b): the DP+TP compressed step on the mesh (DP over
    "data", TP over "model"), ``SHARD_CMP_STEPS`` steps from phase 14
    (e)'s seed-28 state and batches, held to phase 14 (e)'s world-of-one
    compressed step: the codec's top-k indices of the first step exactly,
    losses and grad norms bitwise or within ``SHARD_REL``."""
    from repro_torch import sharding as shd
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state, make_compressed_train_step

    cc = CompressionConfig()
    # popped: phase 14's record is written as JSON
    want, want_idx = (ref["metrics"][:SHARD_CMP_STEPS],
                      ref.pop("topk_first_step"))
    state = init_train_state(torch.Generator(device=dev).manual_seed(28),
                             cfg, hyper, cc)
    state = _placed_state(cfg, state, mesh, shd.DP_TP_RULES, cc)
    step = make_compressed_train_step(cfg, hyper, cc, mesh,
                                      dp_axes=("data",))
    got, got_idx = [], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with shd.use_sharding(mesh, shd.DP_TP_RULES):
        for i in range(SHARD_CMP_STEPS):
            with (_topk_recorder(got_idx) if i == 0
                  else contextlib.nullcontext()):
                state, met = step(state, lm_batches(task, i, device=dev))
            got.append({k: float(v) for k, v in met.items()})
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = _launches_zero(ops.launch_counts(), "lm_sharded_dptp")
    assert len(got_idx) == len(want_idx) > 0, (len(got_idx), len(want_idx))
    same_idx = all(torch.equal(a, b) for a, b in zip(got_idx, want_idx))
    assert same_idx, "the codec's indices differ"
    held = dict(
        loss=_same_or_rel([m["loss"] for m in got],
                          [m["loss"] for m in want], SHARD_REL, "loss"),
        grad_norm=_same_or_rel([m["grad_norm"] for m in got],
                               [m["grad_norm"] for m in want], SHARD_REL,
                               "grad_norm"))
    n_idx = sum(int(x.numel()) for x in got_idx)
    print(f"  (b) DP+TP compressed step on the {tuple(mesh.shape)} mesh "
          f"(dp over data) against phase 14 (e)'s world-of-one compressed "
          f"step: {len(got_idx)} leaves' top-k indices ({n_idx} integers) "
          f"equal; losses / grad norms "
          f"{'bitwise' if held['loss']['bitwise'] else held['loss']['max_rel']}"
          f" / {'bitwise' if held['grad_norm']['bitwise'] else held['grad_norm']['max_rel']}"
          f"; {SHARD_CMP_STEPS} steps {mesh_s:.1f} s on the mesh; launches "
          f"{launches}")
    return dict(metrics=got, reference_metrics=want, held=held,
                topk_leaves=len(got_idx), topk_integers=n_idx,
                launches=launches, seconds_mesh=mesh_s)


def _sharded_cut(torch, dev, mesh, cfg, hyper) -> dict:
    """Phase 15 (c), the 2-layer cut at full width: the state drawn onto
    the mesh leaf by leaf equal to the placed draw, a checkpoint of the
    unsharded state restored with ``shardings=`` onto the mesh (each local
    shard equal to its slice), and the FSDP step through ``run_training``
    preempted at step 6 and resumed from step 4 onto the mesh, bitwise
    equal to a clean sharded run."""
    import shutil
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch import sharding as shd
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data.lm import LMTask, lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import (TrainLoopConfig, init_train_state,
                                   make_train_step, run_training,
                                   train_state_specs)
    from repro_torch.tree import leaves, leaves_with_paths, path_name

    cut = _train_cut(cfg)
    task = LMTask(vocab=cut.vocab, seq_len=TRAIN_CUT_SEQ, batch=1)
    root = REPO / "build" / "sharded_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    state0 = init_train_state(torch.Generator(device=dev).manual_seed(31),
                              cut, hyper)
    sh = shd.tree_named_shardings(train_state_specs(cut), state0, mesh,
                                  shd.FSDP_RULES)
    drawn = init_train_state(torch.Generator(device=dev).manual_seed(31),
                             cut, hyper, shardings=sh)
    assert all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(
        leaves(drawn), leaves(shd.place(state0, sh)))), "drawn placed"
    del drawn
    try:
        save_checkpoint(str(root / "plain"), 1, state0)
        back = restore_checkpoint(str(root / "plain"), 1, state0,
                                  shardings=sh)
        slices = 0
        for (path, got), want in zip(leaves_with_paths(back),
                                     leaves(state0)):
            shape, offset = compute_local_shape_and_global_offset(
                got.shape, got.device_mesh, got.placements)
            sl = tuple(slice(o, o + n) for o, n in zip(offset, shape))
            assert torch.equal(got.to_local(), want[sl]), path_name(path)
            slices += 1
        step = make_train_step(cut, hyper)

        def batch_fn(s):
            return lm_batches(task, s, device=dev)

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with shd.use_sharding(mesh, shd.FSDP_RULES):
            crash, log = run_training(
                shd.place(state0, sh), step, batch_fn, TrainLoopConfig(
                    total_steps=TRAIN_FT_STEPS, ckpt_dir=str(root / "run"),
                    ckpt_every=TRAIN_FT_EVERY, log_every=1,
                    preempt_at=TRAIN_FT_PREEMPT), shardings=sh)
        torch.cuda.synchronize()
        crash_s = time.perf_counter() - t0
        launches = _launches_zero(ops.launch_counts(),
                                  "lm_sharded_fault_tolerance")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with shd.use_sharding(mesh, shd.FSDP_RULES):
        clean, _ = run_training(shd.place(state0, sh), step, batch_fn,
                                TrainLoopConfig(total_steps=TRAIN_FT_STEPS,
                                                log_every=1))
    events = [(m["event"], m.get("step")) for m in log if "event" in m]
    assert events == [("preempted", None), ("resume", TRAIN_FT_EVERY)], events
    differ = [path_name(p) for (p, a), b in zip(leaves_with_paths(crash),
                                                leaves(clean))
              if not torch.equal(a.full_tensor(), b.full_tensor())]
    assert not differ, differ
    print(f"  (c) {TRAIN_CUT_LAYERS}-layer cut: the state drawn onto the "
          f"mesh leaf by leaf equal to the placed draw; the unsharded "
          f"checkpoint restored onto the mesh, {slices} leaves each equal "
          f"to its slice; the sharded run preempted at {TRAIN_FT_PREEMPT} and "
          f"resumed from step {TRAIN_FT_EVERY} ({events}) bitwise equal to "
          f"a clean one ({crash_s:.1f} s with the restart); launches "
          f"{launches}")
    return dict(restored_leaves=slices, events=events, bitwise_equal=True,
                launches=launches, crash_run_seconds=crash_s)


def _lm_shard_rank(argv, probe: bool = False) -> int:
    """One of phase 15 (d)'s ranks sharing the card (started by
    :func:`_sharded_ranks` as ``chip_smoke.py --lm-shard-rank R WORLD
    STORE OUT DEVICE``): the float32 2-layer cut's FSDP steps on a (2,
    WORLD/2) ("data", "model") mesh, the metrics and each parameter leaf's
    norm written to OUT (JSON).  With ``probe`` (``--lm-shard-probe``) it
    only gathers a split tensor on DEVICE through DTensor, writing each
    stage it reaches to OUT as it goes."""
    import torch
    import torch.distributed as dist
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dev = torch.device(argv[4])

    def stage(name):
        if probe:
            with open(out, "a") as f:
                f.write(name + "\n")

    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO / "src"))
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh_for
    stage("start")
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        stage("group")
        mesh = make_mesh_for((2, world // 2), ("data", "model"),
                             device_type=dev.type)
        stage("mesh")
        if probe:
            x = distribute_tensor(torch.arange(8.0, device=dev), mesh,
                                  [Shard(0), Replicate()])
            stage("placed")
            whole = x.full_tensor().cpu()
            stage("gathered")
            if not torch.equal(whole, torch.arange(8.0)):
                raise RuntimeError(f"gathered {whole.tolist()}")
            stage("ok")
            return 0
        res = _shard_cut_steps(torch, dev, mesh)
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def _shard_cut_steps(torch, dev, mesh) -> dict:
    """The float32 2-layer cut's ``SHARD_RANK_STEPS`` FSDP steps on
    ``mesh`` from the seed-32 state at batch ``SHARD_RANK_BATCH`` x
    ``TRAIN_CUT_SEQ``: the metrics, each parameter leaf's L2 norm after
    them, the launches and the seconds."""
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.data.lm import LMTask, lm_batches
    from repro_torch.kernels import ops
    from repro_torch.train import TrainHyper, init_train_state, make_train_step
    from repro_torch.tree import leaves_with_paths, path_name

    cut = _train_cut(get_config("tinyllama-1.1b"), torch.float32)
    hyper = TrainHyper(peak_lr=3e-4, warmup=1, total_steps=10)
    task = LMTask(vocab=cut.vocab, seq_len=TRAIN_CUT_SEQ,
                  batch=SHARD_RANK_BATCH)
    state = init_train_state(torch.Generator(device=dev).manual_seed(32),
                             cut, hyper)
    state = _placed_state(cut, state, mesh, shd.FSDP_RULES)
    step = make_train_step(cut, hyper)
    ops.reset_launch_counts()
    mets = []
    t0 = time.perf_counter()
    with shd.use_sharding(mesh, shd.FSDP_RULES):
        for i in range(SHARD_RANK_STEPS):
            state, met = step(state, lm_batches(task, i, device=dev))
            mets.append({k: float(v) for k, v in met.items()})
    secs = time.perf_counter() - t0
    norms = {path_name(p): float(torch.linalg.vector_norm(t.full_tensor()))
             for p, t in leaves_with_paths(state["params"])}
    return dict(metrics=mets, norms=norms, launches=ops.launch_counts(),
                seconds=secs)


def _start_ranks(dev, mode: str, store, timeout: float):
    """Run ``SHARD_RANKS4`` copies of this script as ``mode`` ranks on
    ``dev``; returns each rank's exit code, output file and log."""
    import shutil
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    world = SHARD_RANKS4
    files = [store / f"rank{r}.out" for r in range(world)]
    logs = [open(store / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), mode, str(r),
         str(world), str(store / "gloo"), str(files[r]), str(dev)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [(p.returncode, f, store / f"rank{r}.log")
            for r, (p, f) in enumerate(zip(procs, files))]


def _sharded_ranks(torch, dev, mesh) -> dict:
    """Phase 15 (d): ``SHARD_RANKS4`` gloo ranks sharing the card on a
    (2, 2) mesh, the float32 2-layer cut, held to the same steps on this
    process's world-of-one mesh within ``SHARD_RANK_REL`` (losses, grad
    norms, each parameter leaf's norm) — run only where gloo carries
    DTensor's collectives for tensors on the card, which a probe of as
    many ranks decides first."""
    t0 = time.perf_counter()
    probe = _start_ranks(dev, "--lm-shard-probe",
                         REPO / "build" / "lm_shard_probe", 120)
    stages = [f.read_text().split() if f.exists() else [] for _, f, _ in probe]
    if any(rc or s[-1:] != ["ok"] for (rc, _, _), s in zip(probe, stages)):
        reason = "; ".join(sorted({
            f"exit {rc}, last stage {s[-1] if s else 'none'}, "
            f"{log.read_text().strip()[-300:]!r}"
            for (rc, _, log), s in zip(probe, stages)}))
        wall = time.perf_counter() - t0
        print(f"  (d) left out: gloo does not carry DTensor's collectives of "
              f"tensors on the card, and NCCL refuses two ranks on one "
              f"device; the probe: {reason} ({wall:.1f} s)")
        return dict(ran=False, reason=reason, wall_seconds=wall)
    world = SHARD_RANKS4
    ran = _start_ranks(dev, "--lm-shard-rank", REPO / "build" /
                       "lm_shard_gloo", 600)
    wall = time.perf_counter() - t0
    failed = [r for r, (rc, _, _) in enumerate(ran) if rc]
    for r in failed:
        print(ran[r][2].read_text()[-3000:])
    assert not failed, f"phase 15 (d) ranks {failed} failed"
    ranks = [json.loads(f.read_text()) for _, f, _ in ran]
    one = _shard_cut_steps(torch, dev, mesh)
    worst = 0.0
    for r in ranks:
        _launches_zero(r["launches"], "lm_sharded_gloo")
        for key in ("loss", "grad_norm"):
            worst = max(worst, _same_or_rel(
                [m[key] for m in r["metrics"]],
                [m[key] for m in one["metrics"]], SHARD_RANK_REL,
                key)["max_rel"])
        worst = max(worst, _same_or_rel(
            [r["norms"][k] for k in sorted(one["norms"])],
            [one["norms"][k] for k in sorted(one["norms"])], SHARD_RANK_REL,
            "param norms")["max_rel"])
    print(f"  (d) {world} gloo ranks on one card, (2, 2) mesh, float32 "
          f"{TRAIN_CUT_LAYERS}-layer cut, {SHARD_RANK_STEPS} FSDP steps: "
          f"losses, grad norms and parameter norms within {worst:.3g} "
          f"relative of the world of one (bound {SHARD_RANK_REL}); "
          f"{[round(r['seconds'], 2) for r in ranks]} s a rank, {wall:.1f} s "
          f"with start-up")
    return dict(ran=True, ranks=world, max_rel=worst,
                metrics=ranks[0]["metrics"], launches=ranks[0]["launches"],
                seconds=[r["seconds"] for r in ranks], wall_seconds=wall)


def phase_lm_sharded(torch, dev, train: dict) -> dict:
    """Phase 15: the LM sharding rules on a DeviceMesh (module
    docstring)."""
    import shutil
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.lm import LMTask
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.train import TrainHyper

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config("tinyllama-1.1b")
    hyper = TrainHyper(peak_lr=3e-4, warmup=2, total_steps=TRAIN_STEPS)
    task = LMTask(vocab=cfg.vocab, seq_len=SHAPES["train_4k"].seq_len,
                  batch=TRAIN_BATCH)
    store = REPO / "build" / "lm_sharded_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store / "nccl"),
                                                         1),
                            rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh_for((1, 1), ("data", "model"))
        print(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} over "
              f"{dist.get_backend()}, world size {dist.get_world_size()}")
        out["fsdp"] = _sharded_main(torch, dev, mesh, cfg, hyper, task,
                                    train["main"])
        torch.cuda.empty_cache()
        out["dptp"] = _sharded_compressed(torch, dev, mesh, cfg, hyper, task,
                                          train["compressed"])
        torch.cuda.empty_cache()
        out["cut"] = _sharded_cut(torch, dev, mesh, cfg, hyper)
        torch.cuda.empty_cache()
        out["gloo_ranks"] = _sharded_ranks(torch, dev, mesh)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 15: {out['seconds']:.1f} s")
    return out


def _dryrun_compress(argv) -> int:
    """The reference's own compression check (``chip_smoke.py
    --dryrun-compress OUT``; ``tests/test_sharding_and_dryrun.py``'s
    model, mesh, codec and batch): the dense and the coreset-compressed
    DP step of a tiny model on an (8,) ("data",) mesh of fake ranks,
    their collective bytes written to OUT as JSON."""
    import torch
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import sharding as shd
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import TrainHyper

    cfg = ModelConfig(name="t", vocab=256, d_model=64, n_layers=2,
                      n_heads=4, n_kv=2, d_ff=256, dtype=torch.float32)
    res = {}
    with dryrun.fake_group(8):
        mesh = make_mesh_for((8,), ("data",), "cpu")
        for compress in (False, True):
            step, args = dryrun.build_step(
                "t", ShapeCell("t", "train", 64, 16), mesh,
                rules=shd.DP_TP_RULES, cfg=cfg, hyper=TrainHyper(),
                compress=compress,
                compression=CompressionConfig(topk_ratio=1 / 64,
                                              min_size=1024))
            res["compressed" if compress else "dense"] = analyze_step(
                step, *args).to_json()
    Path(argv[0]).write_text(json.dumps(res))
    return 0


def phase_dryrun(torch, dev, train: dict) -> dict:
    """Phase 16: the dry run (module docstring)."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.launch.shapes import SHAPES, ShapeCell
    from repro_torch.train import TrainHyper

    t0 = time.perf_counter()
    work = REPO / "build" / "dryrun"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", sh, "--mesh", m, "--tag", tag, "--force", *flags]
            for a, sh, m, flags, tag in DRYRUN_CELLS]
    cmds.append([sys.executable, str(Path(__file__).resolve()),
                 "--dryrun-compress", str(work / "compress.json")])
    logs = [open(work / f"cell{i}.log", "w") for i in range(len(cmds))]
    procs = [subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for cmd, log in zip(cmds, logs)]
    try:
        # (b) meanwhile: phase 14's own cell, a world of one, in this process
        cfg = get_config("tinyllama-1.1b")
        cell = ShapeCell("train_4k", "train", SHAPES["train_4k"].seq_len,
                         TRAIN_BATCH)
        ops.reset_launch_counts()
        tb = time.perf_counter()
        step, args = dryrun.build_step(
            "tinyllama-1.1b", cell, None, cfg=cfg,
            hyper=TrainHyper(peak_lr=3e-4, warmup=2, total_steps=TRAIN_STEPS))
        st = analyze_step(step, *args)
        del step, args
        b_secs = time.perf_counter() - tb
        launches = _launches_zero(ops.launch_counts(), "dryrun")
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    failed = [i for i, p in enumerate(procs) if p.returncode]
    for i in failed:
        print((work / f"cell{i}.log").read_text()[-3000:])
    assert not failed, f"dry-run processes {failed} failed"

    # (a) the four cells
    cells = []
    for arch, shape, mesh, flags, tag in DRYRUN_CELLS:
        res = json.loads(Path(dryrun.cell_path(arch, shape, mesh, tag))
                         .read_text())
        assert res["status"] == "ok", (arch, shape, res.get("error"))
        row = roofline.roofline_row(res)
        ma, coll = res["memory_analysis"], res["collectives"]
        if res["cell"]["kind"] == "decode":
            assert roofline.fits(row), (arch, shape, row["fit_gib"])
        name = f"{arch} {shape} {mesh}" + (" " + " ".join(flags)
                                           if flags else "")
        print(f"dry run (a) {name}, {res['n_devices']} ranks: "
              f"{res['op_analysis']['flops']:.4g} FLOPs a device, arguments "
              f"{ma['argument_bytes'] / 1e9:.3f} GB, temporaries "
              f"{ma['temp_bytes'] / 1e9:.3f} GB (fit {row['fit_gib']:.2f} "
              f"GiB), collectives "
              f"{ {k: coll[k]['bytes'] for k in coll if k != 'total_bytes'} }"
              f" bytes; roofline compute {row['t_compute'] * 1e3:.3f} ms, "
              f"memory {row['t_memory'] * 1e3:.3f} ms, collective "
              f"{row['t_collective'] * 1e3:.3f} ms ({row['dominant']}), "
              f"MODEL/HLO {row['useful_ratio']:.3f}, roofline fraction "
              f"{row['roofline_frac']:.4f}; traced in "
              f"{res['timings']['trace_s']} s")
        cells.append(dict(name=name, n_devices=res["n_devices"],
                          flops=res["op_analysis"]["flops"],
                          memory=ma, collectives=coll, roofline=row,
                          timings=res["timings"],
                          warnings=res["op_analysis"]["warnings"]))
    dense, comp = cells[2]["collectives"], cells[3]["collectives"]
    ref = json.loads((work / "compress.json").read_text())
    ref_dense = ref["dense"]["collective_bytes"]["all-reduce"]
    ref_comp = ref["compressed"]["total_collective_bytes"]
    assert ref_comp < ref_dense, (ref_comp, ref_dense)
    print(f"dry run (a) the reference's compression check, (8,) mesh: "
          f"compressed step {ref_comp:.0f} collective bytes against the "
          f"dense step's {ref_dense:.0f} all-reduce bytes; at train_4k on "
          f"the (16, 16) mesh: compressed (dp_tp) {comp['total_bytes']:.4g}"
          f" bytes in all against the FSDP cell's {dense['all-reduce']['bytes']:.4g}"
          f" all-reduce bytes (the tensor-parallel activation all-reduces, "
          f"{comp['all-reduce']['bytes']:.4g} bytes in the compressed cell, "
          f"are in both)")

    # (b) against phase 14's measurement
    main = train["main"]
    one_step = st.memory["argument_bytes"] + st.memory["temp_bytes"]
    peak = main["peak_memory_gb"] * 1e9
    resident = main["resident_before_gb"] * 1e9
    mem_rel = one_step / (peak - resident) - 1
    flops_rel = st.flops / main["operations"] - 1
    print(f"dry run (b) phase 14's cell, batch {TRAIN_BATCH} x "
          f"{cell.seq_len}, world of one ({b_secs:.1f} s): arguments "
          f"{st.memory['argument_bytes'] / 1e9:.3f} GB + temporaries "
          f"{st.memory['temp_bytes'] / 1e9:.3f} GB = {one_step / 1e9:.3f} GB "
          f"against phase 14's peak {peak / 1e9:.3f} GB less "
          f"{resident / 1e9:.3f} GB resident before the loop "
          f"({mem_rel:+.4f}; {one_step / peak:.4f} of the whole peak); "
          f"{st.flops:.5g} FLOPs against _train_bounds' "
          f"{main['operations']:.5g} ({flops_rel:+.4f}); launches "
          f"{launches}")
    assert abs(mem_rel) <= DRYRUN_MEM_REL, mem_rel
    assert abs(flops_rel) <= DRYRUN_FLOPS_REL, flops_rel
    secs = time.perf_counter() - t0
    print(f"phase 16: {secs:.1f} s")
    return dict(cells=cells, reference_compression=dict(
                    dense_allreduce_bytes=ref_dense,
                    compressed_total_bytes=ref_comp),
                phase14_cell=dict(memory=st.memory, flops=st.flops,
                                  one_step_bytes=one_step,
                                  phase14_peak_bytes=peak,
                                  phase14_resident_bytes=resident,
                                  mem_rel=mem_rel,
                                  ratio_to_whole_peak=one_step / peak,
                                  operations=main["operations"],
                                  flops_rel=flops_rel, seconds=b_secs),
                launches=launches, seconds=secs)


def train_drift(argv) -> int:
    """``chip_smoke.py --train-drift [LAYERS ...]``: the CPU estimate phase
    14's bounds were set from.  tinyllama-1.1b at full width cut to each
    of LAYERS (default 1 2 4) layers, batch 1, ``TRAIN_CUT_SEQ`` tokens
    past a dense limit of ``TRAIN_CUT_CHUNK`` (the flash causal walk, under
    remat): the first step's loss and gradient in bf16 against float32
    (|loss difference|, the whole gradient's cosine, the smallest leaf
    cosine); then the two walks' float32 dq, dk, dv against autograd
    through the dense attention at phase 14 (c)'s shapes.  Runs on the
    CPU."""
    import dataclasses
    import torch
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.lm import LMTask, lm_batches
    from repro_torch.models import layers
    from repro_torch.models.flash import (flash_banded_attention,
                                          flash_causal_attention)
    from repro_torch.models.transformer import init_params
    from repro_torch.train import make_loss_fn, value_and_grad

    cfg = get_config("tinyllama-1.1b")
    for n in [int(a) for a in argv] or [1, 2, 4]:
        cut = dataclasses.replace(_cut_cfg(cfg, n),
                                  dense_attn_max_seq=TRAIN_CUT_CHUNK,
                                  attn_chunk=TRAIN_CUT_CHUNK)
        params = init_params(torch.Generator().manual_seed(31), cut)
        batch = lm_batches(LMTask(vocab=cfg.vocab, seq_len=TRAIN_CUT_SEQ,
                                  batch=1), 0, device="cpu")
        t0 = time.perf_counter()
        l16, _, g16 = value_and_grad(make_loss_fn(cut), params, batch)
        cut32 = dataclasses.replace(cut, dtype=torch.float32)
        l32, _, g32 = value_and_grad(make_loss_fn(cut32), params, batch)
        cos, worst = _tree_cos(g16, g32)
        print(f"tinyllama-1.1b, {n} layers, batch 1 x {TRAIN_CUT_SEQ}: bf16 "
              f"against float32 loss {float(l16):.6f} / {float(l32):.6f} "
              f"(|difference| {abs(float(l16) - float(l32)):.4g}), gradient "
              f"cosine {cos:.6f}, smallest leaf cosine {worst:.6f} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    g3 = get_config("gemma3-12b")
    c = LM_CHUNK
    cases = [
        ("causal", (1, LM_FLASH_PROMPT, cfg.n_kv, cfg.n_heads // cfg.n_kv,
                    cfg.head_dim),
         lambda q, k, v: flash_causal_attention(q, k, v, c),
         lambda q, k, v: layers.dense_attention(q, k, v)),
        ("banded", (1, GEMMA3_PROMPT, g3.n_kv, g3.n_heads // g3.n_kv,
                    g3.head_dim),
         lambda q, k, v: flash_banded_attention(q, k, v, g3.window, c),
         lambda q, k, v: layers.dense_attention(q, k, v, window=g3.window))]
    for name, shape, walk, dense in cases:
        g = torch.Generator().manual_seed(26)
        q = torch.randn(shape, generator=g)
        k, v = (torch.randn(shape[:3] + shape[4:], generator=g)
                for _ in range(2))
        dout = torch.randn(shape, generator=g)
        grads = []
        for fn in (walk, dense):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            fn(*xs).backward(dout)
            grads.append([x.grad for x in xs])
        errs = [float((a - b).abs().max()) for a, b in zip(*grads)]
        print(f"{name} walk {shape}: dq, dk, dv against the dense "
              f"attention's max |difference| {errs}", flush=True)
    return 0


def bf16_drift(argv) -> int:
    """``chip_smoke.py --bf16-drift [ARCH ...]``: the CPU estimate phase
    12's bfloat16 bounds were set from.  Each config at full width, cut in
    depth (grok-1-314b also to a 32768-row vocabulary and experts of 8192,
    to fit the CPU; its 8 experts top-2 kept), at phase 12's batch,
    prompt and new tokens: bf16 greedy tokens from ``generate``, replayed;
    an MoE config's steps against a float32 decode replay, a recurrent
    config's against teacher-forced bf16 and float32 forwards.  Prints the
    RMS and largest differences over the logits' std.  Runs on the CPU."""
    import dataclasses
    import torch
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.serving.engine import generate

    cases = {
        "recurrentgemma-2b": [(3, {}), (6, {})],
        "mamba2-130m": [(6, {}), (24, {})],
        "deepseek-moe-16b": [(2, {"param_dtype": torch.bfloat16})],
        "grok-1-314b": [(1, {"param_dtype": torch.bfloat16, "vocab": 32768,
                             "moe": "d_expert=8192"})],
    }
    with torch.no_grad():
        for arch in argv or cases:
            for layers, over in cases[arch]:
                base = get_config(arch)
                if over.get("moe"):
                    over = dict(over, moe=dataclasses.replace(
                        base.moe, d_expert=8192))
                cfg = _cut_cfg(dataclasses.replace(base, **over), layers)
                g = torch.Generator().manual_seed(31)
                params = tt.init_params(g, cfg)
                served = tt.compute_params(params, cfg)
                new = MOE_NEW if cfg.moe_layers else REC_NEW
                prompt = torch.randint(0, cfg.vocab, (MIX_BATCH, MIX_PROMPT),
                                       generator=g)
                t0 = time.perf_counter()
                tokens = generate(served, cfg, prompt, new, device="cpu")
                dec, _ = _lm_replay(torch, tt, served, cfg, prompt, tokens)
                assert torch.equal(dec.argmax(-1).int(), tokens)
                cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
                p32 = tt.compute_params(params, cfg32)
                rows = {}
                if cfg.moe_layers:
                    ref, _ = _lm_replay(torch, tt, p32, cfg32, prompt, tokens)
                    rows["bf16 steps vs float32 decode replay"] = ref
                else:
                    full = _teacher_forced(torch, cfg, prompt, tokens)
                    steps = slice(MIX_PROMPT - 1, MIX_PROMPT + new - 1)
                    rows["decode vs bf16 forward"] = tt.forward(
                        served, cfg, full)[:, steps].float()
                    rows["bf16 steps vs float32 forward"] = tt.forward(
                        p32, cfg32, full)[:, steps]
                for what, ref in rows.items():
                    d = _lm_diff(torch, dec, ref, cfg.vocab)
                    agree = float((dec[..., :cfg.vocab].argmax(-1)
                                   == ref[..., :cfg.vocab].argmax(-1))
                                  .float().mean())
                    print(f"{arch}, {layers} layers{' ' + str(over) if over else ''}"
                          f": {what}: RMS {d['rms_over_std']:.4g}, largest "
                          f"{d['max_over_std']:.4g} of the std "
                          f"{d['std']:.4g}; argmax agreement {agree:.4f} "
                          f"({time.perf_counter() - t0:.0f} s)", flush=True)
                del params, served, p32, rows
    return 0


def _first_row(x):
    """Row 0 of a stacked state (tensors, named tuples, dicts)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_first_row(v) for v in x))
    if isinstance(x, dict):
        return {k: _first_row(v) for k, v in x.items()}
    return x[0]


def main() -> int:
    import torch
    smi = phase_card(torch)
    sys.path.insert(0, str(REPO / "src"))
    ptxas = phase_build()
    dev = torch.device("cuda")
    table, extra = phase_kernels(torch, dev)
    fleet, fleet_launches = phase_fleet(torch, dev)
    importance = phase_importance(torch, dev)
    scarce, feed = phase_scarce_fleet(torch, dev)
    task_fleet = phase_task_fleet(torch, dev)
    streamed = phase_streamed(torch, dev)
    host_serve = phase_host_serve(torch, dev, feed)
    sharded = phase_sharded(torch, dev)
    paper = phase_paper_path(torch, dev)
    lm = phase_lm_serve(torch, dev)
    assert not any(lm["tinyllama"]["launches"].values()), lm["tinyllama"]
    mixers = phase_lm_mixers(torch, dev)
    multimodal = phase_lm_multimodal(torch, dev)
    train = phase_lm_train(torch, dev)
    lm_sharded = phase_lm_sharded(torch, dev, train)
    dry = phase_dryrun(torch, dev, train)
    # each kernel's launches on every path, each counted from zero;
    # ``launches`` is its main path's: the fleet's three, and the sampler's
    # entry point
    by_path = {"fleet": fleet_launches, "importance": importance,
               "scarce_fleet": scarce["launches"],
               "task_fleet": task_fleet["launches"],
               "streamed": streamed["launches"]["streamed"],
               "host_serve_fleet": host_serve["fleet_queue_mode"]["launches"],
               "host_serve_underprovisioned":
                   host_serve["underprovisioned"]["launches"],
               "sharded": sharded["world1"]["launches"],
               "sharded_per_shard_host": sharded["per_shard_host"]["launches"],
               "sharded_edge_host": sharded["edge_host"]["launches"],
               "sharded_gloo_rank0":
                   sharded["gloo_ranks"]["launches_per_rank"][0],
               "sharded_keyed": sharded["keyed"]["launches"],
               "per_sensor_oracle": paper["oracle"][0]["launches"]["oracle"],
               "bearing_step": paper["bearing_step"]["launches"],
               "codecs": paper["codecs"]["launches"],
               "lm_serve": lm["tinyllama"]["launches"],
               **{f"lm_mixers_{name}": mixers[name]["launches"]
                  for name in ("deepseek", "grok", "recurrentgemma",
                               "mamba2")},
               **{f"lm_multimodal_{name}": multimodal[name]["launches"]
                  for name in ("whisper", "qwen2vl")},
               "lm_train": train["main"]["launches"],
               "lm_train_fault_tolerance":
                   train["fault_tolerance"]["launches"],
               "lm_train_compressed": train["compressed"]["launches"],
               "lm_train_gloo_rank0": train["gloo_ranks"]["launches"],
               "lm_sharded_fsdp": lm_sharded["fsdp"]["launches"],
               "lm_sharded_dptp": lm_sharded["dptp"]["launches"],
               "lm_sharded_fault_tolerance": lm_sharded["cut"]["launches"],
               "dryrun": dry["launches"]}
    if lm_sharded["gloo_ranks"]["ran"]:
        by_path["lm_sharded_gloo_rank0"] = lm_sharded["gloo_ranks"][
            "launches"]
    launches = dict(fleet_launches,
                    importance_select=importance["importance_select"])
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    launches_by_path={p: v.get(name, 0)
                                      for p, v in by_path.items()},
                    **table[name])
               for name, (src, rep) in _SOURCES.items()]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, kernels=kernels, timing=extra, ptxas=ptxas,
             fleet=fleet, scarce_fleet=scarce, task_fleet=task_fleet,
             streamed=streamed, host_serve=host_serve, sharded=sharded,
             paper_path=paper, lm_serve=lm, lm_mixers=mixers,
             lm_multimodal=multimodal, lm_train=train,
             lm_sharded=lm_sharded, dryrun=dry),
        indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(_sharded_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--bf16-drift"]:
        sys.exit(bf16_drift(sys.argv[2:]))
    if sys.argv[1:2] == ["--train-rank"]:
        sys.exit(_train_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--lm-shard-rank"]:
        sys.exit(_lm_shard_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--lm-shard-probe"]:
        sys.exit(_lm_shard_rank(sys.argv[2:], probe=True))
    if sys.argv[1:2] == ["--dryrun-compress"]:
        sys.exit(_dryrun_compress(sys.argv[2:]))
    if sys.argv[1:2] == ["--train-drift"]:
        sys.exit(train_drift(sys.argv[2:]))
    sys.exit(main())
