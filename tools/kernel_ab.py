#!/usr/bin/env python3
"""Device time of the port's four CUDA kernels at the HAR fleet's shapes,
for comparing two trees of the repository on one card.

Each process loads the ``repro_torch`` found under the ``src`` directory it
is given, builds that tree's kernels there, and prints one JSON line of
device milliseconds per call (``torch.profiler``, kernels whose name holds
the op's name, mean over 50 calls after a warm-up):

* ``signature_corr``: (3000, 60, 3) windows against the (12, 60, 3) bank;
* ``fake_quant``: one slot's three per-node activations, (3000, 60, 3),
  (3000, 30, 32) and (3000, 15, 64), 16 bits, ``per_sample``;
* ``kmeans_coreset``: (9000, 60, 2) channel clouds, k = 12, 4 rounds;
* ``importance_select``: (3000, 60, 3) windows, m = 20.

Compare two trees in turns within one call on the card, for example a
parent unpacked with ``git archive`` into ``build/parent``:

    for s in build/parent/src src src build/parent/src; do
        python3 tools/kernel_ab.py $s; done
"""
import json
import subprocess
import sys
from pathlib import Path


def device_ms(torch, fn, match: str, reps: int = 50) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and match in e.key:
            us += float(getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))
    if us <= 0:
        raise RuntimeError(f"the profiler saw no device time for {match}")
    return us / reps / 1e3


def main(src: str) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.core.coreset import points_from_window
    from repro_torch.data.sensors import class_signatures, har_windows
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    labels = torch.randint(0, 12, (3000,), generator=g, device=dev)
    windows = har_windows(g, labels).contiguous()
    sigs = class_signatures(device=dev).contiguous()
    acts = [torch.randn(s, generator=g, device=dev) * 3.0
            for s in ((3000, 60, 3), (3000, 30, 32), (3000, 15, 64))]
    pts = points_from_window(windows.transpose(1, 2)[..., None]).reshape(
        -1, 60, 2).contiguous()

    def quant_slot():
        for x in acts:
            ops.fake_quant_op(x, 16, per_sample=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {
        "src": src, "card": smi.strip(),
        "signature_corr": device_ms(
            torch, lambda: ops.signature_corr_op(windows, sigs),
            "signature_corr"),
        "fake_quant": device_ms(torch, quant_slot, "fake_quant"),
        "kmeans_coreset": device_ms(
            torch, lambda: ops.kmeans_coreset_op(pts, 12, 4),
            "kmeans_coreset"),
        "importance_select": device_ms(
            torch, lambda: ops.importance_select_op(windows, 20),
            "importance_select"),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: kernel_ab.py SRC_DIR")
    sys.exit(main(sys.argv[1]))
