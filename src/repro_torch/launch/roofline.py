"""Roofline analysis: three terms per (arch x shape x mesh) from the dry run.

PyTorch counterpart of :mod:`repro.launch.roofline`, with the H100 SXM's
figures (NVIDIA's data sheet):

    compute term    = FLOPs_per_device / 989e12         (dense bf16 peak)
    memory term     = HBM_bytes_per_device / 3.35e12     (HBM3 bandwidth)
    collective term = collective_bytes_per_device / 50e9 (one 400 Gb/s
                                                          InfiniBand NDR
                                                          link a card)

The production meshes span hosts of 8 cards ((16, 16) is 32 hosts), so
their collectives cross InfiniBand; NVLink's 450 GB/s each way holds
only among the 8 cards of one host.

Sources: the dry run's op analysis (:mod:`repro_torch.launch.dryrun`,
:mod:`repro_torch.launch.op_analysis`) for FLOPs, HBM bytes and collective
bytes.  The reference scales XLA's ``bytes accessed`` by its trip-count
correction ratio (corrected over raw FLOPs); the port's ``cost_analysis``
holds the op analysis's own counts, with nothing left to correct, so that
ratio is 1 and the formula is kept as it is.

MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (inference), D = tokens
processed per step; the ratio MODEL_FLOPS / counted FLOPs flags remat and
redundancy waste.  A cell fits when its per-device argument, temporary and
output bytes less the aliased ones stay under the card's 80 GB.

Usage: ``python -m repro_torch.launch.roofline [--tag TAG]``: prints the
markdown table and writes ``experiments/roofline_torch<tag>.md``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_BYTES", "RESULTS_DIR",
           "load_cells", "roofline_row", "fits", "markdown_table", "main"]

PEAK_FLOPS = 989e12       # dense bf16 FLOP/s a card (H100 SXM)
HBM_BW = 3.35e12          # B/s a card (HBM3)
LINK_BW = 50e9            # B/s a link (InfiniBand NDR, 400 Gb/s)
HBM_BYTES = 80e9          # the card's memory

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

_SUGGEST = {
    ("compute", "train"): "raise arithmetic intensity: fewer remat recomputes"
        " / larger per-device batch; compute term is the roofline itself once"
        " MODEL/HLO ratio ~1",
    ("compute", "prefill"): "prefill is compute-bound by design; reduce"
        " non-model FLOPs (attention masking waste, dispatch overhead)",
    ("compute", "decode"): "decode compute is tiny; batch more requests",
    ("memory", "train"): "cut activation traffic: fuse CE, fewer f32"
        " casts, tighter remat policy",
    ("memory", "prefill"): "stream KV to the cache layout directly;"
        " bf16 end-to-end",
    ("memory", "decode"): "decode is weight/KV-bound: quantize KV (paper C6),"
        " shard KV wider, batch more",
    ("collective", "train"): "compress the DP gradient reduction with coreset"
        " codecs (paper C1-C3), overlap FSDP gathers with compute",
    ("collective", "prefill"): "re-shard to cut resharding collectives;"
        " sequence-parallel attention",
    ("collective", "decode"): "split-KV softmax reductions dominate: shard KV"
        " on heads where divisible, batch on data axis",
}


def load_cells(tag: str = "") -> list[dict]:
    suffix = f"__{tag}.json" if tag else ".json"
    cells = []
    for path in sorted(glob.glob(os.path.join(RESULTS_DIR, f"*{suffix}"))):
        base = os.path.basename(path)[:-len(".json")]
        parts = base.split("__")
        if tag:
            if len(parts) != 4 or parts[3] != tag:
                continue
        elif len(parts) != 3:
            continue
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def roofline_row(cell: dict) -> dict | None:
    if cell.get("status") != "ok":
        return None
    ops = cell.get("op_analysis", {})
    raw = cell.get("cost_analysis", {})
    flops = ops.get("flops", 0.0)
    raw_flops = raw.get("flops", 0.0)
    ratio = (flops / raw_flops) if raw_flops else 1.0
    hbm_bytes = raw.get("bytes_accessed", 0.0) * ratio
    coll_bytes = ops.get("total_collective_bytes", 0.0)

    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = coll_bytes / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)

    kind = cell["cell"]["kind"]
    n_active = cell.get("active_params", 0)
    b = cell["cell"]["global_batch"]
    s = cell["cell"]["seq_len"]
    tokens = b * s if kind != "decode" else b
    n_dev = cell.get("n_devices", 1)
    mult = 6 if kind == "train" else 2
    model_flops_dev = mult * n_active * tokens / n_dev
    useful = model_flops_dev / flops if flops else 0.0

    # roofline fraction: useful model FLOP/s achievable if the step runs at
    # the bound of its dominant term
    step_time = max(terms.values())
    frac = (model_flops_dev / step_time) / PEAK_FLOPS if step_time > 0 else 0.0

    ma = cell.get("memory_analysis", {})
    fit_gib = (ma.get("argument_bytes", 0) + ma.get("temp_bytes", 0)
               + ma.get("output_bytes", 0) - ma.get("alias_bytes", 0)) / 2**30

    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "t_compute": t_compute, "t_memory": t_memory, "t_collective": t_coll,
        "dominant": dominant, "model_flops_dev": model_flops_dev,
        "hlo_flops_dev": flops, "useful_ratio": useful,
        "roofline_frac": frac, "fit_gib": fit_gib,
        "suggest": _SUGGEST.get((dominant, kind), ""),
        "kind": kind,
    }


def fits(row: dict) -> bool:
    """Does the row's per-device footprint fit the card's memory?"""
    return row["fit_gib"] * 2**30 < HBM_BYTES


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
           "| dominant | MODEL/HLO | roofline frac | fit GiB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute']*1e3:.2f} | {r['t_memory']*1e3:.2f} "
            f"| {r['t_collective']*1e3:.2f} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_frac']*100:.1f}% "
            f"| {r['fit_gib']:.1f} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    cells = load_cells(args.tag)
    rows = [r for c in cells if (r := roofline_row(c)) is not None]
    if args.mesh != "both":
        rows = [r for r in rows if r["mesh"] == args.mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    table = markdown_table(rows)
    print(table)
    skipped = [c for c in cells if c.get("status") == "skipped"]
    errors = [c for c in cells if c.get("status") == "error"]
    over = [r for r in rows if not fits(r)]
    print(f"\n{len(rows)} cells, {len(skipped)} skipped, {len(errors)} errors, "
          f"{len(over)} over {HBM_BYTES / 1e9:.0f} GB a card")
    for r in over:
        print(f"  OVER {r['arch']} {r['shape']} {r['mesh']}: "
              f"{r['fit_gib']:.1f} GiB")
    for c in errors:
        print(f"  ERROR {c['arch']} {c['shape']} {c['mesh']}: {c.get('error')}")
    os.makedirs(os.path.join(RESULTS_DIR, ".."), exist_ok=True)
    out_path = os.path.join(
        RESULTS_DIR, "..",
        f"roofline_torch{'_' + args.tag if args.tag else ''}.md")
    with open(out_path, "w") as f:
        f.write(table)
    print("wrote", os.path.normpath(out_path))


if __name__ == "__main__":
    main()
