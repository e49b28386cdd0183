"""One rank of the gloo CPU run of ``tests/test_torch_compression.py``.

Run as ``python tests/_torch_train_worker.py RANK WORLD STORE BUNDLE OUT``:
the rank joins a ``WORLD``-rank gloo group through the ``FileStore`` at
``STORE``, reads the per-rank gradients and residuals and the batches from
``BUNDLE`` (``.npz``) and the initial train state from the ``.pkl`` beside
it (numpy leaves the test wrote), runs ``coreset_allreduce`` on its rank's
rows with both codecs and two compressed train steps on the global
batches, and writes what it got to ``OUT`` (``torch.save``), each state
leaf named by its key path as ``jax.tree_util.keystr`` names it.  It
imports neither JAX nor the JAX package.
"""
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.convert import train_state  # noqa: E402
from repro_torch.core.compression import (CompressionConfig,  # noqa: E402
                                          coreset_allreduce)
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train import TrainHyper, make_compressed_train_step  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


def keystr(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def main(argv) -> int:
    rank, world, store, bundle, out = (int(argv[0]), int(argv[1]), argv[2],
                                       argv[3], argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            world_size=world, rank=rank)
    data = dict(np.load(bundle))
    names = sorted(k for k in data if k.startswith("g_"))
    res = {"allreduce": {}, "metrics": []}
    for method in ("topk", "topk_block"):
        cfg = CompressionConfig(method=method, block=1024)
        g = {k: torch.as_tensor(data[k][rank]) for k in names}
        e = {k: torch.as_tensor(data["e" + k[1:]][rank]) for k in names}
        mean, ef = coreset_allreduce(g, dist.group.WORLD, cfg, e)
        for k in names:
            res["allreduce"][f"{method}/mean/{k}"] = mean[k]
            res["allreduce"][f"{method}/ef/{k}"] = ef[k]
    mcfg = ModelConfig(name="t", vocab=64, d_model=32, n_layers=2, n_heads=4,
                       n_kv=2, d_ff=64, dtype=torch.float32)
    hyper = TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10)
    step = make_compressed_train_step(
        mcfg, hyper, CompressionConfig(topk_ratio=1 / 16, min_size=1024),
        dist.group.WORLD)
    with open(bundle[:-len(".npz")] + ".pkl", "rb") as f:
        state = train_state(pickle.load(f))
    for i in range(2):
        state, met = step(state, {"tokens": torch.as_tensor(
            data[f"tokens{i}"])})
        res["metrics"].append({k: v.clone() for k, v in met.items()})
    res["state"] = {keystr(p): v for p, v in leaves_with_paths(state)}
    torch.save(res, out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
