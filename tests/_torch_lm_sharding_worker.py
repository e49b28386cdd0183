"""One rank of the gloo CPU runs of ``tests/test_torch_lm_sharding.py``.

Run as ``python tests/_torch_lm_sharding_worker.py RANK WORLD STORE BUNDLE
OUT``: the rank joins a ``WORLD``-rank gloo group through the ``FileStore``
at ``STORE``, reads the initial states (numpy trees drawn by JAX), batches
and configs from ``BUNDLE`` (a pickle the test wrote), and writes what it
got to ``OUT`` (``torch.save``).  With four ranks it runs, on a (2, 2)
("data", "model") mesh: two FSDP steps of the tinyllama smoke config, two
DP+TP coreset-compressed steps (``dp_axes=("data",)``, the codec's top-k
indices recorded), one FSDP step of the deepseek smoke config (its experts
on "model") and of the recurrentgemma one (one KV head: its q heads split
within the group), one pure-DP step of the mamba2 smoke config, a restore of
JAX's checkpoint onto the mesh, the state drawn onto the mesh leaf by leaf
and saved from it, and a preempted and a clean sharded run of the
fault-tolerant loop, and decode steps of the tinyllama, recurrentgemma
(split-KV) and mamba2 smoke configs on a placed cache against the same
steps on plain tensors.  With one rank it runs the FSDP step (also with
microbatches) and the DP+TP step on a (1, 1) mesh beside the unsharded and
process-group steps.  It imports
neither JAX nor the JAX package.
"""
import dataclasses
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import sharding as shd  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import to_numpy, train_state  # noqa: E402
from repro_torch.core import compression as tc  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for  # noqa: E402
from repro_torch.train import (TrainHyper, TrainLoopConfig,  # noqa: E402
                               abstract_train_state, init_train_state,
                               make_compressed_train_step, make_train_step,
                               run_training, train_state_specs)
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

HYPER = TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10)


def cfg_of(name: str, overrides: dict):
    return dataclasses.replace(get_smoke(name), **overrides)


def keystr(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def flat(tree) -> dict:
    """A tree by key path, each leaf whole as numpy (a collective for
    DTensor leaves)."""
    return {keystr(p): to_numpy(v) for p, v in leaves_with_paths(tree)}


def local_layout(tree) -> dict:
    """Each DTensor leaf's local shape and global offset on this rank."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    out = {}
    for p, v in leaves_with_paths(tree):
        shape, offset = compute_local_shape_and_global_offset(
            v.shape, v.device_mesh, v.placements)
        assert tuple(v.to_local().shape) == tuple(shape)
        out[keystr(p)] = (tuple(shape), tuple(offset))
    return out


def placed(state_np, cfg, mesh, rules, compression=None):
    state = train_state(state_np)
    return shd.place(state, shd.tree_named_shardings(
        train_state_specs(cfg, compression), state, mesh, rules))


def steps(step, state, batches, rules, mesh):
    metrics = []
    with shd.use_sharding(mesh, rules):
        for b in batches:
            state, m = step(state, {"tokens": torch.as_tensor(b)})
            metrics.append({k: v.clone() for k, v in m.items()})
    return state, metrics


def record_topk(store: list):
    """Wrap the codec's top-k to record the indices of every call."""
    inner = tc.topk_compress

    def wrapped(flat_, k):
        vals, idx = inner(flat_, k)
        store.append(idx.clone())
        return vals, idx

    tc.topk_compress = wrapped
    return inner


def four_ranks(b: dict, res: dict):
    mesh = make_mesh_for((2, 2), ("data", "model"))
    fsdp, dptp = shd.FSDP_RULES, shd.DP_TP_RULES
    tl = cfg_of("tinyllama-1.1b", b["tiny_over"])
    state = placed(b["tiny"], tl, mesh, fsdp)
    res["fsdp_layout"] = local_layout(state)
    state, res["fsdp_metrics"] = steps(make_train_step(tl, HYPER), state,
                                       b["tiny_batches"], fsdp, mesh)
    res["fsdp_state"] = flat(state)

    comp = tc.CompressionConfig(topk_ratio=1 / 16, min_size=1024)
    state = placed(b["tiny_ef"], tl, mesh, dptp, comp)
    picked: list = []
    inner = record_topk(picked)
    step = make_compressed_train_step(tl, HYPER, comp, mesh,
                                      dp_axes=("data",))
    state, res["dptp_metrics"] = steps(step, state, b["tiny_batches"], dptp,
                                       mesh)
    tc.topk_compress = inner
    res["dptp_topk"] = picked
    res["dptp_state"] = flat(state)

    for name, rules in (("deepseek-moe-16b", fsdp),
                        ("recurrentgemma-2b", fsdp),
                        ("mamba2-130m", shd.PURE_DP_RULES)):
        cfg = cfg_of(name, {})
        state = placed(b[name], cfg, mesh, rules)
        state, m = steps(make_train_step(cfg, HYPER), state,
                         b[name + "/batch"], rules, mesh)
        res[name] = {"metrics": m, "state": flat(state)}

    template = train_state(b["tiny"])
    sh = shd.tree_named_shardings(train_state_specs(tl), template, mesh,
                                  fsdp)
    back = restore_checkpoint(b["ckpt"], 3, template, shardings=sh)
    res["restored"] = {keystr(p): v.to_local().clone()
                       for p, v in leaves_with_paths(back)}
    res["restored_layout"] = local_layout(back)

    cut = cfg_of("tinyllama-1.1b", b["loop_over"])
    hyper = TrainHyper(peak_lr=3e-3, warmup=2, total_steps=6)
    plain = init_train_state(torch.Generator().manual_seed(1), cut, hyper)
    sh = shd.tree_named_shardings(train_state_specs(cut),
                                  abstract_train_state(cut, hyper), mesh,
                                  fsdp)
    drawn = init_train_state(torch.Generator().manual_seed(1), cut, hyper,
                             shardings=sh)
    ckpt = f"{b['tmp']}/drawn"
    save_checkpoint(ckpt, 1, drawn)
    res["drawn"] = {
        keystr(p): (tuple(d.placements) == tuple(s_.placements)
                    and torch.equal(d.to_local(), s_.to_local()))
        for (p, d), s_ in zip(leaves_with_paths(drawn),
                              leaves(shd.place(plain, sh)))}
    res["saved"] = {keystr(p): torch.equal(a, w) for (p, a), w in zip(
        leaves_with_paths(restore_checkpoint(ckpt, 1, plain)),
        leaves(plain))}

    res["decode"] = {name: decode_on_mesh(b, name, mesh, rules)
                     for name, rules in (("tinyllama-1.1b", fsdp),
                                         ("recurrentgemma-2b", fsdp),
                                         ("mamba2-130m", shd.PURE_DP_RULES))}

    res["loop"] = {}
    for kind, preempt in (("clean", ()), ("preempted", (5,))):
        st = init_train_state(torch.Generator().manual_seed(1), cut, hyper,
                              shardings=sh)
        loop = TrainLoopConfig(total_steps=6, ckpt_dir=f"{b['tmp']}/{kind}",
                               ckpt_every=2, log_every=1, preempt_at=preempt)
        batches = b["loop_batches"]
        with shd.use_sharding(mesh, fsdp):
            st, log = run_training(
                st, make_train_step(cut, hyper),
                lambda s: {"tokens": torch.as_tensor(batches[s])}, loop)
        res["loop"][kind] = {"state": flat(st), "log": log}


def decode_on_mesh(b: dict, name: str, mesh, rules, new: int = 2) -> dict:
    """A prefill's cache placed by ``cache_specs`` (a split-KV cache where
    the KV heads do not divide "model"), then ``new`` decode steps on the
    mesh, against the same steps on plain tensors: the largest difference
    of the logits, and each step's logits on the mesh as numpy."""
    from repro_torch.models import (cache_specs, compute_params,
                                    decode_step, forward, param_specs)
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg_of(name, b["tiny_over"] if name == "tinyllama-1.1b" else {})
    params = compute_params(train_state(b["tiny" if name == "tinyllama-1.1b"
                                          else name])["params"], cfg)
    prompt = torch.as_tensor(b[name + "/prompt"])
    n, s = prompt.shape
    length = s + new

    def fresh_cache():
        return forward(params, cfg, prompt, return_cache=True,
                       cache_len=length)[1]

    plain_cache, plain = fresh_cache(), []
    tokens = torch.as_tensor(b[name + "/decode"])
    for t in range(new):
        logits, plain_cache = decode_step(params, cfg, plain_cache,
                                          tokens[:, t:t + 1])
        plain.append(logits)
    cache = fresh_cache()
    with shd.use_sharding(mesh, rules), implicit_replication():
        placed_params = shd.place(params, shd.tree_named_shardings(
            param_specs(cfg), params, mesh, rules))
        cache = shd.place(cache, shd.tree_named_shardings(
            cache_specs(cfg, n, length), cache, mesh, rules))
        got, err = [], 0.0
        for t in range(new):
            tok = shd.place(tokens[:, t:t + 1], shd.named_sharding(
                ("batch", None), (n, 1), mesh, rules))
            logits, cache = decode_step(placed_params, cfg, cache, tok)
            whole = logits.full_tensor()
            err = max(err, float((whole - plain[t]).abs().max()))
            got.append(whole.numpy())
    split = {keystr(p): [str(q) for q in v.placements]
             for p, v in leaves_with_paths(cache["runs"])}
    return {"err": err, "logits": got, "placements": split}


def one_rank(b: dict, res: dict):
    """The (1, 1) mesh's steps beside the unsharded ones, from one state:
    the FSDP step, with and without microbatches of 2, and the DP+TP
    compressed step."""
    mesh = make_mesh_for((1, 1), ("data", "model"))
    tl = cfg_of("tinyllama-1.1b", b["tiny_over"])
    for name, hyper in (("fsdp", HYPER),
                        ("fsdp_micro", dataclasses.replace(HYPER,
                                                           microbatch=2))):
        plain, plain_m = train_state(b["tiny"]), []
        step = make_train_step(tl, hyper)
        for batch in b["tiny_batches"]:
            plain, m = step(plain, {"tokens": torch.as_tensor(batch)})
            plain_m.append(m)
        state = placed(b["tiny"], tl, mesh, shd.FSDP_RULES)
        state, m = steps(step, state, b["tiny_batches"], shd.FSDP_RULES,
                         mesh)
        res[name] = {"plain": (flat(plain), plain_m),
                     "mesh": (flat(state), m)}

    comp = tc.CompressionConfig(topk_ratio=1 / 16, min_size=1024)
    plain, plain_m = train_state(b["tiny_ef"]), []
    step = make_compressed_train_step(tl, HYPER, comp, None)
    for batch in b["tiny_batches"]:
        plain, m = step(plain, {"tokens": torch.as_tensor(batch)})
        plain_m.append(m)
    state = placed(b["tiny_ef"], tl, mesh, shd.DP_TP_RULES, comp)
    state, m = steps(make_compressed_train_step(tl, HYPER, comp, mesh),
                     state, b["tiny_batches"], shd.DP_TP_RULES, mesh)
    res["dptp"] = {"plain": (flat(plain), plain_m),
                   "mesh": (flat(state), m)}


def main(argv) -> int:
    rank, world, store, bundle, out = (int(argv[0]), int(argv[1]), argv[2],
                                       argv[3], argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            world_size=world, rank=rank)
    with open(bundle, "rb") as f:
        b = pickle.load(f)
    res: dict = {}
    (four_ranks if world == 4 else one_rank)(b, res)
    torch.save(res, out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
