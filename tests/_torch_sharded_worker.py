"""One rank of the gloo CPU run of ``tests/test_torch_sharded.py``.

Run as ``python tests/_torch_sharded_worker.py RANK WORLD STORE BUNDLE
OUT``: the rank joins a ``WORLD``-rank gloo group through the ``FileStore``
at ``STORE``, loads the inputs the test wrote to ``BUNDLE`` (``torch.save``
of tensors and named tuples), drives every sharded entry point of the port
on an (8,) ("data",) and a (2, 4) ("pod", "data") mesh (the noise from a
generator, pre-drawn, or from per-node keys), and writes what it
got to ``OUT`` (``torch.save``).  It imports neither JAX nor the JAX
package; the inputs that only the parameters of a scenario decide are built
here by :func:`lane_inputs` and :func:`task_inputs`, which the test calls
too for its single-device runs.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import repro_torch  # noqa: E402
from repro_torch import host as thost  # noqa: E402
from repro_torch.configs.seeker_har import HAR  # noqa: E402
from repro_torch.core.decision import IntermittentConfig  # noqa: E402
from repro_torch.core.energy import (BrownoutConfig,  # noqa: E402
                                     fleet_alive_traces,
                                     fleet_harvest_traces)
from repro_torch.core.recovery import init_generator  # noqa: E402
from repro_torch.data.sensors import (bearing_stream,  # noqa: E402
                                      class_signatures, har_stream)
from repro_torch.models.har import har_aux_init, har_init  # noqa: E402
from repro_torch.obs import counter, metrics_psum, spec_union  # noqa: E402

S, BLOCK = 6, 4
N_LANES = 13            # the churn / brown-out / intermittent fleet
N_TASKS = 13            # the mixed HAR and bearing fleet
CHUNK = 4               # the streamed driver's segments
LANE_SEED, TASK_SEED, NOISE_SEED, KEY_SEED = 11, 12, 13, 14
# the bare fleet's layouts: (N, mesh, node_block); with node_block 1 every
# block has one node on one rank or eight, so even the logits are bitwise
BARE = {"n3": (3, "data", BLOCK), "n8": (8, "data", BLOCK),
        "n13": (13, "data", BLOCK), "n13_pod": (13, "pod", BLOCK),
        "n13_block1": (13, "data", 1)}


def lane_inputs() -> dict:
    """The scarce-harvest fleet: per-node HAR streams and labels, churn,
    brown-out at 6/30 µJ from 12 µJ and the intermittent lane, telemetry
    on; engine keyword arguments (every rank and the test build the same
    ones from the seed)."""
    g = torch.Generator().manual_seed(LANE_SEED)
    params = har_init(g, HAR)
    windows, labels = har_stream(g, S, streams=N_LANES)       # (N, S, T, C)
    scarcity = torch.linspace(0.04, 0.5, N_LANES)[:, None]
    return dict(
        windows=windows, harvest=fleet_harvest_traces(g, N_LANES, S)
        * scarcity,
        signatures=class_signatures(), qdnn_params=params,
        host_params=params,
        gen_params=init_generator(g, HAR.window, HAR.channels), har_cfg=HAR,
        aux_params=har_aux_init(g, HAR), labels=labels.T.contiguous(),
        alive=fleet_alive_traces(g, N_LANES, S, duty=0.75, period=4,
                                 p_glitch=0.1),
        brownout=BrownoutConfig(6.0, 30.0), initial_uj=12.0,
        intermittent=IntermittentConfig(1, 0.0), telemetry=True,
        node_block=BLOCK, device="cpu")


def keyed_inputs() -> dict:
    """The scarce-harvest fleet drawing its noise from per-node keys, in
    node blocks of one, so that even the logits compare bitwise."""
    return dict(lane_inputs(), node_block=1,
                node_keys=repro_torch.fleet_node_keys(KEY_SEED, N_LANES,
                                                      "cpu"))


def task_inputs() -> dict:
    """The mixed fleet: HAR wearables (even nodes) and bearing monitors
    resampled to the HAR grid (odd nodes), a host weight tree per task,
    labels and telemetry."""
    g = torch.Generator().manual_seed(TASK_SEED)
    params = har_init(g, HAR)
    hosts = (har_init(g, HAR), har_init(g, HAR))
    task = repro_torch.TaskLaneConfig(per_task_host=True)
    bearing = torch.arange(N_TASKS) % 2 == 1
    n_b = int(bearing.sum())
    har_w, har_l = har_stream(g, S, streams=N_TASKS - n_b)
    brg_w, brg_l = bearing_stream(g, S, t=HAR.window, streams=n_b)
    windows = torch.empty((N_TASKS, S, HAR.window, HAR.channels))
    windows[~bearing] = har_w
    windows[bearing] = brg_w.expand(-1, -1, -1, HAR.channels)
    labels = torch.empty((S, N_TASKS), dtype=torch.int64)
    labels[:, ~bearing] = har_l.T
    labels[:, bearing] = brg_l.T
    return dict(
        windows=windows, harvest=fleet_harvest_traces(g, N_TASKS, S),
        signatures=class_signatures(), qdnn_params=params,
        host_params=hosts,
        gen_params=init_generator(g, HAR.window, HAR.channels), har_cfg=HAR,
        labels=labels, task=task, telemetry=True, node_block=BLOCK,
        device="cpu")


def serve_cfg(telemetry: bool = True):
    """The serve steps' host server: batch 4, queue and cache 16."""
    return thost.HostServeConfig(
        channels=HAR.channels, k=12, m=20, t=HAR.window,
        n_classes=HAR.n_classes, n_nodes=13, batch_size=4,
        queue_capacity=16, cache_capacity=16, qos_slots=4,
        telemetry=telemetry)


def noise_gen() -> torch.Generator:
    return torch.Generator().manual_seed(NOISE_SEED)


def _cpu(x):
    """A result with its tensors (and named tuples and dicts of them) kept,
    everything else dropped."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cpu(v) for v in x))
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()
                if isinstance(v, (torch.Tensor, dict, tuple, int))}
    return x


def run_rank(bundle: dict, meshes: dict) -> dict:
    """Every scenario once, in the same order on every rank."""
    b = bundle
    out = {"bare": {}}
    kw = dict(signatures=b["signatures"], qdnn_params=b["params"],
              host_params=b["params"], gen_params=b["gen"], har_cfg=HAR,
              node_block=BLOCK, device="cpu")
    for name, (n, mesh, block) in BARE.items():
        out["bare"][name] = _cpu(repro_torch.seeker_fleet_simulate_sharded(
            b["wins"], b["harvest"][n], labels=b["labels"],
            noise=b["noise"][n], mesh=meshes[mesh],
            **dict(kw, node_block=block)))

    lanes = lane_inputs()
    w, h = lanes.pop("windows"), lanes.pop("harvest")
    out["lanes"] = _cpu(repro_torch.seeker_fleet_simulate_sharded(
        w, h, mesh=meshes["data"], generator=noise_gen(), **lanes))
    out["streamed"] = _cpu(repro_torch.seeker_fleet_simulate_streamed(
        w, h, chunk=CHUNK, mesh=meshes["data"], generator=noise_gen(),
        **lanes))
    keyed = keyed_inputs()
    w, h = keyed.pop("windows"), keyed.pop("harvest")
    out["keyed"] = _cpu(repro_torch.seeker_fleet_simulate_sharded(
        w, h, mesh=meshes["pod"], **keyed))
    out["keyed_streamed"] = _cpu(repro_torch.seeker_fleet_simulate_streamed(
        w, h, chunk=CHUNK, mesh=meshes["data"], **keyed))
    tasks = task_inputs()
    w, h = tasks.pop("windows"), tasks.pop("harvest")
    out["tasks"] = _cpu(repro_torch.seeker_fleet_simulate_sharded(
        w, h, mesh=meshes["pod"], generator=noise_gen(), **tasks))

    sw, alive = b["serve_wins"], b["serve_alive"]
    skw = dict(host_params=b["params"], har_cfg=HAR, device="cpu")
    qkw = dict(serve_cfg=serve_cfg(), gen_params=b["gen"], alive=alive,
               **skw)
    out["direct"] = _cpu(repro_torch.fleet_serve_step(
        sw, mesh=meshes["data"], noise=b["direct_noise"], **skw))
    state, rounds = thost.host_server_init(serve_cfg(), "cpu"), []
    for _ in range(2):
        r = repro_torch.fleet_serve_step(sw, mesh=meshes["data"],
                                         host_state=state, **qkw)
        state = r["host_state"]
        rounds.append(_cpu(r))
    out["queue"] = rounds
    state, rounds = thost.host_server_init_stacked(serve_cfg(), 8, "cpu"), []
    for _ in range(2):
        r = repro_torch.fleet_serve_step(sw, mesh=meshes["data"],
                                         per_shard_host=True,
                                         host_state=state, **qkw)
        state = r["host_state"]
        rounds.append(_cpu(r))
    out["per_shard"] = rounds
    out["edge_host"] = _cpu(repro_torch.edge_host_serve_step(
        b["edge_wins"], signatures=b["signatures"], qdnn_params=b["params"],
        gen_params=b["gen"], mesh=meshes["pod"], noise=b["edge_noise"],
        **skw))

    # counter pairs near 2**16 on every rank: the psum must carry
    spec = spec_union((counter("a"), counter("b")))
    rank = torch.distributed.get_rank()
    out["psum"] = _cpu(metrics_psum(spec, {
        "a": torch.tensor([rank, 65535], dtype=torch.int32),
        "b": torch.tensor([0, 65000 + rank], dtype=torch.int32)},
        meshes["data"].get_group(0)))
    return out


def main(argv) -> int:
    rank, world, store, bundle, out = argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.sharding import make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        meshes = {"data": make_mesh((world,), ("data",), "cpu"),
                  "pod": make_mesh((2, world // 2), ("pod", "data"), "cpu")}
        result = run_rank(torch.load(bundle, weights_only=False), meshes)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
