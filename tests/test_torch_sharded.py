"""The port's sharded fleet driver on 8 gloo CPU ranks, against the port's
single-device engine and against the JAX package's sharded engine.

One spawn of 8 ranks (``tests/_torch_sharded_worker.py``, a ``FileStore``
under ``tmp_path``) runs every scenario once: the bare fleet at N = 3, 8
and 13 on an (8,) ("data",) mesh and at N = 13 on a (2, 4) ("pod",
"data") mesh; churn, brown-out, the intermittent lane and labels; the mixed
HAR and bearing task lane with telemetry; the streamed driver on the mesh;
``fleet_serve_step`` in its gather/direct, gather/queue and per-shard host
modes; ``edge_host_serve_step`` on the (2, 4) mesh; and the lanes' fleet
again with per-node keyed noise, sharded and streamed.  S = 6 slots,
``node_block`` 4 (1 for the keyed runs).

Against the port's single-device engine with the same noise: integer and
energy traces and every aggregate and telemetry lane exactly equal; the
logits bitwise where the node blocks have one shape (``node_block`` 1),
else within ``LOGIT_TOL_SHARDED``.  Against JAX's sharded engine (run with
8 virtual XLA devices as ``tests/test_fleet_sharded.py`` runs it, in three
subprocesses side by side: the bare fleet, the per-shard host, which JAX
runs op by op and so compiles for about a minute, and the pod-paired
step; JAX's draws are injected into the port): ``padded_nodes``, the
summed aggregates, the per-shard host's QoS counters and telemetry exactly
equal, and the pod-paired logits within ``LOGIT_TOL`` (the port's
convolutions sum in another order than XLA's).
"""
import contextlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.configs.seeker_har import HAR  # noqa: E402
from repro.core import fleet_harvest_traces  # noqa: E402
from repro.core.recovery import init_generator  # noqa: E402
from repro.data.sensors import class_signatures, har_stream  # noqa: E402
from repro.models.har import har_init  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import host as thost  # noqa: E402
from repro_torch.configs.seeker_har import HAR as THAR  # noqa: E402
from repro_torch.serving.edge_host import _edge_encode_coresets  # noqa: E402

import _torch_sharded_worker as worker  # noqa: E402
from test_torch_fleet import jax_fleet_noise  # noqa: E402
from test_torch_host import jax_split_noise  # noqa: E402

WORLD, S, BLOCK = 8, worker.S, worker.BLOCK
N_SERVE, N_EDGE = 13, 16
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL_SHARDED = dict(rtol=1e-5, atol=1e-5)
TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
# integer and energy traces held exactly equal
EXACT = ("decisions", "payload_bytes", "stored_uj", "k_trace", "alive",
         "brownout", "preds")
LANE_EXACT = EXACT + ("it_emit", "it_label", "it_src", "it_stage")
PADDED = {"n3": 5, "n8": 0, "n13": 3, "n13_pod": 3, "n13_block1": 3}
AXES = {"n13_pod": ("pod", "data")}
JAX_LAYOUTS = ("n3", "n13_pod")

_JAX_CODE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.seeker_har import HAR
from repro.core import fleet_harvest_traces
from repro.core.recovery import init_generator
from repro.data.sensors import class_signatures, har_stream
from repro.host import HostServeConfig, host_server_init_stacked
from repro.models.har import har_init
from repro.serving import (edge_host_serve_step, fleet_serve_step,
                           seeker_fleet_simulate_sharded, wire_bytes_exact)
from repro.sharding import make_mesh_compat

assert jax.device_count() == 8, jax.device_count()
part, path = sys.argv[1:3]
S, BLOCK = {S}, {BLOCK}
key = jax.random.PRNGKey(0)
params = har_init(key, HAR)
gen = init_generator(key, HAR.window, HAR.channels)
sigs = class_signatures()
meshes = {{"data": make_mesh_compat((8,), ("data",)),
          "pod": make_mesh_compat((2, 4), ("pod", "data"))}}
out = {{}}
if part == "bare":
    wins, labels = har_stream(key, S)
    for name, n, mesh in (("n3", 3, "data"), ("n13_pod", 13, "pod")):
        res = seeker_fleet_simulate_sharded(
            wins, fleet_harvest_traces(key, n, S), signatures=sigs,
            qdnn_params=params, host_params=params, gen_params=gen,
            har_cfg=HAR, mesh=meshes[mesh], key=key, labels=labels,
            node_block=BLOCK, donate=False)
        out[name + "/padded_nodes"] = res["padded_nodes"]
        out[name + "/bytes_on_wire_exact"] = wire_bytes_exact(res)
        for k in ("decision_histogram", "completed", "alive_slots",
                  "brownout_slots", "brownout_events", "correct"):
            out[name + "/" + k] = np.asarray(res[k])
elif part == "per_shard":
    cfg = HostServeConfig(channels=HAR.channels, k=12, m=20, t=HAR.window,
                          n_classes=HAR.n_classes, n_nodes={N_SERVE},
                          batch_size=4, queue_capacity=16,
                          cache_capacity=16, qos_slots=4, telemetry=True)
    res = fleet_serve_step(
        har_stream(jax.random.PRNGKey(2), {N_SERVE})[0], host_params=params,
        har_cfg=HAR, mesh=meshes["data"], key=key,
        host_state=host_server_init_stacked(cfg, 8), serve_cfg=cfg,
        gen_params=gen, alive=jnp.asarray(np.arange({N_SERVE}) % 4 != 1),
        per_shard_host=True)
    for k, v in res["qos"].items():
        out["per_shard/qos/" + k] = v
    for k, v in res["telemetry"].items():
        out["per_shard/telemetry/" + k] = np.asarray(v)
else:
    out["edge_host/logits"] = np.asarray(edge_host_serve_step(
        har_stream(jax.random.PRNGKey(3), {N_EDGE})[0], signatures=sigs,
        qdnn_params=params, host_params=params, gen_params=gen,
        har_cfg=HAR, mesh=meshes["pod"], key=key))
np.savez(path, **out)
"""
JAX_PARTS = ("bare", "per_shard", "edge")


def _spawn(args, env: dict, log: Path) -> subprocess.Popen:
    """A background process whose output goes to ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, *args],
                                env=dict(os.environ, **env), stdout=f,
                                stderr=subprocess.STDOUT)


def _bundle() -> dict:
    """The inputs JAX draws, in the port's types: the bare fleet's weights,
    shared stream, harvest and noise per N, and the serve steps' windows
    and recovery draws."""
    key = jax.random.PRNGKey(0)
    params = har_init(key, HAR)
    gen = init_generator(key, HAR.window, HAR.channels)
    wins, labels = har_stream(key, S)
    t, c = HAR.window, HAR.channels
    pad = (-N_SERVE) % WORLD
    # the reference's direct mode splits one key per padded row; its
    # pod-paired step splits one per row of a rank's tile, on every rank
    edge_tile = jax_split_noise(key, N_EDGE // WORLD, c, t)
    noise = jax_fleet_noise(key, 13, S, t, c)
    return dict(
        params=convert.har_params(params),
        gen=convert.generator_params(gen),
        signatures=convert.tensor(class_signatures()),
        wins=convert.tensor(wins), labels=convert.tensor(labels),
        harvest={n: convert.tensor(fleet_harvest_traces(key, n, S))
                 for n in (3, 8, 13)},
        # a node's draws come from its own key, so the smaller fleets take
        # the first rows of the largest's
        noise={n: {k: torch.from_numpy(v[:, :n]) for k, v in noise.items()}
               for n in (3, 8, 13)},
        serve_wins=convert.tensor(har_stream(jax.random.PRNGKey(2),
                                             N_SERVE)[0]),
        serve_alive=torch.arange(N_SERVE) % 4 != 1,
        direct_noise={k: v[:N_SERVE] for k, v in
                      jax_split_noise(key, N_SERVE + pad, c, t).items()},
        edge_wins=convert.tensor(har_stream(jax.random.PRNGKey(3),
                                            N_EDGE)[0]),
        edge_noise={k: v.repeat((WORLD,) + (1,) * (v.ndim - 1))
                    for k, v in edge_tile.items()})


@contextlib.contextmanager
def _one_thread():
    """One CPU thread, as each rank runs: the CPU kernels split their sums
    by thread count, so bitwise comparisons need the same count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _single_device(b: dict) -> dict:
    """The port's single-device engine and serve step on the ranks'
    inputs."""
    kw = dict(signatures=b["signatures"], qdnn_params=b["params"],
              host_params=b["params"], gen_params=b["gen"], har_cfg=THAR,
              device="cpu")
    out = {"bare": {}}
    for name, (n, _, block) in worker.BARE.items():
        out["bare"][name] = repro_torch.seeker_fleet_simulate(
            b["wins"], b["harvest"][n], labels=b["labels"],
            noise=b["noise"][n], node_block=block, **kw)
    lanes = worker.lane_inputs()
    out["lanes"] = repro_torch.seeker_fleet_simulate(
        lanes.pop("windows"), lanes.pop("harvest"),
        generator=worker.noise_gen(), **lanes)
    keyed = worker.keyed_inputs()
    out["keyed"] = repro_torch.seeker_fleet_simulate(
        keyed.pop("windows"), keyed.pop("harvest"), **keyed)
    tasks = worker.task_inputs()
    out["tasks"] = repro_torch.seeker_fleet_simulate(
        tasks.pop("windows"), tasks.pop("harvest"),
        generator=worker.noise_gen(), **tasks)
    sw, alive = b["serve_wins"], b["serve_alive"]
    skw = dict(host_params=b["params"], har_cfg=THAR, device="cpu")
    out["direct"] = repro_torch.fleet_serve_step(
        sw, noise=b["direct_noise"], **skw)
    state, rounds = thost.host_server_init(worker.serve_cfg(), "cpu"), []
    for _ in range(2):
        r = repro_torch.fleet_serve_step(
            sw, host_state=state, serve_cfg=worker.serve_cfg(),
            gen_params=b["gen"], alive=alive, **skw)
        state = r["host_state"]
        rounds.append(r)
    out["queue"] = rounds
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's subprocess and the 8 ranks run in the background while this
    process runs the single-device engine; every process is waited for
    (or killed) before the fixture returns."""
    tmp = tmp_path_factory.mktemp("sharded")
    code = textwrap.dedent(_JAX_CODE.format(S=S, BLOCK=BLOCK,
                                            N_SERVE=N_SERVE, N_EDGE=N_EDGE))
    logs = ([tmp / f"jax_{p}.log" for p in JAX_PARTS]
            + [tmp / f"rank{r}.log" for r in range(WORLD)])
    jax_env = dict(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [_spawn(["-c", code, p, str(tmp / f"jax_{p}.npz")], jax_env, log)
             for p, log in zip(JAX_PARTS, logs)]
    try:
        bundle = _bundle()
        torch.save(bundle, tmp / "bundle.pt")
        procs += [_spawn(
            [str(TESTS / "_torch_sharded_worker.py"), str(r), str(WORLD),
             str(tmp / "store"), str(tmp / "bundle.pt"),
             str(tmp / f"rank{r}.pt")],
            dict(PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
            logs[len(JAX_PARTS) + r]) for r in range(WORLD)]
        with _one_thread():
            single = _single_device(bundle)
        for p in procs:
            p.wait(timeout=300)
        failed = [log.read_text()[-3000:] for p, log in zip(procs, logs)
                  if p.returncode]
        assert not failed, "\n".join(failed)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    jax_res = {}
    for p in JAX_PARTS:
        with np.load(tmp / f"jax_{p}.npz") as z:
            jax_res.update(z)
    return dict(bundle=bundle, single=single, jax=jax_res,
                ranks=[torch.load(tmp / f"rank{r}.pt", weights_only=False)
                       for r in range(WORLD)])


def _equal(got, want, what):
    assert torch.equal(torch.as_tensor(got), torch.as_tensor(want)), what


# ---------------------------------------------------------------------------
# The bare fleet on four layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(worker.BARE))
def test_bare_padding_and_axes(runs, layout):
    res = runs["ranks"][0]["bare"][layout]
    assert res["padded_nodes"] == PADDED[layout]
    assert res["node_axes"] == AXES.get(layout, ("data",))
    if layout in JAX_LAYOUTS:
        want = int(runs["jax"][f"{layout}/padded_nodes"])
        assert res["padded_nodes"] == want


@pytest.mark.parametrize("layout", sorted(worker.BARE))
def test_bare_traces_equal_single_device(runs, layout):
    got = runs["ranks"][0]["bare"][layout]
    want = runs["single"]["bare"][layout]
    for k in EXACT:
        _equal(got[k], want[k], (layout, k))
    for f in ("stored_uj", "prev_label"):
        _equal(getattr(got["final_state"], f),
               getattr(want["final_state"], f), (layout, f))
    if worker.BARE[layout][2] == 1:
        _equal(got["logits"], want["logits"], (layout, "logits"))
    else:
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want["logits"].numpy(),
                                   **LOGIT_TOL_SHARDED)


@pytest.mark.parametrize("layout", sorted(worker.BARE))
def test_bare_aggregates_equal_single_device_and_jax(runs, layout):
    got = runs["ranks"][0]["bare"][layout]
    want = runs["single"]["bare"][layout]
    keys = ("bytes_on_wire_exact", "decision_histogram", "completed",
            "alive_slots", "brownout_slots", "brownout_events", "correct")
    for k in keys:
        _equal(got[k], want[k], (layout, k))
    np.testing.assert_allclose(float(got["bytes_on_wire"]),
                               float(want["bytes_on_wire"]), rtol=1e-6)
    if layout in JAX_LAYOUTS:
        for k in keys:
            np.testing.assert_array_equal(
                got[k].numpy(), runs["jax"][f"{layout}/{k}"],
                err_msg=f"{layout} {k} against JAX's sharded engine")


def test_every_rank_returns_the_whole_fleet(runs):
    first = runs["ranks"][0]
    for rank in runs["ranks"][1:]:
        for layout in worker.BARE:
            for k in EXACT + ("logits", "decision_histogram", "correct"):
                _equal(rank["bare"][layout][k], first["bare"][layout][k],
                       (layout, k))
        _equal(rank["edge_host"], first["edge_host"], "edge_host")
        _equal(rank["direct"]["host_logits"], first["direct"]["host_logits"],
               "direct")


# ---------------------------------------------------------------------------
# The lanes, the task lane and the streamed driver
# ---------------------------------------------------------------------------

def _assert_run_equal(got, want, exact, what):
    for k in exact:
        _equal(got[k], want[k], (what, k))
    for k in want:
        if k in got and isinstance(want[k], torch.Tensor) and (
                want[k].ndim <= 1 and not want[k].is_floating_point()):
            _equal(got[k], want[k], (what, k))
    for name, lane in want["telemetry"].items():
        _equal(got["telemetry"][name], lane, (what, name))
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(),
                               **LOGIT_TOL_SHARDED)


def test_lanes_sharded_equals_single_device(runs):
    got, want = runs["ranks"][0]["lanes"], runs["single"]["lanes"]
    hist = want["decision_histogram"]
    # the run holds what the lanes do: dead slots, brown-outs, D6, D7, D8
    assert int((~got["alive"]).sum()) > 0 and int(want["brownout_slots"]) > 0
    assert all(int(hist[code]) > 0 for code in (6, 7, 8)), hist
    assert got["padded_nodes"] == 3
    _assert_run_equal(got, want, LANE_EXACT, "lanes")
    lane, want_lane = got["final_intermittent"], want["final_intermittent"]
    for f in ("active", "stage", "src_slot"):
        _equal(getattr(lane, f), getattr(want_lane, f), f)
    # the suspended activations are floats of node blocks of other shapes
    np.testing.assert_allclose(lane.acts.numpy(), want_lane.acts.numpy(),
                               **LOGIT_TOL_SHARDED)
    _equal(got["final_brownout"], want["final_brownout"], "final_brownout")


def test_task_lane_sharded_equals_single_device(runs):
    got, want = runs["ranks"][0]["tasks"], runs["single"]["tasks"]
    assert got["node_axes"] == ("pod", "data") and got["padded_nodes"] == 3
    assert bool((want["completed_by_task"] > 0).all())
    _assert_run_equal(got, want, EXACT, "tasks")
    for k in ("completed_by_task", "deadline_miss_by_task",
              "correct_by_task"):
        _equal(got[k], want[k], k)


def test_streamed_on_the_mesh_is_one_long_run(runs):
    got, want = runs["ranks"][0]["streamed"], runs["single"]["lanes"]
    assert got["n_chunks"] == 2 and got["padded_nodes"] == 3
    _assert_run_equal(got, want, LANE_EXACT, "streamed")
    _equal(got["final_state"].stored_uj, want["final_state"].stored_uj,
           "final stored")


@pytest.mark.parametrize("run", ["keyed", "keyed_streamed"])
def test_keyed_sharded_equals_single_device(runs, run):
    """Per-node keyed noise: each rank hashes only its tile's keys, so the
    sharded run (and the streamed one, its segments chained through
    ``final_keys``) is bitwise the single-device keyed run, the logits
    included (node blocks of one), the final keys too."""
    got, want = runs["ranks"][0][run], runs["single"]["keyed"]
    assert int((~got["alive"]).sum()) > 0 and int(want["brownout_slots"]) > 0
    assert got["padded_nodes"] == 3
    _assert_run_equal(got, want, LANE_EXACT + ("logits", "final_keys"), run)
    _equal(got["final_state"].stored_uj, want["final_state"].stored_uj,
           "final stored")


# ---------------------------------------------------------------------------
# The serve steps
# ---------------------------------------------------------------------------

def test_serve_direct_mode_equals_single_device(runs):
    """The gathered payloads recover, with the draws JAX's direct mode
    makes, into the single-device serve step's logits bit for bit (that
    one is held against JAX in tests/test_torch_host.py)."""
    got = runs["ranks"][0]["direct"]
    want = runs["single"]["direct"]
    assert got["wire_bytes"] == want["wire_bytes"]
    _equal(got["host_logits"], want["host_logits"], "direct logits")


@pytest.mark.parametrize("round_", [0, 1])
def test_serve_queue_mode_equals_single_device(runs, round_):
    got = runs["ranks"][0]["queue"][round_]
    want = runs["single"]["queue"][round_]
    assert got["wire_bytes"] == want["wire_bytes"]
    want_stats = thost.host_server_stats(want["host_state"])
    assert thost.host_server_stats(got["host_state"]) == want_stats
    for a, b in zip(got["slot_output"], want["slot_output"]):
        _equal(a, b, "slot_output")
    if round_:
        assert want_stats["cache_hits"] > 0


def test_per_shard_host_equals_jax(runs):
    """The summed QoS counters and telemetry lanes of one serve round, on
    every rank, against JAX's per-shard host."""
    jax_res = runs["jax"]
    for rank in runs["ranks"]:
        got = rank["per_shard"][0]
        assert sorted(got["qos"]) == sorted(
            k.split("/")[-1] for k in jax_res if k.startswith("per_shard/qos"))
        for k, v in got["qos"].items():
            assert v == int(jax_res[f"per_shard/qos/{k}"]), k
        for name, lane in got["telemetry"].items():
            np.testing.assert_array_equal(
                lane.numpy(), jax_res[f"per_shard/telemetry/{name}"],
                err_msg=name)


def test_per_shard_host_serves_each_tile_on_its_own(runs):
    """Each rank's server is the single-device server of its own tile:
    the rows it served, their logits, and its row of the stacked state."""
    b = runs["bundle"]
    cfg = worker.serve_cfg()
    size = (N_SERVE + (-N_SERVE) % WORLD) // WORLD
    served = 0
    for r, rank in enumerate(runs["ranks"]):
        lo, hi = r * size, (r + 1) * size
        wins = torch.zeros((hi - lo, THAR.window, THAR.channels))
        real = b["serve_wins"][lo:min(hi, N_SERVE)]
        wins[:real.shape[0]] = real
        mask = torch.zeros(hi - lo, dtype=torch.bool)
        mask[:real.shape[0]] = b["serve_alive"][lo:min(hi, N_SERVE)]
        state = thost.host_server_init(cfg, "cpu")
        with _one_thread():
            entries = thost.cluster_entries(_edge_encode_coresets(wins, 12),
                                            cfg.m)
            for round_ in range(2):
                state, out = thost.host_serve_slot(
                    state, entries, torch.arange(lo, hi), mask, cfg=cfg,
                    host_params=b["params"], gen_params=b["gen"])
                got = rank["per_shard"][round_]
                for a, w in zip(got["slot_output"], out):
                    _equal(a, w, (r, round_, "slot_output"))
                row = got["host_state"]         # this rank's row advanced
                _equal(row.served[r], state.served, (r, "served"))
                _equal(row.cache.hits[r], state.cache.hits, (r, "hits"))
        served += int(state.served)
    assert served == runs["ranks"][0]["per_shard"][1]["qos"]["served"]


def test_edge_host_serve_step_pairs_pods(runs):
    """Rank (pod, data) recovers the windows of rank (pod - 1, data): the
    single-device direct mode on the windows rolled by one pod's rows, and
    JAX's pod-paired step."""
    b = runs["bundle"]
    got = runs["ranks"][0]["edge_host"]
    roll = N_EDGE // 2                      # one pod's rows of the batch
    want = repro_torch.fleet_serve_step(
        b["edge_wins"].roll(roll, 0), host_params=b["params"], har_cfg=THAR,
        noise={k: v.roll(roll, 0) for k, v in b["edge_noise"].items()},
        device="cpu")["host_logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               **LOGIT_TOL_SHARDED)
    np.testing.assert_allclose(got.numpy(), runs["jax"]["edge_host/logits"],
                               **LOGIT_TOL)


def test_metrics_psum_carries_across_ranks(runs):
    """Counter pairs near 2**16 on every rank: the summed pairs carry their
    low digits into the high one and stay canonical."""
    hi_a = sum(range(WORLD))
    total_a = (hi_a << 16) + WORLD * 65535
    total_b = sum(65000 + r for r in range(WORLD))
    for rank in runs["ranks"]:
        a, b = rank["psum"]["a"].tolist(), rank["psum"]["b"].tolist()
        assert (a[0] << 16) + a[1] == total_a and 0 <= a[1] < 1 << 16
        assert (b[0] << 16) + b[1] == total_b and 0 <= b[1] < 1 << 16
