"""The port's fleet sharding (``repro_torch.sharding`` and
``repro_torch.obs.metrics_psum``) on the CPU, in this process.

The rule table and the tile arithmetic against ``repro.sharding`` on the
(8,) ("data",) and (2, 4) ("pod", "data") layouts; the meshes the port
refuses, with the reference's words where it has them; the counters'
carry after a sum; and a world of one gloo rank (the layout of one card),
where every sharded entry point must give exactly what its single-device
twin gives.  The 8-rank runs are tests/test_torch_sharded.py's.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once
import torch.distributed as dist  # noqa: E402

from repro.configs.seeker_har import HAR  # noqa: E402
from repro.obs import registry as jregistry  # noqa: E402
from repro.serving import (  # noqa: E402
    fleet_serve_step as jax_fleet_serve_step,
    seeker_fleet_simulate_sharded as jax_sharded)
from repro.sharding import make_mesh_compat  # noqa: E402
from repro.sharding import node_mesh_axes as jax_node_mesh_axes  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import host as thost  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.obs import (counter, gauge, histogram,  # noqa: E402
                             metrics_psum, spec_union, trace)
from repro_torch.serving.fleet import draw_fleet_noise  # noqa: E402

import _torch_sharded_worker as worker  # noqa: E402

LAYOUTS = {
    "data8": ((8,), ("data",)),
    "pod2_data4": ((2, 4), ("pod", "data")),
    "pod4": ((4,), ("pod",)),
    "model2": ((2,), ("model",)),
    "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
}


def _meshes(layout):
    """Stand-ins with what each package's ``node_mesh_axes`` reads: the
    port's ``mesh_dim_names`` and ``shape`` tuple, the reference's
    ``shape`` dict."""
    shape, names = LAYOUTS[layout]
    return (SimpleNamespace(mesh_dim_names=names, shape=shape),
            SimpleNamespace(shape=dict(zip(names, shape))))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_node_mesh_axes_matches_jax(layout):
    port, ref = _meshes(layout)
    assert sharding.node_mesh_axes(port) == jax_node_mesh_axes(ref)
    assert sharding.FLEET_RULES["nodes"] == ("pod", "data")


@pytest.mark.parametrize("n,pad", [(3, 5), (8, 0), (13, 3), (3000, 0),
                                   (3001, 7)])
@pytest.mark.parametrize("layout", ["data8", "pod2_data4"])
def test_tiles_partition_the_padded_fleet(layout, n, pad):
    port, _ = _meshes(layout)
    axes, quantum = sharding.node_mesh_axes(port)
    sizes = dict(zip(port.mesh_dim_names, port.shape))
    bounds = [sharding.tile_bounds(n, quantum, i) for i in range(quantum)]
    assert {b[0] for b in bounds} == {pad}
    rows = [r for _, lo, hi in bounds for r in range(lo, hi)]
    assert rows == list(range(n + pad))
    # the tile index reads the coordinates pod-major, as JAX lays out
    # P(("pod", "data")): the flat position on the node axes' grid
    grid = np.arange(quantum).reshape(tuple(sizes[a] for a in axes))
    for coord in np.ndindex(grid.shape):
        assert sharding.tile_index(dict(zip(axes, coord)), sizes,
                                   axes) == grid[coord]
    with pytest.raises(ValueError, match="outside"):
        sharding.tile_bounds(n, quantum, quantum)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.make_mesh((1,), ("data",), "cpu")


def test_metrics_psum_carries_like_jax():
    """Eight ranks' canonical pairs near 2**16, summed: the reference's psum
    over a vmapped axis of 8, against the port's on the sum (a world of
    one rank sums nothing, so the carry is what is compared)."""
    rng = np.random.default_rng(0)
    spec = spec_union((counter("c0"), counter("c1"), gauge("g"),
                       histogram("h", 4, log=False)))
    jspec = jregistry.spec_union((
        jregistry.counter("c0"), jregistry.counter("c1"),
        jregistry.gauge("g"), jregistry.histogram("h", 4, log=False)))
    ranks = {"c0": np.stack([rng.integers(0, 50, 8),
                             rng.integers(65000, 65536, 8)], -1),
             "c1": np.stack([np.zeros(8, int), np.full(8, 65535)], -1),
             "g": rng.integers(0, 1000, 8),
             "h": rng.integers(0, 100, (8, 4))}
    ranks = {k: v.astype(np.int32) for k, v in ranks.items()}
    want = jax.vmap(lambda m: jregistry.metrics_psum(jspec, m, "i"),
                    axis_name="i")({k: jnp.asarray(v)
                                    for k, v in ranks.items()})
    with _world_of_one():
        got = metrics_psum(spec, {
            k: torch.as_tensor(v.sum(0), dtype=torch.int32)
            for k, v in ranks.items()})
    for k in ranks:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k])[0],
                                      err_msg=k)
    assert int(got["c1"][1]) == (8 * 65535) % 65536


# ---------------------------------------------------------------------------
# A world of one rank: the layout of one card
# ---------------------------------------------------------------------------

class _world_of_one:
    """A gloo group of one rank in this process, through a ``FileStore``
    in a fresh temporary directory; destroyed on exit."""

    def __enter__(self):
        import tempfile
        self._dir = tempfile.TemporaryDirectory()
        dist.init_process_group(
            "gloo", store=dist.FileStore(f"{self._dir.name}/store", 1),
            rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()
        self._dir.cleanup()
        return False


@pytest.fixture
def world():
    with _world_of_one():
        yield


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("entry", ["fleet", "serve", "edge_host"])
def test_bad_meshes_are_refused(world, entry):
    """A mesh without the node axes raises the reference's words; a JAX
    mesh, and a mesh with another dim, are refused too."""
    wins = np.zeros((4, HAR.window, HAR.channels), np.float32)
    harvest = np.ones((4, 2), np.float32)
    d = worker.lane_inputs()
    kw = {k: d[k] for k in ("signatures", "qdnn_params", "host_params",
                            "gen_params", "har_cfg", "device")}
    jax_model = make_mesh_compat((1,), ("model",))
    if entry == "fleet":
        def call(m):
            return repro_torch.seeker_fleet_simulate_sharded(
                wins[:2], harvest, mesh=m, **kw)
        want = _message(lambda: jax_sharded(
            jnp.asarray(wins[:2]), jnp.asarray(harvest), signatures=None,
            qdnn_params=None, host_params=None, gen_params=None,
            har_cfg=HAR, mesh=jax_model))
    else:
        def call(m):
            if entry == "serve":
                return repro_torch.fleet_serve_step(
                    wins, host_params=kw["host_params"], har_cfg=HAR,
                    mesh=m, device="cpu")
            return repro_torch.edge_host_serve_step(wins, mesh=m, **kw)
        want = _message(lambda: jax_fleet_serve_step(
            jnp.asarray(wins), host_params=None, har_cfg=HAR,
            mesh=jax_model))
    assert want == "mesh ('model',) has none of the FLEET_RULES node axes"
    model = sharding.make_mesh((1,), ("model",), "cpu")
    assert _message(lambda: call(model)) == want
    assert _message(lambda: call(make_mesh_compat((1,), ("data",)))) == (
        "mesh must be a torch.distributed.device_mesh.DeviceMesh, got Mesh")
    extra = sharding.make_mesh((1, 1), ("data", "model"), "cpu")
    assert "are not FLEET_RULES node axes" in _message(lambda: call(extra))


@pytest.mark.parametrize("case", ["unstacked state", "tile over capacity"])
def test_per_shard_host_errors_match_jax(world, case):
    """The per-shard host refuses a state that is not stacked one row a
    rank, and a tile wider than the queue, in the reference's words."""
    from repro import host as jhost
    from repro.core.recovery import init_generator as jax_init_generator
    from repro.models.har import har_init as jax_har_init

    n = 4 if case == "unstacked state" else 20
    wins = np.zeros((n, HAR.window, HAR.channels), np.float32)
    kw = dict(channels=HAR.channels, k=12, m=20, t=HAR.window,
              n_classes=HAR.n_classes, n_nodes=n, batch_size=4,
              queue_capacity=16, cache_capacity=16)
    jcfg, tcfg = jhost.HostServeConfig(**kw), thost.HostServeConfig(**kw)
    if case == "unstacked state":
        jstate, tstate = (jhost.host_server_init(jcfg),
                          thost.host_server_init(tcfg, "cpu"))
    else:
        jstate, tstate = (jhost.host_server_init_stacked(jcfg, 1),
                          thost.host_server_init_stacked(tcfg, 1, "cpu"))
    key = jax.random.PRNGKey(0)
    want = _message(lambda: jax_fleet_serve_step(
        jnp.asarray(wins), host_params=jax_har_init(key, HAR), har_cfg=HAR,
        mesh=make_mesh_compat((1,), ("data",)), key=key, host_state=jstate,
        serve_cfg=jcfg, gen_params=jax_init_generator(key, HAR.window,
                                                      HAR.channels),
        per_shard_host=True))
    d = worker.lane_inputs()
    got = _message(lambda: repro_torch.fleet_serve_step(
        wins, host_params=d["host_params"], har_cfg=HAR,
        mesh=sharding.make_mesh((1,), ("data",), "cpu"), host_state=tstate,
        serve_cfg=tcfg, gen_params=d["gen_params"], per_shard_host=True,
        device="cpu"))
    assert got == want


def _assert_same(got, want, what=""):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want), what
    elif isinstance(want, tuple) and hasattr(want, "_fields"):
        for f in want._fields:
            _assert_same(getattr(got, f), getattr(want, f), f"{what}.{f}")
    elif isinstance(want, dict):
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k}]")


def _noise_source(name, s, n):
    """A fresh noise source of each kind, the same on every call."""
    if name == "generator":
        return {"generator": worker.noise_gen()}
    if name == "noise":
        return {"noise": draw_fleet_noise(worker.noise_gen(), s, n,
                                          HAR.window, HAR.channels)}
    return {"node_keys": repro_torch.fleet_node_keys(worker.KEY_SEED, n,
                                                     "cpu")}


@pytest.mark.parametrize("source", ["generator", "noise", "node_keys"])
def test_world_of_one_fleet_is_the_single_device_engine(world, source):
    """Every output of the sharded engine and of the streamed driver on the
    mesh, bit for bit the single-device engine's, with each noise source:
    one tile is the whole fleet, so even the node blocks are the same."""
    mesh = sharding.make_mesh((1,), ("data",), "cpu")
    d = worker.lane_inputs()
    w, h = d.pop("windows"), d.pop("harvest")
    n, s = h.shape
    want = repro_torch.seeker_fleet_simulate(
        w, h, **_noise_source(source, s, n), **d)
    got = repro_torch.seeker_fleet_simulate_sharded(
        w, h, mesh=mesh, **_noise_source(source, s, n), **d)
    assert got["padded_nodes"] == 0 and got["node_axes"] == ("data",)
    assert set(got) == set(want) | {"padded_nodes", "node_axes"}
    for k, v in want.items():
        _assert_same(got[k], v, k)
    streamed = repro_torch.seeker_fleet_simulate_streamed(
        w, h, chunk=worker.CHUNK, mesh=mesh, **_noise_source(source, s, n),
        **d)
    for k in ("decisions", "stored_uj", "logits", "it_emit", "correct",
              "telemetry", "final_state", "final_intermittent"):
        _assert_same(streamed[k], want[k], k)
    if source == "node_keys":
        _assert_same(streamed["final_keys"], want["final_keys"])


def test_world_of_one_sharded_spans(world):
    """The sharded engine opens the single-device engine's spans plus one
    ``fleet.tile`` inside ``fleet.prepare`` and one ``fleet.collect``
    inside ``fleet.aggregates``, which ``sharded.collect_ms_per_slot``
    reads; the single-device engine opens neither."""
    mesh = sharding.make_mesh((1,), ("data",), "cpu")
    d = worker.keyed_inputs()
    w, h = d.pop("windows"), d.pop("harvest")
    names = {}
    for entry, kw in ((repro_torch.seeker_fleet_simulate, {}),
                      (repro_torch.seeker_fleet_simulate_sharded,
                       {"mesh": mesh})):
        trace.clear()
        trace.enable()
        try:
            entry(w, h, **kw, **d)
        finally:
            trace.enable(False)
        evs = trace.events()
        by_id = {e["id"]: e for e in evs}
        names[entry] = [(e["name"], by_id[e["parent"]]["name"])
                        for e in evs if e["parent"] is not None]
    trace.clear()
    single = names[repro_torch.seeker_fleet_simulate]
    sharded = names[repro_torch.seeker_fleet_simulate_sharded]
    assert not {"fleet.tile", "fleet.collect"} & {a for a, _ in single}
    assert sorted(sharded) == sorted(single + [
        ("fleet.tile", "fleet.prepare"),
        ("fleet.collect", "fleet.aggregates")])


def test_world_of_one_serve_steps_are_the_single_device_ones(world):
    """The gather modes and the per-shard host on one rank are the
    single-device serve step (one server over every node); the pod-paired
    step on a (1, 1) mesh pairs each pod with itself, the direct mode."""
    d = worker.lane_inputs()
    wins = d["windows"][:, 0].contiguous()                    # (N, T, C)
    n = wins.shape[0]
    alive = torch.arange(n) % 5 != 2
    cfg = worker.serve_cfg()
    mesh = sharding.make_mesh((1,), ("data",), "cpu")
    kw = dict(host_params=d["host_params"], har_cfg=d["har_cfg"],
              device="cpu")
    qkw = dict(serve_cfg=cfg, gen_params=d["gen_params"], alive=alive, **kw)
    _assert_same(repro_torch.fleet_serve_step(
        wins, mesh=mesh, generator=worker.noise_gen(), **kw),
        repro_torch.fleet_serve_step(wins, generator=worker.noise_gen(),
                                     **kw))
    want = repro_torch.fleet_serve_step(
        wins, host_state=thost.host_server_init(cfg, "cpu"), **qkw)
    _assert_same(repro_torch.fleet_serve_step(
        wins, mesh=mesh, host_state=thost.host_server_init(cfg, "cpu"),
        **qkw), want)
    per_shard = repro_torch.fleet_serve_step(
        wins, mesh=mesh, per_shard_host=True,
        host_state=thost.host_server_init_stacked(cfg, 1, "cpu"), **qkw)
    _assert_same(per_shard["slot_output"], want["slot_output"])
    _assert_same(_row(per_shard["host_state"]), want["host_state"])
    stats = thost.host_server_stats(want["host_state"], cfg)
    assert per_shard["qos"] == {k: stats[k] for k in (
        "served", "deadline_misses", "drops_overflow")}
    _assert_same(per_shard["telemetry"], want["host_state"].metrics)
    pods = sharding.make_mesh((1, 1), ("pod", "data"), "cpu")
    _assert_same(repro_torch.edge_host_serve_step(
        wins, mesh=pods, generator=worker.noise_gen(),
        **{k: d[k] for k in ("signatures", "qdnn_params", "host_params",
                             "gen_params", "har_cfg", "device")}),
        repro_torch.fleet_serve_step(wins, generator=worker.noise_gen(),
                                     **kw)["host_logits"])


def _row(x):
    """Row 0 of a stacked state (tensors, named tuples, dicts, None)."""
    if x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_row(v) for v in x))
    if isinstance(x, dict):
        return {k: _row(v) for k, v in x.items()}
    return x[0]
