"""The port's slice as a whole: ``repro_torch.seeker_fleet_simulate`` against
``repro.serving.seeker_fleet_simulate`` at the real HAR widths, on the CPU
(the port's kernels run as their plain versions there).

Both packages get the same weights (converted through
``repro_torch.convert``), windows, harvest and labels, and the port gets
``noise=`` built from exactly the draws the JAX engine makes: the per-node
keys ``fold_in(key, i)`` (fleet.py:256), the 3-way split per slot
(fleet.py:301), the sensor key ``ks[:, 1]`` (D4's uniforms, coreset.py:230)
and the host key ``ks[:, 2]`` split as in edge_host.py:207 (cluster
recovery per channel, recovery.py:56-59,96; sampling latent,
recovery.py:167).  Integer traces and aggregates must be exactly equal.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.configs.seeker_har import HAR  # noqa: E402
from repro.core import fleet_harvest_traces, harvest_trace, make_aac_table  # noqa: E402
from repro.core.recovery import init_generator  # noqa: E402
from repro.data.sensors import class_signatures, har_stream  # noqa: E402
from repro.models.har import har_init  # noqa: E402
from repro.serving import (fleet_node_keys, seeker_fleet_simulate,  # noqa: E402
                           seeker_simulate, wire_bytes_exact)

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.seeker_har import HAR as THAR  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402

N, S = 4, 6
REPO = Path(__file__).resolve().parent.parent

# exact: integer traces and aggregates; stated tolerances for floats
STORED_TOL = dict(rtol=1e-6, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_fleet_noise(key, n, s, t, c, latent=16, alive=None):
    """(S, N, ...) numpy noise, drawn with the JAX engine's keys and split
    discipline, in the layout of ``repro_torch`` ``noise=``.  ``alive`` is
    the (S, N) alive lane the JAX engine emitted: a node's key stays frozen
    through the slots it did not run (fleet.py:458)."""
    keys = fleet_node_keys(key, n)

    def host_draws(k):
        k1, k2 = jax.random.split(k)

        def per_channel(kk):
            knorm, kdir = jax.random.split(kk)
            return (jax.random.normal(kdir, (t, 2), jnp.float32),
                    jax.random.uniform(knorm, (t, 1), jnp.float32))

        dirs, radii = jax.vmap(per_channel)(jax.random.split(k1, c))
        return dirs, radii, jax.random.normal(k2, (latent,), jnp.float32)

    @jax.jit
    def slot_draws(keys):
        ks = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
        u = jax.vmap(lambda k: jax.random.uniform(
            k, (t,), minval=1e-9, maxval=1.0))(ks[:, 1])
        return ks[:, 0], u, *jax.vmap(host_draws)(ks[:, 2])

    out = {k: [] for k in ("u", "dirs", "radii_u", "latent")}
    for si in range(s):
        nxt, u, d, r, lat = slot_draws(keys)
        out["u"].append(u)
        out["dirs"].append(d)
        out["radii_u"].append(r)
        out["latent"].append(lat)
        keys = nxt if alive is None else jnp.where(
            jnp.asarray(alive[si])[:, None], nxt, keys)
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    params = har_init(key, HAR)
    gen = init_generator(key, HAR.window, HAR.channels)
    sigs = class_signatures()
    wins, labels = har_stream(key, S)
    per_node = [har_stream(jax.random.fold_in(key, 100 + i), S)
                for i in range(N)]
    wn = jnp.stack([w for w, _ in per_node])                 # (N, S, T, C)
    ln = jnp.stack([lab for _, lab in per_node]).T           # (S, N)
    harvest = fleet_harvest_traces(key, N, S)
    rng = np.random.default_rng(0)
    aac = make_aac_table(rng.uniform(0.6, 0.9, (HAR.n_classes, 4)),
                         [4, 6, 8, 12])
    port = dict(signatures=convert.tensor(sigs),
                qdnn_params=convert.har_params(params),
                host_params=convert.har_params(params),
                gen_params=convert.generator_params(gen), har_cfg=THAR)
    return dict(key=key, params=params, gen=gen, sigs=sigs, wins=wins,
                labels=labels, wn=wn, ln=ln, harvest=harvest, aac=aac,
                port=port,
                noise=jax_fleet_noise(key, N, S, HAR.window, HAR.channels))


# shared stream at the defaults; per-node streams with an AAC table, a
# lower memo threshold and scarcer energy, so D0, D2, D3 and DEFER all occur
CASES = {
    "shared": lambda d: (d["wins"], d["labels"], d["harvest"], None, {}),
    "per_node_aac": lambda d: (d["wn"], d["ln"], d["harvest"] * 0.5, d["aac"],
                               dict(corr_threshold=0.9, initial_uj=20.0)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request, setup):
    d = setup
    wins, labels, harvest, aac, knobs = CASES[request.param](d)
    ref = seeker_fleet_simulate(
        wins, harvest, signatures=d["sigs"], qdnn_params=d["params"],
        host_params=d["params"], gen_params=d["gen"], har_cfg=HAR,
        aac_table=aac, key=d["key"], labels=labels, **knobs)
    res = repro_torch.seeker_fleet_simulate(
        np.asarray(wins), np.asarray(harvest), labels=np.asarray(labels),
        aac_table=None if aac is None else convert.aac_table(aac),
        noise=d["noise"], device="cpu", **knobs, **d["port"])
    return ref, res


@pytest.mark.parametrize("name", ["decisions", "payload_bytes", "k_trace",
                                  "decision_histogram", "completed",
                                  "alive_slots", "correct", "preds"])
def test_fleet_integer_outputs_equal_jax(both, name):
    ref, res = both
    np.testing.assert_array_equal(res[name].numpy(), np.asarray(ref[name]))


def test_fleet_wire_bytes_and_floats_match_jax(both):
    ref, res = both
    assert tfleet.wire_bytes_exact(res) == wire_bytes_exact(ref)
    np.testing.assert_allclose(res["stored_uj"].numpy(),
                               np.asarray(ref["stored_uj"]), **STORED_TOL)
    np.testing.assert_allclose(res["logits"].numpy(),
                               np.asarray(ref["logits"]), **LOGIT_TOL)
    np.testing.assert_allclose(float(res["completed_frac"]),
                               float(ref["completed_frac"]), rtol=1e-6)
    np.testing.assert_allclose(float(res["fleet_accuracy"]),
                               float(ref["fleet_accuracy"]), rtol=1e-6)
    # the slice must exercise more than one rung of the ladder
    assert int((np.asarray(ref["decision_histogram"]) > 0).sum()) >= 2


def test_seeker_simulate_n3_matches_jax(setup):
    d = setup
    harvest = harvest_trace(d["key"], S, "rf")
    ref = seeker_simulate(d["wins"], d["labels"], harvest,
                          signatures=d["sigs"], qdnn_params=d["params"],
                          host_params=d["params"], gen_params=d["gen"],
                          har_cfg=HAR)
    noise = jax_fleet_noise(jax.random.PRNGKey(0), 3, S, HAR.window,
                            HAR.channels)
    res = repro_torch.seeker_simulate(
        np.asarray(d["wins"]), np.asarray(d["labels"]), np.asarray(harvest),
        noise=noise, device="cpu", **d["port"])
    for name in ("decisions", "preds", "k_trace", "payload_bytes"):
        np.testing.assert_array_equal(res[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    np.testing.assert_allclose(res["stored_uj"].numpy(),
                               np.asarray(ref["stored_uj"]), **STORED_TOL)
    for name in ("completed_frac", "accuracy_completed", "accuracy_scheduled"):
        np.testing.assert_allclose(float(res[name]), float(ref[name]),
                                   rtol=1e-6, err_msg=name)


def test_node_blocks_and_resume_match_one_full_run(setup):
    """node_block splits each slot into node blocks, and state0 resumes a
    run: neither changes a result."""
    d = setup
    kw = dict(device="cpu", labels=np.asarray(d["ln"]), **d["port"])
    wn, harvest = np.asarray(d["wn"]), np.asarray(d["harvest"])
    full = repro_torch.seeker_fleet_simulate(wn, harvest, noise=d["noise"],
                                             **kw)
    blocked = repro_torch.seeker_fleet_simulate(wn, harvest, noise=d["noise"],
                                                node_block=3, **kw)
    for name in ("decisions", "k_trace", "payload_bytes", "stored_uj",
                 "logits"):
        np.testing.assert_array_equal(blocked[name].numpy(),
                                      full[name].numpy(), err_msg=name)
    half = S // 2
    first = repro_torch.seeker_fleet_simulate(
        wn[:, :half], harvest[:, :half],
        noise={k: v[:half] for k, v in d["noise"].items()},
        **dict(kw, labels=np.asarray(d["ln"])[:half]))
    second = repro_torch.seeker_fleet_simulate(
        wn[:, half:], harvest[:, half:], state0=first["final_state"],
        noise={k: v[half:] for k, v in d["noise"].items()},
        **dict(kw, labels=np.asarray(d["ln"])[half:]))
    np.testing.assert_array_equal(
        np.concatenate([first["decisions"], second["decisions"]]),
        full["decisions"].numpy())
    np.testing.assert_array_equal(second["stored_uj"].numpy(),
                                  full["stored_uj"][half:].numpy())


# ---------------------------------------------------------------------------
# Isolation and device policy
# ---------------------------------------------------------------------------

def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f)
                                            & {"jax", "jaxlib", "repro"})
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_leaves_jax_out():
    code = ("import sys; import repro_torch.serving, repro_torch.convert; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["False", "False"]


def test_default_device_is_cuda_and_never_falls_back(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.seeker_fleet_simulate(
            np.asarray(d["wins"]), np.asarray(d["harvest"]), **d["port"])


@pytest.mark.parametrize("lane", ["task", "telemetry", "mesh"])
def test_task_and_telemetry_run_and_mesh_raises(setup, lane):
    """The task and telemetry lanes run (their parity with JAX is
    tests/test_torch_tasks.py's); the streamed driver's ``mesh=`` must be a
    ``DeviceMesh`` (the sharded runs are tests/test_torch_sharded.py's), and
    anything else raises ``ValueError``."""
    d = setup
    args = (np.asarray(d["wins"]), np.asarray(d["harvest"]))
    if lane == "mesh":
        with pytest.raises(ValueError, match="must be a torch.distributed"
                                             ".device_mesh.DeviceMesh"):
            repro_torch.seeker_fleet_simulate_streamed(
                *args, chunk=2, mesh=object(), device="cpu", **d["port"])
        return
    value = (repro_torch.TaskLaneConfig() if lane == "task" else True)
    res = repro_torch.seeker_fleet_simulate(*args, device="cpu",
                                            noise=d["noise"],
                                            **{lane: value}, **d["port"])
    bare = repro_torch.seeker_fleet_simulate(*args, device="cpu",
                                             noise=d["noise"], **d["port"])
    if lane == "task":
        assert int(res["completed_by_task"].sum()) == int(res["completed"])
    else:
        assert torch.equal(res["telemetry"]["fleet.decisions"],
                           res["decision_histogram"].to(torch.int32))
        assert torch.equal(res["decisions"], bare["decisions"])
