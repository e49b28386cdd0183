"""The port's task and telemetry lanes against the JAX package, on the CPU:
``repro_torch.seeker_fleet_simulate(task=, tasks=, telemetry=)`` against
``repro.serving.seeker_fleet_simulate`` on a mixed fleet of HAR wearables
and bearing monitors at the real HAR widths, N=8, S=8.

Both packages get the same weights (through ``repro_torch.convert``),
per-node streams (even nodes HAR, odd nodes bearing vibration resampled to
the HAR grid and tiled to 3 channels), (S, N) labels, harvest and alive
traces, and the port gets the noise JAX drew (``jax_fleet_noise``, each
node's key frozen through the slots JAX's engine did not run it).  Integer
traces, per-task splits and every telemetry counter and histogram must be
exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.configs.seeker_har import HAR  # noqa: E402
from repro.core import fleet_harvest_traces  # noqa: E402
from repro.core.decision import IntermittentConfig  # noqa: E402
from repro.core.energy import BrownoutConfig, fleet_alive_traces  # noqa: E402
from repro.core.recovery import init_generator  # noqa: E402
from repro.data.sensors import (bearing_stream, class_signatures,  # noqa: E402
                                har_stream)
from repro.models import har as jhar  # noqa: E402
from repro.serving import (TaskLaneConfig, seeker_fleet_simulate,  # noqa: E402
                           stack_task_params)
from repro.serving.fleet_lanes import fleet_task_assignment  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.seeker_har import HAR as THAR  # noqa: E402
from repro_torch.core import decision as tdec  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402
from repro_torch.serving import fleet_lanes as tlanes  # noqa: E402

from test_torch_fleet import LOGIT_TOL, STORED_TOL, jax_fleet_noise  # noqa: E402

N, S = 8, 8
# benchmarks/fleet_scale.py's scarce rows (BROWNOUT_CFG, BROWNOUT_INITIAL_UJ,
# INTERMITTENT_CFG), over a per-node spread of harvest scales so that the
# ladder's rungs, brown-outs and the lane's codes all occur
SCARCITY = np.linspace(0.04, 0.5, N, dtype=np.float32)
LANES = dict(brownout=(6.0, 30.0), initial_uj=12.0, intermittent=(1, 0.0))
# the plain ladder: a lower memo threshold so HAR nodes hit the signature
# bank (D0) and score correct results
PLAIN = dict(corr_threshold=0.9, harvest_scale=2.0)
INT_NAMES = ("decisions", "payload_bytes", "k_trace", "alive", "brownout",
             "preds", "decision_histogram", "completed", "alive_slots",
             "correct", "completed_by_task", "deadline_miss_by_task",
             "correct_by_task", "tasks", "brownout_slots",
             "brownout_events", "final_brownout")
CASES = ("plain", "lanes")
LANE_INT_NAMES = ("it_emit", "it_src", "it_stage", "it_full", "it_early",
                  "correct_ladder", "it_correct_full", "it_correct_early")


@pytest.fixture(scope="module")
def mixed():
    key = jax.random.PRNGKey(0)
    params = jhar.har_init(key, HAR)
    aux = jhar.har_aux_init(jax.random.fold_in(key, 7), HAR)
    gen = init_generator(key, HAR.window, HAR.channels)
    har = jax.jit(har_stream, static_argnums=1)
    brg = jax.jit(bearing_stream, static_argnums=(1, 2))
    wins, labels = [], []
    for i in range(N):
        if i % 2 == 0:
            w, lab = har(jax.random.fold_in(key, 100 + i), S)
        else:
            w, lab = brg(jax.random.fold_in(key, 200 + i), S, HAR.window)
            w = jnp.tile(w, (1, 1, HAR.channels))       # (S, T, 1) -> 3
        wins.append(w)
        labels.append(lab)
    return dict(
        key=key, params=params, aux=aux, gen=gen, sigs=class_signatures(),
        wins=np.asarray(jnp.stack(wins)),                   # (N, S, T, C)
        labels=np.asarray(jnp.stack(labels).T),             # (S, N)
        harvest=np.asarray(fleet_harvest_traces(key, N, S)),
        alive=np.asarray(fleet_alive_traces(jax.random.fold_in(key, 3), N, S,
                                            duty=0.75, period=8,
                                            p_glitch=0.1)),
        port=dict(signatures=convert.tensor(class_signatures()),
                  qdnn_params=convert.har_params(params),
                  host_params=convert.har_params(params),
                  gen_params=convert.generator_params(gen), har_cfg=THAR,
                  device="cpu"))


def _jax_kw(d, case):
    kw = dict(signatures=d["sigs"], qdnn_params=d["params"],
              host_params=d["params"], gen_params=d["gen"], har_cfg=HAR,
              key=d["key"], labels=d["labels"], telemetry=True)
    if case == "lanes":
        kw.update(alive=d["alive"],
                  brownout=BrownoutConfig(*LANES["brownout"]),
                  initial_uj=LANES["initial_uj"],
                  intermittent=IntermittentConfig(*LANES["intermittent"]),
                  aux_params=d["aux"])
        return d["harvest"] * SCARCITY[:, None], kw
    kw.update(corr_threshold=PLAIN["corr_threshold"])
    return d["harvest"] * PLAIN["harvest_scale"], kw


def _port_kw(d, case):
    kw = dict(d["port"], labels=d["labels"], telemetry=True)
    if case == "lanes":
        kw.update(alive=d["alive"],
                  brownout=tenergy.BrownoutConfig(*LANES["brownout"]),
                  initial_uj=LANES["initial_uj"],
                  intermittent=tdec.IntermittentConfig(*LANES["intermittent"]),
                  aux_params=convert.aux_params(d["aux"]))
    else:
        kw.update(corr_threshold=PLAIN["corr_threshold"])
    return kw


@pytest.fixture(scope="module")
def runs(mixed):
    """The JAX engine and the port on the same mixed fleet, per case: the
    plain ladder, and churn, brown-out and the intermittent lane."""
    d, out = mixed, {}
    for case in CASES:
        harvest, jkw = _jax_kw(d, case)
        ref = seeker_fleet_simulate(d["wins"], harvest,
                                    task=TaskLaneConfig(), **jkw)
        noise = jax_fleet_noise(d["key"], N, S, HAR.window, HAR.channels,
                                alive=np.asarray(ref["alive"]))
        kw = _port_kw(d, case)
        res = repro_torch.seeker_fleet_simulate(
            d["wins"], harvest, noise=noise, task=tlanes.TaskLaneConfig(),
            **kw)
        out[case] = dict(case=case, ref=ref, res=res, wins=d["wins"],
                         harvest=harvest, noise=noise, kw=kw)
    return out


@pytest.mark.parametrize("case", CASES)
def test_task_fleet_exercises_both_tasks(runs, case):
    """The parity below proves something only if both tasks complete and
    miss slots, and (with the lanes) the run browns out and the lane
    emits."""
    ref = runs[case]["ref"]
    assert (np.asarray(ref["completed_by_task"]) > 0).all()
    assert (np.asarray(ref["deadline_miss_by_task"]) > 0).all()
    if case == "lanes":
        assert int(ref["brownout_events"]) > 0 and int(ref["it_full"]) > 0
    else:
        assert int(ref["correct"]) > 0


@pytest.mark.parametrize("case,name", [(c, n) for c in CASES
                                       for n in INT_NAMES]
                         + [("lanes", n) for n in LANE_INT_NAMES])
def test_task_fleet_integer_outputs_equal_jax(runs, case, name):
    np.testing.assert_array_equal(runs[case]["res"][name].numpy(),
                                  np.asarray(runs[case]["ref"][name]))


def _near_integer(stored, alive):
    """Nodes whose stored charge lies within STORED_TOL of an integer: the
    only ones whose floor may differ between the packages."""
    tol = STORED_TOL["atol"] + STORED_TOL["rtol"] * np.abs(stored)
    return int((alive & (np.abs(stored - np.round(stored)) <= tol)).sum())


@pytest.mark.parametrize("case", CASES)
def test_task_fleet_telemetry_equals_jax(runs, case):
    """Every counter and histogram is exactly JAX's; the ``fleet.stored_uj``
    gauge (the sum of floor(stored) over the last slot's alive nodes) may
    differ by at most the number of nodes whose stored value lies within
    STORED_TOL of an integer."""
    ref, res = runs[case]["ref"], runs[case]["res"]
    tel_r, tel_p = ref["telemetry"], res["telemetry"]
    assert res["telemetry_spec"].names() == ref["telemetry_spec"].names()
    assert set(tel_p) == set(tel_r)
    for name in tel_r:
        if name == "fleet.stored_uj":
            continue
        np.testing.assert_array_equal(tel_p[name].numpy(),
                                      np.asarray(tel_r[name]), err_msg=name)
        assert tel_p[name].dtype == torch.int32, name
    slack = _near_integer(np.asarray(ref["stored_uj"])[-1],
                          np.asarray(ref["alive"])[-1])
    assert abs(int(tel_p["fleet.stored_uj"])
               - int(tel_r["fleet.stored_uj"])) <= slack


@pytest.mark.parametrize("case", CASES)
def test_task_fleet_telemetry_equals_aggregates(runs, case):
    """The registry lanes count what the aggregates count."""
    from repro_torch.obs import counter_value
    res = runs[case]["res"]
    tel = res["telemetry"]
    assert counter_value(tel, "fleet.wire_bytes") == tfleet.wire_bytes_exact(
        res)
    for lane, agg in (("fleet.completed", "completed"),
                      ("fleet.alive_slots", "alive_slots"),
                      ("fleet.brownout_slots", "brownout_slots"),
                      ("fleet.brownout_events", "brownout_events")):
        assert counter_value(tel, lane) == int(res[agg]), lane
    np.testing.assert_array_equal(tel["fleet.decisions"].numpy(),
                                  res["decision_histogram"].numpy())
    np.testing.assert_array_equal(tel["fleet.task_completed"].numpy(),
                                  res["completed_by_task"].numpy())
    # the splits partition the totals
    assert int(res["completed_by_task"].sum()) == int(res["completed"])
    assert int((res["completed_by_task"]
                + res["deadline_miss_by_task"]).sum()) == int(
        res["alive_slots"])


@pytest.mark.parametrize("case", CASES)
def test_task_fleet_floats_match_jax(runs, case):
    ref, res = runs[case]["ref"], runs[case]["res"]
    np.testing.assert_allclose(res["stored_uj"].numpy(),
                               np.asarray(ref["stored_uj"]), **STORED_TOL)
    np.testing.assert_allclose(res["logits"].numpy(),
                               np.asarray(ref["logits"]), **LOGIT_TOL)
    for name in ("completed_frac", "fleet_accuracy"):
        np.testing.assert_allclose(float(res[name]), float(ref[name]),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(res["accuracy_by_task"].numpy(),
                               np.asarray(ref["accuracy_by_task"]), rtol=1e-6)
    assert tuple(res["task_names"]) == tuple(ref["task_names"])


@pytest.mark.parametrize("case", CASES)
def test_stacked_counters_are_the_lane_by_lane_fold(runs, case):
    """The engine adds the slot's counters in one stacked reduction; it is
    bit for bit the fold of each lane's ``counter_add``."""
    res = runs[case]["res"]
    spec = res["telemetry_spec"]
    active = tfleet._active_lanes(
        runs[case]["kw"].get("intermittent"), tlanes.TaskLaneConfig(),
        runs[case]["kw"].get("brownout"))
    rng = np.random.default_rng(0)
    m_stacked = m_folded = {k: torch.as_tensor(
        rng.integers(0, 1 << 16, v.shape), dtype=torch.int32)
        for k, v in res["telemetry"].items()}
    for si in range(S):
        out_t = {k: res[k][si] for k in ("decisions", "payload_bytes",
                                         "stored_uj", "alive", "brownout")}
        out_t["bo_event"] = torch.as_tensor(rng.random(N) < 0.3)
        out_t["payload_bytes"] = out_t["payload_bytes"] * 4096.0
        if "it_emit" in res:
            out_t["it_emit"] = res["it_emit"][si]
        exo = torch.as_tensor(rng.random(N) < 0.8)
        m_stacked = tfleet._update_fleet_lanes(spec, m_stacked, out_t, exo,
                                               active, res["tasks"])
        m_folded = tfleet._update_fleet_lanes(spec, m_folded, out_t, exo,
                                              active, res["tasks"],
                                              stack_counters=False)
    for k in m_folded:
        assert torch.equal(m_stacked[k], m_folded[k]), k


# ---------------------------------------------------------------------------
# Per-task host weights, the unit cost scale, telemetry as an observer
# ---------------------------------------------------------------------------

def test_per_task_host_matches_jax_and_is_blind(mixed, runs):
    """``per_task_host``: each task's nodes run through their own host
    weights, within LOGIT_TOL of JAX's gather; task-0 nodes do not see what
    task 1's weights are."""
    d, plain = mixed, runs["plain"]
    params_b = jhar.har_init(jax.random.fold_in(d["key"], 21), HAR)
    params_c = jhar.har_init(jax.random.fold_in(d["key"], 22), HAR)
    harvest, jkw = _jax_kw(d, "plain")
    jkw.pop("host_params")
    ref = seeker_fleet_simulate(
        d["wins"], harvest, task=TaskLaneConfig(per_task_host=True),
        host_params=(d["params"], params_b), **jkw)
    kw = dict(plain["kw"])
    kw.pop("host_params")
    cfg = tlanes.TaskLaneConfig(per_task_host=True)
    res = repro_torch.seeker_fleet_simulate(
        d["wins"], harvest, noise=plain["noise"], task=cfg,
        host_params=convert.task_host_params((d["params"], params_b)), **kw)
    for name in ("decisions", "preds", "correct_by_task", "completed_by_task"):
        np.testing.assert_array_equal(res[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    np.testing.assert_allclose(res["logits"].numpy(),
                               np.asarray(ref["logits"]), **LOGIT_TOL)
    other = repro_torch.seeker_fleet_simulate(
        d["wins"], harvest, noise=plain["noise"], task=cfg,
        host_params=convert.task_host_params((d["params"], params_c)), **kw)
    task0 = res["tasks"].numpy() == 0
    assert torch.equal(other["logits"][:, task0], res["logits"][:, task0])
    assert not torch.equal(other["logits"][:, ~task0],
                           res["logits"][:, ~task0])
    # in node blocks, each block's nodes of a task share one host step: a
    # batch of another size sums in another order, so logits agree to
    # LOGIT_TOL and the integer outputs exactly
    blocked = repro_torch.seeker_fleet_simulate(
        d["wins"], harvest, noise=plain["noise"], task=cfg, node_block=3,
        host_params=convert.task_host_params((d["params"], params_b)), **kw)
    for name in ("decisions", "preds", "correct_by_task"):
        assert torch.equal(blocked[name], res[name]), name
    np.testing.assert_allclose(blocked["logits"].numpy(),
                               res["logits"].numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("case", CASES)
def test_unit_cost_scale_is_the_run_without_the_lane(runs, case):
    """A task lane whose every scale is 1 leaves every trace bitwise as the
    run without it (the ladder's and the intermittent lane's costs)."""
    d = runs[case]
    kw = dict(d["kw"], telemetry=None)
    bare = repro_torch.seeker_fleet_simulate(d["wins"], d["harvest"],
                                             noise=d["noise"], **kw)
    unit = repro_torch.seeker_fleet_simulate(
        d["wins"], d["harvest"], noise=d["noise"],
        task=tlanes.TaskLaneConfig(cost_scale=(1.0, 1.0)), **kw)
    for name in tfleet.fleet_trace_keys(frozenset({"intermittent"})):
        if name in bare:
            assert torch.equal(unit[name], bare[name]), name


@pytest.mark.parametrize("case", CASES)
def test_telemetry_is_a_pure_observer(runs, case):
    """With ``telemetry=None`` every trace is bitwise the telemetered
    run's, and no telemetry comes back."""
    d = runs[case]
    off = repro_torch.seeker_fleet_simulate(
        d["wins"], d["harvest"], noise=d["noise"],
        task=tlanes.TaskLaneConfig(), **dict(d["kw"], telemetry=None))
    assert "telemetry" not in off
    for name in tfleet.fleet_trace_keys(frozenset({"intermittent"})):
        if name in off:
            assert torch.equal(off[name], d["res"][name]), name


def _message(fn):
    with pytest.raises((ValueError, TypeError)) as err:
        fn()
    return f"{err.type.__name__}: {err.value}"


def test_validation_errors_match_jax(mixed):
    """Malformed task arguments fail with JAX's messages, word for word."""
    d = mixed
    harvest, jkw = _jax_kw(d, "plain")
    kw = _port_kw(d, "plain")
    bad = {
        "short tasks": dict(tasks=np.zeros((N - 1,), np.int32)),
        "ids out of range": dict(tasks=np.full((N,), 5, np.int32),
                                 task="default"),
        "negative ids": dict(tasks=-np.ones((N,), np.int32)),
        "host not a sequence": dict(task="per_task_host"),
        "host of one tree": dict(task="per_task_host", host_params="one"),
        "telemetry of another type": dict(telemetry="yes"),
    }
    configs = {"default": (TaskLaneConfig(), tlanes.TaskLaneConfig()),
               "per_task_host": (TaskLaneConfig(per_task_host=True),
                                 tlanes.TaskLaneConfig(per_task_host=True))}
    for what, args in bad.items():
        j_args, p_args = dict(args), dict(args)
        if "task" in args:
            j_args["task"], p_args["task"] = configs[args["task"]]
        if args.get("host_params") == "one":
            j_args["host_params"] = (d["params"],)
            p_args["host_params"] = (kw["host_params"],)
        want = _message(lambda: seeker_fleet_simulate(
            d["wins"], harvest, **{**jkw, **j_args}))
        got = _message(lambda: repro_torch.seeker_fleet_simulate(
            d["wins"], harvest, **{**kw, **p_args}))
        assert got == want, what
    for args in (dict(names=()), dict(cost_scale=(1.0,)),
                 dict(cost_scale=(1.0, 0.0))):
        assert (_message(lambda: tlanes.TaskLaneConfig(**args))
                == _message(lambda: TaskLaneConfig(**args))), args
    assert tlanes.TaskLaneConfig() == tlanes.TaskLaneConfig(
        ("har", "bearing"), (1.0, tenergy.BEARING_COST_SCALE))
    np.testing.assert_array_equal(
        tlanes.fleet_task_assignment(7, 3).numpy(),
        np.asarray(fleet_task_assignment(7, 3)))
    stacked = tlanes.stack_task_params(convert.task_host_params(
        (d["params"], d["params"])))
    want = stack_task_params((d["params"], d["params"]))
    for k, v in want.items():
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(v))
