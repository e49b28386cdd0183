"""The port's streamed driver, ``repro_torch.seeker_fleet_simulate_streamed``,
on the CPU: segments of ``CHUNK`` slots over S=8 (a ragged last segment),
chained through the resume arguments, must be bitwise the port's one long
run in every lane combination, and, given the noise JAX drew, equal JAX's
streamed driver on the integer outputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.configs.seeker_har import HAR  # noqa: E402
from repro.core.decision import IntermittentConfig  # noqa: E402
from repro.core.energy import BrownoutConfig  # noqa: E402
from repro.serving import (TaskLaneConfig,  # noqa: E402
                           seeker_fleet_simulate_streamed, wire_bytes_exact)

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import decision as tdec  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402
from repro_torch.serving import fleet_lanes as tlanes  # noqa: E402

from test_torch_fleet import jax_fleet_noise  # noqa: E402
from test_torch_tasks import LANES, SCARCITY, N, S, mixed  # noqa: E402,F401

CHUNK = 3
COMBOS = {
    "bare": dict(),
    "churn": dict(alive=True),
    "brownout+intermittent": dict(brownout=True, intermittent=True),
    "all+task+telemetry": dict(alive=True, brownout=True, intermittent=True,
                               task=True, telemetry=True),
}


def _port_kw(d, combo):
    on = COMBOS[combo]
    kw = dict(d["port"], labels=d["labels"], initial_uj=LANES["initial_uj"])
    if on.get("alive"):
        kw["alive"] = d["alive"]
    if on.get("brownout"):
        kw["brownout"] = tenergy.BrownoutConfig(*LANES["brownout"])
    if on.get("intermittent"):
        kw.update(intermittent=tdec.IntermittentConfig(*LANES["intermittent"]),
                  aux_params=convert.aux_params(d["aux"]))
    if on.get("task"):
        kw["task"] = tlanes.TaskLaneConfig()
    if on.get("telemetry"):
        kw["telemetry"] = True
    return kw


def _harvest(d):
    return d["harvest"] * SCARCITY[:, None]


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_same(long, streamed):
    """Every trace, counter, final state and telemetry lane bit for bit."""
    for k, v in long.items():
        if k in ("fleet_accuracy", "completed_frac", "accuracy_by_task",
                 "bytes_on_wire", "raw_bytes_per_window", "telemetry_spec",
                 "task_names"):
            continue
        if k in ("final_state", "final_intermittent"):
            for a, b in zip(_leaves(v), _leaves(streamed[k])):
                assert torch.equal(a, b), k
        elif k == "telemetry":
            for lane in v:
                assert torch.equal(v[lane], streamed[k][lane]), lane
        else:
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(streamed[k])), k
    for k in ("fleet_accuracy", "completed_frac"):
        assert float(long[k]) == float(streamed[k]), k
    assert streamed["n_chunks"] == -(-S // CHUNK)


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_streamed_is_bitwise_one_long_run(mixed, combo):  # noqa: F811
    """One generator handed from segment to segment draws what one long run
    draws; pre-drawn noise sliced per segment does the same."""
    d = mixed
    kw = _port_kw(d, combo)
    long = repro_torch.seeker_fleet_simulate(
        d["wins"], _harvest(d), generator=torch.Generator().manual_seed(5),
        **kw)
    streamed = repro_torch.seeker_fleet_simulate_streamed(
        d["wins"], _harvest(d), chunk=CHUNK,
        generator=torch.Generator().manual_seed(5), **kw)
    _assert_same(long, streamed)
    noise = tfleet.draw_fleet_noise(torch.Generator().manual_seed(5), S, N,
                                    HAR.window, HAR.channels)
    sliced = repro_torch.seeker_fleet_simulate_streamed(
        lambda a, b: torch.tensor(d["wins"][:, a:b]), _harvest(d),
        chunk=CHUNK, noise=noise, **kw)
    _assert_same(long, sliced)


def test_cross_segment_emission_scores_as_in_one_run(mixed):  # noqa: F811
    """A staged inference started in one segment and emitted in the next is
    scored against its source slot's label, as in one long run.  The labels
    are set to what each emission says, so every lane emission scores."""
    d = mixed
    kw = _port_kw(d, "brownout+intermittent")
    gen = lambda: torch.Generator().manual_seed(5)          # noqa: E731
    probe = repro_torch.seeker_fleet_simulate(d["wins"], _harvest(d),
                                              generator=gen(), **kw)
    emit = probe["it_emit"].numpy() > 0
    src, lab = probe["it_src"].numpy(), probe["it_label"].numpy()
    labels = d["labels"].copy()
    slots, nodes = np.nonzero(emit)
    labels[src[slots, nodes], nodes] = lab[slots, nodes]
    crossing = (src[slots, nodes] // CHUNK) < (slots // CHUNK)
    assert crossing.any(), "no emission crosses a segment boundary"
    kw["labels"] = labels
    long = repro_torch.seeker_fleet_simulate(d["wins"], _harvest(d),
                                             generator=gen(), **kw)
    streamed = repro_torch.seeker_fleet_simulate_streamed(
        d["wins"], _harvest(d), chunk=CHUNK, generator=gen(), **kw)
    lane_ok = int(long["it_correct_full"] + long["it_correct_early"])
    assert lane_ok == int(emit.sum())
    for k in ("correct", "correct_ladder", "it_correct_full",
              "it_correct_early"):
        assert int(streamed[k]) == int(long[k]), k


def test_streamed_equals_jax_streamed(mixed):  # noqa: F811
    """All lanes, the task lane and telemetry: the port's streamed driver,
    given the noise JAX drew, equals JAX's streamed driver on the integer
    outputs."""
    d = mixed
    ref = seeker_fleet_simulate_streamed(
        d["wins"], _harvest(d), chunk=CHUNK, signatures=d["sigs"],
        qdnn_params=d["params"], host_params=d["params"],
        gen_params=d["gen"], har_cfg=HAR, key=d["key"], labels=d["labels"],
        alive=d["alive"], brownout=BrownoutConfig(*LANES["brownout"]),
        initial_uj=LANES["initial_uj"],
        intermittent=IntermittentConfig(*LANES["intermittent"]),
        aux_params=d["aux"], task=TaskLaneConfig(), telemetry=True)
    noise = jax_fleet_noise(d["key"], N, S, HAR.window, HAR.channels,
                            alive=np.asarray(ref["alive"]))
    res = repro_torch.seeker_fleet_simulate_streamed(
        d["wins"], _harvest(d), chunk=CHUNK, noise=noise,
        **_port_kw(d, "all+task+telemetry"))
    for k in ("decisions", "payload_bytes", "k_trace", "alive", "brownout",
              "preds", "it_emit", "it_src", "it_stage", "decision_histogram",
              "completed", "alive_slots", "correct", "correct_ladder",
              "it_correct_full", "it_correct_early", "brownout_slots",
              "brownout_events", "it_full", "it_early", "completed_by_task",
              "deadline_miss_by_task", "correct_by_task", "final_brownout"):
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert tfleet.wire_bytes_exact(res) == wire_bytes_exact(ref)
    assert res["n_chunks"] == ref["n_chunks"]
    for lane, v in ref["telemetry"].items():
        if lane != "fleet.stored_uj":
            np.testing.assert_array_equal(res["telemetry"][lane].numpy(),
                                          np.asarray(v), err_msg=lane)
