"""The fleet's slot loop replayed as CUDA graphs, against the eager loop.

On a CUDA device :func:`repro_torch.seeker_fleet_simulate` runs a key's
first call eagerly, captures one graph a slot, and replays them after.
The tests marked ``cuda`` hold the replays to the eager loop on the same
card (``python -m pytest -q --noconftest -m cuda
tests/test_torch_fleet_graph.py`` there, where JAX, which ``conftest.py``
imports, is absent; they skip without a card): three chained calls, each
resuming the last one's state, keys and brown-out flags, equal the eager
calls in every trace, aggregate and end state, bit for bit; what an
earlier call handed out is left as it was; new weight tensors capture
once; and the paths that stay eager count ``eager_slots``.  The CPU cases
run the loop eagerly, count no capture, and hold the cost and payload
tables the slot reads to the values the slot used to build.  Small sizes:
64 nodes, 4 slots a call, node blocks of 32.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs.seeker_har import HAR  # noqa: E402
from repro_torch.core.coreset import sampling_payload_bytes  # noqa: E402
from repro_torch.core.decision import (IntermittentConfig,  # noqa: E402
                                       _decision_table)
from repro_torch.core.energy import (TABLE2_COSTS, BrownoutConfig,  # noqa: E402
                                     EnergyCosts, fleet_harvest_traces)
from repro_torch.core.recovery import init_generator  # noqa: E402
from repro_torch.data.sensors import class_signatures, har_stream  # noqa: E402
from repro_torch.graph_io import tree_map  # noqa: E402
from repro_torch.models.har import har_aux_init, har_init  # noqa: E402
from repro_torch.serving import fleet  # noqa: E402
from repro_torch.serving.edge_host import _payload_table  # noqa: E402

N, S, CALLS, BLOCK = 64, 4, 3, 32
# the name, the harvest scale and the lane knobs of each chained case
CASES = {"typical": (1.0, {}),
         "brownout": (0.05, dict(brownout=BrownoutConfig(6.0, 30.0),
                                 initial_uj=12.0, telemetry=True)),
         "shared": (1.0, {})}


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fleet._GRAPHS.clear()
    return torch.device("cuda")


def _fleet(dev, case="typical", n=N, seed=0):
    """Windows and harvest for ``CALLS`` calls of ``S`` slots, and the
    engine's keyword arguments, on ``dev``."""
    scale, knobs = CASES[case]
    g = torch.Generator().manual_seed(seed)
    params = har_init(g, HAR)
    slots = CALLS * S
    if case == "shared":
        windows, labels = har_stream(g, slots)                 # (S, T, C)
    else:
        windows, labels = har_stream(g, slots, streams=n)      # (N, S, T, C)
        labels = labels.T.contiguous()
    harvest = fleet_harvest_traces(g, n, slots) * scale
    kw = dict(signatures=class_signatures(), qdnn_params=params,
              host_params=params,
              gen_params=init_generator(g, HAR.window, HAR.channels),
              har_cfg=HAR, node_block=BLOCK, **knobs)
    kw = {k: v if isinstance(v, (bool, float, int)) or v is None
          else _to(v, dev) for k, v in kw.items()}
    return (windows.to(dev), harvest.to(dev), labels.to(dev),
            repro_torch.fleet_node_keys(seed, n, dev), dict(kw, device=dev))


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict) or hasattr(x, "_fields"):
        return tree_map(lambda v: v.to(dev), x)
    return x


def _chain(windows, harvest, labels, keys, kw, calls=CALLS):
    """``calls`` calls of S slots, each resuming the last one's node state,
    keys and brown-out flags; returns each call's result."""
    out, state, browned = [], None, None
    shared = windows.ndim == 3
    for i in range(calls):
        sl = slice(i * S, (i + 1) * S)
        res = repro_torch.seeker_fleet_simulate(
            windows[sl] if shared else windows[:, sl], harvest[:, sl],
            labels=labels[sl], node_keys=keys, state0=state,
            brownout_state0=browned, **kw)
        out.append(res)
        state, keys = res["final_state"], res["final_keys"]
        browned = res["final_brownout"]
    return out


def _eager(monkeypatch, *args, **kw):
    """The same chain with the loop run eagerly on the card (as inside a
    caller's capture)."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        return _chain(*args, **kw)


def _tensors(res):
    """Every tensor of a result, by name."""
    out = {}
    for k, v in res.items():
        if isinstance(v, torch.Tensor):
            out[k] = v
        elif isinstance(v, dict) or hasattr(v, "_fields"):
            leaves = []
            tree_map(lambda x: leaves.append(x) or x, v)
            out.update({f"{k}.{i}": x for i, x in enumerate(leaves)})
    return out


def _assert_same(got, want):
    a, b = _tensors(got), _tensors(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_chained_calls_equal_the_eager_loop(cuda_dev, monkeypatch, case):
    """Three chained calls: the first runs eagerly and captures, the next
    two replay S graphs each; every trace, aggregate and end state equals
    the eager loop's, and no call's results moved under a later call."""
    inputs = _fleet(cuda_dev, case)
    want = _eager(monkeypatch, *inputs)
    before = repro_torch.serving.fleet_graph_counts()
    got = _chain(*inputs)
    kept = [{k: v.clone() for k, v in _tensors(r).items()} for r in got]
    torch.cuda.synchronize()
    after = repro_torch.serving.fleet_graph_counts()
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == (CALLS - 1) * S
    assert after["eager_slots"] - before["eager_slots"] == S
    for g, w in zip(got, want):
        _assert_same(g, w)
    # a later call changed nothing an earlier one handed out
    _chain(*inputs)
    for g, k in zip(got, kept):
        assert all(torch.equal(_tensors(g)[n], v) for n, v in k.items())
    last = got[-1]
    assert int(last["decision_histogram"][:5].sum()) > 0
    if case == "brownout":
        assert int(last["brownout_slots"]) > 0


@pytest.mark.cuda
def test_new_weights_capture_once(cuda_dev, monkeypatch):
    """The quantized D2 weights are made anew every call and copied in, so
    new D2 tensors capture nothing; new host weights capture once and
    answer as the eager loop does, and an in-place update of them is read
    by the replay."""
    windows, harvest, labels, keys, kw = _fleet(cuda_dev)

    def captures():
        return repro_torch.serving.fleet_graph_counts()["captures"]

    _chain(windows, harvest, labels, keys, kw, calls=2)
    n0 = captures()
    fresh_d2 = {k: v.clone() for k, v in kw["qdnn_params"].items()}
    _chain(windows, harvest, labels, keys, dict(kw, qdnn_params=fresh_d2),
           calls=2)
    assert captures() == n0
    host = {k: v.clone() for k, v in kw["host_params"].items()}
    kw = dict(kw, host_params=host)
    _chain(windows, harvest, labels, keys, kw, calls=2)
    assert captures() == n0 + 1
    host["head_b"].add_(0.5)
    got = _chain(windows, harvest, labels, keys, kw, calls=2)
    assert captures() == n0 + 1
    want = _eager(monkeypatch, windows, harvest, labels, keys, kw, calls=2)
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.cuda
def test_generator_intermittent_and_copied_weights_run_eagerly(cuda_dev):
    """A ``generator=`` run, the intermittent lane, and a signature bank
    copied to the card each call run every slot eagerly and capture
    nothing."""
    windows, harvest, labels, keys, kw = _fleet(cuda_dev)
    g = torch.Generator().manual_seed(5)
    runs = [dict(kw, generator=torch.Generator(device=cuda_dev).manual_seed(1)),
            dict(kw, node_keys=keys, intermittent=IntermittentConfig(1, 0.0),
                 aux_params=_to(har_aux_init(g, HAR), cuda_dev)),
            dict(kw, node_keys=keys, signatures=class_signatures())]
    for run in runs:
        before = repro_torch.serving.fleet_graph_counts()
        for _ in range(2):
            repro_torch.seeker_fleet_simulate(windows[:, :S], harvest[:, :S],
                                              **run)
        after = repro_torch.serving.fleet_graph_counts()
        assert after["captures"] == before["captures"]
        assert after["replays"] == before["replays"]
        assert after["eager_slots"] - before["eager_slots"] == 2 * S


def test_cpu_call_runs_eagerly():
    """On the CPU every slot runs eagerly; nothing is captured or
    replayed, and a call resumed from the last one's carry goes on."""
    windows, harvest, labels, keys, kw = _fleet(torch.device("cpu"), n=8)
    before = repro_torch.serving.fleet_graph_counts()
    res = _chain(windows, harvest, labels, keys, kw, calls=2)
    after = repro_torch.serving.fleet_graph_counts()
    assert after["captures"] == before["captures"]
    assert after["replays"] == before["replays"]
    assert after["eager_slots"] - before["eager_slots"] == 2 * S
    assert res[1]["decisions"].shape == (S, 8)
    assert not torch.equal(res[1]["final_keys"], res[0]["final_keys"])


@pytest.mark.parametrize("costs, m, c", [
    (TABLE2_COSTS, 20, 3),
    # as a JSON config gives it: a list, so the costs are unhashable
    (EnergyCosts(dnn16=12.5, stage_split=[0.1, 0.6, 0.3]), 20, 3),
    (TABLE2_COSTS, 20, 1)])
def test_hoisted_tables_equal_the_old_literals(costs, m, c):
    """The cost and payload tables made once per configuration and device
    are bit for bit the tensors the slot used to build on every call, and
    the same object on every call, also for costs that do not hash."""
    dev = torch.device("cpu")
    cost = _decision_table(costs.decision_costs(), dev)
    old_cost = torch.tensor(costs.decision_costs(), dtype=torch.float32,
                            device=dev)
    assert cost.dtype == torch.float32 and torch.equal(cost, old_cost)
    assert _decision_table(costs.decision_costs(), dev) is cost
    pay = _payload_table(m, c, dev)
    old_pay = torch.tensor([2.0, 2.0, 2.0, 0.0,
                            float(sampling_payload_bytes(m, channels=c)),
                            0.0], dtype=torch.float32, device=dev)
    assert pay.dtype == torch.float32 and torch.equal(pay, old_pay)
    assert _payload_table(m, c, dev) is pay
