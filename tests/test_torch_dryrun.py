"""The port's dry run on the CPU: ``repro_torch.launch.op_analysis`` (the
twin of ``repro.launch.hlo_analysis``), ``repro_torch.launch.dryrun`` and
``repro_torch.launch.roofline``.

* The op analysis against hand counts on fake process groups: a matrix
  product sharded on a (16, 16) mesh, its per-device FLOPs and the bytes
  of the all-reduce that makes its partial sums whole; a data-parallel
  gradient all-reduce on 8 ranks.
* Against JAX on one device: the smoke tinyllama config's prefill and its
  train step with ``remat="full"``.  ``analyze_hlo`` of XLA's compiled
  program and ``analyze_step`` of the port's eager step count the same
  matrix-product FLOPs, exactly; the dry run's ``argument_bytes`` equals
  XLA's ``memory_analysis().argument_size_in_bytes`` exactly.
* ``roofline_row`` against the reference's formulas on one set of cells.
* ``run_cell``: tinyllama-1.1b ``decode_32k`` on 256 fake ranks fits the
  card, ``long_500k`` of a full-attention arch is skipped, and the
  reference's own compression check (a tiny model on an (8,) ("data",)
  mesh: the compressed step's collective bytes under the dense step's
  all-reduce bytes).

Every fake group is started and destroyed inside its test
(``dryrun.fake_group``), so later tests on the worker can start their
own.  The reference's ``repro.launch.dryrun`` is not imported: it sets
the XLA device count when imported.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import abstract_params as jax_abstract_params  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.train import TrainHyper as JTrainHyper  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402

from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.op_analysis import analyze_step  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train import TrainHyper  # noqa: E402

BATCH, SEQ = 2, 32


def _mesh(shape, names):
    from repro_torch.launch.mesh import make_mesh_for
    return make_mesh_for(shape, names, "cpu")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Hand counts on fake groups
# ---------------------------------------------------------------------------

def test_mm_on_a_16x16_mesh_counts_one_devices_share():
    """x (1024, 4096) split over "data" by rows, w (4096, 4096) over
    "model" by columns: each of the 256 ranks multiplies (64, 4096) by
    (4096, 256), 2 * 1024 * 4096 * 4096 / 256 FLOPs, with no collective.
    With w split by rows instead, the product is a partial sum over
    "model", whose all-reduce (counted twice) moves the (64, 4096) float32
    result."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m, k, n = 1024, 4096, 4096
    with dryrun.fake_group(256):
        mesh = _mesh((16, 16), ("data", "model"))
        x = distribute_tensor(_meta(m, k), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        w_cols = distribute_tensor(_meta(k, n), mesh, [Replicate(), Shard(1)],
                                   src_data_rank=None)
        st = analyze_step(torch.matmul, x, w_cols)
        assert st.flops == 2 * m * k * n / 256
        assert st.total_collective_bytes == 0
        assert st.hbm_bytes == 4 * (64 * k + k * 256 + 64 * 256)
        assert st.memory["argument_bytes"] == 4 * (64 * k + k * 256)
        assert st.memory["temp_bytes"] == st.memory["output_bytes"] \
            == 4 * 64 * 256

        w_rows = distribute_tensor(_meta(k, n), mesh, [Replicate(), Shard(0)],
                                   src_data_rank=None)
        st = analyze_step(lambda a, b: (a @ b).redistribute(
            mesh, [Shard(0), Replicate()]), x, w_rows)
        assert st.flops == 2 * m * k * n / 256
        assert st.collective_bytes["all-reduce"] == 2 * 4 * 64 * n
        assert st.collective_counts["all-reduce"] == 1
        assert st.total_collective_bytes == 2 * 4 * 64 * n
        assert st.warnings == []


def test_dp_gradient_allreduce_on_8_ranks():
    """A data-parallel gradient reduction (``torch.distributed``'s c10d
    op, as the compressed step's reductions issue it): twice the
    gradient's bytes, one all-reduce; a gather of 8 tiles counts the
    gathered bytes."""
    import torch.distributed as dist

    with dryrun.fake_group(8):
        grad = _meta(1000, 64)

        def reduce(g):
            out = g.clone()
            dist.all_reduce(out)
            return out

        st = analyze_step(reduce, grad)
        assert st.collective_bytes["all-reduce"] == 2 * 1000 * 64 * 4
        assert st.collective_counts == {"all-reduce": 1, "all-gather": 0,
                                        "reduce-scatter": 0, "all-to-all": 0,
                                        "collective-permute": 0}
        assert st.flops == 0

        def gather(g):
            parts = [torch.empty_like(g) for _ in range(8)]
            dist.all_gather(parts, g)
            return torch.cat(parts)

        st = analyze_step(gather, grad)
        assert st.collective_bytes["all-gather"] == 8 * 1000 * 64 * 4
        assert st.collective_counts["all-gather"] == 1
        table = dryrun.parse_collectives(st)
        assert table["total_bytes"] == 8 * 1000 * 64 * 4
        assert table["all-gather"] == {"count": 1, "bytes": 8 * 1000 * 64 * 4}


# ---------------------------------------------------------------------------
# Against JAX on one device
# ---------------------------------------------------------------------------

def _cfgs():
    jcfg = dataclasses.replace(jax_smoke("tinyllama-1.1b"), remat="full")
    tcfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), remat="full")
    return jcfg, tcfg


def _jax_prefill(jcfg):
    def prefill(params, tokens):
        return jax_forward(params, jcfg, tokens, return_cache=True,
                           cache_len=SEQ)
    tokens = jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32)
    return jax.jit(prefill).lower(jax_abstract_params(jcfg), tokens).compile()


def _jax_train(jcfg):
    hyper = JTrainHyper()
    state = jax.eval_shape(
        lambda: jax_init_state(jax.random.PRNGKey(0), jcfg, hyper))
    batch = {"tokens": jax.ShapeDtypeStruct((BATCH, SEQ + 1), jnp.int32)}
    return jax.jit(jax_train_step(jcfg, hyper)).lower(state, batch).compile()


@pytest.fixture(scope="module")
def one_device():
    """Both sides' counts of the prefill and the train step."""
    jcfg, tcfg = _cfgs()
    out = {}
    for kind, compile_jax in (("prefill", _jax_prefill),
                              ("train", _jax_train)):
        compiled = compile_jax(jcfg)
        step, args = dryrun.build_step(
            "tinyllama-1.1b", ShapeCell(kind, kind, SEQ, BATCH), None,
            cfg=tcfg, hyper=TrainHyper())
        out[kind] = dict(hlo=analyze_hlo(compiled.as_text()),
                         xla_args=compiled.memory_analysis()
                         .argument_size_in_bytes,
                         port=analyze_step(step, *args))
    return out


def _dots(cfg, kind: str) -> float:
    """The smoke config's matrix-product FLOPs by hand: per token and layer
    the q, k, v, o projections and the three MLP products, the dense
    attention's two products over all S keys, and the unembedding.  The
    train step's backward runs two products for each (the input's and the
    weight's gradients), and its remat forward recomputes each layer's up
    to the last product the backward needs: all but the MLP's down
    projection, whose output nothing saves."""
    d, h, g, dh, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                         cfg.d_ff, cfg.vocab)
    per_tok = cfg.n_layers * 2 * (d * h * dh * 2 + 2 * d * g * dh
                                  + 3 * d * f + 2 * SEQ * h * dh) + 2 * d * v
    fwd = BATCH * SEQ * per_tok
    if kind == "prefill":
        return fwd
    layers = fwd - BATCH * SEQ * 2 * d * v
    remat = layers - BATCH * SEQ * cfg.n_layers * 2 * d * f
    return fwd + remat + 2 * fwd


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flops_match_xla_hlo_analysis(one_device, kind):
    """Both count the same products on the smoke config, exactly (a
    tolerance of zero): the port's eager count equals the hand count of
    the model's products, and so does ``analyze_hlo`` of XLA's optimized
    CPU program, which keeps every product a ``dot`` and drops the same
    dead recompute (the last layer products of the remat forward)."""
    got = one_device[kind]
    want = _dots(_cfgs()[1], kind)
    assert got["port"].flops == want
    assert got["hlo"].flops == want
    assert got["hlo"].warnings == [] and got["port"].warnings == []


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_argument_bytes_match_xla(one_device, kind):
    """The parameters (and the AdamW moments and step) and int32 tokens:
    the same bytes as XLA's program arguments."""
    got = one_device[kind]
    assert got["port"].memory["argument_bytes"] == got["xla_args"]


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

def _cells() -> list[dict]:
    """Dry-run results in both packages' key names, with different terms
    dominating."""
    cells = []
    for i, (kind, flops, nbytes, coll) in enumerate((
            ("train", 5e13, 3e12, 7e10), ("decode", 4e9, 3e9, 2e8),
            ("prefill", 1e15, 1e12, 1e9), ("decode", 1e9, 1e12, 1e5))):
        ops = {"flops": flops, "total_collective_bytes": coll,
               "hbm_bytes": nbytes}
        cells.append({
            "arch": f"a{i}", "shape": f"s{i}", "mesh": "single",
            "status": "ok", "hlo_analysis": ops, "op_analysis": ops,
            "cost_analysis": {"flops": flops / 2 if i == 0 else flops,
                              "bytes_accessed": nbytes},
            "memory_analysis": {"argument_bytes": 3e9 * (i + 1),
                                "temp_bytes": 2e9, "output_bytes": 1e9,
                                "alias_bytes": 5e8},
            "n_devices": 256, "params": 1.1e9, "active_params": 1.1e9,
            "cell": {"kind": kind, "global_batch": 128, "seq_len": 4096}})
    cells.append({"arch": "x", "shape": "long_500k", "mesh": "single",
                  "status": "skipped"})
    return cells


def test_roofline_rows_follow_the_reference_formulas():
    for cell in _cells():
        want = jroof.roofline_row(cell)
        got = roofline.roofline_row(cell)
        if want is None:
            assert got is None
            continue
        assert set(got) == set(want)
        for k in ("arch", "shape", "mesh", "kind", "model_flops_dev",
                  "hlo_flops_dev", "useful_ratio", "fit_gib"):
            assert got[k] == want[k], k
        # each time term is the reference's scaled by the ratio of the
        # constants
        assert got["t_compute"] == pytest.approx(
            want["t_compute"] * jroof.PEAK_FLOPS / roofline.PEAK_FLOPS)
        assert got["t_memory"] == pytest.approx(
            want["t_memory"] * jroof.HBM_BW / roofline.HBM_BW)
        assert got["t_collective"] == pytest.approx(
            want["t_collective"] * jroof.ICI_BW / roofline.LINK_BW)
        terms = {"compute": got["t_compute"], "memory": got["t_memory"],
                 "collective": got["t_collective"]}
        assert got["dominant"] == max(terms, key=terms.get)
        step = max(terms.values())
        assert got["roofline_frac"] == pytest.approx(
            got["model_flops_dev"] / step / roofline.PEAK_FLOPS)
        assert got["suggest"] == jroof._SUGGEST.get(
            (got["dominant"], got["kind"]), "")
    doms = {roofline.roofline_row(c)["dominant"] for c in _cells()[:4]}
    assert doms == {"compute", "memory", "collective"}
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.HBM_BYTES) == (989e12, 3.35e12, 50e9, 80e9)


def test_roofline_table_has_the_reference_columns():
    rows = [r for c in _cells() if (r := roofline.roofline_row(c))]
    got, want = roofline.markdown_table(rows), jroof.markdown_table(rows)
    assert got.splitlines()[:2] == want.splitlines()[:2]
    assert len(got.splitlines()) == len(rows) + 2
    assert all(roofline.fits(r) for r in rows)
    assert not roofline.fits(dict(rows[0], fit_gib=80e9 / 2**30))


# ---------------------------------------------------------------------------
# run_cell
# ---------------------------------------------------------------------------

def test_run_cell_tinyllama_decode_fits_the_card():
    """The reference's own dry-run cell on the (16, 16) mesh of 256 fake
    ranks: it places, runs and fits 80 GB a card."""
    res = dryrun.run_cell("tinyllama-1.1b", "decode_32k", multi_pod=False)
    assert res["status"] == "ok", res.get("error")
    assert res["n_devices"] == 256 and res["mesh"] == "single"
    ma = res["memory_analysis"]
    assert 0 < ma["argument_bytes"] + ma["temp_bytes"] < roofline.HBM_BYTES
    # the cache is written in place: the result aliases it
    assert ma["alias_bytes"] > 0
    assert res["op_analysis"]["flops"] > 0
    assert res["cost_analysis"]["flops"] == res["op_analysis"]["flops"]
    assert res["collectives"]["total_bytes"] == \
        res["op_analysis"]["total_collective_bytes"] > 0
    assert set(res) >= {"status", "cost_analysis", "memory_analysis",
                        "collectives", "op_analysis", "timings",
                        "n_devices", "params", "active_params", "cell"}
    row = roofline.roofline_row(res)
    assert roofline.fits(row) and row["kind"] == "decode"


def test_run_cell_skips_long_context_on_full_attention():
    res = dryrun.run_cell("tinyllama-1.1b", "long_500k", multi_pod=False)
    assert res["status"] == "skipped" and "full-attention" in res["reason"]


def test_reference_compression_check():
    """The reference's own check (``tests/test_sharding_and_dryrun.py``):
    on an (8,) ("data",) mesh, a tiny model's coreset-compressed DP step
    moves fewer collective bytes in all than the dense step's all-reduce."""
    cfg = ModelConfig(name="t", vocab=256, d_model=64, n_layers=2,
                      n_heads=4, n_kv=2, d_ff=256, dtype=torch.float32)
    cell = ShapeCell("t", "train", 64, 16)
    with dryrun.fake_group(8):
        mesh = _mesh((8,), ("data",))
        stats = {}
        for compress in (False, True):
            step, args = dryrun.build_step(
                "t", cell, mesh, rules=shd.DP_TP_RULES, cfg=cfg,
                hyper=TrainHyper(), compress=compress,
                compression=CompressionConfig(topk_ratio=1 / 64,
                                              min_size=1024))
            stats[compress] = analyze_step(step, *args)
    dense_ar = stats[False].collective_bytes["all-reduce"]
    assert stats[True].total_collective_bytes < dense_ar
    assert np.isfinite(dense_ar) and dense_ar > 0
