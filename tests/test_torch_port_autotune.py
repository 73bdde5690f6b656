"""The port's strategy search and machine model against the JAX package's.

On the CPU at small sizes; the JAX side runs as tests/test_autotune*.py
run it (its own ffsim build, the cpu_sim preset). Every comparison but the
calibrators' is exact: the search's inputs are floats from each op's
`cost_stats`, computed in the same order in both packages, and both
packages hand them to the same native core (each its own build of
native/ffsim/ffsim.cc), so equal inputs must give equal costs and plans.
The calibrators time the port's own code, so here they run at tiny sizes
on the CPU for their plumbing only (keys, positive values, the fit's
table bytes); their numbers come from the card (chip_smoke.py).
"""
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.autotune import bindings as rb
from dlrm_flexflow_tpu.autotune import machine as rmach
from dlrm_flexflow_tpu.autotune import search as rsearch
from dlrm_flexflow_tpu.models import dlrm as rdlrm
from dlrm_flexflow_tpu.models import zoo as rzoo
from dlrm_flexflow_tpu.parallel.passes import fuse_embedding_tables as ref_fuse
from dlrm_flexflow_tpu.parallel.plan import dlrm_hybrid_plan as ref_hybrid_plan

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.autotune import bindings as pb
from dlrm_flexflow_tpu_torch.autotune import machine as pmach
from dlrm_flexflow_tpu_torch.autotune import search as psearch
from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
from dlrm_flexflow_tpu_torch.models import zoo as pzoo
from dlrm_flexflow_tpu_torch.parallel.passes import fuse_embedding_tables as port_fuse
from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan as port_hybrid_plan

REPO = Path(__file__).resolve().parent.parent
VOCAB_CAP = 5000
DLRM_CONFIGS = ["tiny_config", "kaggle_config", "mlperf_config", "mlperf_lite_config", "summit_config",
                "summit_large_config"]


def _dlrm_pair(name, batch=256, cap=VOCAB_CAP):
    jc, pc = getattr(rdlrm, name)(batch_size=batch), getattr(pdlrm, name)(batch_size=batch)
    jc.embedding_size = [min(v, cap) for v in jc.embedding_size]
    pc.embedding_size = list(jc.embedding_size)
    return (rdlrm.make_dlrm_model(jc, ref.FFConfig(batch_size=batch)),
            pdlrm.make_dlrm_model(pc, port.FFConfig(batch_size=batch), device="cpu"))


ZOO_SMALL = {
    "mnist_mlp": dict(batch_size=16),
    "moe_mlp": dict(batch_size=16, in_dim=32, num_classes=10),
    "transformer": dict(batch_size=2, seq_len=16, hidden=32, num_heads=4, num_layers=2),
    "candle_uno": dict(batch_size=16, dense_layers=(64, 32), dense_feature_layers=(48, 24),
                       feature_shapes={"dose": 1, "cell.rnaseq": 94, "drug.descriptors": 527,
                                       "drug.fingerprints": 204}),
    "bert_proxy": dict(batch_size=2, seq_length=16, hidden=64, num_heads=4, num_layers=2),
    "mnist_cnn": dict(batch_size=4),
    "cifar10_cnn": dict(batch_size=4),
    "alexnet": dict(batch_size=2),
    "resnet": dict(batch_size=2),
    "inception_v3": dict(batch_size=2),
    "nmt": dict(batch_size=4, src_len=6, dst_len=5, hidden_size=32, embed_size=24, vocab_size=50),
}


def _zoo_pair(name):
    kw = ZOO_SMALL[name]
    return getattr(rzoo, name)(**kw), getattr(pzoo, name)(**kw, device="cpu")


def _stats(model):
    return [(op.name, type(op).__name__, op.cost_stats()) for op in model.graph.compute_ops]


# ------------------------------------------------------------------ cost_stats


@pytest.mark.parametrize("name", DLRM_CONFIGS)
def test_cost_stats_of_every_dlrm_op_equal_jax(name):
    """Every op of each DLRM config (vocabs capped at 5000), and the fused
    collection of its tables over 4 shards: the JAX package's floats,
    exactly."""
    jm, pm = _dlrm_pair(name)
    assert _stats(pm) == _stats(jm)
    jc = ref_fuse(jm.graph, ref_hybrid_plan(), 4, min_vocab=100)
    pc = port_fuse(pm.graph, port_hybrid_plan(), 4, min_vocab=100, shard=0)
    assert pc.cost_stats() == jc.cost_stats() and pc.cost_stats()["param_bytes"] > 0


@pytest.mark.parametrize("name", sorted(ZOO_SMALL))
def test_cost_stats_of_every_zoo_op_equal_jax(name):
    """Every op of each zoo model at small widths (conv, pool, batch norm,
    LSTM, attention, batch-matmul, MoE, the elementwise and shape ops on
    the base class's default): the JAX package's floats, exactly."""
    jm, pm = _zoo_pair(name)
    assert _stats(pm) == _stats(jm)


def test_op_cost_signatures_equal_jax():
    """The measured-cost table's keys (`op_cost_sig`) of the conv, LSTM,
    attention and batch-matmul ops are the JAX package's strings, so a
    machine file's op_costs apply in either package."""
    for name in ("resnet", "nmt", "transformer", "bert_proxy"):
        jm, pm = _zoo_pair(name)
        want = [rmach.op_cost_sig(op) for op in rmach.measurable_graph_ops(jm.graph)]
        assert want and [pmach.op_cost_sig(op) for op in pmach.measurable_graph_ops(pm.graph)] == want
        assert pmach.graph_dense_shapes(pm.graph) == rmach.graph_dense_shapes(jm.graph)


# ------------------------------------------------------------------ cost specs and the native core


@pytest.fixture(scope="module")
def spec_pairs():
    out = {n: _dlrm_pair(n) for n in ("kaggle_config", "mlperf_lite_config")}
    out.update({n: _zoo_pair(n) for n in ("moe_mlp", "transformer", "mnist_cnn")})
    return out


@pytest.mark.parametrize("name", ["kaggle_config", "mlperf_lite_config", "moe_mlp", "transformer", "mnist_cnn"])
def test_cost_specs_equal_jax(spec_pairs, name):
    """graph_to_cost_spec (placed and min_vocab-replicated tables, a split)
    and graph_to_cost_spec_v2 (bf16 tables, measured dense and op costs
    from one machine's tables, a host-tail candidate): dict for dict."""
    jm, pm = spec_pairs[name]
    for kw in (dict(), dict(min_vocab=1000), dict(exchange_dtype_bytes=2.0)):
        assert psearch.graph_to_cost_spec(pm.graph, 1024, **kw) == rsearch.graph_to_cost_spec(jm.graph, 1024, **kw)
    n_placed = len([v for v in rsearch.iter_embedding_vocabs(jm.graph) if v > 1000])
    if n_placed:
        split = [2] * n_placed
        assert (psearch.graph_to_cost_spec(pm.graph, 1024, split, min_vocab=1000)
                == rsearch.graph_to_cost_spec(jm.graph, 1024, split, min_vocab=1000))
    dense = {f"{a}x{b}": 0.01 for a, b in rmach.graph_dense_shapes(jm.graph)}
    ops = {rmach.op_cost_sig(op): 0.02 for op in rmach.measurable_graph_ops(jm.graph)}
    kw = dict(exchange_dtype_bytes=2.0, dense_costs=dense, op_costs=ops, host_tail_hot=512, table_dtype_bytes=2.0)
    assert psearch.graph_to_cost_spec_v2(pm.graph, 1024, **kw) == rsearch.graph_to_cost_spec_v2(jm.graph, 1024, **kw)


def test_struct_fields_equal_jax():
    """FFSimMachine and FFSimOp: the JAX package's fields, names, types and
    order (native/ffsim/ffsim.h)."""
    assert pb.FFSimMachine._fields_ == rb.FFSimMachine._fields_
    assert pb.FFSimOp._fields_ == rb.FFSimOp._fields_
    assert ctypes.sizeof(pb.FFSimMachine) == ctypes.sizeof(rb.FFSimMachine)


def test_native_functions_equal_jax(spec_pairs):
    """simulate, breakdown, mcmc_search, simulate2 and breakdown2 (staged and
    on the task DAG), search2, wire_bytes and schedule_dag: equal to the
    JAX bindings' on the same inputs."""
    jm, pm = spec_pairs["kaggle_config"]
    ops, names = rsearch.graph_to_cost_spec(jm.graph, 4096, min_vocab=1000)
    jmach = rmach.preset("cpu_sim", 4).torus_for(4)
    pmach_ = pmach.preset("cpu_sim", 4).torus_for(4)
    a, b = jmach.to_native(), pmach_.to_native()
    owner = [i % 4 for i in range(len(names))]
    assert pb.simulate(b, ops, owner, 1.0) == rb.simulate(a, ops, owner, 1.0)
    assert pb.breakdown(b, ops, owner) == rb.breakdown(a, ops, owner)
    assert (pb.mcmc_search(b, ops, owner, budget=400, seed=7)
            == rb.mcmc_search(a, ops, owner, budget=400, seed=7))
    ops2, tnames, vocabs, nd, edges, _, op_edges = rsearch.graph_to_cost_spec_v2(jm.graph, 4096)
    nt = len(vocabs)
    state = ([i % 4 for i in range(nt)], [1] * nt, [0] * nt, [1] * nd)
    for oe in ((), op_edges):
        assert (pb.simulate2(b, ops2, *state, 1.0, op_edges=oe)
                == rb.simulate2(a, ops2, *state, 1.0, op_edges=oe))
        assert pb.breakdown2(b, ops2, *state, op_edges=oe) == rb.breakdown2(a, ops2, *state, op_edges=oe)
        assert (pb.search2(b, ops2, *state, vocabs, edges, budget=300, seed=3, split_cap=4, op_edges=oe)
                == rb.search2(a, ops2, *state, vocabs, edges, budget=300, seed=3, split_cap=4, op_edges=oe))
    assert pb.wire_bytes(b, ops2, *state[:3]) == rb.wire_bytes(a, ops2, *state[:3])
    dag = ([1.0, 2.0, 3.0, 0.5], [0, 1, 0, 1], [(0, 2), (1, 2), (2, 3)])
    assert pb.schedule_dag(2, *dag) == rb.schedule_dag(2, *dag)


@pytest.mark.parametrize("name", ["kaggle_config", "mlperf_lite_config"])
def test_autotune_plans_equal_jax(spec_pairs, name):
    """autotune_plan (with the split search) and autotune_plan_joint, one
    seed, budget and machine (preset("cpu_sim", 4).torus_for(4)): the same
    owner, cost and report."""
    jm, pm = spec_pairs[name]
    jmach, pmach_ = rmach.preset("cpu_sim", 4).torus_for(4), pmach.preset("cpu_sim", 4).torus_for(4)
    kw = dict(budget=400, seed=5, min_vocab=1000, opt_state_factor=1.0)
    assert (psearch.autotune_plan(pm.graph, pmach_, 4096, search_splits=True, **kw)
            == rsearch.autotune_plan(jm.graph, jmach, 4096, search_splits=True, **kw))
    got = psearch.autotune_plan_joint(pm.graph, pmach_, 4096, exchange_dtype_bytes=2.0, table_dtype_bytes=2.0, **kw)
    assert got == rsearch.autotune_plan_joint(jm.graph, jmach, 4096, exchange_dtype_bytes=2.0,
                                              table_dtype_bytes=2.0, **kw)
    assert got[0] and got[2]["best_us"] > 0


def test_chunk_helpers_equal_jax():
    """The port's copies of the JAX package's pure `rows_per_pack` and
    `pick_chunk_packs` (the selective-update term of the cost spec)."""
    from dlrm_flexflow_tpu.ops.pallas import packed_update as pu

    for d in (1, 4, 16, 32, 128):
        assert psearch.rows_per_pack(d) == pu.rows_per_pack(d)
        for v, k in ((100, 8), (10_131_227, 65536), (2_000_000, 16384), (7, 1)):
            assert psearch.pick_chunk_packs(v, d, k) == pu.pick_chunk_packs(v, d, k)


# ------------------------------------------------------------------ the machine model


def test_jax_saved_machine_file_loads_and_saves_back(tmp_path):
    """A machine file the JAX package saved (a calibrated one, with dense
    and op costs, mode maps and a residual) loads in the port field for
    field and saves back to the same document; so does the JAX package's
    own TPU calibration, the root .ffsim_machine.json."""
    spec = dataclasses.replace(rmach.preset("tpu_v5p", 8).torus_for(8), dense_costs={"13x512": 0.01},
                               op_costs={"OP_CONV2D|a|b|c|": 0.3}, gather_mode="subpack",
                               gather_mode_by_dim={"32": "subpack"}, stream_mode_by_dim={"16": "compact"},
                               step_residual=1.7)
    spec.save(str(tmp_path / "jax.json"))
    got = pmach.MachineSpec.from_file(str(tmp_path / "jax.json"))
    assert dataclasses.asdict(got) == dataclasses.asdict(spec)
    got.save(str(tmp_path / "port.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    root = pmach.MachineSpec.from_file(str(REPO / ".ffsim_machine.json"))
    assert dataclasses.asdict(root) == dataclasses.asdict(rmach.MachineSpec.from_file(str(REPO / ".ffsim_machine.json")))
    assert [getattr(root.to_native(), f) for f, _ in pb.FFSimMachine._fields_] == [
        getattr(rmach.MachineSpec.from_file(str(REPO / ".ffsim_machine.json")).to_native(), f)
        for f, _ in rb.FFSimMachine._fields_]


def test_presets_equal_jax_and_the_h100_preset():
    """Every JAX preset in the port, field for field; "h100" carries the data
    sheet's figures and maps a host's cards to the native model's ring."""
    for name in ("tpu_v5e", "tpu_v5p", "tpu_v4", "cpu_sim"):
        assert dataclasses.asdict(pmach.preset(name, 4, 2)) == dataclasses.asdict(rmach.preset(name, 4, 2))
        assert (dataclasses.asdict(pmach.preset(name, 8).torus_for(8))
                == dataclasses.asdict(rmach.preset(name, 8).torus_for(8)))
    h = pmach.preset("h100", 4, 4).nvswitch_for(4)
    assert (h.mxu_tflops, h.hbm_gbps, h.hbm_capacity_gb, h.ici_gbps) == (989.0, 3350.0, 80.0, 450.0)
    assert (h.num_chips, h.ici_axis_x, h.ici_axis_y, h.ici_domain, h.chips_per_host) == (4, 4, 1, 4, 4)
    assert pb.simulate2(h.to_native(), [{"kind": pb.KIND_DENSE, "flops": 1e9, "stage": 0}], [], [], [], [1]) > 0


def test_solve_update_model4_equals_jax():
    for args in ((1e-3, 2e-3, 3.5e-3, 2.2e-3, 16384, 65536, 4, 8, 64e6, 256e6),
                 (1e-4, 1.1e-4, 1.5e-4, 1.0e-4, 16384, 65536, 4, 8, 32e6, 128e6),
                 (5e-5, 4e-5, 6e-5, 7e-5, 16384, 65536, 4, 8, 32e6, 128e6)):
        assert pmach.solve_update_model4(*args) == rmach.solve_update_model4(*args)


def test_calibrate_or_cached_loads_the_cache_with_the_specs_topology(tmp_path):
    """A cached machine file is loaded (no calibration runs) with the given
    spec's chip count, host grouping, torus and model axis, as the JAX
    package's calibrate_or_cached does."""
    cache = tmp_path / "m.json"
    pmach.MachineSpec(name="h100", gather_gbps=123.0, update_ns_per_row=0.7, step_residual=1.3).save(str(cache))
    spec = pmach.preset("cpu_sim", 4, 2).torus_for(4)
    spec.model_axis = 2
    got = pmach.calibrate_or_cached(spec, str(cache), device="cpu")
    want = rmach.calibrate_or_cached(dataclasses.replace(rmach.preset("cpu_sim", 4, 2).torus_for(4), model_axis=2),
                                     str(cache))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.gather_gbps, got.num_chips, got.chips_per_host, got.ici_axis_x, got.model_axis) == (123.0, 4, 2, 2, 2)


def test_machine_cache_path_is_never_the_jax_calibration(tmp_path):
    """The port's default machine file is its own under the ignored build/
    directory, never the JAX package's root .ffsim_machine.json; a machine
    file or an exported strategy moves it as in the JAX package."""
    cfg = port.FFConfig()
    default = Path(cfg.machine_cache_path())
    assert default == REPO / "build" / "ffsim_machine_h100.json"
    assert default.name != ".ffsim_machine.json" and ref.FFConfig().machine_cache_path() == ".ffsim_machine.json"
    assert port.FFConfig(export_strategy_file="s.json").machine_cache_path() == "s.json.machine.json"
    assert port.FFConfig(machine_model_file="m.json").machine_cache_path() == "m.json"
    assert "/build/" in (REPO / ".gitignore").read_text()


def test_mode_fields_round_trip_and_select_nothing_by_design(tmp_path):
    """Difference by design: the JAX package's gather and stream mode
    winners (`gather_mode`, `stream_mode`, `*_by_dim`) choose between two
    Pallas variants; the port has one kernel for each, keeps the fields so
    a file round-trips, and nothing of the port reads them: no setter
    exists, and the search's result does not move with them."""
    import dlrm_flexflow_tpu_torch.ops.kernels.row_update as ru

    assert not any(hasattr(ru, f) for f in ("set_gather_mode", "set_stream_mode"))
    src = "".join(p.read_text() for p in (REPO / "dlrm_flexflow_tpu_torch").rglob("*.py")
                  if p.name != "machine.py")
    assert not re.search(r"\.(gather|stream)_mode\b|_mode_by_dim", src)
    jm, pm = _dlrm_pair("kaggle_config")
    base = pmach.preset("cpu_sim", 4).torus_for(4)
    other = dataclasses.replace(base, gather_mode="subpack", stream_mode="compact",
                                gather_mode_by_dim={"16": "subpack"}, stream_mode_by_dim={"16": "compact"})
    kw = dict(budget=200, seed=1, min_vocab=1000)
    assert psearch.autotune_plan_joint(pm.graph, base, 4096, **kw) == psearch.autotune_plan_joint(pm.graph, other,
                                                                                                   4096, **kw)


# ------------------------------------------------------------------ the calibrators (plumbing, on the CPU)


def test_calibrators_run_on_the_cpu_at_tiny_sizes(monkeypatch):
    """Each calibrator's plumbing at tiny sizes on the CPU (the numbers are
    the card's, chip_smoke.py): calibrate fills both rates, calibrate_packed
    fits the four points with the port's [V, D] table bytes at the table's
    dtype (bf16: 2 bytes an entry; the JAX package reckons its packed f32
    pools), calibrate_dense and calibrate_graph_ops fill one cost a shape
    and keep the cached ones."""
    spec = pmach.preset("h100")
    got = pmach.calibrate(spec, vocab=1000, batch=64, repeats=2, device="cpu")
    assert got.gather_gbps > 0 and got.scatter_gbps > 0 and got.gather_gbps != spec.gather_gbps
    seen = {}

    def spy(*args):
        seen["args"] = args
        return (100.0, 1.0, 2.0, 3.0)

    monkeypatch.setattr(pmach, "solve_update_model4", spy)
    got = pmach.calibrate_packed(spec, vocab=500, repeats=2, device="cpu", points=(16, 64, 2, 3))
    assert seen["args"][4:] == (16, 64, 2, 3, 500 * 16 * 2.0, 2000 * 16 * 2.0)
    assert all(m > 0 for m in seen["args"][:4])
    assert (got.update_pass_gbps, got.update_ns_per_row, got.update_us_per_table) == (100.0, 1.0, 2.0)
    assert got.step_overhead_us == spec.step_overhead_us + 3.0
    monkeypatch.undo()
    got = pmach.calibrate_dense(dataclasses.replace(spec, dense_costs={"4x8": 9.0}), [(4, 8), (8, 2)], batch=16,
                                repeats=2, device="cpu")
    assert got.dense_costs["4x8"] == 9.0 and got.dense_costs["8x2"] > 0
    _, pm = _zoo_pair("transformer")
    got = pmach.calibrate_graph_ops(spec, pm.graph, repeats=2, device="cpu")
    assert set(got.op_costs) == {pmach.op_cost_sig(op) for op in pmach.measurable_graph_ops(pm.graph)}
    assert all(v > 0 for v in got.op_costs.values())
    assert pmach.measure_dispatch_latency(2, device="cpu") > 0


def test_physical_limits_flag_an_impossible_constant():
    """A rate above the card's memory rate, or a Dense cost below its
    shape's roofline, is flagged; the preset's own figures pass."""
    spec = pmach.preset("h100")
    assert all(r["ok"] for r in pmach.physical_limits(spec))
    bad = dataclasses.replace(spec, gather_gbps=5000.0, dense_costs={"1024x1024": 1e-6, "13x512": 0.01})
    flagged = {r["name"] for r in pmach.physical_limits(bad) if not r["ok"]}
    assert flagged == {"gather_gbps", "dense_costs[1024x1024]"}


# ------------------------------------------------------------------ the native build and the boundary


def test_ffsim_builds_into_build_host_and_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """libffsim is built from native/ffsim/ffsim.cc with native/Makefile's
    flags into build/host/, named by a hash of source, header and flags,
    never into native/build/; a source that does not compile raises
    RuntimeError with g++'s output (no fallback)."""
    path = pb.library_path()
    assert path.parent == REPO / "build" / "host" and path.name.startswith("libffsim-")
    pb.get_lib()
    assert path.exists()
    bad = tmp_path / "ffsim.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pb, "SOURCE", bad)
    monkeypatch.setattr(pb, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pb.get_lib()


def test_the_autotune_and_profiling_modules_import_no_jax():
    code = ("import sys; import dlrm_flexflow_tpu_torch.autotune.search, dlrm_flexflow_tpu_torch.autotune.machine, "
            "dlrm_flexflow_tpu_torch.utils.profiling, dlrm_flexflow_tpu_torch.examples.dlrm, "
            "dlrm_flexflow_tpu_torch.examples.host_offload_dlrm; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dlrm_flexflow_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_host_offload_example_trains_on_the_cpu():
    """The port's examples/host_offload_dlrm.py at a cut vocab: the tables
    above the threshold on the host, the rest on the device, a few SGD
    steps with finite losses."""
    from dlrm_flexflow_tpu_torch.examples import host_offload_dlrm

    got = host_offload_dlrm.main(["--device", "cpu", "--batch-size", "32", "--steps", "2", "--vocab-cap", "3000",
                                  "--offload-threshold", "2000"])
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["loss"]) and got["examples_per_s"] > 0
