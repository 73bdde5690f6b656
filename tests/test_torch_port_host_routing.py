"""Host routing, the native data library and the port's bench, on the CPU.

The port's own binding of native/ffdata against numpy; `compute_routes`
against the JAX package's (the same stable order) and against the port's
device-side `sort_rows`; host-routed training against the JAX package's
host-routed training (its Pallas update kernels interpreted, as
tests/test_packed_update.py runs them) from carried weights; the shuffled
loader against the JAX loader; the port's bench at a tiny size. The CUDA
cases (host-routed against device-sorted bit for bit, on the card) are in
tests/test_torch_port_cuda.py.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.data.loader import DataLoader as RefLoader
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch import bench as port_bench
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.data import loader as port_loader
from dlrm_flexflow_tpu_torch.data import native_batcher as nb
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm
from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update, sort_rows

REPO = Path(__file__).resolve().parents[1]
BF16_STEP = 2.0**-7


# ----------------------------------------------------------------- the ffdata binding


@pytest.mark.parametrize("t, k, hi", [(3, 1000, 50), (1, 65536, 10_131_227), (4, 257, 2**40), (2, 0, 1)])
def test_argsort_is_numpys_stable_argsort(t, k, hi):
    keys = np.random.default_rng(k).integers(0, hi, (t, k))
    want = np.argsort(keys, axis=1, kind="stable").astype(np.int32)
    got = nb.argsort_i64_batch(keys)
    assert got.dtype == np.int32 and got.shape == (t, k)
    np.testing.assert_array_equal(got, want)
    if k:
        np.testing.assert_array_equal(nb.argsort_i64(keys[0]), want[0])


def test_argsort_refuses_negative_keys():
    with pytest.raises(ValueError, match="keys >= 0"):
        nb.argsort_i64(np.array([3, -1, 2]))


def test_gather_batch_is_numpys_take():
    rng = np.random.default_rng(0)
    n = 5000  # above the library's 4096-row threshold for its threads
    arrays = [rng.integers(0, 10**9, n), rng.standard_normal((n, 13)).astype(np.float32),
              rng.integers(0, 100, (n, 3)).astype(np.int32), rng.integers(0, 255, (n, 3)).astype(np.uint8)]
    idx = rng.permutation(n)[:4500]
    outs = nb.gather_batch(arrays, idx)
    for a, o in zip(arrays, outs):
        np.testing.assert_array_equal(o, a[idx])
    mine = [np.empty((4500,) + a.shape[1:], a.dtype) for a in arrays]
    assert all(o is m for o, m in zip(nb.gather_batch(arrays, idx, mine), mine))
    with pytest.raises(IndexError):
        nb.gather_batch(arrays, np.array([0, n]))
    with pytest.raises(ValueError):
        nb.gather_batch(arrays[:1], idx, [np.empty(4500, np.int32)])


def test_scatter_add_drops_rows_outside_the_table():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 4)).astype(np.float32)
    idx = np.array([1, 1, 49, -1, 50, 7, 1])
    g = rng.standard_normal((7, 4)).astype(np.float32)
    want = table.copy()
    keep = (idx >= 0) & (idx < 50)
    np.add.at(want, idx[keep], np.float32(0.5) * g[keep])
    nb.scatter_add_f32(table, idx, g, scale=0.5)
    np.testing.assert_allclose(table, want, rtol=1e-6, atol=1e-7)


def test_the_library_builds_into_the_ports_directory_and_raises_when_it_cannot(tmp_path, monkeypatch):
    path = nb.library_path()
    assert path.parent == REPO / "build" / "host" and (REPO / "native") not in path.parents
    assert nb.available() and path.is_file()
    # the shared source, unchanged, with native/Makefile's flags
    assert nb.SOURCE == REPO / "native" / "ffdata" / "ffdata.cc"
    assert set(nb.CXX_FLAGS) == {"-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"}
    bad = tmp_path / "ffdata.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nb, "SOURCE", bad)
    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nb.get_lib()
    assert not nb.available()
    # the shuffled loader gathers through the binding: no numpy fallback
    feeds = {"x": np.arange(64).reshape(32, 2)}
    loader = port_loader.DataLoader(feeds, np.zeros((32, 1), np.float32), 8, shuffle=True)
    with pytest.raises(RuntimeError, match="ffdata"):
        next(loader.epoch())
    assert not list((tmp_path / "host").glob("*.tmp"))


# ----------------------------------------------------------------- routes


def _small_cfg(pkg):
    """tests/test_packed_update.py::_small_dlrm: 3 tables on the route."""
    return pkg.DLRMConfig(sparse_feature_size=16, embedding_size=[500, 300, 800],
                          embedding_bag_size=2, mlp_bot=[4, 16, 16], mlp_top=[64, 16, 1],
                          batch_size=32)


def _edge_feeds(cfg, n, seed):
    """Feeds with padding (-1) and indices >= V in the route tables."""
    feeds, labels = ref_synthetic.random_batches(cfg, n, seed=seed)
    feeds["sparse_0"][:5, 1] = -1
    feeds["sparse_1"][3:9, 0] = 300 + np.arange(6)
    feeds["sparse_2"][::7, :] = -1
    return feeds, labels


def _pair(ffkw, opt, sparse_opt=None):
    """A JAX model and a port model (CPU) compiled alike, the port carrying
    the JAX model's weights. opt: (class name, args)."""
    rm = ref_dlrm.make_dlrm_model(_small_cfg(ref_dlrm), ref.FFConfig(**ffkw))
    rm.compile(getattr(ref, opt[0])(**opt[1]), ref.LossType.LOSS_BINARY_CROSSENTROPY,
               [ref.MetricsType.METRICS_ACCURACY])
    pm = port_dlrm.make_dlrm_model(_small_cfg(port_dlrm), port.FFConfig(**ffkw), device="cpu")
    pm.compile(getattr(port, opt[0])(**opt[1]), port.LossType.LOSS_BINARY_CROSSENTROPY,
               [port.MetricsType.METRICS_ACCURACY])
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    return rm, pm


ROUTED = dict(batch_size=32, compute_dtype="float32", onehot_embedding_threshold=0, packed_tables="on",
              host_routing=True)


def test_compute_routes_order_equals_the_jax_packages():
    rm, pm = _pair(ROUTED, ("SGDOptimizer", dict(lr=0.05)))
    assert [op.name for op in rm._route_ops] == [op.name for op in pm._sparse_ops if op.kernel_route]
    feeds, _ = _edge_feeds(_small_cfg(ref_dlrm), 32, seed=2)
    want, got = rm.compute_routes(feeds), pm.compute_routes(feeds)
    assert set(got) == {f"_route:table_{i}:{f}" for i in range(3) for f in ("order", "rows")}
    for op in rm._route_ops:
        order = got[f"_route:{op.name}:order"]
        np.testing.assert_array_equal(order, np.asarray(want[f"_route:{op.name}:order"]))
        rows = feeds[op.inputs[0].owner_op.name].reshape(-1)
        keys = np.where((rows >= 0) & (rows < op.num_entries), rows, op.num_entries)
        np.testing.assert_array_equal(got[f"_route:{op.name}:rows"], keys[order])
        assert order.dtype == got[f"_route:{op.name}:rows"].dtype == np.int32


def test_compute_routes_equals_sort_rows():
    """The host's stable radix sort and torch's stable sort of the same keys
    give the same order and the same sorted rows; tensors as feeds too."""
    _, pm = _pair(ROUTED, ("SGDOptimizer", dict(lr=0.05)))
    feeds, _ = _edge_feeds(_small_cfg(ref_dlrm), 32, seed=3)
    ops = [op for op in pm._sparse_ops if op.kernel_route]
    tables = [pm.get_parameters()[op.name]["weight"] for op in ops]
    rs, order = sort_rows(tables, [torch.from_numpy(feeds[op.inputs[0].owner_op.name]).reshape(-1)
                                   for op in ops])
    for got in (pm.compute_routes(feeds), pm.compute_routes(pm._stage(feeds))):
        for i, op in enumerate(ops):
            np.testing.assert_array_equal(got[f"_route:{op.name}:order"], order[i].numpy())
            np.testing.assert_array_equal(got[f"_route:{op.name}:rows"], rs[i].numpy())
    staged = pm.stage_routes(pm.compute_routes(feeds))
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in staged.values())
    assert all(pm.stage_routes(staged)[k] is t for k, t in staged.items())


@pytest.mark.parametrize("opt", [("SGDOptimizer", dict(lr=0.05)), ("AdamOptimizer", dict(alpha=0.01))],
                         ids=["sgd", "adam"])
def test_host_routed_training_matches_the_jax_packages(opt):
    """tests/test_packed_update.py:379's host-routed model, f32, bags of 2,
    padding and indices >= V: 3 steps from carried weights on both sides,
    the JAX update kernels interpreted."""
    rm, pm = _pair(ROUTED, opt)
    assert rm._route_ops and all(op.kernel_route for op in pm._sparse_ops)
    feeds, labels = _edge_feeds(_small_cfg(ref_dlrm), 96, seed=9)
    calls = sort_rows.calls
    losses = {"ref": [], "port": []}
    for i in range(3):
        sl = slice(32 * i, 32 * (i + 1))
        batch = {k: v[sl] for k, v in feeds.items()}
        losses["ref"].append(float(rm.train_batch(batch, labels[sl])))
        losses["port"].append(float(pm.train_batch(batch, labels[sl])))
    assert sort_rows.calls == calls
    # the same f32 operations in another summation order, as
    # tests/test_torch_port_training.py's and test_torch_port_sparse_optim.py's
    # whole-model tests state them
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5, atol=1e-6)
    atol = 1e-6 if opt[0] == "SGDOptimizer" else 3 * 3.2 * 0.01  # Adam: 3.2 alpha a step
    for op in rm.get_parameters():
        for k, want in rm.get_weights(op).items():
            err = np.abs(pm.get_weights(op)[k] - np.asarray(want, np.float32))
            assert err.max() <= atol, (op, k, err.max())
            assert np.mean(err <= 1e-6) >= 0.99, (op, k)


def test_train_batch_uses_routes_given_with_the_batch_and_equals_computing_them(monkeypatch):
    a = port_dlrm.make_dlrm_model(_small_cfg(port_dlrm), port.FFConfig(**ROUTED), device="cpu")
    b = port_dlrm.make_dlrm_model(_small_cfg(port_dlrm), port.FFConfig(**ROUTED), device="cpu")
    for m in (a, b):
        m.compile(port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, labels = _edge_feeds(_small_cfg(ref_dlrm), 64, seed=4)
    for i in range(2):
        sl = slice(32 * i, 32 * (i + 1))
        batch = {k: v[sl] for k, v in feeds.items()}
        given = {**a._stage(batch), **a.stage_routes(a.compute_routes(batch))} if i else \
            {**batch, **a.compute_routes(batch)}
        with monkeypatch.context() as mp:
            mp.setattr(a, "compute_routes", lambda f: pytest.fail("routes recomputed"))
            la = a.train_batch(given, labels[sl])
        lb = b.train_batch(batch, labels[sl])
        assert float(la) == float(lb)
    for op in a.get_parameters():
        for k, w in a.get_weights(op).items():
            np.testing.assert_array_equal(w, b.get_weights(op)[k])


def test_a_route_of_another_batch_size_raises():
    m = port_dlrm.make_dlrm_model(_small_cfg(port_dlrm), port.FFConfig(**ROUTED), device="cpu")
    m.compile(port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, labels = _edge_feeds(_small_cfg(ref_dlrm), 48, seed=5)
    batch = {k: v[:32] for k, v in feeds.items()}
    wrong = m.compute_routes({k: v[16:48] if k.startswith("dense") else v[:16] for k, v in feeds.items()})
    with pytest.raises(ValueError, match="route"):
        m.train_batch({**batch, **wrong}, labels[:32])
    t = torch.zeros((10, 4))
    rows = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        row_update([t], [rows], [torch.ones((3, 4))], torch.tensor(1.0),
                   routes=[(rows.long(), torch.arange(3, dtype=torch.int32))])


def test_fit_takes_host_routing_and_sorts_nothing():
    m = port_dlrm.make_dlrm_model(_small_cfg(port_dlrm), port.FFConfig(**ROUTED), device="cpu")
    m.compile(port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY,
              [port.MetricsType.METRICS_ACCURACY])
    feeds, labels = _edge_feeds(_small_cfg(ref_dlrm), 96, seed=6)
    calls, computed = sort_rows.calls, []
    compute = m.compute_routes
    m.compute_routes = lambda f: computed.append(1) or compute(f)
    hist = m.fit(feeds, labels, epochs=1, verbose=False, shuffle=True)
    assert np.isfinite(hist["accuracy"]) and len(computed) == 3 and sort_rows.calls == calls


# ----------------------------------------------------------------- the loader


def test_shuffled_loader_and_stacked_epoch_give_the_jax_loaders_batches(monkeypatch):
    feeds, labels = ref_synthetic.random_batches(_small_cfg(ref_dlrm), 100, seed=1)
    gathered = []
    gather = port_loader.gather_batch
    monkeypatch.setattr(port_loader, "gather_batch", lambda a, i: gathered.append(1) or gather(a, i))
    r = RefLoader(feeds, labels, 16, shuffle=True, seed=4)
    p = port_loader.DataLoader(feeds, labels, 16, shuffle=True, seed=4)
    for _ in range(2):
        for (rf, rl), (pf, plb) in zip(r.epoch(), p.epoch()):
            np.testing.assert_array_equal(plb, rl)
            for k in rf:
                np.testing.assert_array_equal(pf[k], rf[k])
    assert len(gathered) == 2 * p.steps_per_epoch == 12
    for shuffle in (False, True):
        r = RefLoader(feeds, labels, 16, shuffle=shuffle, seed=7)
        p = port_loader.DataLoader(feeds, labels, 16, shuffle=shuffle, seed=7)
        got, want = list(p.stacked_epoch(4)), list(r.stacked_epoch(4))
        assert [lbl.shape for _, lbl in got] == [(4, 16, 1), (2, 16, 1)]
        for (pf, plb), (rf, rl) in zip(got, want):
            np.testing.assert_array_equal(plb, rl)
            for k in rf:
                np.testing.assert_array_equal(pf[k], rf[k])


# ----------------------------------------------------------------- the bench


TINY = ["--device", "cpu", "--config", "tiny", "--batch-size", "64", "--quick"]


@pytest.mark.parametrize("extra, engaged", [(["--packed-tables", "on"], True), ([], False),
                                            (["--mode", "infer"], False),
                                            (["--packed-tables", "on", "--no-host-routing", "--optimizer",
                                              "adam"], True)],
                         ids=["train-routed", "train-auto", "infer", "adam-device-sorted"])
def test_bench_prints_bench_py_keys(capsys, extra, engaged):
    calls = sort_rows.calls
    port_bench.main(TINY + extra)
    captured = capsys.readouterr()
    res = json.loads(captured.out.strip().splitlines()[-1])
    assert set(res) == {"metric", "value", "unit", "examples_per_sec_per_chip", "devices", "table_dtype",
                        "packed_engaged", "loss"}
    assert res["packed_engaged"] is engaged and res["devices"] == 1 and res["unit"] == "examples/s"
    assert np.isfinite(res["value"]) and res["value"] > 0 and np.isfinite(res["loss"])
    assert res["table_dtype"] == ("bfloat16" if engaged else "float32")
    assert "# config=tiny" in captured.err and "device=cpu" in captured.err
    assert sort_rows.calls == calls  # the CPU's plain update sorts nothing


@pytest.mark.parametrize("flags, item", [(["--mesh"], "more than one rank")])
def test_bench_raises_for_what_the_port_has_not(flags, item):
    """--mesh in a world of one (no launcher) is refused, as the JAX bench
    takes the mesh only with more than one device; the group it joined is
    left again."""
    with pytest.raises(ValueError, match=item):
        port_bench.main(TINY + flags)
    assert not torch.distributed.is_initialized()


def test_bench_trains_mlperf_full_under_host_tail_offload(capsys):
    """--config mlperf-full at a cut batch (64) and hot prefix (4096 rows,
    where the card keeps 2^20; the 15 tables above it go to the host):
    eager steps, bench.py's host-tail keys, Zipf ids by default."""
    port_bench.main(["--device", "cpu", "--config", "mlperf-full", "--batch-size", "64", "--quick",
                     "--host-tail-threshold", "4096"])
    captured = capsys.readouterr()
    res = json.loads(captured.out.strip().splitlines()[-1])
    assert set(res) == {"metric", "value", "unit", "examples_per_sec_per_chip", "host_tail_tables",
                        "host_tail_touched_rows", "host_tail_drop_fraction", "devices", "table_dtype",
                        "packed_engaged", "loss"}
    assert res["metric"] == "dlrm_mlperf-full_train_examples_per_sec" and res["host_tail_tables"] == 15
    assert res["host_tail_touched_rows"] > 0 and 0.0 <= res["host_tail_drop_fraction"] < 1.0
    assert np.isfinite(res["value"]) and res["value"] > 0 and np.isfinite(res["loss"])
    assert "steps=eager" in captured.err and "host-tail tables=15" in captured.err
    with pytest.raises(SystemExit):
        port_bench.main(["--device", "cpu", "--config", "mlperf-full", "--mode", "infer"])


def test_bench_takes_the_mid_band_threshold(capsys):
    """--onehot-packed-threshold: the tiny config's 100000-row tables become
    mid-band (dense gradients, no row-update route)."""
    port_bench.main(TINY + ["--onehot-packed-threshold", "200000"])
    captured = capsys.readouterr()
    res = json.loads(captured.out.strip().splitlines()[-1])
    assert set(res) == {"metric", "value", "unit", "examples_per_sec_per_chip", "devices", "table_dtype",
                        "packed_engaged", "loss"}
    assert res["packed_engaged"] is False and np.isfinite(res["loss"]) and res["value"] > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int8"])
def test_bench_serves_quantized_tables(capsys, dtype):
    """--mode infer --table-dtype quantizes after staging, as bench.py does,
    and says so; serving steps are eager."""
    port_bench.main(TINY + ["--mode", "infer", "--table-dtype", dtype])
    captured = capsys.readouterr()
    res = json.loads(captured.out.strip().splitlines()[-1])
    assert set(res) == {"metric", "value", "unit", "examples_per_sec_per_chip", "devices", "table_dtype",
                        "packed_engaged", "loss"}
    assert res["table_dtype"] == dtype and res["loss"] == 0.0 and np.isfinite(res["value"]) and res["value"] > 0
    assert f"# quantized 8 embedding arrays to {dtype}" in captured.err
    assert "steps=eager" in captured.err


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import dlrm_flexflow_tpu_torch.data.native_batcher, dlrm_flexflow_tpu_torch.bench\n"
        "import dlrm_flexflow_tpu_torch.tools.bench_gather_probe\n"
        "import dlrm_flexflow_tpu_torch.ops.kernels.row_gather\n"
        "import dlrm_flexflow_tpu_torch.training.checkpoint, dlrm_flexflow_tpu_torch.training.callbacks\n"
        "import dlrm_flexflow_tpu_torch.data.criteo, dlrm_flexflow_tpu_torch.tools.graph_nodes\n"
        "import dlrm_flexflow_tpu_torch.parallel.host_tail, dlrm_flexflow_tpu_torch.parallel.passes\n"
        "import dlrm_flexflow_tpu_torch.training.host_offload\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dlrm_flexflow_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout
