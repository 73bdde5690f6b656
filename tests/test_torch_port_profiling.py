"""The port's per-op profiling and observability against the JAX package's
(tests/test_profiling.py's checks on both packages at once), and
`FFModel.calibrate_step_residual`.

Exact where the two compute the same text or the same floats (the task
graph, the report's names, types, flops and bytes, the NaN sweep's keys);
times are each package's own and only checked positive.
"""
import os

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data.synthetic import random_batches
from dlrm_flexflow_tpu.models import dlrm as rdlrm
from dlrm_flexflow_tpu.utils import profiling as rprof

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
from dlrm_flexflow_tpu_torch.utils import profiling as pprof


def _pair(name="tiny_config", batch=16, cap=3000, **ffkw):
    jc, pc = getattr(rdlrm, name)(batch_size=batch), getattr(pdlrm, name)(batch_size=batch)
    jc.embedding_size = [min(v, cap) for v in jc.embedding_size]
    pc.embedding_size = list(jc.embedding_size)
    kw = dict(batch_size=batch, compute_dtype="float32", **ffkw)
    jm = rdlrm.make_dlrm_model(jc, ref.FFConfig(**kw))
    jm.compile(ref.SGDOptimizer(lr=0.01), ref.LossType.LOSS_BINARY_CROSSENTROPY, [ref.MetricsType.METRICS_ACCURACY])
    pm = pdlrm.make_dlrm_model(pc, port.FFConfig(**kw), device="cpu")
    pm.compile(port.SGDOptimizer(lr=0.01), port.LossType.LOSS_BINARY_CROSSENTROPY,
               [port.MetricsType.METRICS_ACCURACY])
    feeds, labels = random_batches(jc, batch, seed=0)
    return jm, pm, feeds, labels


@pytest.mark.parametrize("name", ["tiny_config", "mlperf_lite_config"])
def test_export_task_graph_equals_jax(tmp_path, name):
    """The DOT file, byte for byte the JAX package's for the same graph."""
    jm, pm, _, _ = _pair(name)
    rprof.export_task_graph(jm, str(tmp_path / "jax.dot"))
    pprof.export_task_graph(pm, str(tmp_path / "port.dot"))
    text = (tmp_path / "port.dot").read_bytes()
    assert text == (tmp_path / "jax.dot").read_bytes() and text.startswith(b"digraph")
    for op in pm.graph.compute_ops:
        assert f'"{op.name}"'.encode() in text


@pytest.mark.parametrize("name", ["tiny_config", "mlperf_lite_config"])
def test_op_timing_report_rows_match_jax(name, capsys):
    """One row an op, in graph order, with the JAX package's names, types,
    flops and bytes; every time positive; the reference's print format."""
    jm, pm, feeds, _ = _pair(name, use_pallas="off")
    want = rprof.op_timing_report(jm, feeds, reps=1, warmup=1)
    got = pprof.op_timing_report(pm, feeds, reps=2, warmup=1)
    keys = ("name", "type", "flops", "bytes")
    assert [{k: r[k] for k in keys} for r in got] == [{k: r[k] for k in keys} for r in want]
    assert len(got) == len(pm.graph.compute_ops) and all(r["ms"] > 0 for r in got)
    pprof.print_op_timings(got)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" forward time")[0] for ln in lines] == [f"[{r['type']}] {r['name']}" for r in got]


def test_check_numerics_clean_and_dirty_like_jax():
    """Clean: nothing in either package. A NaN in the first bottom-MLP
    kernel: the same op outputs flagged, with the same kind."""
    jm, pm, feeds, labels = _pair()
    assert pprof.check_numerics(pm, feeds, labels) == {} == rprof.check_numerics(jm, feeds, labels)
    name = next(n for n in pm.get_parameters() if "bot" in n)
    with torch.no_grad():
        pm.get_parameters()[name]["kernel"].view(-1)[0] = float("nan")
    poisoned = np.asarray(jm._params[name]["kernel"]).copy()
    poisoned.flat[0] = np.nan
    jm._params[name]["kernel"] = poisoned
    bad = pprof.check_numerics(pm, feeds, labels)
    assert bad and bad == rprof.check_numerics(jm, feeds, labels)


def test_log_shardings_one_row_per_parameter():
    """One row a parameter with its shape, dtype, device and placement: on
    one device, and under a mesh in a world of one (the flat collection
    replicated)."""
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.launch import initialize
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan

    _, pm, _, _ = _pair()
    rows = pprof.log_shardings(pm)
    params = [(op, k, t) for op, sub in pm.get_parameters().items() for k, t in sub.items()]
    assert rows == [f"param {op}/{k} shape={tuple(t.shape)} dtype={t.dtype} device=cpu spec=one device"
                    for op, k, t in params]
    initialize("cpu")
    try:
        cfg = pdlrm.tiny_config(batch_size=16)
        m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=16, onehot_embedding_threshold=0), device="cpu")
        m.compile(port.SGDOptimizer(lr=0.01), port.LossType.LOSS_BINARY_CROSSENTROPY, mesh=make_mesh(device="cpu"),
                  plan=dlrm_hybrid_plan())
        rows = pprof.log_shardings(m)
        assert len(rows) == sum(len(sub) for sub in m.get_parameters().values())
        assert all("shape=" in r and r.endswith("spec=replicated") for r in rows)
        assert any(r.startswith("param embedding_collection/pool ") for r in rows)
    finally:
        dist.destroy_process_group()


def test_trace_writes_a_tensorboard_file(tmp_path):
    """trace(logdir) leaves a torch.profiler `*.pt.trace.json` under logdir
    holding the block's operators."""
    _, pm, feeds, _ = _pair()
    logdir = tmp_path / "prof"
    with pprof.trace(str(logdir)):
        pm.predict(feeds)
    found = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert len(found) == 1 and found[0].endswith(".pt.trace.json")
    assert '"traceEvents"' in open(found[0]).read()


def test_calibrate_step_residual_leaves_the_model_unchanged(tmp_path):
    """calibrate_step_residual times `steps` train_chunk steps and writes
    back every parameter, optimizer state, metric total and the step
    count, bit for bit (here under Adam, whose state moves every step);
    it returns measured / predicted and saves that residual to the cache
    path; the model then trains as one never calibrated."""
    from dlrm_flexflow_tpu_torch.autotune.machine import MachineSpec
    from dlrm_flexflow_tpu_torch.tools.state import state_tensors

    def model():
        cfg = pdlrm.tiny_config(batch_size=16)
        m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=16, compute_dtype="float32",
                                                     onehot_embedding_threshold=100), device="cpu")
        m.compile(port.AdamOptimizer(alpha=0.01), port.LossType.LOSS_BINARY_CROSSENTROPY,
                  [port.MetricsType.METRICS_ACCURACY])
        return m

    feeds, labels = random_batches(pdlrm.tiny_config(batch_size=16), 32, seed=2)
    a, b = model(), model()
    a.train_batch({k: v[:16] for k, v in feeds.items()}, labels[:16])
    b.train_batch({k: v[:16] for k, v in feeds.items()}, labels[:16])
    before = {k: v.clone() for k, v in state_tensors(a).items()}
    cache = tmp_path / "machine.json"
    residual, measured, predicted = a.calibrate_step_residual({k: v[:16] for k, v in feeds.items()}, labels[:16],
                                                              steps=3, cache_path=str(cache))
    after = state_tensors(a)
    assert before.keys() == after.keys() and all(torch.equal(before[k], after[k]) for k in before)
    assert a._step_count == 1 and residual == measured / predicted and measured > 0 and predicted > 0
    assert MachineSpec.from_file(str(cache)).step_residual == residual
    second = {k: v[16:] for k, v in feeds.items()}
    assert float(a.train_batch(second, labels[16:])) == float(b.train_batch(second, labels[16:]))
