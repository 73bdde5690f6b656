"""The port's spans, op ranges and step phases (utils/profiling.py) on the
CPU: what a profiler sees of them, what they cost with none, the registry's
arithmetic, and where `predict`, `train_batch`, `train_chunk` and
`compute_routes` open them. The card's phase stamps are held against CUDA
events in tests/test_torch_port_cuda.py."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
from dlrm_flexflow_tpu_torch.utils import profiling
from dlrm_flexflow_tpu_torch.utils.profiling import PHASES, op_range, reset_spans, span, span_totals

BATCH = 32


@pytest.fixture(autouse=True)
def empty_registry():
    reset_spans()  # the registry is process-wide: earlier tests fill it
    yield
    reset_spans()


def _model(host_routing=False):
    cfg = pdlrm.DLRMConfig(sparse_feature_size=8, embedding_size=[100, 20000, 30], embedding_bag_size=1,
                           mlp_bot=[4, 16, 8], mlp_top=[32, 16, 1], batch_size=BATCH)
    m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=BATCH, packed_tables="on", host_routing=host_routing),
                              device="cpu")
    m.compile(port.SGDOptimizer(lr=0.01), port.LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, labels = random_batches(cfg, 4 * BATCH, seed=3)
    return m, feeds, labels


def _batch(feeds, labels, i):
    return {k: v[i * BATCH:(i + 1) * BATCH] for k, v in feeds.items()}, labels[i * BATCH:(i + 1) * BATCH]


def test_spans_and_op_ranges_are_profiler_ranges_nested_as_called():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with op_range("op:middle"):
                with span("inner", numbered=True):
                    time.sleep(0.001)
    ev = {e.name: e.time_range for e in prof.events() if e.name in ("outer", "op:middle", "inner")}
    assert set(ev) == {"outer", "op:middle", "inner"}
    assert ev["outer"].start <= ev["op:middle"].start <= ev["inner"].start
    assert ev["inner"].end <= ev["op:middle"].end <= ev["outer"].end
    assert set(span_totals()) == {"outer", "inner"}  # an op range keeps no totals


def test_with_no_profiler_nothing_opens_a_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record_function range was opened with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling._autograd_profiler._is_profiler_enabled
    with span("quiet"):
        with op_range("op:quiet"):
            pass
    assert op_range("op:quiet") is profiling._NO_RANGE
    assert set(span_totals()) == {"quiet"}


def test_registry_counts_and_seconds_add_up_for_nested_spans():
    for _ in range(2):
        with span("parent"):
            for _ in range(3):
                with span("child"):
                    time.sleep(0.0005)
            time.sleep(0.001)
    tot = span_totals()
    p, c = tot["parent"], tot["child"]
    assert (p["count"], c["count"]) == (2, 6)
    assert (p["parent"], c["parent"]) == (None, "parent")
    assert c["self_s"] == c["host_s"] >= 6 * 0.0005
    assert p["self_s"] == pytest.approx(p["host_s"] - c["host_s"], abs=1e-9)
    assert p["self_s"] >= 2 * 0.001
    assert 0 < c["first_s"] < c["host_s"] and 0 < p["first_s"] < p["host_s"]
    reset_spans()
    assert span_totals() == {}


def test_spans_inside_a_capture_add_nothing():
    with span("outside"):
        with profiling.capturing():
            with span("captured"):
                pass
    assert set(span_totals()) == {"outside"}
    assert not profiling._CAPTURES


def test_predict_opens_its_spans_once_a_call_and_once_a_chunk():
    m, feeds, _ = _model()
    n = 2 * BATCH + 5  # three chunks, the last padded
    m.predict({k: v[:n] for k, v in feeds.items()})
    tot = span_totals()
    assert tot["predict"]["count"] == 1
    for name in ("forward:stage", "forward:execute", "predict:readback"):
        assert tot[name]["count"] == 3 and tot[name]["parent"] == "predict", name
    inner = sum(tot[name]["host_s"] for name in ("forward:stage", "forward:execute", "predict:readback"))
    assert tot["predict"]["self_s"] == pytest.approx(tot["predict"]["host_s"] - inner, abs=1e-9)


def test_predict_ranges_carry_the_call_number_and_name_each_op():
    m, feeds, _ = _model()
    batch, _ = _batch(feeds, np.zeros(4 * BATCH), 0)
    m.predict(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.predict(batch)
    names = [e.name for e in prof.events()]
    assert {"predict", "forward:stage", "forward:execute", "predict:readback"} <= set(names)
    assert {f"op:{op.name}" for op in m.graph.compute_ops} <= set(names)
    assert span_totals()["predict"]["count"] == 2


def test_train_batch_stamps_each_phase_once_a_step():
    m, feeds, labels = _model()
    for i in range(3):
        m.train_batch(*_batch(feeds, labels, i))
    tot = span_totals()
    assert [tot[name]["count"] for name in PHASES] == [3] * len(PHASES)
    assert all(tot[name]["device_s"] >= 0 for name in PHASES)
    phases = sum(tot[name]["device_s"] for name in PHASES)
    assert 0 < phases <= tot["step:device_step"]["host_s"]
    assert tot["step:device_step"]["count"] == 3


def test_train_chunk_on_the_cpu_steps_and_stamps_without_a_capture():
    m, feeds, labels = _model()
    stack = {k: np.stack([_batch(feeds, labels, i)[0][k] for i in range(2)]) for k in feeds}
    lab = np.stack([_batch(feeds, labels, i)[1] for i in range(2)])
    m.train_chunk(stack, lab)
    m.train_chunk(stack, lab)
    tot = span_totals()
    assert [tot[name]["count"] for name in PHASES] == [4] * len(PHASES)
    assert not any(name.startswith("train_chunk:") for name in tot)  # the graph's spans are CUDA's


def test_compute_routes_is_one_span_a_call():
    m, feeds, labels = _model(host_routing=True)
    assert m._route_ops()
    for i in range(3):
        m.compute_routes(_batch(feeds, labels, i)[0])
    assert span_totals()["routes"]["count"] == 3


def test_phase_clock_resets_in_place():
    m, feeds, labels = _model()
    m.train_batch(*_batch(feeds, labels, 0))
    clock = profiling._clock(m.device)
    reset_spans()
    assert profiling._clock(m.device) is clock and not any(clock.read())
    m.train_batch(*_batch(feeds, labels, 1))
    assert span_totals()["phase:backward"]["count"] == 1


def test_a_span_nested_in_its_own_name_adds_to_its_totals():
    with span("again"):
        with span("again"):
            time.sleep(0.0005)
    tot = span_totals()["again"]
    assert tot["count"] == 2 and tot["parent"] == "again"  # the inner call closes first
    assert tot["self_s"] == pytest.approx(tot["host_s"] - tot["first_s"], abs=1e-9)
