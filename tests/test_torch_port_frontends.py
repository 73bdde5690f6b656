"""The port's model-import frontends against the JAX package's, on the CPU.

Each behaviour of tests/test_frontends.py has a counterpart here: the same
model built through the Keras facade, torch.fx, ONNX or tf.keras in both
packages (every Keras layer named, since each package counts its own
default names), the JAX model's weights carried by `params_from_jax`, the
same numpy inputs; the forward, then 3 SGD steps through `Model.fit` (or
`FFModel.fit` after `apply`): the history's metrics, then every weight.
A graph with Dropout at a rate above 0 compares the forward (and
`evaluate`) only: the two packages draw their masks differently by design,
each from its own generator. The datasets, the torch.fx node lines and the
IR files are compared bit for bit. A real tf.keras model is held against
TF's own output in both packages, and a stand-in with a channels-first
convolution against a plain computation from its arrays. Under
use_pallas="on" the imported models' Dense layers go through K6's plain
version and their tables through K5f's and K4's, against `dense_pallas`,
`onehot_embedding_pallas` and `embedding_bag_pallas` in the TPU interpreter.

Tolerances: f32 compute, so both sides sum f32 products in other orders:
rtol 1e-5, atol 1e-6 on metrics, and atol 1e-6 plus 1e-5 of the largest
magnitude on outputs and weights (a sum that cancels keeps the absolute
error of its largest terms). Adam moves a weight by up to about 3.2 alpha a
step however small its gradient, so where the two summation orders give a
gradient near 0 other signs, its weights part by up to 3 * 3.2 alpha after
3 steps (tests/test_torch_port_zoo.py); all but 1 in 1000 of an array (or 1
of a smaller one) stay within rtol 1e-4, atol 1e-5. Under "on" in bf16
every layer's output is rounded to bf16, and a flipped rounding moves a
value in [0.5, 1) by one bf16 step, 2^-8: atol 2^-7 allows two. TF's own
output: rtol 1e-4, atol 1e-5, as tests/test_frontends.py.
"""
import gzip
import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.frontends import datasets as ref_datasets
from dlrm_flexflow_tpu.frontends import keras as RK
from dlrm_flexflow_tpu.frontends import onnx as ref_onnx
from dlrm_flexflow_tpu.frontends import tf_keras as ref_tf
from dlrm_flexflow_tpu.frontends import torch_fx as ref_fx

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.frontends import datasets as port_datasets
from dlrm_flexflow_tpu_torch.frontends import keras as PK
from dlrm_flexflow_tpu_torch.frontends import onnx as port_onnx
from dlrm_flexflow_tpu_torch.frontends import tf_keras as port_tf
from dlrm_flexflow_tpu_torch.frontends import torch_fx as port_fx
from dlrm_flexflow_tpu_torch.ops import dense as port_dense
from dlrm_flexflow_tpu_torch.ops import embedding as port_embedding
from dlrm_flexflow_tpu_torch.training.callbacks import VerifyMetrics

import torch.nn as nn

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
F32_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_ATOL = 3 * 3.2 * 0.001  # "adam" is AdamOptimizer(alpha=0.001) in both packages
ADAM_SHARE_TOL = dict(rtol=1e-4, atol=1e-5)
ON_ATOL = 2.0**-7
TF_TOL = dict(rtol=1e-4, atol=1e-5)
TIMES = ("epoch_time_s", "throughput", "first_epoch_time_s")
# each package with its tf.keras importer and the keywords that put its FFModel on the CPU
TF_SIDES = ((ref, ref_tf, {}), (port, port_tf, {"device": "cpu"}))


@pytest.fixture(scope="module")
def tf():
    """TensorFlow, imported once for the file (it takes seconds)."""
    import tensorflow

    return tensorflow


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 + 1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


def _host(out):
    """A forward's output as numpy: the port's tensor, the JAX package's array."""
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _f32(pkg, bs, **kw):
    return pkg.FFConfig(batch_size=bs, compute_dtype="float32", **kw)


def _carry(r_ff, p_ff):
    p_ff.set_parameters(params_from_jax({op: r_ff.get_weights(op) for op in r_ff.get_parameters()}))


def _weights_close(r_ff, p_ff, adam=False):
    for op in r_ff.get_parameters():
        for k, v in r_ff.get_weights(op).items():
            got = p_ff.get_weights(op)[k]
            if not adam:
                _close(got, v, err_msg=f"{op}/{k}")
                continue
            np.testing.assert_allclose(got, v, rtol=0, atol=ADAM_ATOL, err_msg=f"{op}/{k}")
            off = ~np.isclose(got, v, **ADAM_SHARE_TOL)
            assert off.sum() <= max(1, 1e-3 * off.size), (op, k, off.sum(), off.size)


def _history_close(hr, hp):
    keys = set(hr) - set(TIMES)
    assert keys == set(hp) - set(TIMES), (sorted(hr), sorted(hp))
    for k in keys:
        np.testing.assert_allclose(hp[k], hr[k], **F32_TOL, err_msg=k)


def _keras_pair(build, bs, **compile_kw):
    """build(K) in each package, compiled in f32 at batch `bs` (the port on
    the CPU), the JAX model's weights carried into the port's."""
    r, p = build(RK), build(PK)
    r.compile(config=_f32(ref, bs), batch_size=bs, **compile_kw)
    p.compile(config=_f32(port, bs), batch_size=bs, device="cpu", **compile_kw)
    _carry(r.ffmodel, p.ffmodel)
    return r, p


def _fit_parity(r, p, x, y, adam=False):
    """One epoch of 3 batches (3 steps) in both packages: the histories'
    metrics and every weight after."""
    _history_close(r.fit(x, y, epochs=1, verbose=False), p.fit(x, y, epochs=1, verbose=False))
    _weights_close(r.ffmodel, p.ffmodel, adam)


def _ff_pair(bs, inputs, apply, **cfg):
    """An FFModel in each package with `inputs` ({name: (shape, DataType
    name)}), and apply("ref" or "port", ff, input handles) -> its output."""
    out = []
    for key, pkg in (("ref", ref), ("port", port)):
        ff = pkg.FFModel(_f32(pkg, bs, **cfg)) if key == "ref" else pkg.FFModel(_f32(pkg, bs, **cfg), device="cpu")
        handles = [ff.create_tensor([bs] + list(shape), dtype=getattr(pkg.DataType, dt), name=name)
                   for name, (shape, dt) in inputs.items()]
        out.append((ff, apply(key, ff, handles)))
    return out


def _compile_carry(r_ff, p_ff, loss, metrics=("METRICS_ACCURACY",), lr=0.05):
    for pkg, ff in ((ref, r_ff), (port, p_ff)):
        ff.compile(pkg.SGDOptimizer(lr=lr), getattr(pkg.LossType, loss),
                   [getattr(pkg.MetricsType, m) for m in metrics])
    _carry(r_ff, p_ff)


def _ff_fit_parity(r_ff, p_ff, feeds, labels):
    _history_close(r_ff.fit(feeds, labels, epochs=1, verbose=False),
                   p_ff.fit(feeds, labels, epochs=1, verbose=False))
    _weights_close(r_ff, p_ff)


# --- the Keras facade --------------------------------------------------------
def _seq_dropout_mlp(K):
    return K.Sequential([K.Dense(32, activation="relu", name="d1"), K.Dropout(0.1, name="drop"),
                         K.Dense(10, name="d2"), K.Softmax(name="probs")])


def test_keras_sequential_mnist_mlp_trains():
    """Dropout 0.1: the forward and `evaluate` against the JAX package
    (no mask there), then the port's own fit, evaluate and predict as the
    JAX test checks them."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 20).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 64)]
    r, p = _keras_pair(_seq_dropout_mlp, 16, optimizer="sgd", loss="categorical_crossentropy",
                       metrics=["accuracy"], input_shape=[20])
    _close(p.predict(x[:16]), r.predict(x[:16]))
    _history_close(r.evaluate(x, y), p.evaluate(x, y))
    hist = p.fit(x, y, epochs=2, verbose=False)
    assert 0.0 <= hist["accuracy"] <= 1.0
    assert 0.0 <= p.evaluate(x, y)["accuracy"] <= 1.0
    pred = p.predict(x[:16])
    assert pred.shape == (16, 10) and pred.dtype == r.predict(x[:16]).dtype
    np.testing.assert_allclose(pred.sum(1), 1.0, rtol=1e-3)


def _two_input_model(K):
    a, b = K.Input([8]), K.Input([4])
    h = K.Concatenate(axis=1, name="cat")([a, b])
    h = K.Dense(16, activation="relu", name="h")(h)
    return K.Model([a, b], K.Dense(1, activation="sigmoid", name="out")(h))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_keras_functional_multi_input_concat(opt):
    rng = np.random.RandomState(1)
    xs = [rng.randn(24, 8).astype(np.float32), rng.randn(24, 4).astype(np.float32)]
    y = rng.randint(0, 2, (24, 1)).astype(np.float32)
    r, p = _keras_pair(_two_input_model, 8, optimizer=opt, loss="binary_crossentropy", metrics=["accuracy"])
    _close(p.predict([x[:8] for x in xs]), r.predict([x[:8] for x in xs]))
    hr, hp = r.fit(xs, y, epochs=1, verbose=False), p.fit(xs, y, epochs=1, verbose=False)
    assert "throughput" in hp and 0.0 <= hp["accuracy"] <= 1.0
    if opt == "sgd":
        _history_close(hr, hp)
    _weights_close(r.ffmodel, p.ffmodel, adam=opt == "adam")


def _small_cnn(K):
    img = K.Input([1, 8, 8])
    t = K.Conv2D(4, 3, padding="same", activation="relu", name="conv")(img)
    t = K.MaxPooling2D(2, 2, name="pool")(t)
    t = K.Flatten(name="flat")(t)
    t = K.Dense(10, name="fc")(t)
    return K.Model(img, K.Softmax(name="probs")(t))


def test_keras_cnn_shapes():
    rng = np.random.RandomState(2)
    x = rng.randn(12, 1, 8, 8).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 12)]
    r, p = _keras_pair(_small_cnn, 4, loss="categorical_crossentropy")
    assert p.summary() == r.summary() and "Conv2D" in p.summary()
    pred = p.predict(x[:4])
    assert pred.shape == (4, 10)
    _close(pred, r.predict(x[:4]))
    _fit_parity(r, p, x, y)


def test_keras_mnist_accuracy_gate_synthetic_surrogate():
    """The accuracy gate: 784-128-10 (SGD, batch 64) in f32, the forward
    and 3 SGD steps against the JAX package, then the port's model goes on
    for the JAX test's 3 epochs of the synthetic surrogate and passes
    VerifyMetrics("accuracy", 0.9)."""
    (xtr, ytr), _ = port_datasets.load_mnist(synthetic_n=2048)
    x = xtr.reshape(len(xtr), 784).astype(np.float32) / 255.0
    y = port_datasets.to_categorical(ytr, 10)

    def build(K):
        return K.Sequential([K.Dense(128, activation="relu", name="h"), K.Dense(10, name="logits"),
                             K.Softmax(name="probs")])

    r, p = _keras_pair(build, 64, optimizer="sgd", loss="categorical_crossentropy", metrics=["accuracy"],
                       input_shape=[784])
    _close(p.predict(x[:64]), r.predict(x[:64]))
    _fit_parity(r, p, x[:192], y[:192])
    p.fit(x, y, epochs=3, verbose=False, callbacks=[VerifyMetrics("accuracy", 0.9)])


def test_keras_layer_called_twice_wires_both_call_sites():
    def build(K):
        a, b = K.Input([4]), K.Input([4])
        shared = K.Dense(3, use_bias=False, name="shared")
        return K.Model([a, b], K.Add(name="sum")([shared(a), shared(b)]))

    with pytest.warns(UserWarning, match="no weight sharing"):
        r, p = _keras_pair(build, 4, loss="mean_squared_error", metrics=[])
    x1, x0 = np.ones((4, 4), np.float32), np.zeros((4, 4), np.float32)
    y_10, y_01, y_11 = (p.predict(xs) for xs in ([x1, x0], [x0, x1], [x1, x1]))
    assert np.abs(y_10).sum() > 0 and np.abs(y_01).sum() > 0
    np.testing.assert_allclose(y_11, y_10 + y_01, rtol=1e-4, atol=1e-5)
    for xs, got in (([x1, x0], y_10), ([x0, x1], y_01), ([x1, x1], y_11)):
        _close(got, r.predict(xs))


def _keras_embedding(K):
    ids = K.Input([4], dtype=K.DataType.DT_INT64)
    e = K.Embedding(30, 8, aggr="sum", name="emb")(ids)
    return K.Model(ids, K.Dense(1, activation="sigmoid", name="out")(e))


def test_keras_embedding_layer_trains():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 30, (24, 4)).astype(np.int64)
    y = rng.randint(0, 2, (24, 1)).astype(np.float32)
    r, p = _keras_pair(_keras_embedding, 8, loss="binary_crossentropy", metrics=["accuracy"])
    _close(p.predict(x[:8]), r.predict(x[:8]))
    _fit_parity(r, p, x, y)


def test_keras_vocabularies_match_jax():
    """The string losses, metrics and optimizers name the same things."""
    assert {k: v.name for k, v in PK._LOSSES.items()} == {k: v.name for k, v in RK._LOSSES.items()}
    assert {k: v.name for k, v in PK._METRICS.items()} == {k: v.name for k, v in RK._METRICS.items()}
    assert PK._as_optimizer("SGD").lr == RK._as_optimizer("SGD").lr == 0.01
    assert PK._as_optimizer("adam").alpha == RK._as_optimizer("adam").alpha == 0.001
    opt = port.AdamOptimizer(alpha=0.5)
    assert PK._as_optimizer(opt) is opt
    for mod in (PK, RK):
        with pytest.raises(ValueError, match="unknown optimizer"):
            mod._as_optimizer("rmsprop")


def test_keras_compile_without_device_raises_with_no_card(monkeypatch):
    """The default device is the card: with none, compile raises and
    makes no model on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _seq_dropout_mlp(PK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.compile(input_shape=[20], batch_size=4)
    assert m.ffmodel is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tf.from_tf_keras(_tf_model([_tf_layer("Dense", "d", {"units": 2}, [])], (3,)), batch_size=4)


# --- torch.fx -----------------------------------------------------------------
class _FxMlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(12, 24)
        self.act = nn.ReLU()
        self.drop = nn.Dropout(0.2)
        self.fc2 = nn.Linear(24, 24)
        self.fc3 = nn.Linear(24, 5)

    def forward(self, x):
        h = self.act(self.fc1(x))
        h2 = self.act(self.fc2(self.drop(h)))
        return torch.softmax(self.fc3(h + h2), dim=1)


class _FxCnnCat(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(1, 4, 3, padding=1)
        self.pool = nn.MaxPool2d(2, 2)
        self.flat = nn.Flatten()
        self.fc = nn.Linear(4 * 4 * 4 * 2, 3)

    def forward(self, x):
        a = self.flat(self.pool(self.conv(x)))
        b = self.flat(self.pool(self.conv(x)))
        return self.fc(torch.cat([a, b], dim=1))


class _FxBag(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.EmbeddingBag(50, 8, mode="sum")
        self.fc = nn.Linear(8, 3)

    def forward(self, idx):
        return self.fc(self.emb(idx))


def _fx_apply(ir):
    def apply(key, ff, handles):
        return (ref_fx if key == "ref" else port_fx).PyTorchModel(ir).apply(ff, handles)
    return apply


def test_torch_fx_roundtrip(tmp_path):
    """The node lines and the IR file bytes equal the JAX package's, the
    file loads back alike; with Dropout 0.2 the forward and `evaluate`
    against the JAX package, then the port's own fit."""
    net = _FxMlp()
    ir = port_fx.torch_to_ir(net)
    assert [n.to_line() for n in ir] == [n.to_line() for n in ref_fx.torch_to_ir(net)]
    paths = {key: tmp_path / f"{key}.ff" for key in ("ref", "port", "ref_file", "port_file")}
    ref_fx.save_ir(ref_fx.torch_to_ir(net), str(paths["ref"]))
    port_fx.save_ir(ir, str(paths["port"]))
    ref_fx.torch_to_file(net, str(paths["ref_file"]))
    port_fx.torch_to_file(net, str(paths["port_file"]))
    assert len({p.read_bytes() for p in paths.values()}) == 1
    ir2 = port_fx.load_ir(str(paths["ref"]))
    assert [n.to_line() for n in ir2] == [n.to_line() for n in ir]
    assert port_fx.FXNode.from_line(ir[1].to_line()) == ir[1]
    (r, r_out), (p, p_out) = _ff_pair(8, {"x": ([12], "DT_FLOAT")}, _fx_apply(ir2))
    assert tuple(p_out.shape) == tuple(r_out.shape) == (8, 5)
    _compile_carry(r, p, "LOSS_CATEGORICAL_CROSSENTROPY", lr=0.01)
    rng = np.random.RandomState(3)
    feeds = {"x": rng.randn(32, 12).astype(np.float32)}
    labels = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 32)]
    _close(p.forward({"x": feeds["x"][:8]}).numpy(), r.forward({"x": feeds["x"][:8]}))
    _history_close(r.evaluate(feeds, labels), p.evaluate(feeds, labels))
    assert 0.0 <= p.fit(feeds, labels, epochs=1, verbose=False)["accuracy"] <= 1.0


def test_torch_fx_cnn_and_cat():
    """A module called twice traces to two ops; the forward and 3 SGD
    steps (MSE) against the JAX package."""
    ir = port_fx.torch_to_ir(_FxCnnCat())
    assert [n.to_line() for n in ir] == [n.to_line() for n in ref_fx.torch_to_ir(_FxCnnCat())]
    assert [n.op for n in ir].count("conv2d") == 2
    (r, r_out), (p, p_out) = _ff_pair(4, {"img": ([1, 8, 8], "DT_FLOAT")}, _fx_apply(ir))
    assert tuple(p_out.shape) == (4, 3)
    _compile_carry(r, p, "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE", metrics=("METRICS_MEAN_SQUARED_ERROR",))
    rng = np.random.RandomState(4)
    feeds = {"img": rng.randn(12, 1, 8, 8).astype(np.float32)}
    _close(p.forward({"img": feeds["img"][:4]}).numpy(), r.forward({"img": feeds["img"][:4]}))
    _ff_fit_parity(r, p, feeds, rng.randn(12, 3).astype(np.float32))


def test_torch_fx_embeddingbag_import():
    ir = port_fx.torch_to_ir(_FxBag())
    assert [n.to_line() for n in ir] == [n.to_line() for n in ref_fx.torch_to_ir(_FxBag())]
    assert "embedding" in [n.op for n in ir]
    (r, _), (p, p_out) = _ff_pair(4, {"ids": ([3], "DT_INT64")}, _fx_apply(ir))
    assert tuple(p_out.shape) == (4, 3)
    _compile_carry(r, p, "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE", metrics=("METRICS_MEAN_SQUARED_ERROR",))
    rng = np.random.RandomState(0)
    feeds = {"ids": rng.randint(0, 50, (12, 3)).astype(np.int64)}
    _close(p.forward({"ids": feeds["ids"][:4]}).numpy(), r.forward({"ids": feeds["ids"][:4]}))
    _ff_fit_parity(r, p, feeds, rng.randn(12, 3).astype(np.float32))


# --- ONNX, with duck-typed proto stand-ins ------------------------------------
class _A:
    def __init__(self, name, **kw):
        self.name = name
        self.ints = kw.get("ints", [])
        self.floats = kw.get("floats", [])
        self.i = kw.get("i")
        self.f = kw.get("f")
        self.s = kw.get("s")


class _N:
    def __init__(self, op_type, input, output, attribute=()):
        self.op_type = op_type
        self.input = list(input)
        self.output = list(output)
        self.attribute = list(attribute)


class _Init:
    def __init__(self, name, array):
        self.name = name
        self.array = array


class _G:
    def __init__(self, node, initializer=(), output=()):
        self.node = node
        self.initializer = list(initializer)
        self.output = list(output)


class _M:
    def __init__(self, graph):
        self.graph = graph


def _onnx_apply(model):
    def apply(key, ff, handles):
        mod = ref_onnx if key == "ref" else port_onnx
        return mod.ONNXModel(model).apply(ff, {h.owner_op.name: h for h in handles})
    return apply


def test_onnx_import_mlp():
    inits = [_Init("w1", np.zeros((16, 12), np.float32)), _Init("b1", np.zeros((16,), np.float32)),
             _Init("w2", np.zeros((5, 16), np.float32)), _Init("b2", np.zeros((5,), np.float32))]
    nodes = [
        _N("Gemm", ["x", "w1", "b1"], ["h"], [_A("transB", i=1)]),
        _N("Relu", ["h"], ["hr"]),
        _N("Gemm", ["hr", "w2", "b2"], ["logits"], [_A("transB", i=1)]),
        _N("Softmax", ["logits"], ["probs"]),
    ]
    model = _M(_G(nodes, inits, output=[_Init("probs", None)]))
    (r, _), (p, p_out) = _ff_pair(8, {"x": ([12], "DT_FLOAT")}, _onnx_apply(model))
    assert tuple(p_out.shape) == (8, 5)
    _compile_carry(r, p, "LOSS_CATEGORICAL_CROSSENTROPY", lr=0.1)
    rng = np.random.RandomState(5)
    feeds = {"x": rng.randn(24, 12).astype(np.float32)}
    _close(p.forward({"x": feeds["x"][:8]}).numpy(), r.forward({"x": feeds["x"][:8]}))
    _ff_fit_parity(r, p, feeds, np.eye(5, dtype=np.float32)[rng.randint(0, 5, 24)])


def test_onnx_import_cnn_concat_split():
    nodes = [
        _N("Conv", ["x", "cw"], ["c"], [
            _A("kernel_shape", ints=[3, 3]), _A("strides", ints=[1, 1]), _A("pads", ints=[1, 1, 1, 1]),
        ]),
        _N("Relu", ["c"], ["cr"]),
        _N("MaxPool", ["cr"], ["p"], [_A("kernel_shape", ints=[2, 2]), _A("strides", ints=[2, 2])]),
        _N("Flatten", ["p"], ["f"]),
        _N("Split", ["f"], ["s1", "s2"], [_A("axis", i=1), _A("split", ints=[32, 32])]),
        _N("Concat", ["s1", "s2"], ["cat"], [_A("axis", i=1)]),
    ]
    model = _M(_G(nodes, [_Init("cw", np.zeros((4, 1, 3, 3), np.float32))]))
    (r, _), (p, p_out) = _ff_pair(2, {"x": ([1, 8, 8], "DT_FLOAT")}, _onnx_apply(model))
    assert tuple(p_out.shape) == (2, 64)
    _compile_carry(r, p, "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE", metrics=("METRICS_MEAN_SQUARED_ERROR",))
    rng = np.random.RandomState(6)
    feeds = {"x": rng.randn(6, 1, 8, 8).astype(np.float32)}
    _close(p.forward({"x": feeds["x"][:2]}).numpy(), r.forward({"x": feeds["x"][:2]}))
    _ff_fit_parity(r, p, feeds, rng.randn(6, 64).astype(np.float32))


def test_onnx_import_every_op_type_it_handles():
    """One graph with all 20 op types ONNXModel.apply handles (Reshape with
    0 and -1, Split into several outputs, MatMul without transB, Dropout
    at 0.25): the same op kinds and shapes as the JAX import, and the
    forward against it."""
    rng = np.random.RandomState(7)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    inits = [_Init("cw", arr(4, 2, 3, 3)), _Init("cb", arr(4)), _Init("shape", np.array([0, -1], np.int64)),
             _Init("w", arr(16, 64)), _Init("b", arr(16)), _Init("w2", arr(16, 6))]
    k2 = [_A("kernel_shape", ints=[2, 2]), _A("strides", ints=[2, 2])]
    nodes = [
        _N("Conv", ["x", "cw", "cb"], ["c"], [_A("kernel_shape", ints=[3, 3]), _A("pads", ints=[1, 1, 1, 1])]),
        _N("BatchNormalization", ["c"], ["bn"]),
        _N("Relu", ["bn"], ["r"]),
        _N("MaxPool", ["r"], ["mp"], k2),
        _N("AveragePool", ["r"], ["ap"], k2),
        _N("Add", ["mp", "ap"], ["s"]),
        _N("Sub", ["mp", "ap"], ["d"]),
        _N("Mul", ["s", "d"], ["m"]),
        _N("GlobalAveragePool", ["m"], ["g"]),
        _N("Flatten", ["g"], ["gf"]),
        _N("Reshape", ["mp", "shape"], ["rs"]),
        _N("Concat", ["rs", "gf"], ["cat"], [_A("axis", i=1)]),
        _N("Split", ["cat"], ["s1", "s2"], [_A("axis", i=1), _A("split", ints=[64, 4])]),
        _N("Gemm", ["s1", "w", "b"], ["h"], [_A("transB", i=1)]),
        _N("Tanh", ["h"], ["th"]),
        _N("Dropout", ["th"], ["dr"], [_A("ratio", f=0.25)]),
        _N("Identity", ["dr"], ["idn"]),
        _N("MatMul", ["idn", "w2"], ["mm"]),
        _N("Sigmoid", ["mm"], ["sg"]),
        _N("Softmax", ["sg"], ["probs"]),
    ]
    assert len({n.op_type for n in nodes}) == 20
    model = _M(_G(nodes, inits, output=[_Init("probs", None)]))
    (r, r_out), (p, p_out) = _ff_pair(4, {"x": ([2, 8, 8], "DT_FLOAT")}, _onnx_apply(model))
    assert tuple(p_out.shape) == tuple(r_out.shape) == (4, 6)
    kinds = [(type(op).__name__, tuple(op.outputs[0].shape)) for op in p.graph.compute_ops]
    assert kinds == [(type(op).__name__, tuple(op.outputs[0].shape)) for op in r.graph.compute_ops]
    _compile_carry(r, p, "LOSS_CATEGORICAL_CROSSENTROPY")
    x = {"x": arr(4, 2, 8, 8)}
    _close(p.forward(x).numpy(), r.forward(x))


class _RealA:  # mimics onnx.AttributeProto: every scalar field present
    def __init__(self, name, type_, **kw):
        self.name = name
        self.type = type_
        self.i = kw.get("i", 0)
        self.f = kw.get("f", 0.0)
        self.s = kw.get("s", b"")
        self.ints = kw.get("ints", [])
        self.floats = kw.get("floats", [])


class _RealN:
    def __init__(self, attrs):
        self.attribute = attrs


@pytest.mark.parametrize("attr, want", [
    (_RealA("ratio", 1, f=0.5), 0.5),                    # FLOAT
    (_RealA("axis", 2, i=3), 3),                         # INT
    (_RealA("axis0", 2, i=0, f=0.25), 0),                # INT 0 beside a stray float
    (_RealA("mode", 3, s=b"constant"), "constant"),      # STRING
    (_RealA("scales", 6, floats=[0.5, 2.0]), [0.5, 2.0]),  # FLOATS
    (_RealA("pads", 7, ints=[1, 1, 1, 1]), [1, 1, 1, 1]),  # INTS
    (_A("kernel_shape", ints=[3, 3]), [3, 3]),            # a stand-in: field presence
    (_A("transB", i=1), 1),
    (_A("mode", s=b"edge"), "edge"),
])
def test_onnx_attrs_real_proto_semantics(attr, want):
    """Real protos dispatch on the type tag, stand-ins on the fields set,
    in both packages alike."""
    node = _RealN([attr])
    assert port_onnx._attrs(node) == ref_onnx._attrs(node) == {attr.name: want}


def test_onnx_to_numpy_takes_arrays_tensors_and_stand_ins():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    for given in (a, torch.from_numpy(a), _Init("t", a.tolist())):
        got = port_onnx._to_numpy(given)
        np.testing.assert_array_equal(got, ref_onnx._to_numpy(given))
        np.testing.assert_array_equal(got, a)


# --- tf.keras -----------------------------------------------------------------
def test_tf_keras_import_with_weight_transfer(tf):
    """A real tf.keras model: both packages reproduce TF's own output."""
    tfm = tf.keras.Sequential([
        tf.keras.layers.Input(shape=(12,)),
        tf.keras.layers.Dense(16, activation="relu"),
        tf.keras.layers.Dense(4, activation="softmax"),
    ])
    x = np.random.RandomState(0).randn(8, 12).astype(np.float32)
    want = np.asarray(tfm(x))
    for pkg, mod, kw in TF_SIDES:
        ff, in_name = mod.from_tf_keras(tfm, batch_size=8, config=_f32(pkg, 8), **kw)
        ff.compile(pkg.SGDOptimizer(lr=0.01), pkg.LossType.LOSS_CATEGORICAL_CROSSENTROPY,
                   [pkg.MetricsType.METRICS_ACCURACY])
        assert mod.load_tf_weights(ff, tfm, ff._tf_weight_transfer[1]) == 2
        np.testing.assert_allclose(_host(ff.forward({in_name: x})), want, **TF_TOL)


def _tf_layer(kind, name, config, weights):
    """A tf.keras layer as from_tf_keras reads it: an object of a class named
    `kind`, with `name`, `get_config()` and `get_weights()` in tf's layouts."""
    return type(kind, (), {"name": name, "get_config": lambda self: dict(config),
                           "get_weights": lambda self: list(weights)})()


def _tf_model(layers, in_shape):
    """A tf.keras Sequential as from_tf_keras reads it: `layers` and the
    input's shape, batch first."""
    return SimpleNamespace(layers=layers, inputs=[SimpleNamespace(shape=(None,) + tuple(in_shape))])


def _tf_stand_in(rng):
    """channels-first conv stem, pooling, flatten, a Dense MLP: kernels in
    tf's HWIO and [in, out] layouts."""
    def arr(*shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    layers = [
        _tf_layer("InputLayer", "in", {}, []),
        _tf_layer("Conv2D", "conv", {"filters": 4, "kernel_size": (3, 3), "strides": (1, 1), "padding": "same",
                                    "data_format": "channels_first", "activation": "relu", "use_bias": True},
                 [arr(3, 3, 2, 4), arr(4)]),
        _tf_layer("MaxPooling2D", "pool", {"pool_size": (2, 2), "strides": (2, 2), "padding": "valid"}, []),
        _tf_layer("Flatten", "flat", {}, []),
        _tf_layer("Dense", "d1", {"units": 16, "activation": "relu", "use_bias": True}, [arr(64, 16), arr(16)]),
        _tf_layer("Dropout", "drop", {"rate": 0.0}, []),
        _tf_layer("Dense", "d2", {"units": 5, "activation": "linear", "use_bias": True}, [arr(16, 5), arr(5)]),
        _tf_layer("Activation", "act", {"activation": "softmax"}, []),
    ]
    return _tf_model(layers, (2, 8, 8))


def _tf_plain(model, x):
    """The stand-in's forward computed directly from its arrays (f32)."""
    t = torch.from_numpy(x)
    ws = {lay.name: [torch.from_numpy(w) for w in lay.get_weights()] for lay in model.layers}
    t = torch.relu(torch.nn.functional.conv2d(t, ws["conv"][0].permute(3, 2, 0, 1), ws["conv"][1], padding=1))
    t = torch.nn.functional.max_pool2d(t, 2).flatten(1)
    t = torch.relu(t @ ws["d1"][0] + ws["d1"][1])
    return torch.softmax(t @ ws["d2"][0] + ws["d2"][1], dim=1).numpy()


def test_tf_keras_stand_in_conv_layouts_against_a_plain_computation():
    """The HWIO -> OIHW and [in, out] -> [out, in] conversions (two Dense
    and one Conv2D updated, the pooling, flatten and dropout carried
    through) in both packages, against the plain forward of the arrays."""
    model = _tf_stand_in(np.random.RandomState(8))
    x = np.random.RandomState(9).randn(4, 2, 8, 8).astype(np.float32)
    want = _tf_plain(model, x)
    outs = []
    for pkg, mod, kw in TF_SIDES:
        ff, in_name = mod.from_tf_keras(model, batch_size=4, config=_f32(pkg, 4), **kw)
        assert ff._tf_weight_transfer[1] == {"conv": "conv", "d1": "d1", "d2": "d2"}
        ff.compile()
        assert mod.load_tf_weights(ff, model, ff._tf_weight_transfer[1]) == 3
        outs.append(_host(ff.forward({in_name: x})))
    _close(outs[1], outs[0])
    _close(outs[1], want)


# --- use_pallas="on": K6, K5f and K4 through their plain versions --------------
def _spy(monkeypatch, calls):
    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_dense, "fused_dense", spy("K6", port_dense.fused_dense))
    monkeypatch.setattr(port_embedding, "onehot_embedding", spy("K5f", port_embedding.onehot_embedding))
    monkeypatch.setattr(port_embedding, "embedding_bag_kernel", spy("K4", port_embedding.embedding_bag_kernel))


def _keras_on_pair(build, bs, cfg=None, **compile_kw):
    """build(K) in both packages under use_pallas="on" (bf16 compute), the
    JAX model's weights carried."""
    r, p = build(RK), build(PK)
    kw = dict(batch_size=bs, use_pallas="on", **(cfg or {}))
    r.compile(config=ref.FFConfig(**kw), loss="mean_squared_error", metrics=[], **compile_kw)
    p.compile(config=port.FFConfig(**kw), loss="mean_squared_error", metrics=[], device="cpu", **compile_kw)
    _carry(r.ffmodel, p.ffmodel)
    return r, p


def test_imported_mlp_under_on_goes_through_k6_as_dense_pallas(monkeypatch):
    """A Keras Sequential MLP (the three Dense layers of mnist_mlp at small
    widths) under "on": K6's plain version three times against
    `dense_pallas` interpreted."""
    def build(K):
        return K.Sequential([K.Dense(32, activation="relu", name="d1"), K.Dense(32, activation="relu", name="d2"),
                             K.Dense(10, name="d3"), K.Softmax(name="probs")])

    r, p = _keras_on_pair(build, 16, input_shape=[24])
    calls = []
    _spy(monkeypatch, calls)
    x = np.random.RandomState(10).randn(16, 24).astype(np.float32)
    got = p.predict(x)
    assert calls == ["K6"] * 3
    with pltpu.force_tpu_interpret_mode():
        want = r.predict(x)
    assert got.shape == want.shape == (16, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ON_ATOL)


def _embedding_model(K, small=48, large=200, dim=128):
    a, b = K.Input([1], dtype=K.DataType.DT_INT64), K.Input([1], dtype=K.DataType.DT_INT64)
    dense = K.Input([13])
    h = K.Concatenate(axis=1, name="cat")([K.Embedding(small, dim, aggr="sum", name="small")(a),
                                           K.Embedding(large, dim, aggr="sum", name="large")(b), dense])
    h = K.Dense(32, activation="relu", name="h")(h)
    return K.Model([a, b, dense], K.Dense(1, activation="sigmoid", name="out")(h))


def test_imported_embedding_model_under_on_goes_through_k5f_k4_and_k6(monkeypatch):
    """The chip phase's embedding model at small vocabularies, with the
    one-hot threshold at 64 in both packages so that the 48-row table takes
    K5f and the 200-row one K4 (D = 128); the two Dense layers K6."""
    r, p = _keras_on_pair(_embedding_model, 16, dict(packed_tables="off", onehot_embedding_threshold=64))
    calls = []
    _spy(monkeypatch, calls)
    rng = np.random.RandomState(11)
    xs = [rng.randint(0, 48, (16, 1)).astype(np.int64), rng.randint(0, 200, (16, 1)).astype(np.int64),
          rng.randn(16, 13).astype(np.float32)]
    got = p.predict(xs)
    assert sorted(calls) == ["K4", "K5f", "K6", "K6"]
    with pltpu.force_tpu_interpret_mode():
        want = r.predict(xs)
    assert got.shape == want.shape == (16, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ON_ATOL)


# --- datasets -------------------------------------------------------------------
def _same(got, want):
    """Equal arrays of the same dtype, nested tuples and lists alike; object
    arrays (reuters' sequences) element by element."""
    if isinstance(want, (tuple, list)) and not isinstance(want, np.ndarray):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == object:
            assert [list(g) for g in got] == [list(w) for w in want]
        else:
            np.testing.assert_array_equal(got, want)
        return
    assert got == want


def _tokenized(mod, num_words):
    tok = mod.Tokenizer(num_words=num_words)
    tok.fit_on_texts(["the cat sat", "the dog sat down", "The Cat ran"])
    texts = ["the cat", "unknown word", "dog dog down the"]
    return (tok.word_index, tok.texts_to_sequences(texts), tok.texts_to_matrix(texts),
            tok.texts_to_matrix(texts, mode="count"))


DATASET_CASES = {
    "mnist-synthetic": lambda m: m.load_mnist(synthetic_n=200),
    "cifar10-synthetic": lambda m: m.load_cifar10(synthetic_n=100),
    "reuters-synthetic": lambda m: m.load_reuters(synthetic_n=50),
    "reuters-synthetic-300-words": lambda m: m.load_reuters(num_words=300, synthetic_n=20, num_classes=5),
    "pad-pre": lambda m: m.pad_sequences([[1, 2, 3], [4], []], maxlen=5),
    "pad-post-truncate-pre": lambda m: m.pad_sequences([[1, 2, 3], [4]], maxlen=2, padding="post"),
    "pad-truncate-post": lambda m: m.pad_sequences([[1, 2, 3]], maxlen=2, truncating="post", value=-1),
    "pad-longest-int32": lambda m: m.pad_sequences([[1, 2, 3], [4]], dtype=np.int32),
    "tokenizer-10": lambda m: _tokenized(m, 10),
    "tokenizer-all": lambda m: _tokenized(m, None),
    "to-categorical": lambda m: (m.to_categorical(np.array([0, 2]), 3), m.to_categorical([[1], [3]])),
    "mnist-idx-fixture": lambda m: m.load_mnist(str(FIXTURES / "mnist_idx")),
    "cifar10-fixture": lambda m: m.load_cifar10(str(FIXTURES / "cifar10_batches")),
    "reuters-fixture": lambda m: m.load_reuters(str(FIXTURES / "reuters_tiny.npz")),
}


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_datasets_and_preprocessing(case):
    """Every loader and preprocessing call, the synthetic surrogates and the
    committed fixtures: the JAX package's arrays bit for bit, same dtypes."""
    _same(DATASET_CASES[case](port_datasets), DATASET_CASES[case](ref_datasets))


def test_mnist_idx_file_loader(tmp_path):
    """Canonical IDX files, gzipped and raw, load alike in both packages
    and give the written arrays."""
    rng = np.random.RandomState(0)

    def write_idx(path, arr, magic, gz):
        data = struct.pack(">i", magic) + struct.pack(">" + "i" * arr.ndim, *arr.shape) + arr.tobytes()
        with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
            f.write(data)

    xtr = rng.randint(0, 255, (12, 28, 28)).astype(np.uint8)
    ytr = rng.randint(0, 10, 12).astype(np.uint8)
    xte = rng.randint(0, 255, (5, 28, 28)).astype(np.uint8)
    yte = rng.randint(0, 10, 5).astype(np.uint8)
    write_idx(tmp_path / "train-images-idx3-ubyte.gz", xtr, 0x803, True)
    write_idx(tmp_path / "train-labels-idx1-ubyte.gz", ytr, 0x801, True)
    write_idx(tmp_path / "t10k-images-idx3-ubyte", xte, 0x803, False)
    write_idx(tmp_path / "t10k-labels-idx1-ubyte", yte, 0x801, False)
    got = port_datasets.load_mnist(str(tmp_path))
    _same(got, ref_datasets.load_mnist(str(tmp_path)))
    _same(got, ((xtr, ytr.astype(np.int64)), (xte, yte.astype(np.int64))))
    os.remove(tmp_path / "t10k-labels-idx1-ubyte")
    for mod in (port_datasets, ref_datasets):
        with pytest.raises(FileNotFoundError, match="t10k-labels-idx1-ubyte"):
            mod.load_mnist(str(tmp_path))


def test_mnist_npz_and_cifar_pickle_loaders(tmp_path):
    rng = np.random.RandomState(1)
    xtr = rng.randint(0, 255, (8, 28, 28)).astype(np.uint8)
    ytr = rng.randint(0, 10, 8)
    np.savez(tmp_path / "mnist.npz", x_train=xtr, y_train=ytr, x_test=xtr[:2], y_test=ytr[:2])
    got = port_datasets.load_mnist(str(tmp_path / "mnist.npz"))
    _same(got, ref_datasets.load_mnist(str(tmp_path / "mnist.npz")))
    np.testing.assert_array_equal(got[0][0], xtr)
    cdir = tmp_path / "cifar"
    cdir.mkdir()
    for name, n in [(f"data_batch_{i}", 4) for i in range(1, 6)] + [("test_batch", 3)]:
        with open(cdir / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 255, (n, 3072)).astype(np.uint8),
                         b"labels": list(rng.randint(0, 10, n))}, f)
    got = port_datasets.load_cifar10(str(cdir))
    _same(got, ref_datasets.load_cifar10(str(cdir)))
    assert got[0][0].shape == (20, 3, 32, 32) and got[1][0].shape == (3, 3, 32, 32)


# --- the package's boundary and the example ----------------------------------
def test_frontends_and_the_example_import_no_jax_tensorflow_keras_or_onnx():
    code = ("import sys; import dlrm_flexflow_tpu_torch.frontends, dlrm_flexflow_tpu_torch.examples.import_models; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dlrm_flexflow_tpu', 'tensorflow', 'keras', 'onnx')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_frontends_export_the_jax_packages_public_names():
    import dlrm_flexflow_tpu.frontends as ref_frontends
    import dlrm_flexflow_tpu_torch.frontends as port_frontends

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")}

    assert public(port_frontends) >= public(ref_frontends) - {"annotations"}
    for r, p in ((RK, PK), (ref_fx, port_fx), (ref_onnx, port_onnx), (ref_tf, port_tf),
                 (ref_datasets, port_datasets)):
        names = {n for n in public(r) if callable(getattr(r, n)) and getattr(getattr(r, n), "__module__", "")
                 == r.__name__}
        assert names and names <= public(p), sorted(names - public(p))


def test_import_models_example_runs_both_tours_on_the_cpu(tf, capsys):
    from dlrm_flexflow_tpu_torch.examples import import_models

    got = import_models.main(["--device", "cpu"])
    assert got["torch"]["shape"] == (8, 4) and got["torch"]["ops"] == ["input", "linear", "relu", "linear", "output"]
    assert 0.0 <= got["torch"]["history"]["accuracy"] <= 1.0
    assert got["tf"]["max_abs_diff"] < 1e-5
    out = capsys.readouterr().out
    assert "torch.fx import" in out and "tf.keras import" in out
    assert set(import_models.main(["--device", "cpu", "--tours", "torch"])) == {"torch"}
    with pytest.raises(SystemExit):
        import_models.main(["--device", "cpu", "--tours", "torch,caffe"])
