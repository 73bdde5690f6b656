"""The port's zoo models against the JAX package's, on the CPU.

mnist_mlp, moe_mlp, transformer, candle_uno and bert_proxy at small widths
(the same graphs: op names, order, parameter shapes), the JAX model's
weights carried by `params_from_jax`, the same numpy inputs: the forward,
then 3 SGD and 3 Adam steps (each step's loss, then every weight). Under
use_pallas="on" moe_mlp's and candle_uno's rank-2 Dense layers take K6's
plain version in the port and `dense_pallas` in the TPU interpreter in the
JAX package (`pltpu.force_tpu_interpret_mode()`). The port's examples run a
tiny epoch each, and compile(mesh=) of these graphs takes them in a world
of one.

Tolerances: f32 compute, so both sides sum f32 products in other orders:
rtol 1e-5, atol 1e-6 on losses and SGD's weights; on outputs atol 1e-6
plus 1e-5 of the output's largest magnitude, since a sum that cancels
keeps the absolute error of its largest terms (bert_proxy, which has no
normalization, gives outputs near 50 at these widths). Adam moves a
weight by up to about 3.2 alpha a step however small its gradient, so
where the two summation orders give a gradient component near 0 other
signs the weights part by up to that (tests/test_torch_port_sparse_optim.py
ADAM_ATOL): every weight within 3 * 3.2 alpha after 3 steps, and all but 1
in 1000 of an array (or 1 of a smaller one) within rtol 1e-4, atol 1e-5.
bk's gradient is 0 in exact arithmetic (softmax ignores a shift shared by
a row's scores), so Adam moves it by the sign of rounding noise: only the
bound holds there. The attention models train on inputs of scale 0.5 at
lr 1e-3 (transformer) and 1e-4 (bert_proxy): with no normalization their
MSE steps at lr 0.05 (bert_proxy: 1e-3) overflow in both packages.
Under "on"
in bf16 K6 rounds each layer's output to bf16, and a flipped rounding
moves a value by one bf16 step (2^-8 of it) and the next layers by about
as much: rtol 2^-7 (two steps) on candle_uno's regression output, with
atol 2^-7 times its largest magnitude for outputs near 0. moe_mlp routes on
its gate's top 2, which a flipped bf16 rounding of a near-tie would change,
so its "on" case runs in f32 compute (K6 then rounds to f32): rtol 1e-5.
"""
import numpy as np
import jax
import pytest
from jax.experimental.pallas import tpu as pltpu

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.models import zoo as ref_zoo

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.models import zoo as port_zoo
from dlrm_flexflow_tpu_torch.ops import dense as port_dense
from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense

F32_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_ALPHA = 0.01
ADAM_ATOL = 3 * 3.2 * ADAM_ALPHA
ADAM_SHARE_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ON_RTOL = 2.0**-7
SCCE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"

# model -> (its function's kwargs, loss)
MODELS = {
    "mnist_mlp": (dict(batch_size=8), SCCE),
    "moe_mlp": (dict(batch_size=16, in_dim=12, num_classes=5), SCCE),
    "transformer": (dict(batch_size=2, seq_len=6, hidden=16, num_heads=2, num_layers=2), MSE),
    "candle_uno": (dict(batch_size=8, dense_layers=(12, 8), dense_feature_layers=(10, 6),
                        feature_shapes={"dose": 1, "cell.rnaseq": 7, "drug.descriptors": 13,
                                        "drug.fingerprints": 5}), MSE),
    "bert_proxy": (dict(batch_size=2, seq_length=6, hidden=16, num_heads=2, num_layers=2), MSE),
}
ATTENTION = ("transformer", "bert_proxy")


def _close_out(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 + 1e-5 * float(np.abs(want).max()))


def _models(name, cdt="float32", **cfg):
    kw, _ = MODELS[name]
    r = getattr(ref_zoo, name)(config=ref.FFConfig(batch_size=kw["batch_size"], compute_dtype=cdt, **cfg), **kw)
    p = getattr(port_zoo, name)(config=port.FFConfig(batch_size=kw["batch_size"], compute_dtype=cdt, **cfg),
                                device="cpu", **kw)
    return r, p


def _data(model, n, seed, scale=1.0):
    """Normal inputs of every graph input (std `scale`), n rows, and
    labels: class ids below the output width for softmax models, else
    unit-normal targets."""
    rng = np.random.default_rng(seed)
    feeds = {iop.name: (scale * rng.standard_normal((n,) + tuple(iop.outputs[0].shape[1:]))).astype(np.float32)
             for iop in model.graph.inputs}
    out = model.graph.compute_ops[-1].outputs[0].shape
    if type(model.graph.compute_ops[-1]).__name__ in ("Softmax", "Aggregate"):
        labels = rng.integers(0, out[-1], size=(n, 1)).astype(np.int32)
    else:
        labels = rng.standard_normal((n,) + tuple(out[1:])).astype(np.float32)
    return feeds, labels


def _carry(r, p):
    p.set_parameters(params_from_jax({op: r.get_weights(op) for op in r.get_parameters()}))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("name", list(MODELS))
def test_zoo_model_forward_and_training_match_jax(name, opt):
    r, p = _models(name)
    loss = MODELS[name][1]
    lr = {"transformer": 1e-3, "bert_proxy": 1e-4}.get(name, 0.05)
    make = {"sgd": (lambda pkg: pkg.SGDOptimizer(lr=lr)), "adam": (lambda pkg: pkg.AdamOptimizer(alpha=ADAM_ALPHA))}[opt]
    r.compile(make(ref), getattr(ref.LossType, loss))
    p.compile(make(port), getattr(port.LossType, loss))
    _carry(r, p)
    bs = MODELS[name][0]["batch_size"]
    feeds, labels = _data(p, 3 * bs, seed=5, scale=0.5 if name in ATTENTION else 1.0)
    first = {k: v[:bs] for k, v in feeds.items()}
    _close_out(p.forward(first).numpy(), np.asarray(r.forward(first)))
    for i in range(3):
        sl = slice(i * bs, (i + 1) * bs)
        batch = {k: v[sl] for k, v in feeds.items()}
        np.testing.assert_allclose(float(p.train_batch(batch, labels[sl])),
                                   float(r.train_batch(batch, labels[sl])), **F32_TOL)
    for op in r.get_parameters():
        for k, v in r.get_weights(op).items():
            got = p.get_weights(op)[k]
            if opt == "sgd":
                np.testing.assert_allclose(got, v, **F32_TOL, err_msg=f"{op}/{k}")
                continue
            np.testing.assert_allclose(got, v, rtol=0, atol=ADAM_ATOL, err_msg=f"{op}/{k}")
            if k == "bk":
                continue
            off = ~np.isclose(got, v, **ADAM_SHARE_TOL)
            assert off.sum() <= max(1, 1e-3 * off.size), (op, k, off.sum(), off.size)


def test_params_from_jax_carries_every_zoo_parameter_one_to_one():
    """Attention's eight arrays, the experts' and the gate's Dense layers,
    candle's towers: the same ops, keys and shapes in both packages, the
    values carried bit for bit."""
    seen = set()
    for name in MODELS:
        r, p = _models(name)
        r.compile()
        p.compile()
        rp = {op: r.get_weights(op) for op in r.get_parameters()}
        assert {op: {k: v.shape for k, v in sub.items()} for op, sub in rp.items()} == \
            {op: {k: tuple(v.shape) for k, v in sub.items()} for op, sub in p.get_parameters().items()}
        _carry(r, p)
        for op, sub in rp.items():
            for k, v in sub.items():
                assert np.array_equal(p.get_weights(op)[k], v)
                seen.add(k)
    assert {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "kernel", "bias"} <= seen
    r, _ = _models("moe_mlp")
    assert {"gate_h", "gate_out", "expert0_h", "expert3_out"} <= set(r.graph.init_params(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name, cdt", [("moe_mlp", "float32"), ("candle_uno", "bfloat16")])
def test_zoo_predict_under_on_through_k6_matches_dense_pallas(name, cdt):
    """Every rank-2 Dense takes the forced kernel: K6's plain version here,
    `dense_pallas` interpreted in the JAX package; a ragged last request."""
    r, p = _models(name, cdt, use_pallas="on")
    r.compile()
    p.compile()
    _carry(r, p)
    bs = MODELS[name][0]["batch_size"]
    feeds, _ = _data(p, bs + 3, seed=8)
    dense_ops = sum(type(op).__name__ == "Dense" for op in p.graph.compute_ops)
    assert dense_ops == {"moe_mlp": 10, "candle_uno": 13}[name]
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return fused_dense(*a, **kw)

    orig, port_dense.fused_dense = port_dense.fused_dense, counting
    try:
        got = p.predict(feeds)
    finally:
        port_dense.fused_dense = orig
    assert len(calls) == 2 * dense_ops
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(r.predict(feeds), dtype=np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if cdt == "float32":
        _close_out(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ON_RTOL, atol=BF16_ON_RTOL * np.abs(want).max())


def test_bert_proxy_seq_length_zeroes_the_rows_past_it_as_jax():
    """With zero biases (a fresh compile) and seq_length 3 of 6, the rows
    past 3 come out zero, as the JAX package's padding gives them; the
    rest matches it."""
    r, p = _models("bert_proxy")
    r.compile()
    p.compile()
    _carry(r, p)
    feeds, _ = _data(p, 2, seed=9)
    r.set_iteration_config_sequence_length(3)
    p.set_iteration_config_sequence_length(3)
    got, want = p.forward(feeds).numpy(), np.asarray(r.forward(feeds))
    assert np.all(got[:, 3:] == 0) and np.all(want[:, 3:] == 0)
    _close_out(got, want)


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.launch import initialize
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    initialize("cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_compile_refuses_the_op_librarys_graphs(world_of_one):
    """compile(mesh=, plan=data_parallel_plan()) takes the op library's
    graphs (refused before the op library trained under a mesh, which
    tests/test_torch_port_mesh_zoo.py holds on 4 ranks): in a world of one,
    moe_mlp and a graph with a batch-shaped constant each take one SGD step
    equal bit for bit to the same model's compiled with no mesh."""
    from dlrm_flexflow_tpu_torch.parallel.plan import data_parallel_plan

    def const_graph():
        m = port.FFModel(port.FFConfig(batch_size=4), device="cpu")
        x = m.create_tensor([4, 3], name="x")
        m.dense(m.add(x, m.create_constant([4, 3], 1.0, name="c")), 2)
        return m

    x = np.random.default_rng(5).standard_normal((16, 12)).astype(np.float32)
    cases = [(lambda: _models("moe_mlp")[1], {"input": x}, np.arange(16, dtype=np.float32)[:, None] % 5, SCCE),
             (const_graph, {"x": x[:4, :3]}, x[:4, 3:5], MSE)]
    for build, feeds, labels, loss in cases:
        models = [build(), build()]
        for m, mesh in zip(models, (world_of_one, None)):
            m.compile(port.SGDOptimizer(lr=0.1), getattr(port.LossType, loss), mesh=mesh,
                      plan=data_parallel_plan() if mesh is not None else None)
        assert models[0].mesh is world_of_one and models[1].mesh is None
        l_mesh, l_one = (float(m.train_batch(feeds, labels)) for m in models)
        assert l_mesh == l_one
        for name in models[1].get_parameters():
            for k, v in models[1].get_weights(name).items():
                np.testing.assert_array_equal(models[0].get_weights(name)[k], v)


@pytest.mark.parametrize("example", ["mnist_mlp", "moe", "nmt"])
def test_port_examples_run_a_tiny_epoch(example, capsys):
    """Each example's epoch at batch 16 on 64 examples: finite step losses;
    the classifiers' accuracy (nmt compiles no metric, as its reference)."""
    import importlib
    import re

    mod = importlib.import_module(f"dlrm_flexflow_tpu_torch.examples.{example}")
    hist = mod.main(["--device", "cpu", "--batch-size", "16", "--epochs", "1", "--examples", "64"])
    out = capsys.readouterr().out
    assert hist["epoch_time_s"] > 0 and hist["samples"] == 64
    assert "epoch 0 done" in out
    losses = [float(v) for v in re.findall(r"loss=(\S+)", out)]
    assert losses and np.isfinite(losses).all()
    if example != "nmt":
        assert np.isfinite(hist["accuracy"])


def test_bert_proxy_at_its_widths_overflows_past_two_layers_in_both_packages():
    """bert_proxy at its default widths (seq 128, hidden 1024, 16 heads),
    batch 1, f32, a unit-normal input: with no softmax and no normalization
    each layer is cubic in its input, so 2 layers give outputs of std
    between 1e6 and 1e9, finite, and 4 layers give NaN, in the JAX package
    and in the port alike. Its default depth of 24 cannot run, so the card
    runs it at 2 layers (chip_smoke.py `zoo-attention`)."""
    x = np.random.default_rng(0).standard_normal((1, 128, 1024)).astype(np.float32)
    for layers in (2, 4):
        r = ref_zoo.bert_proxy(batch_size=1, num_layers=layers,
                               config=ref.FFConfig(batch_size=1, compute_dtype="float32"))
        p = port_zoo.bert_proxy(batch_size=1, num_layers=layers,
                                config=port.FFConfig(batch_size=1, compute_dtype="float32"), device="cpu")
        r.compile()
        p.compile()
        _carry(r, p)
        want, got = np.asarray(r.forward({"tokens": x})), p.forward({"tokens": x}).numpy()
        if layers == 2:
            assert np.isfinite(want).all() and np.isfinite(got).all()
            assert 1e6 < np.std(want.astype(np.float64)) < 1e9
            _close_out(got, want)
        else:
            assert np.isnan(want).any() and np.isnan(got).any()
