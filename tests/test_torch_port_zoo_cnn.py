"""The port's convolutional and recurrent zoo models against the JAX
package's, on the CPU: mnist_cnn, cifar10_cnn, alexnet, resnet (with
`_bottleneck`), inception_v3 (with `_inception_a` to `_inception_e`) and
nmt.

All six build graphs equal to the JAX package's at their default widths
(op names, kinds and order, output and parameter shapes); alexnet, resnet
and inception_v3 are too large to run here, so they are only built.
mnist_cnn and cifar10_cnn run whole at batch 2, each ResNet and Inception
block on a small model of its own (a few input channels, a small image),
and nmt at small widths (as tests/test_nmt.py), with its tables on the
one-hot lookup and on the sparse update path: the JAX model's weights
carried by `params_from_jax`, the same numpy inputs, the forward, then 3
SGD steps (each step's loss, then every weight).

Tolerances: f32 compute, so both sides sum f32 products in other orders:
rtol 1e-5, atol 1e-6 on losses, and atol 1e-6 plus 1e-5 of the largest
magnitude on outputs and weights (a sum that cancels keeps the absolute
error of its largest terms).
"""
import numpy as np
import pytest

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.models import zoo as ref_zoo

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.models import zoo as port_zoo

F32_TOL = dict(rtol=1e-5, atol=1e-6)
SCCE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
NMT_SMALL = dict(batch_size=4, src_len=6, dst_len=5, hidden_size=32, embed_size=24, vocab_size=50, num_layers=2)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 + 1e-5 * float(np.abs(want).max()))


def _graph(model):
    return [(op.name, type(op).__name__, op.op_type.name, [tuple(t.shape) for t in op.outputs],
             [(p.key, tuple(p.shape)) for p in op.params], [t.owner_op.name for t in op.inputs])
            for op in model.graph.ops]


@pytest.mark.parametrize("name", ["mnist_cnn", "cifar10_cnn", "alexnet", "resnet", "inception_v3", "nmt"])
def test_zoo_graph_matches_jax_at_its_default_widths(name):
    r = getattr(ref_zoo, name)()
    p = getattr(port_zoo, name)(device="cpu")
    assert _graph(p) == _graph(r)
    assert p.config.batch_size == r.config.batch_size


def _pair(build, cdt="float32", batch=2, **cfg):
    """The JAX and port models from `build(pkg, zoo, config, **device)`,
    SGD-compiled, the JAX weights carried over."""
    r = build(ref, ref_zoo, ref.FFConfig(batch_size=batch, compute_dtype=cdt, **cfg))
    p = build(port, port_zoo, port.FFConfig(batch_size=batch, compute_dtype=cdt, **cfg), device="cpu")
    return r, p


def _train_alike(r, p, feeds, labels, loss, lr, batch):
    """Compile both under SGD(lr), carry the weights, then the forward of
    the first batch and 3 steps on the batches of `feeds` against each
    other; every weight after."""
    r.compile(ref.SGDOptimizer(lr=lr), getattr(ref.LossType, loss))
    p.compile(port.SGDOptimizer(lr=lr), getattr(port.LossType, loss))
    p.set_parameters(params_from_jax({op: r.get_weights(op) for op in r.get_parameters()}))
    first = {k: v[:batch] for k, v in feeds.items()}
    _close(p.forward(first).numpy(), np.asarray(r.forward(first)))
    for i in range(3):
        sl = slice(i * batch, (i + 1) * batch)
        batch_feeds = {k: v[sl] for k, v in feeds.items()}
        np.testing.assert_allclose(float(p.train_batch(batch_feeds, labels[sl])),
                                   float(r.train_batch(batch_feeds, labels[sl])), **F32_TOL)
    for op in r.get_parameters():
        for k, v in r.get_weights(op).items():
            _close(p.get_weights(op)[k], np.asarray(v))


@pytest.mark.parametrize("name", ["mnist_cnn", "cifar10_cnn"])
def test_cnn_forward_and_sgd_steps_match_jax(name):
    r, p = _pair(lambda pkg, zoo, cfg, **kw: getattr(zoo, name)(batch_size=2, config=cfg, **kw))
    shape = tuple(p.graph.inputs[0].outputs[0].shape[1:])
    rng = np.random.default_rng(1)
    feeds = {"image": rng.standard_normal((6,) + shape).astype(np.float32)}
    labels = rng.integers(0, 10, (6, 1)).astype(np.int32)
    _train_alike(r, p, feeds, labels, SCCE, 0.05, 2)


# block -> (its call on (model, t), input [C, H, W])
BLOCKS = {
    "bottleneck-s1": (lambda zoo, m, t: zoo._bottleneck(m, t, 4, 1), (16, 6, 6)),
    "bottleneck-s2": (lambda zoo, m, t: zoo._bottleneck(m, t, 4, 2), (8, 7, 7)),
    "inception_a": (lambda zoo, m, t: zoo._inception_a(m, t, 8), (6, 5, 5)),
    "inception_b": (lambda zoo, m, t: zoo._inception_b(m, t), (6, 7, 7)),
    "inception_c": (lambda zoo, m, t: zoo._inception_c(m, t, 8), (6, 5, 5)),
    "inception_d": (lambda zoo, m, t: zoo._inception_d(m, t), (6, 7, 7)),
    "inception_e": (lambda zoo, m, t: zoo._inception_e(m, t), (6, 4, 4)),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_resnet_and_inception_blocks_match_jax(block):
    """Each block on a small model of its own (the block's output under
    MSE): its graph (the 1x7 and 7x1 kernels and paddings, the stride-2
    projection, the concat on axis 1, the 3x3 AVG pools at stride 1 and
    padding 1), the forward and 3 SGD steps."""
    call, shape = BLOCKS[block]

    def build(pkg, zoo, cfg, **kw):
        m = pkg.FFModel(cfg, **kw)
        call(zoo, m, m.create_tensor([2, *shape], name="image"))
        return m

    r, p = _pair(build)
    assert _graph(p) == _graph(r)
    rng = np.random.default_rng(2)
    out = tuple(p.graph.compute_ops[-1].outputs[0].shape[1:])
    feeds = {"image": rng.standard_normal((6,) + shape).astype(np.float32)}
    labels = rng.standard_normal((6,) + out).astype(np.float32)
    _train_alike(r, p, feeds, labels, MSE, 1e-3, 2)


@pytest.mark.parametrize("tables", ["onehot", "sparse"])
def test_nmt_forward_and_sgd_steps_match_jax(tables):
    """nmt at small widths, [B, T] labels against [B, T, V] logits. "sparse":
    vocab 50 above onehot_embedding_threshold 16, so both tables take the
    sparse update path; with the kernel route asked for (packed_tables
    "on"), D = 24 does not divide 128 and keeps them on the scatter rule,
    as the reference's D = 2048 does (the JAX package's
    core/ffmodel.py:753-773, 815)."""
    cfg = {"onehot": {}, "sparse": dict(onehot_embedding_threshold=16, packed_tables="on")}[tables]
    r, p = _pair(lambda pkg, zoo, c, **kw: zoo.nmt(config=c, **NMT_SMALL, **kw), batch=4, **cfg)
    rng = np.random.default_rng(3)
    feeds = {"src_tokens": rng.integers(0, 50, (12, 6)).astype(np.int32),
             "dst_tokens": rng.integers(0, 50, (12, 5)).astype(np.int32)}
    _train_alike(r, p, feeds, feeds["dst_tokens"], SCCE, 0.3, 4)
    assert [(op.name, op.kernel_route) for op in p._sparse_ops] == (
        [("src_embed", False), ("dst_embed", False)] if tables == "sparse" else [])


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


def test_mesh_compile_refuses_cnn_and_nmt_graphs_naming_expert_parallelism(world_of_one):
    """compile(mesh=, plan=data_parallel_plan()) takes the convolutional and
    recurrent graphs (refused, naming expert parallelism, before the op
    library trained under a mesh; tests/test_torch_port_mesh_zoo.py holds
    nmt on 4 ranks): in a world of one, mnist_cnn and nmt (its tables on
    the sparse path) each take one SGD step equal bit for bit to the same
    model's compiled with no mesh."""
    from dlrm_flexflow_tpu_torch.parallel.plan import data_parallel_plan

    rng = np.random.default_rng(4)
    toks = rng.integers(0, 50, (4, 6)).astype(np.int32)
    cases = [(lambda: port_zoo.mnist_cnn(batch_size=4, config=port.FFConfig(batch_size=4), device="cpu"),
              {"image": rng.standard_normal((4, 1, 28, 28)).astype(np.float32)},
              rng.integers(0, 10, (4, 1)).astype(np.float32)),
             (lambda: port_zoo.nmt(config=port.FFConfig(batch_size=4, onehot_embedding_threshold=16), device="cpu",
                                   **NMT_SMALL),
              {"src_tokens": toks, "dst_tokens": toks[:, :5]}, toks[:, :5].astype(np.float32))]
    for build, feeds, labels in cases:
        models = [build(), build()]
        for m, mesh in zip(models, (world_of_one, None)):
            m.compile(port.SGDOptimizer(lr=0.1), port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, mesh=mesh,
                      plan=data_parallel_plan() if mesh is not None else None)
        assert models[0].mesh is world_of_one and models[1].mesh is None
        assert [op.name for op in models[0]._sparse_ops] == [op.name for op in models[1]._sparse_ops]
        assert float(models[0].train_batch(feeds, labels)) == float(models[1].train_batch(feeds, labels))
        for name in models[1].get_parameters():
            for k, v in models[1].get_weights(name).items():
                np.testing.assert_array_equal(models[0].get_weights(name)[k], v)
