"""The PyTorch port's ops against the JAX package's, on shared inputs.

Each case builds the same one-op graph in both packages, feeds it the same
numpy arrays and weights, and runs the JAX package's `Graph.execute` and
the port's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.core.graph import OpContext as RefContext
from dlrm_flexflow_tpu.ops.common import apply_activation as ref_activation

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.core.graph import OpContext as PortContext
from dlrm_flexflow_tpu_torch.ops.common import apply_activation as port_activation

B = 9


def _run_both(build, feeds, params, compute_dtype="float32", onehot_threshold=0, use_pallas="off"):
    """build(model, pkg) adds ops to a model of package pkg; returns the
    outputs of its last op from the JAX package and from the port."""
    rm = ref.FFModel(ref.FFConfig(batch_size=B))
    build(rm, ref)
    rctx = RefContext(
        training=False, compute_dtype=jnp.dtype(compute_dtype),
        onehot_threshold=onehot_threshold, use_pallas=use_pallas,
    )
    (r,) = rm.graph.execute(
        {op: {k: jnp.asarray(v) for k, v in sub.items()} for op, sub in params.items()},
        {k: jnp.asarray(v) for k, v in feeds.items()},
        rctx,
    )
    pm = port.FFModel(port.FFConfig(batch_size=B), device="cpu")
    build(pm, port)
    pctx = PortContext(
        compute_dtype=port.DataType(compute_dtype).to_torch(),
        onehot_threshold=onehot_threshold, use_pallas=use_pallas,
    )
    (p,) = pm.graph.execute(
        {op: {k: torch.from_numpy(v) for k, v in sub.items()} for op, sub in params.items()},
        {k: torch.from_numpy(v) for k, v in feeds.items()},
        pctx,
    )
    return np.asarray(r), p.numpy()


ACTS = ["AC_MODE_NONE", "AC_MODE_RELU", "AC_MODE_SIGMOID", "AC_MODE_TANH", "AC_MODE_GELU"]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_dense_matches_reference(compute_dtype, act):
    rng = np.random.default_rng(10)
    feeds = {"x": rng.standard_normal((B, 24)).astype(np.float32)}
    params = {
        "fc": {
            "kernel": rng.standard_normal((40, 24)).astype(np.float32) * 0.3,
            "bias": rng.standard_normal((40,)).astype(np.float32),
        }
    }

    def build(m, pkg):
        t = m.create_tensor([B, 24], name="x")
        m.dense(t, 40, activation=getattr(pkg.ActiMode, act), name="fc")

    r, p = _run_both(build, feeds, params, compute_dtype)
    # both multiply compute-dtype operands with f32 sums; they differ only
    # in the order of the f32 sum (the bf16 rounding happens before it)
    np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)


AGGRS = ["AGGR_MODE_SUM", "AGGR_MODE_AVG", "AGGR_MODE_NONE"]


@pytest.mark.parametrize("onehot_threshold", [8192, 0], ids=["onehot", "gather"])
@pytest.mark.parametrize("aggr", AGGRS)
def test_embedding_matches_reference(aggr, onehot_threshold):
    rng = np.random.default_rng(11)
    vocab, dim, bag = 50, 16, 3
    idx = rng.integers(0, vocab, size=(B, bag)).astype(np.int64)
    idx[2, 1:] = -1  # padding
    idx[5, :] = -1  # a fully padded bag
    feeds = {"ids": idx}
    params = {"emb": {"weight": rng.standard_normal((vocab, dim)).astype(np.float32)}}

    def build(m, pkg):
        t = m.create_tensor([B, bag], pkg.DataType.DT_INT64, name="ids")
        m.embedding(t, vocab, dim, getattr(pkg.AggrMode, aggr), name="emb")

    r, p = _run_both(build, feeds, params, "bfloat16", onehot_threshold)
    assert p.shape == r.shape
    # one-hot: bf16-rounded rows summed in f32 on both sides; gather: exact
    # f32 rows summed in f32 (AVG adds one f32 division)
    np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("onehot_threshold", [8192, 0], ids=["onehot", "gather"])
def test_embedding_out_of_range_index_matches_reference(onehot_threshold):
    """An index >= vocab adds a zero row on the one-hot path and NaN on the
    gather path (jnp.take's fill mode) in both packages."""
    rng = np.random.default_rng(12)
    idx = np.array([[1, 60], [2, 3], [70, -1]], dtype=np.int64)
    feeds = {"ids": idx}
    params = {"emb": {"weight": rng.standard_normal((50, 8)).astype(np.float32)}}

    def build(m, pkg):
        t = m.create_tensor([3, 2], pkg.DataType.DT_INT64, name="ids")
        m.embedding(t, 50, 8, pkg.AggrMode.AGGR_MODE_AVG, name="emb")

    r, p = _run_both(build, feeds, params, "float32", onehot_threshold)
    np.testing.assert_array_equal(np.isnan(p), np.isnan(r))
    np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6)


def test_concat_matches_reference():
    rng = np.random.default_rng(13)
    feeds = {
        "a": rng.standard_normal((B, 3)).astype(np.float32),
        "b": rng.standard_normal((B, 5)).astype(np.float32),
    }

    def build(m, pkg):
        a = m.create_tensor([B, 3], name="a")
        b = m.create_tensor([B, 5], name="b")
        m.concat([b, a], axis=1, name="cat")

    r, p = _run_both(build, feeds, {})
    np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("act", ACTS)
def test_activation_matches_reference(act):
    x = np.linspace(-6.0, 6.0, 301, dtype=np.float32)
    r = ref_activation(jnp.asarray(x), getattr(ref.ActiMode, act))
    p = port_activation(torch.from_numpy(x), getattr(port.ActiMode, act))
    np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_pallas", ["off", "auto"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dot_interaction_op_matches_reference_plain_path(use_pallas, compute_dtype):
    """On the CPU "auto" resolves to the plain path in both packages, which
    rounds the inputs to the compute dtype and sums in f32."""
    rng = np.random.default_rng(14)
    feeds = {f"f{i}": rng.standard_normal((B, 16)).astype(np.float32) for i in range(5)}

    def build(m, pkg):
        ts = [m.create_tensor([B, 16], name=f"f{i}") for i in range(5)]
        m.dot_interaction(ts, name="dot")

    r, p = _run_both(build, feeds, {}, compute_dtype, use_pallas=use_pallas)
    np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)


def test_dot_interaction_op_on_routes_to_f32_kernel_path():
    """use_pallas="on" takes the kernel path, which computes in f32 whatever
    the compute dtype (on the CPU, the kernel's plain version)."""
    rng = np.random.default_rng(15)
    xs = [torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)) for _ in range(3)]
    m = port.FFModel(port.FFConfig(batch_size=8), device="cpu")
    op = m.dot_interaction([m.create_tensor([8, 128]) for _ in range(3)]).owner_op
    on = op.forward({}, xs, PortContext(compute_dtype=torch.bfloat16, use_pallas="on"))[0]
    off = op.forward({}, xs, PortContext(compute_dtype=torch.bfloat16, use_pallas="off"))[0]
    f32 = op.forward({}, xs, PortContext(compute_dtype=torch.float32, use_pallas="off"))[0]
    torch.testing.assert_close(on, f32, rtol=1e-6, atol=1e-5)
    assert (on - off).abs().max() > 1e-3  # bf16 inputs really are rounded off the kernel path
