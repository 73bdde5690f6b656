"""The PyTorch port under use_pallas="on" against the JAX package.

The forced kernels K6 (fused dense), K4 (embedding bag) and K5f (one-hot
lookup) run in CUDA only on the card (chip_smoke.py and
tests/test_torch_port_cuda.py hold them against their plain versions
there). Here each wrapper takes its plain version, because the tensors lie
on the CPU; the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them. A whole JAX model under "on" calls
its kernels without `interpret=True`, so it runs inside
`pltpu.force_tpu_interpret_mode()`.

Tolerances: where both sides round the same operands to bf16 and sum exact
products in f32 in another order, each f32 sum of n terms is within
n * 2^-24 * sum |term| of the exact one, so the two within twice that; a
result rounded to bf16 afterwards may land one bf16 step apart (at most
2^-7 of its magnitude) where that difference crosses a rounding boundary.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.core.graph import OpContext as RefContext
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm
from dlrm_flexflow_tpu.ops.embedding import packed_embedding_bag
from dlrm_flexflow_tpu.ops.pallas.embedding_bag import embedding_bag_pallas
from dlrm_flexflow_tpu.ops.pallas.fused_mlp import dense_pallas
from dlrm_flexflow_tpu.ops.pallas.onehot_embedding import onehot_embedding_pallas
from dlrm_flexflow_tpu.ops.pallas.packed_update import pack_table

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch import _build
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.core.graph import OpContext as PortContext
from dlrm_flexflow_tpu_torch.data import synthetic as port_synthetic
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm
from dlrm_flexflow_tpu_torch.ops import dense as port_dense
from dlrm_flexflow_tpu_torch.ops import embedding as port_embedding
from dlrm_flexflow_tpu_torch.ops import kernels as port_kernels
from dlrm_flexflow_tpu_torch.ops.embedding import embedding_bag_onehot
from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import embedding_bag, embedding_bag_backward
from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense, fused_dense_reference
from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import onehot_embedding

F32_UNIT = 2.0**-24
BF16_STEP = 2.0**-7  # one bf16 step, relative to the value, at most
SUM, AVG = port.AggrMode.AGGR_MODE_SUM, port.AggrMode.AGGR_MODE_AVG
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------------- K6
DENSE_CASES = [
    # m, k, n, activation, bias, compute dtype
    (37, 13, 1, "AC_MODE_SIGMOID", True, torch.bfloat16),  # ragged M, K = 13, N = 1
    (40, 48, 24, "AC_MODE_RELU", True, torch.bfloat16),
    (16, 128, 130, "AC_MODE_NONE", False, torch.bfloat16),
    (9, 479 // 8, 33, "AC_MODE_RELU", True, torch.float32),
    (24, 32, 40, "AC_MODE_SIGMOID", False, torch.float32),
    (8, 20, 16, "AC_MODE_NONE", True, torch.float32),
]


@pytest.mark.parametrize("m, k, n, act, bias, cdt", DENSE_CASES)
def test_fused_dense_plain_version_matches_dense_pallas(m, k, n, act, bias, cdt):
    x = _np((m, k), 1)
    w = _np((n, k), 2, 0.3)  # the [out, in] parameter
    b = _np((n,), 3) if bias else None
    mode = getattr(port.ActiMode, act)
    jdt = JAX_DT[cdt]
    want = dense_pallas(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).T.astype(jdt),
        None if b is None else jnp.asarray(b).astype(jdt),
        getattr(ref.ActiMode, act), interpret=True,
    ).astype(jnp.float32)
    got = fused_dense(
        torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b), mode, cdt
    )
    assert got.dtype == torch.float32 and got.shape == (m, n)
    xc = torch.from_numpy(x).to(cdt).float()
    wc = torch.from_numpy(w).to(cdt).float()
    mag = xc.abs() @ wc.abs().t() + (0 if b is None else torch.from_numpy(b).abs())
    want = torch.from_numpy(np.array(want))
    tol = 2 * k * F32_UNIT * mag + 4 * F32_UNIT * want.abs()
    if cdt == torch.bfloat16:
        tol += BF16_STEP * want.abs()
        assert torch.equal(got, got.to(torch.bfloat16).float())  # rounded to bf16 already
    assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max()


def test_fused_dense_keeps_bf16_input_dtype_and_refuses_what_it_cannot_take():
    x = torch.from_numpy(_np((5, 8), 4)).to(torch.bfloat16)
    w = torch.from_numpy(_np((3, 8), 5))
    got = fused_dense(x, w, None, port.ActiMode.AC_MODE_TANH, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got, fused_dense_reference(x, w, None, port.ActiMode.AC_MODE_TANH, torch.bfloat16), rtol=0, atol=0
    )
    with pytest.raises(ValueError):
        fused_dense(x, w[:, :4], None, port.ActiMode.AC_MODE_NONE, torch.bfloat16)  # K mismatch
    with pytest.raises(TypeError):
        fused_dense(x, w.double(), None, port.ActiMode.AC_MODE_NONE, torch.bfloat16)
    with pytest.raises(ValueError):
        fused_dense(x.float().t(), w, None, port.ActiMode.AC_MODE_NONE, torch.bfloat16)


def test_fused_dense_has_no_gradient_as_dense_pallas():
    x = torch.from_numpy(_np((4, 6), 6)).requires_grad_(True)
    w = torch.from_numpy(_np((2, 6), 7))
    y = fused_dense(x, w, None, port.ActiMode.AC_MODE_RELU, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no gradient"):
        y.sum().backward()


# ------------------------------------------------------------------- K4
def _bags(m, h, r, seed):
    idx = np.random.default_rng(seed).integers(0, r, size=(m, h)).astype(np.int64)
    if h > 1:
        idx[1, 2:] = -1  # padding
        idx[4, :] = -1  # a fully padded bag
        idx[6, 1] = idx[6, 0]  # a duplicate
    else:
        idx[3, 0] = -1
    return idx


@pytest.mark.parametrize("aggr", [SUM, AVG], ids=["sum", "avg"])
@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_embedding_bag_plain_version_matches_embedding_bag_pallas(aggr, h, dtype):
    r, d, m = 40, 128, 13
    table = torch.from_numpy(_np((r, d), 8)).to(dtype)
    idx = _bags(m, h, r, 9)
    want = embedding_bag_pallas(
        jnp.asarray(table.float().numpy()).astype(JAX_DT[dtype]), jnp.asarray(idx),
        getattr(ref.AggrMode, aggr.name), 8, True,
    )
    got = embedding_bag(table, torch.from_numpy(idx), aggr)
    assert got.dtype == dtype and got.shape == (m, d)
    # rows summed in f32 on both sides (exact for h = 1); a bf16 table rounds
    # the result once, possibly one bf16 step apart
    rtol = BF16_STEP if dtype == torch.bfloat16 else 2 * h * F32_UNIT
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=rtol, atol=1e-6)


def test_embedding_bag_index_past_the_table_gives_nan_as_the_plain_gather():
    table = torch.from_numpy(_np((10, 128), 10))
    idx = torch.tensor([[1, 12], [2, -1], [-1, -1]])
    got = embedding_bag(table, idx, AVG)
    want = port_embedding.embedding_bag(table, idx, AVG)
    assert torch.isnan(got[0]).all() and not torch.isnan(got[1:]).any()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6, equal_nan=True)


def test_embedding_bag_backward_matches_jax_grad():
    import jax

    table = _np((20, 128), 11)
    idx = _bags(9, 3, 20, 12)
    g = _np((9, 128), 13)

    def f(t):
        return jnp.sum(embedding_bag_pallas(t, jnp.asarray(idx), ref.AggrMode.AGGR_MODE_AVG, 8, True) * g)

    want = jax.grad(f)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    (embedding_bag(tt, torch.from_numpy(idx), AVG) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    direct = embedding_bag_backward(torch.from_numpy(idx), torch.from_numpy(g), AVG, (20, 128))
    torch.testing.assert_close(direct, tt.grad, rtol=0, atol=0)


# ------------------------------------------------------------------ K5f
def _onehot_bags(v):
    """SUM/AVG trap cases: duplicates with n_r = 2 and 3, padding, indices
    >= V (they count in AVG's divisor) and a fully padded bag."""
    return np.array([
        [0, 1, 2, 3],
        [5, 5, 6, -1],  # n_r = 2, padding
        [7, 7, 7, 2],  # n_r = 3
        [4, v, v + 3, 1],  # indices >= V
        [-1, -1, -1, -1],
        [v - 1, 3, v - 1, v - 1],
        [9, -1, 9, 9],
    ], dtype=np.int64)


@pytest.mark.parametrize("aggr", [SUM, AVG], ids=["sum", "avg"])
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_onehot_plain_version_matches_onehot_embedding_pallas(aggr, cdt):
    v, d = 11, 16
    table = _np((v, d), 14)
    idx = _onehot_bags(v)
    want = onehot_embedding_pallas(
        jnp.asarray(table), jnp.asarray(idx), getattr(ref.AggrMode, aggr.name), 8, True, JAX_DT[cdt]
    )
    got = onehot_embedding(torch.from_numpy(table), torch.from_numpy(idx), aggr, cdt)
    assert got.dtype == torch.float32
    # exact products w_r * row summed in f32 over at most 4 distinct rows
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=8 * F32_UNIT, atol=1e-7)


def test_onehot_avg_weight_is_rounded_per_row_unlike_the_plain_onehot_path():
    """A bag of 7 entries where row 2 appears 3 times: K5f weighs that row by
    bf16(3/7), which is not 3/7, while the plain one-hot path sums the rows
    and divides by 7 in f32. The two differ; K5f's plain version follows
    the TPU kernel."""
    table = torch.from_numpy(_np((5, 16), 15))
    idx = torch.tensor([[2, 2, 2, 1, 0, 3, 4]])
    k5f = onehot_embedding(table, idx, AVG, torch.bfloat16)
    plain = embedding_bag_onehot(table, idx, AVG, torch.bfloat16)
    want = onehot_embedding_pallas(
        jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()), ref.AggrMode.AGGR_MODE_AVG, 8, True,
        jnp.bfloat16,
    )
    np.testing.assert_allclose(k5f.numpy(), np.asarray(want), rtol=8 * F32_UNIT, atol=1e-7)
    assert (k5f - plain).abs().max() > 1e-4


def test_onehot_embedding_backward_matches_jax_grad():
    """K5b: the op is differentiable as `onehot_embedding_pallas` is; its
    plain gradient against `jax.grad` through the interpreted `_bwd_kernel`,
    on the trap bags (duplicates, padding, indices >= V, an empty bag)."""
    import jax

    v, d = 11, 16
    table = _np((v, d), 16)
    idx = _onehot_bags(v)
    g = _np((idx.shape[0], d), 17)

    def f(t):
        y = onehot_embedding_pallas(t, jnp.asarray(idx), ref.AggrMode.AGGR_MODE_AVG, 8, True, jnp.bfloat16)
        return jnp.sum(y * g)

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    (onehot_embedding(tt, torch.from_numpy(idx), AVG, torch.bfloat16) * torch.from_numpy(g)).sum().backward()
    assert tt.grad.dtype == torch.float32
    # exact bf16 products summed in f32 over at most 7 bags, in another order
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=14 * F32_UNIT, atol=1e-6)
    assert not tt.grad[v - 1 :].eq(0).all() and tt.grad[8].eq(0).all()  # row 8: no bag holds it


# -------------------------------------------------------------- routing
def test_ops_under_on_route_to_the_forced_kernels(monkeypatch):
    """Dense (rank 2) goes to K6, a pooled table of vocab <= the threshold to
    K5f, a pooled table with D % 128 == 0 to K4, and a table on the
    row-update route keeps the gather, as in the JAX package."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_dense, "fused_dense", spy("K6", port_dense.fused_dense))
    monkeypatch.setattr(port_embedding, "onehot_embedding", spy("K5f", port_embedding.onehot_embedding))
    monkeypatch.setattr(port_embedding, "embedding_bag_kernel", spy("K4", port_embedding.embedding_bag_kernel))
    monkeypatch.setattr(port_embedding, "embedding_bag", spy("gather", port_embedding.embedding_bag))

    m = port.FFModel(port.FFConfig(batch_size=4), device="cpu")
    x = m.create_tensor([4, 8])
    ids = m.create_tensor([4, 2], port.DataType.DT_INT64)
    ops = {
        "dense": m.dense(x, 16).owner_op,
        "small": m.embedding(ids, 100, 16).owner_op,
        "large_d128": m.embedding(ids, 10_000, 128).owner_op,
        "large_d16": m.embedding(ids, 10_000, 16).owner_op,
        "route": m.embedding(ids, 10_000, 128).owner_op,
        "unpooled": m.embedding(ids, 10_000, 128, port.AggrMode.AGGR_MODE_NONE).owner_op,
    }
    ops["route"].kernel_route = True
    gen = torch.Generator().manual_seed(0)
    xs = {"dense": [torch.randn(4, 8)]}
    idx = torch.tensor([[1, 2], [3, -1], [5, 5], [0, 9]])
    want = {"dense": ["K6"], "small": ["K5f"], "large_d128": ["K4"], "large_d16": ["gather"],
            "route": ["gather"], "unpooled": ["gather"]}
    for up in ("on", "auto", "off"):
        ctx = PortContext(training=False, compute_dtype=torch.bfloat16, onehot_threshold=8192, use_pallas=up)
        for name, op in ops.items():
            calls.clear()
            op.forward(op.init_params(gen, torch.device("cpu")), xs.get(name, [idx]), ctx)
            if up == "on":
                assert calls == want[name], (name, calls)
            else:
                assert not {"K6", "K5f", "K4"} & set(calls), (up, name, calls)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_dense_op_under_on_matches_reference_forced_kernel(compute_dtype):
    """The same one-op graph in both packages under "on": the JAX package's
    Dense calls dense_pallas (in the TPU interpreter here), the port's calls
    K6. Both round the bias and the output to the compute dtype."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((9, 24)).astype(np.float32)
    params = {"fc": {"kernel": rng.standard_normal((40, 24)).astype(np.float32) * 0.3,
                     "bias": rng.standard_normal((40,)).astype(np.float32)}}
    rm = ref.FFModel(ref.FFConfig(batch_size=9))
    rm.dense(rm.create_tensor([9, 24], name="x"), 40, activation=ref.ActiMode.AC_MODE_RELU, name="fc")
    with pltpu.force_tpu_interpret_mode():
        (r,) = rm.graph.execute(
            {"fc": {k: jnp.asarray(v) for k, v in params["fc"].items()}}, {"x": jnp.asarray(x)},
            RefContext(training=False, compute_dtype=jnp.dtype(compute_dtype), use_pallas="on"),
        )
    pm = port.FFModel(port.FFConfig(batch_size=9), device="cpu")
    pm.dense(pm.create_tensor([9, 24], name="x"), 40, activation=port.ActiMode.AC_MODE_RELU, name="fc")
    ctx = PortContext(training=False, compute_dtype=port.DataType(compute_dtype).to_torch(), use_pallas="on")
    (p,) = pm.graph.execute(
        {"fc": {k: torch.from_numpy(v) for k, v in params["fc"].items()}}, {"x": torch.from_numpy(x)}, ctx
    )
    r = np.asarray(r)
    rtol = BF16_STEP if compute_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=1e-5)
    off = pm.graph.execute(
        {"fc": {k: torch.from_numpy(v) for k, v in params["fc"].items()}}, {"x": torch.from_numpy(x)},
        PortContext(training=False, compute_dtype=ctx.compute_dtype, use_pallas="off"),
    )[0]
    if compute_dtype == "bfloat16":
        assert (p - off).abs().max() > 0  # "on" rounds bias and output, "off" does not


@pytest.mark.parametrize("aggr", [SUM, AVG], ids=["sum", "avg"])
def test_route_table_gives_a_zero_row_past_the_vocab_as_the_packed_lookup(aggr):
    """A table on the row-update route answers an index >= V with a zero row,
    as the JAX package's packed lookup does: it clips the index into the
    packed table, whose padding is zero. Here V = 50 rows of D = 16 pack 8 to
    a line, 7 lines padded to 8 (chunk of 4 lines): rows 50-63 are padding.

    One case still differs, by design: an index past the padding of a packed
    table that has none (V * D fills its chunks exactly) is clipped to row
    V - 1 in the JAX package, and reads as zero in the port.

    A table off the route keeps giving NaN, as `jnp.take` does
    (tests/test_torch_port_ops.py)."""
    v, d = 50, 16
    w = _np((v, d), 18)
    idx = np.array([[1, 49], [50, 3], [63, -1], [64, 200], [-1, -1], [7, 55]], dtype=np.int64)
    packed = pack_table(jnp.asarray(w), 4)
    assert packed.shape[0] * 128 // d > v  # the packed table has padding rows
    want = packed_embedding_bag(packed, jnp.asarray(idx), getattr(ref.AggrMode, aggr.name), d)
    m = port.FFModel(port.FFConfig(batch_size=6), device="cpu")
    op = m.embedding(m.create_tensor([6, 2], port.DataType.DT_INT64), v, d, aggr).owner_op
    op.kernel_route = True
    ctx = PortContext(training=False, compute_dtype=torch.bfloat16, use_pallas="on")
    (got,) = op.forward({"weight": torch.from_numpy(w)}, [torch.from_numpy(idx)], ctx)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_kernel_package_docstring_lists_every_kernel_module():
    for name in _build.kernel_names():
        assert f"{name}.py" in port_kernels.__doc__, name


# ---------------------------------------------------------- the slice
def test_train_batch_and_fit_raise_under_on():
    cfg = port_dlrm.mlperf_lite_config(batch_size=8, vocab_cap=100)
    m = port_dlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=8, use_pallas="on", packed_tables="off"),
                                  device="cpu")
    m.compile(loss_type=port.LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, labels = port_synthetic.random_batches(cfg, 16, seed=1)
    with pytest.raises(NotImplementedError, match="dense_pallas"):
        m.train_batch({k: v[:8] for k, v in feeds.items()}, labels[:8])
    with pytest.raises(NotImplementedError, match="use_pallas='on'"):
        m.fit(feeds, labels, epochs=1, verbose=False)
    loss = m.eval_batch({k: v[:8] for k, v in feeds.items()}, labels[:8])
    assert torch.isfinite(loss)


def test_mlperf_lite_predict_under_on_matches_reference_on_carried_weights():
    """mlperf-lite widths (bottom 13-512-256-128, top 479-1024-1024-512-256-1,
    26 tables at D = 128, dot interaction), batch 32, vocabs capped at 2000.
    The one-hot threshold is set to 1024 in both packages so that both
    forced lookups run: 9 tables (3 to 976 rows) take K5f, 17 take K4; all 8
    Dense layers take K6, the interaction K3. Both packages run
    use_pallas="on", packed_tables="off", bf16 compute; the weights are the
    JAX package's, carried by params_from_jax.

    Tolerance: the output is a sigmoid rounded to bf16 (K6 rounds every
    layer's output), so a sum order that flips a rounding moves the result
    by one bf16 step, 2^-8 in [0.5, 1); 2^-7 allows two."""
    bs, n = 32, 40  # one full request and a ragged one
    rcfg = ref_dlrm.mlperf_lite_config(batch_size=bs, vocab_cap=2000)
    pcfg = port_dlrm.mlperf_lite_config(batch_size=bs, vocab_cap=2000)
    kw = dict(batch_size=bs, use_pallas="on", packed_tables="off", onehot_embedding_threshold=1024)
    rm = ref_dlrm.make_dlrm_model(rcfg, ref.FFConfig(**kw))
    rm.compile(loss_type=ref.LossType.LOSS_BINARY_CROSSENTROPY)
    pm = port_dlrm.make_dlrm_model(pcfg, port.FFConfig(**kw), device="cpu")
    pm.compile(loss_type=port.LossType.LOSS_BINARY_CROSSENTROPY)
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    for op in rm.get_parameters():  # carried unchanged
        for k, v in rm.get_weights(op).items():
            np.testing.assert_array_equal(pm.get_weights(op)[k], v)
    small = sum(1 for v in pcfg.embedding_size if v <= 1024)
    assert small == 9
    feeds, _ = ref_synthetic.random_batches(rcfg, n, seed=19)
    with pltpu.force_tpu_interpret_mode():
        want = rm.predict(feeds)
    got = pm.predict(feeds)
    assert got.shape == want.shape == (n, 1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), rtol=0, atol=2.0**-7)
