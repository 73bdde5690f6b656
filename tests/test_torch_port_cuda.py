"""The PyTorch port's CUDA kernels on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so it runs where JAX is not installed; on such a machine
run it without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import json
import time

import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu_torch import (
    ActiMode,
    AdamOptimizer,
    AggrMode,
    FFConfig,
    LossType,
    MetricsType,
    RowWiseAdagradOptimizer,
    SGDOptimizer,
)
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches, zipf_indices
from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config, make_dlrm_model, mlperf_lite_config
from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import (
    dot_interaction,
    dot_interaction_reference,
)
from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import embedding_bag, embedding_bag_reference
from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense, fused_dense_reference
from dlrm_flexflow_tpu_torch.ops.kernels import row_update as ru
from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import (
    backward_plan,
    onehot_embedding,
    onehot_embedding_backward,
    onehot_embedding_backward_reference,
    onehot_embedding_reference,
)
from dlrm_flexflow_tpu_torch.ops.kernels.row_gather import DEPTHS, row_gather, row_gather_reference
from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update, row_update_reference, sort_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _x(shape, dtype, seed, device):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize(
    "shape, self_interaction, dtype",
    [
        ((16384, 27, 128), False, torch.float32),
        ((16384, 27, 128), True, torch.float32),
        ((16384, 27, 128), False, torch.bfloat16),
        ((1000, 5, 16), False, torch.float32),
        ((7, 64, 300), True, torch.float32),
        ((33, 64, 1000), False, torch.bfloat16),
        ((5, 3, 7), True, torch.float32),
        ((1, 2, 1), False, torch.float32),
        ((3, 1, 5), True, torch.float32),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, self_interaction, dtype):
    x = _x(shape, dtype, 0, cuda)
    before = dot_interaction.launches
    got = dot_interaction(x, self_interaction)
    assert dot_interaction.launches == before + 1
    want = dot_interaction_reference(x, self_interaction)
    # f32 sums over D in another order than the bmm: each dot within
    # 2 * D * 2^-24 of the same dot taken over |x|
    tol = 2.0 * shape[2] * 2.0**-24 * dot_interaction_reference(x.abs(), self_interaction)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(((got - want).abs() <= tol).all())


def test_backward_through_kernel_matches_plain_autograd(cuda):
    x = _x((64, 27, 128), torch.float32, 1, cuda)
    g = _x((64, 351), torch.float32, 2, cuda)
    xk = x.clone().requires_grad_(True)
    (dot_interaction(xk, False) * g).sum().backward()
    xr = x.clone().requires_grad_(True)
    (dot_interaction_reference(xr, False) * g).sum().backward()
    torch.testing.assert_close(xk.grad, xr.grad, rtol=1e-5, atol=1e-4)


def test_predict_on_cuda_launches_kernel_and_matches_cpu(cuda):
    bs = 64
    cfg = mlperf_lite_config(batch_size=bs, vocab_cap=5_000)
    gpu = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=3), device=cuda)
    cpu = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=3), device="cpu")
    for m in (gpu, cpu):
        m.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
    # like with like: "auto" resolves to "off" on the CPU; set it back so that
    # the CPU model takes the CUDA model's routes (the interaction's f32
    # kernel path, plain Dense and lookups)
    cpu._ctx.use_pallas = "auto"
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, _ = random_batches(cfg, 2 * bs + 5, seed=3)
    before = dot_interaction.launches
    y_gpu = gpu.predict(feeds)
    assert dot_interaction.launches == before + 3
    # bf16-rounded MLP operands summed in f32 in another order; a flipped
    # bf16 rounding moves an activation by one bf16 step into the next layer
    np.testing.assert_allclose(y_gpu, cpu.predict(feeds), rtol=0, atol=2e-3)


def _row_case(d, table_dtype, h, k, v, seed, device, zipf=False):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(device, table_dtype)
    if zipf:
        rows = zipf_indices(rng, v, k, 1.05)
    else:
        rows = rng.integers(-3, v + 3, k)  # rows < 0 and >= V are dropped
    src = torch.from_numpy(rng.standard_normal((k // h, d)).astype(np.float32)).to(device)
    return table, torch.from_numpy(rows).to(device), src


def _row_tolerance(table, rows, src, h, scale, bf16_table):
    """The kernel sums each row's deltas in sorted order, the plain version
    with index_add_'s atomics in any order: within n * 2^-24 * (|t| +
    sum |delta|) each of the exact sum (n terms), so within twice that of
    each other; a bf16 table adds one bf16 step of the sum and one of the
    result where that difference flips a rounding."""
    v, d = table.shape
    keep = (rows >= 0) & (rows < v)
    k = torch.arange(rows.numel(), device=rows.device)[keep]
    mag = table.float().abs().clone()
    mag.index_add_(0, rows[keep], (scale * src[k // h]).abs())
    n = torch.ones(v, device=rows.device).index_add_(0, rows[keep], torch.ones_like(k, dtype=torch.float32))
    tol = 2 * n[:, None] * 2.0**-24 * mag
    return tol + 2 * 2.0**-8 * mag if bf16_table else tol


@pytest.mark.parametrize(
    "d, table_dtype, stream, h, k, v, zipf",
    [
        (16, torch.bfloat16, torch.bfloat16, 1, 65536, 1_000_000, False),
        (16, torch.float32, torch.float32, 1, 65536, 1_000_000, False),
        (16, torch.bfloat16, torch.bfloat16, 1, 65536, 1_000_000, True),
        (16, torch.float32, torch.bfloat16, 1, 16, 10_000_000, False),
        (1, torch.float32, torch.bfloat16, 2, 4000, 50, False),
        (4, torch.bfloat16, torch.float32, 4, 4096, 300, False),
        (100, torch.float32, torch.float32, 3, 3000, 2000, False),
        (128, torch.bfloat16, torch.bfloat16, 1, 1000, 10_000, True),
    ],
)
def test_row_update_kernel_matches_plain_version(cuda, d, table_dtype, stream, h, k, v, zipf):
    table, rows, src = _row_case(d, table_dtype, h, k, v, 0, cuda, zipf)
    scale = torch.tensor(-0.01, device=cuda)
    want = table.clone()
    row_update_reference(want, rows, (src, h), scale, stream)
    tol = _row_tolerance(table, rows, src, h, scale, table_dtype == torch.bfloat16)
    before = row_update.launches
    row_update([table], [rows], [(src, h)], scale, stream)
    torch.cuda.synchronize()
    assert row_update.launches == before + 1
    assert bool(((table.float() - want.float()).abs() <= tol).all())


def test_row_update_kernel_is_bit_reproducible_and_launches_once_per_table(cuda):
    tables, rows, srcs = zip(*[
        _row_case(16, torch.bfloat16, 1, 65536, v, s, cuda, zipf=True)
        for s, v in ((1, 100_000), (2, 3_000_000))
    ])
    scale = torch.tensor(-0.5, device=cuda)
    copies = [t.clone() for t in tables]
    before = row_update.launches
    row_update(list(tables), rows, srcs, scale)
    row_update(copies, rows, srcs, scale)
    assert row_update.launches == before + 4
    for a, b in zip(tables, copies):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_row_update_kernel_refuses_what_it_cannot_take(cuda):
    t = torch.zeros((10, 4), device=cuda)
    rows = torch.zeros(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        row_update([t], [rows], [torch.zeros((3, 4))], torch.tensor(1.0, device=cuda))  # payload on the CPU
    with pytest.raises(ValueError):
        row_update([t], [rows], [torch.zeros((3, 4), device=cuda)], torch.tensor(1.0))  # scale on the CPU


def test_kaggle_shaped_training_on_cuda_tracks_the_cpu(cuda):
    """16 one-hot and 10 kernel-route tables (bf16), bf16 compute: 3 steps
    on CUDA (the row-update kernel, 10 launches a step) against the CPU
    (plain versions) from the same weights."""
    bs = 128
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    kw = dict(batch_size=bs, compute_dtype="bfloat16", table_dtype="bfloat16", packed_tables="on", seed=4)
    gpu = make_dlrm_model(cfg, FFConfig(**kw), device=cuda)
    cpu = make_dlrm_model(cfg, FFConfig(**kw), device="cpu")
    for m in (gpu, cpu):
        m.compile(SGDOptimizer(lr=0.05), LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY])
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, labels = random_batches(cfg, 3 * bs, seed=4)
    before = row_update.launches
    for i in range(3):
        sl = slice(i * bs, (i + 1) * bs)
        batch = {k: v[sl] for k, v in feeds.items()}
        lg = gpu.train_batch(batch, labels[sl])
        lc = cpu.train_batch(batch, labels[sl])
        # bf16 operands summed in f32 in another order; a flipped bf16
        # rounding moves a value one bf16 step into the next layer
        assert abs(float(lg) - float(lc)) <= 2e-3
    assert row_update.launches == before + 30
    for name in gpu.get_parameters():
        for k, w in gpu.get_weights(name).items():
            np.testing.assert_allclose(w, cpu.get_weights(name)[k], rtol=0, atol=2e-3)


def _dense_tolerance(x, w, b, want, cdt):
    """The tensor cores sum exact bf16 products in f32 in another order than
    the plain f32 matmul and may truncate rather than round each addition:
    each within K * 2^-23 * sum |term| of the exact sum, so within 4 * K *
    2^-24 of each other; the activation is 1-Lipschitz but for GELU (1.13);
    a result rounded to bf16 may then land one bf16 step (2^-7 of its
    value, at most) away."""
    k = x.shape[1]
    mag = x.to(cdt).float().abs() @ w.to(cdt).float().abs().t()
    if b is not None:
        mag = mag + b.abs()
    tol = 1.2 * 4 * k * 2.0**-24 * mag + 4 * 2.0**-24 * want.float().abs()
    if cdt == torch.bfloat16:
        tol = tol + 2.0**-7 * want.float().abs()
    return tol


@pytest.mark.parametrize(
    "m, k, n, act, bias, cdt",
    [
        (16384, 13, 512, "AC_MODE_RELU", True, torch.bfloat16),  # mlperf-lite's 8 layers
        (16384, 512, 256, "AC_MODE_RELU", True, torch.bfloat16),
        (16384, 256, 128, "AC_MODE_RELU", True, torch.bfloat16),
        (16384, 479, 1024, "AC_MODE_RELU", True, torch.bfloat16),
        (16384, 1024, 1024, "AC_MODE_RELU", True, torch.bfloat16),
        (16384, 1024, 512, "AC_MODE_RELU", True, torch.bfloat16),
        (16384, 256, 1, "AC_MODE_SIGMOID", True, torch.bfloat16),
        (1000, 512, 256, "AC_MODE_RELU", True, torch.bfloat16),
        (1000, 13, 512, "AC_MODE_RELU", True, torch.bfloat16),
        (77, 100, 130, "AC_MODE_NONE", False, torch.bfloat16),
        (33, 64, 48, "AC_MODE_TANH", True, torch.bfloat16),
        (40, 96, 72, "AC_MODE_GELU", True, torch.bfloat16),
        (1000, 479, 1024, "AC_MODE_RELU", True, torch.float32),
        (65, 13, 1, "AC_MODE_SIGMOID", False, torch.float32),
    ],
)
def test_fused_dense_kernel_matches_plain_version(cuda, m, k, n, act, bias, cdt):
    x = _x((m, k), torch.float32, 5, cuda)
    w = _x((n, k), torch.float32, 6, cuda) * k**-0.5
    b = _x((n,), torch.float32, 7, cuda) if bias else None
    mode = getattr(ActiMode, act)
    before = fused_dense.launches
    got = fused_dense(x, w, b, mode, cdt)
    assert fused_dense.launches == before + 1
    want = fused_dense_reference(x, w, b, mode, cdt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if cdt == torch.bfloat16:
        assert torch.equal(got, got.to(torch.bfloat16).float())  # the output is rounded to bf16
    assert bool(((got - want).abs() <= _dense_tolerance(x, w, b, want, cdt)).all())


def test_fused_dense_kernel_takes_bf16_input(cuda):
    x = _x((300, 40), torch.bfloat16, 8, cuda)
    w = _x((24, 40), torch.float32, 9, cuda)
    got = fused_dense(x, w, None, ActiMode.AC_MODE_RELU, torch.bfloat16)
    want = fused_dense_reference(x, w, None, ActiMode.AC_MODE_RELU, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs() <= _dense_tolerance(x, w, None, want, torch.bfloat16)).all())


@pytest.mark.parametrize(
    "m, k, n, x_kind",
    [
        (16384, 479, 1024, "bf16"),  # a pitch TMA cannot read: rounded into the padded scratch
        (16384, 512, 256, "bf16"),  # read by TMA as it lies
        (1000, 256, 1, "bf16"),  # the narrow tile
        (1000, 1024, 1024, "misaligned"),  # an f32 x whose base is not 16-byte aligned
    ],
)
def test_fused_dense_kernel_on_bf16_x_and_on_x_that_tma_cannot_read_as_it_lies(cuda, m, k, n, x_kind):
    x = _x((m, k), torch.float32, 10, cuda)
    if x_kind == "bf16":
        x = x.to(torch.bfloat16)
    else:
        x = torch.empty(m * k + 1, device=cuda)[1:].view(m, k).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w = _x((n, k), torch.float32, 11, cuda) * k**-0.5
    b = _x((n,), torch.float32, 12, cuda)
    before = fused_dense.launches
    got = fused_dense(x, w, b, ActiMode.AC_MODE_RELU, torch.bfloat16)
    assert fused_dense.launches == before + 1
    want = fused_dense_reference(x, w, b, ActiMode.AC_MODE_RELU, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (m, n)
    assert torch.equal(got, got.to(torch.bfloat16).to(got.dtype))
    tol = _dense_tolerance(x, w, b, want, torch.bfloat16)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def _bag_idx(m, h, r, seed, device, past=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, r + past, size=(m, h))
    if h > 1:
        idx[:: 7, h // 2 :] = -1  # padding
        idx[3] = -1  # a fully padded bag
        idx[5, 1] = idx[5, 0]  # a duplicate
    return torch.from_numpy(idx).to(device)


@pytest.mark.parametrize(
    "r, d, m, h, aggr, dtype, idx_dtype",
    [
        (2_000_000, 128, 16384, 1, "AGGR_MODE_SUM", torch.float32, torch.int64),
        (100_000, 128, 4096, 4, "AGGR_MODE_AVG", torch.float32, torch.int64),
        (100_000, 128, 4096, 4, "AGGR_MODE_SUM", torch.bfloat16, torch.int32),
        (5000, 99, 777, 3, "AGGR_MODE_AVG", torch.float32, torch.int32),  # scalar loads
        (5000, 256, 500, 9, "AGGR_MODE_SUM", torch.bfloat16, torch.int64),
        (2_000_000, 128, 16384, 1, "AGGR_MODE_SUM", torch.float16, torch.int64),  # quantized serving
        (100_000, 128, 4096, 4, "AGGR_MODE_AVG", torch.float16, torch.int32),
        (5000, 99, 777, 3, "AGGR_MODE_SUM", torch.float16, torch.int64),  # scalar loads
    ],
)
def test_embedding_bag_kernel_matches_plain_version(cuda, r, d, m, h, aggr, dtype, idx_dtype):
    table = _x((r, d), dtype, 10, cuda)
    idx = _bag_idx(m, h, r, 11, cuda).to(idx_dtype)
    mode = getattr(AggrMode, aggr)
    before = embedding_bag.launches
    got = embedding_bag(table, idx, mode)
    assert embedding_bag.launches == before + 1
    want = embedding_bag_reference(table, idx, mode)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    # f32 sums of h rows in bag order against torch's sum order; a bf16 or
    # f16 table rounds the result once, possibly a step of its own apart
    rtol = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}.get(dtype, 2 * h * 2.0**-24)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-6)


def test_embedding_bag_kernel_gives_nan_past_the_table_and_reads_inside_it(cuda):
    table = _x((1000, 128), torch.float32, 12, cuda)
    idx = _bag_idx(2048, 2, 1000, 13, cuda, past=50)
    got = embedding_bag(table, idx, AggrMode.AGGR_MODE_AVG)
    want = embedding_bag_reference(table, idx, AggrMode.AGGR_MODE_AVG)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got).any())
    torch.testing.assert_close(got, want, rtol=4 * 2.0**-24, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize(
    "v, d, b, aggr, cdt, table_dtype",
    [
        (7424, 128, 16384, "AGGR_MODE_SUM", torch.bfloat16, torch.float32),
        (7424, 128, 16384, "AGGR_MODE_AVG", torch.bfloat16, torch.float32),
        (7424, 128, 4096, "AGGR_MODE_AVG", torch.float32, torch.float32),
        (3, 128, 1000, "AGGR_MODE_SUM", torch.bfloat16, torch.bfloat16),
        (500, 37, 999, "AGGR_MODE_AVG", torch.bfloat16, torch.float32),  # scalar loads
        (7424, 128, 16384, "AGGR_MODE_SUM", torch.bfloat16, torch.float16),  # quantized serving
        (7424, 128, 4096, "AGGR_MODE_AVG", torch.float32, torch.float16),
        (500, 37, 999, "AGGR_MODE_AVG", torch.bfloat16, torch.float16),  # scalar loads
    ],
)
def test_onehot_embedding_kernel_matches_plain_version(cuda, v, d, b, aggr, cdt, table_dtype):
    """Bags of 6 with duplicates (n_r = 2 and 3), padding and indices >= V."""
    rng = np.random.default_rng(14)
    idx = rng.integers(0, v, size=(b, 6))
    idx[:, 1] = idx[:, 0]  # n_r >= 2
    idx[::3, 2] = idx[::3, 0]  # n_r = 3
    idx[::5, 3] = -1
    idx[::4, 4] = v + 2  # matches no row, counts in AVG's divisor
    table = _x((v, d), table_dtype, 15, cuda)
    idx = torch.from_numpy(idx).to(cuda)
    mode = getattr(AggrMode, aggr)
    before = onehot_embedding.launches
    got = onehot_embedding(table, idx, mode, cdt)
    assert onehot_embedding.launches == before + 1
    want = onehot_embedding_reference(table, idx, mode, cdt)
    torch.cuda.synchronize()
    # exact products w_r * row summed in f32 over at most 6 distinct rows, in
    # another order; a bf16 or f16 table rounds the result once
    rtol = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}.get(table_dtype, 12 * 2.0**-24)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-6)


def test_predict_under_on_launches_every_forced_kernel_and_matches_cpu(cuda):
    """mlperf-lite widths, vocabs capped at 20000 (13 tables take K5f, 13
    K4), use_pallas="on" and packed_tables="off" on both devices: CUDA
    launches K3, K6, K4 and K5f; the CPU runs their plain versions."""
    bs = 64
    cfg = mlperf_lite_config(batch_size=bs, vocab_cap=20_000)
    kw = dict(batch_size=bs, seed=16, use_pallas="on", packed_tables="off")
    gpu = make_dlrm_model(cfg, FFConfig(**kw), device=cuda)
    cpu = make_dlrm_model(cfg, FFConfig(**kw), device="cpu")
    for m in (gpu, cpu):
        m.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, _ = random_batches(cfg, 2 * bs + 5, seed=16)
    counts = (dot_interaction, fused_dense, embedding_bag, onehot_embedding)
    before = [f.launches for f in counts]
    y_gpu = gpu.predict(feeds)
    assert [f.launches - b for f, b in zip(counts, before)] == [3, 24, 39, 39]
    # every layer's output is rounded to bf16 on both devices: a sum order
    # that flips a rounding moves the output a bf16 step (2^-8 in [0.5, 1))
    np.testing.assert_allclose(y_gpu, cpu.predict(feeds), rtol=0, atol=2.0**-7)


def _pools(rule, v, d, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    if rule in ("momentum", "nesterov"):
        return [torch.randn((v, d), generator=gen, device=device) * 1e-3]
    if rule == "adam":
        return [torch.randn((v, d), generator=gen, device=device) * 1e-3,
                torch.rand((v, d), generator=gen, device=device) * 1e-6]
    return [torch.rand((v,), generator=gen, device=device) * 0.1]


def _rule(rule, wd, table, pools, rows, src, h, plain):
    rate = torch.tensor(3e-3 if rule == "adam" else 0.01, device=table.device)
    p = (src, h)
    if rule in ("momentum", "nesterov"):
        args = (rate, 0.9, rule == "nesterov", wd)
        if plain:
            ru.momentum_reference(table, pools[0], rows, p, *args)
        else:
            ru.row_update_momentum([table], [pools[0]], [rows], [p], *args)
    elif rule == "adam":
        args = (rate, 0.9, 0.999, 1e-8, wd)
        if plain:
            ru.adam_reference(table, pools[0], pools[1], rows, p, *args)
        else:
            ru.row_update_adam([table], [pools[0]], [pools[1]], [rows], [p], *args)
    elif plain:
        ru.adagrad_reference(table, pools[0], rows, p, rate, 1e-10)
    else:
        ru.row_update_adagrad([table], [pools[0]], [rows], [p], rate, 1e-10)


@pytest.mark.parametrize(
    "rule, wd, d, table_dtype, h, k, v, zipf",
    [
        ("momentum", 0.0, 16, torch.bfloat16, 1, 65536, 1_000_000, False),
        ("nesterov", 0.0, 16, torch.bfloat16, 1, 65536, 1_000_000, False),
        ("momentum", 0.01, 8, torch.float32, 2, 4000, 500, False),
        ("adam", 0.0, 16, torch.bfloat16, 1, 65536, 1_000_000, False),
        ("adam", 0.01, 16, torch.bfloat16, 1, 65536, 1_000_000, True),
        ("adam", 0.0, 128, torch.float32, 3, 3000, 2000, False),
        ("adagrad", 0.0, 16, torch.bfloat16, 1, 65536, 1_000_000, False),
        ("adagrad", 0.0, 64, torch.bfloat16, 2, 4096, 300, True),
        ("adagrad", 0.0, 4, torch.float32, 4, 4096, 300, False),
    ],
)
def test_optimizer_mode_kernels_match_plain_versions(cuda, rule, wd, d, table_dtype, h, k, v, zipf):
    """Each rule's kernel against its plain version from the same table and
    pools: the pools within the sum-order bound (2 n 2^-24 of the summed
    magnitudes; AdaGrad's mean over D adds 2 D 2^-24), the table within two
    bf16 steps (2^-6) of |t| + |t'| + the row's summed |delta| (a flipped
    rounding of an entry, the delta or the epilogue); rows < 0 and >= V, and
    rows the stream does not touch, unchanged; a second run bit-identical."""
    table, rows, src = _row_case(d, table_dtype, h, k, v, 20, cuda, zipf)
    _check_rule(rule, wd, table, rows, src * 1e-2, h, cuda)


def _check_rule(rule, wd, table, rows, src, h, cuda):
    v, d = table.shape
    k = rows.numel()
    pools = _pools(rule, v, d, 21, cuda)
    want_t, want_p = table.clone(), [p.clone() for p in pools]
    _rule(rule, wd, want_t, want_p, rows, src, h, plain=True)
    got = []
    for _ in range(2):
        t, ps = table.clone(), [p.clone() for p in pools]
        _rule(rule, wd, t, ps, rows, src, h, plain=False)
        got.append((t, ps))
    torch.cuda.synchronize()
    keep = (rows >= 0) & (rows < v)
    r = rows[keep]
    x = src[torch.arange(k, device=cuda)[keep] // h]
    rowsum = lambda a: torch.zeros((v,) + tuple(a.shape[1:]), device=cuda).index_add_(0, r, a)  # noqa: E731
    n = rowsum(torch.ones(r.numel(), device=cuda)) + 1
    terms = {"momentum": [x.abs() + 0.1], "nesterov": [x.abs()], "adam": [0.1 * (x.abs() + 0.1),
             1e-3 * (x.abs() + 0.1) ** 2], "adagrad": [(x * x).mean(dim=1)]}[rule]
    for i, (g_p, w_p) in enumerate(zip(got[0][1], want_p)):
        nn = n + d if rule == "adagrad" else n[:, None]
        tol = 2 * nn * 2.0**-24 * (pools[i].abs() + rowsum(terms[i]))
        assert bool(((g_p - w_p).abs() <= tol).all())
    deltas = 0.0
    if rule == "adagrad":
        deltas = (0.01 * torch.rsqrt(want_p[0] + 1e-10))[:, None] * rowsum(x.abs())
    tol_t = 2.0**-6 * (table.float().abs() + want_t.float().abs() + deltas)
    assert bool(((got[0][0].float() - want_t.float()).abs() <= tol_t).all())
    touched = torch.zeros(v, dtype=torch.bool, device=cuda)
    touched[r] = True
    assert torch.equal(got[0][0][~touched], table[~touched])
    for g_p, p in zip(got[0][1], pools):
        assert torch.equal(g_p[~touched], p[~touched])
    (a_t, a_p), (b_t, b_p) = got
    assert torch.equal(a_t.view(torch.uint8), b_t.view(torch.uint8))
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(a_p, b_p))


def _chunk_case(case, seed, device):
    """Streams shaped against the kernel's chunks of CHUNK (64) sorted
    positions: (table [V, 16] bf16, rows, src, h)."""
    rng = np.random.default_rng(seed)
    c = ru.CHUNK
    h = 1
    if case == "run-over-5-chunks":
        v, k = 1000, 1000
        rows = rng.integers(0, v, k)
        rows[100:100 + 5 * c] = 7
    elif case == "runs-end-on-chunk-edges":
        v = 50
        rows = np.repeat([3, 9, 14, 20, 31, 40], [c, 2 * c, c, 3 * c, 4 * c, c])
        rng.shuffle(rows)
        k = rows.size
    elif case == "one-row":
        v, k, h = 100, 1000, 4
        rows = np.full(k, 42)
    elif case == "dropped-in-a-spanning-chunk":
        v, k = 500, 900
        rows = rng.integers(0, v - 1, k)
        rows[:300] = v - 1  # its run ends where the dropped rows begin
        rows[300:450] = -1
        rows[450:600] = v + 2
    else:  # K below one chunk
        v, k = 100, c - 24
        rows = rng.integers(-2, v + 2, k)
    table = torch.from_numpy(rng.standard_normal((v, 16)).astype(np.float32)).to(device, torch.bfloat16)
    src = torch.from_numpy(rng.standard_normal((k // h, 16)).astype(np.float32)).to(device)
    return table, torch.from_numpy(rows).to(device), src, h


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "adagrad"])
@pytest.mark.parametrize("case", ["run-over-5-chunks", "runs-end-on-chunk-edges", "one-row",
                                  "dropped-in-a-spanning-chunk", "k-below-a-chunk"])
def test_row_update_kernel_sums_runs_across_chunks_like_the_plain_version(cuda, rule, case):
    """The kernel cuts the sorted stream into chunks of CHUNK positions and
    sums a run that crosses chunk edges piece by piece, in chunk order:
    every mode against its plain version (SGD within the sum-order bound of
    test_row_update_kernel_matches_plain_version, the optimizer modes within
    test_optimizer_mode_kernels_match_plain_versions's), and a second run
    bit-identical, on a run over 5 chunks, runs that end on chunk edges,
    one row for the whole stream, dropped rows in a chunk a run crosses,
    and a stream shorter than a chunk."""
    table, rows, src, h = _chunk_case(case, 30, cuda)
    if rule != "sgd":
        _check_rule(rule, 0.0, table, rows, src * 1e-2, h, cuda)
        return
    scale = torch.tensor(-0.01, device=cuda)
    want = table.clone()
    row_update_reference(want, rows, (src, h), scale)
    got = [table.clone(), table.clone()]
    for t in got:
        row_update([t], [rows], [(src, h)], scale)
    torch.cuda.synchronize()
    tol = _row_tolerance(table, rows, src, h, scale, True)
    assert bool(((got[0].float() - want.float()).abs() <= tol).all())
    assert torch.equal(got[0].view(torch.int16), got[1].view(torch.int16))


def test_optimizer_mode_wrappers_count_one_launch_per_table_and_refuse_bad_pools(cuda):
    tables, rows, srcs = zip(*[_row_case(16, torch.bfloat16, 1, 1024, v, s, cuda) for s, v in ((1, 500), (2, 900))])
    vels = [torch.zeros_like(t, dtype=torch.float32) for t in tables]
    before = ru.row_update_momentum.launches
    ru.row_update_momentum(list(tables), vels, rows, srcs, torch.tensor(0.1, device=cuda), 0.9)
    assert ru.row_update_momentum.launches == before + 2
    with pytest.raises(ValueError):  # the rate on the CPU
        ru.row_update_momentum(list(tables), vels, rows, srcs, torch.tensor(0.1), 0.9)
    with pytest.raises(ValueError):  # a [V, D] pool where AdaGrad keeps [V]
        ru.row_update_adagrad([tables[0]], [vels[0]], [rows[0]], [srcs[0]],
                              torch.tensor(0.1, device=cuda), 1e-10)


@pytest.mark.parametrize(
    "v, d, b, h, aggr, cdt, g_dtype, idx_dtype",
    [
        (7424, 128, 16384, 1, "AGGR_MODE_SUM", torch.bfloat16, torch.float32, torch.int64),
        (7424, 128, 4096, 6, "AGGR_MODE_AVG", torch.float32, torch.float32, torch.int64),
        (3, 128, 1000, 6, "AGGR_MODE_SUM", torch.bfloat16, torch.bfloat16, torch.int64),
        (500, 37, 999, 6, "AGGR_MODE_AVG", torch.bfloat16, torch.float32, torch.int64),  # scalar loads
        (3, 128, 16384, 1, "AGGR_MODE_SUM", torch.bfloat16, torch.float32, torch.int64),  # hot rows
        (4, 128, 16384, 1, "AGGR_MODE_SUM", torch.bfloat16, torch.float32, torch.int64),
        (63, 128, 16384, 1, "AGGR_MODE_SUM", torch.bfloat16, torch.float32, torch.int64),  # S = 132
        (976, 128, 16384, 1, "AGGR_MODE_SUM", torch.bfloat16, torch.float32, torch.int64),  # S = 9
        (5683, 16, 65536, 1, "AGGR_MODE_SUM", torch.bfloat16, torch.bfloat16, torch.int32),  # kaggle
        (100000, 128, 1000, 1, "AGGR_MODE_SUM", torch.float32, torch.float32, torch.int32),  # v > B * H
    ],
)
def test_onehot_backward_kernel_matches_plain_version(cuda, v, d, b, h, aggr, cdt, g_dtype, idx_dtype):
    """K5b, through the op's autograd, against its plain version: bags with
    duplicates (n_r = 2 and 3), padding and indices >= V; sums of exact (bf16)
    or alike-rounded (f32) products in another order, within 2 n 2^-24 of
    the summed magnitudes; a second run bit-identical. Where the plan gives
    one segment, a row's terms are added in member order into 0, as the
    plain version's index_add_ adds them on the CPU: bit for bit."""
    rng = np.random.default_rng(22)
    idx = rng.integers(0, v, size=(b, h))
    if h > 1:
        idx[:, 1] = idx[:, 0]
        idx[::3, 2] = idx[::3, 0]
        idx[::5, 3] = -1
        idx[::4, 4] = v + 2
    idx = torch.from_numpy(idx).to(device=cuda, dtype=idx_dtype)
    mode = getattr(AggrMode, aggr)
    g = _x((b, d), g_dtype, 23, cuda)
    table = _x((v, d), g_dtype, 24, cuda).requires_grad_(True)
    before = onehot_embedding_backward.launches
    grads = [torch.autograd.grad(onehot_embedding(table, idx, mode, cdt), [table], grad_outputs=g)[0]
             for _ in range(2)]
    got = onehot_embedding_backward(idx, g, v, mode, cdt)
    assert onehot_embedding_backward.launches == before + 3  # one a wrapper call
    want = onehot_embedding_backward_reference(idx, g, v, mode, cdt)
    n = onehot_embedding_backward_reference(idx, torch.ones((b, 1), device=cuda), v,
                                            AggrMode.AGGR_MODE_SUM, torch.float32)
    mag = onehot_embedding_backward_reference(idx, g.float().abs(), v, mode, cdt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert bool(((got - want).abs() <= 2 * n * 2.0**-24 * mag).all())
    # autograd hands the table its gradient in the table's dtype
    assert torch.equal(grads[0], got.to(table.dtype)) and torch.equal(grads[0], grads[1])
    if backward_plan(b, h, v, d).segments == 1:
        cpu = onehot_embedding_backward_reference(idx.cpu(), g.cpu(), v, mode, cdt)
        assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.parametrize("v, kernels", [(7424, 1), (976, 2), (63, 2), (3, 2)])
def test_onehot_backward_runs_its_plans_kernels_and_no_sort(cuda, v, kernels):
    """A call puts the tile kernel alone on the card where one segment holds
    the stream, and the segment sum after it where hot rows take more: no
    sort, no key preparation, nothing else (counted in a CUDA graph of the
    call)."""
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import graph_nodes

    idx = torch.from_numpy(np.random.default_rng(25).integers(0, v, size=(16384, 1))).to(cuda)
    g = _x((16384, 128), torch.float32, 26, cuda)
    assert backward_plan(16384, 1, v, 128).launches == kernels
    nodes = graph_nodes(lambda: onehot_embedding_backward(idx, g, v, AggrMode.AGGR_MODE_SUM, torch.bfloat16))
    assert nodes == {"kernel": kernels}, nodes


ADAGRAD_LR = 0.05


@pytest.mark.parametrize("rule", ["adam", "momentum", "adam+adagrad"])
def test_kaggle_shaped_training_under_each_rule_tracks_the_cpu(cuda, rule):
    """As the SGD test above, under Adam, momentum and Adam with a row-wise
    AdaGrad sparse optimizer (lr 0.05): 3 steps, 10 kernel launches a step.

    Bounds. The loss within 2e-3 a step, as for SGD. Where the two devices'
    summation orders leave a gradient near 0 with other signs, Adam moves a
    weight by up to about 3.2 alpha a step and row-wise AdaGrad by up to
    lr * sqrt(D) = 4 lr (its accumulator holds at least the step's own
    mean of g^2) on one device and not the other: every weight within that
    over 3 steps. All but 1 in 1000 of the weights that AdaGrad does not
    normalize (the MLPs and one-hot tables, under dense Adam) agree within
    2e-3. Row-wise AdaGrad's step lr * g_d * rsqrt(acc) does not shrink
    with the gradient: on the first step acc = mean_d(g^2), so a touched
    row moves by lr * g / rms(g), whose RMS over the row is exactly lr, and
    two gradients of slightly different direction (the bf16 backward
    rounds in other places on the card) move the row apart by a share of
    lr, not of lr * |g|. So all but 1 in 1000 of all weights agree within
    2e-3 + lr / 4, a quarter of that RMS step. The row-update kernel gives
    the same bits as its plain version run on the card
    (`python -m dlrm_flexflow_tpu_torch.tools.adagrad_parity` shows where
    the two devices part), and the CPU port keeps these bounds against the
    JAX package (tests/test_torch_port_sparse_optim.py)."""
    bs = 128
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    kw = dict(batch_size=bs, compute_dtype="bfloat16", table_dtype="bfloat16", packed_tables="on", seed=5)
    opt = {"adam": lambda: (AdamOptimizer(alpha=1e-3), None),
           "momentum": lambda: (SGDOptimizer(lr=0.05, momentum=0.9), None),
           "adam+adagrad": lambda: (AdamOptimizer(alpha=1e-3), RowWiseAdagradOptimizer(lr=ADAGRAD_LR))}[rule]
    gpu = make_dlrm_model(cfg, FFConfig(**kw), device=cuda)
    cpu = make_dlrm_model(cfg, FFConfig(**kw), device="cpu")
    for m in (gpu, cpu):
        o, so = opt()
        m.compile(o, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY], sparse_optimizer=so)
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    wrapper = {"adam": ru.row_update_adam, "momentum": ru.row_update_momentum,
               "adam+adagrad": ru.row_update_adagrad}[rule]
    feeds, labels = random_batches(cfg, 3 * bs, seed=5)
    before = wrapper.launches
    for i in range(3):
        sl = slice(i * bs, (i + 1) * bs)
        batch = {k: v[sl] for k, v in feeds.items()}
        loss_err = abs(float(gpu.train_batch(batch, labels[sl])) - float(cpu.train_batch(batch, labels[sl])))
        assert loss_err <= 2e-3, ("loss", i, loss_err)
    assert wrapper.launches == before + 30
    atol = {"adam": 3 * 3.2 * 1e-3, "adam+adagrad": 3 * 4 * ADAGRAD_LR}.get(rule, 0.0) + 2e-3
    errs = {f"{name}/{k}": np.abs(w - cpu.get_weights(name)[k])
            for name in gpu.get_parameters() for k, w in gpu.get_weights(name).items()}
    worst = max(errs, key=lambda n: errs[n].max())
    flat = np.concatenate([e.reshape(-1) for e in errs.values()])
    assert flat.max() <= atol, ("max", worst, float(flat.max()))
    normalized = {f"{op.name}/weight" for op in gpu._sparse_ops if op.kernel_route} if rule == "adam+adagrad" else set()
    rest = np.concatenate([e.reshape(-1) for n, e in errs.items() if n not in normalized])
    assert np.mean(rest <= 2e-3) >= 0.999, ("share", float(np.mean(rest <= 2e-3)))
    share_atol = 2e-3 + (ADAGRAD_LR / 4 if rule == "adam+adagrad" else 0.0)
    assert np.mean(flat <= share_atol) >= 0.999, ("share", float(np.mean(flat <= share_atol)), worst)


# ------------------------------------------------------------------ K7, host routing


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize(
    "p, w, k, dtype",
    [
        (125952, 128, 65536, torch.float32),  # the probe's packed table
        (125952, 128, 65536, torch.bfloat16),
        (20000, 16, 3001, torch.float32),  # narrow, ragged K
        (20000, 16, 3001, torch.bfloat16),
        (777, 24, 1000, torch.float32),  # 96-byte rows: 6 chunks, the divide instance
        (777, 40, 999, torch.bfloat16),  # 80-byte rows: 5 chunks
        (3, 8, 1, torch.bfloat16),  # one 16-byte chunk a row
    ],
)
def test_row_gather_kernel_matches_plain_version_bit_for_bit(cuda, p, w, k, dtype, depth):
    rng = np.random.default_rng(p + w + k)
    table = _x((p, w), dtype, 5, cuda)
    rows = rng.integers(0, p, k)
    rows[::13] = -1 - rows[::13] % 3  # NaN rows
    rows[5::17] = p + rows[5::17] % 3
    rows = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    before = row_gather.launches
    got = row_gather(table, rows, depth)
    again = row_gather(table, rows, depth)
    assert row_gather.launches == before + 2
    want = row_gather_reference(table, rows)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (k, w)
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(again), _bits(got))


def test_row_gather_kernel_refuses_what_it_cannot_take(cuda):
    rows = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        row_gather(torch.zeros((8, 6), device=cuda), rows)  # 24-byte rows
    with pytest.raises(ValueError, match="aligned"):  # a bf16 table that starts 2 bytes in
        row_gather(torch.zeros(8 * 8 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(8, 8), rows)
    with pytest.raises(TypeError):
        row_gather(torch.zeros((8, 4), device=cuda), rows.long())
    with pytest.raises(ValueError):
        row_gather(torch.zeros((8, 4), device=cuda), rows.cpu())
    with pytest.raises(ValueError):
        row_gather(torch.zeros((8, 4), device=cuda), rows, depth=3)
    assert row_gather(torch.zeros((8, 4), device=cuda), rows[:0]).shape == (0, 4)


def test_compute_routes_on_card_feeds_equal_sort_rows(cuda):
    """compute_routes reads index feeds that lie on the card back to the
    host; its order and sorted rows equal sort_rows' on the card."""
    bs = 512
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    m = make_dlrm_model(cfg, FFConfig(batch_size=bs, packed_tables="on", host_routing=True), device=cuda)
    m.compile(SGDOptimizer(lr=0.05), LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, _ = random_batches(cfg, bs, seed=6)
    feeds["sparse_2"][:7] = -1
    staged = m._stage(feeds)
    ops = [op for op in m._sparse_ops if op.kernel_route]
    routes = m.compute_routes(staged)
    assert routes.keys() == m.compute_routes(feeds).keys()
    tables = [m.get_parameters()[op.name]["weight"] for op in ops]
    rs, order = sort_rows(tables, [staged[op.inputs[0].owner_op.name].reshape(-1) for op in ops])
    for i, op in enumerate(ops):
        np.testing.assert_array_equal(routes[f"_route:{op.name}:order"], order[i].cpu().numpy())
        np.testing.assert_array_equal(routes[f"_route:{op.name}:rows"], rs[i].cpu().numpy())
    staged_routes = m.stage_routes(routes)
    assert all(t.is_cuda and t.dtype == torch.int32 for t in staged_routes.values())
    # routes already on the card pass through ("cuda" is the card of cuda:0)
    assert all(m.stage_routes(staged_routes)[k] is t for k, t in staged_routes.items())


def test_host_routed_training_on_cuda_is_bit_identical_to_device_sorted(cuda):
    """The row-update kernel reads the same order from the host's radix sort
    as from torch.sort: 4 SGD steps give the same bits, sorting nothing on
    the card under host routing (deterministic algorithms keep the one-hot
    lookups' index_add_ in one order on both)."""
    bs = 256
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    models = {}
    for hr in (True, False):
        kw = dict(batch_size=bs, compute_dtype="bfloat16", table_dtype="bfloat16", packed_tables="on",
                  seed=8, host_routing=hr)
        models[hr] = make_dlrm_model(cfg, FFConfig(**kw), device=cuda)
        models[hr].compile(SGDOptimizer(lr=0.05), LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, labels = random_batches(cfg, 4 * bs, seed=8)
    losses = {True: [], False: []}
    sorts = {True: 0, False: 0}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(4):
            sl = slice(i * bs, (i + 1) * bs)
            batch = {k: v[sl] for k, v in feeds.items()}
            for hr, m in models.items():
                before = sort_rows.calls
                if hr and i % 2:  # routes computed beforehand and staged, as the bench does
                    batch_hr = {**m._stage(batch), **m.stage_routes(m.compute_routes(batch))}
                    losses[hr].append(float(m.train_batch(batch_hr, labels[sl])))
                else:
                    losses[hr].append(float(m.train_batch(batch, labels[sl])))
                sorts[hr] += sort_rows.calls - before
    finally:
        torch.use_deterministic_algorithms(False)
    assert sorts == {True: 0, False: 4}
    assert losses[True] == losses[False]
    for name in models[True].get_parameters():
        for k, w in models[True].get_weights(name).items():
            np.testing.assert_array_equal(w, models[False].get_weights(name)[k])


# ------------------------------------------------------------------ the multi-step call


def _tensors(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensors(v, f"{path}/{k}"))
        return out
    return {path: tree} if isinstance(tree, torch.Tensor) else {}


def _capped_kaggle(bs, rule, device, **kw):
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    m = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=11, compute_dtype="bfloat16",
                                      table_dtype="bfloat16", packed_tables="on", **kw), device=device)
    opt = {"sgd": SGDOptimizer(lr=0.05), "adam": AdamOptimizer(alpha=0.001),
           "adagrad": RowWiseAdagradOptimizer(lr=0.01)}[rule]
    m.compile(opt, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY])
    return cfg, m


@pytest.mark.parametrize("rule, host_routing", [("sgd", False), ("adam", False), ("adagrad", False),
                                                ("sgd", True)])
def test_train_chunk_graph_replays_equal_eager_steps_bit_for_bit(cuda, rule, host_routing):
    """A chunk of 4, the rate changed, the parameters set, then a tail chunk
    of 2 (the same graph, replayed twice), against 6 eager steps doing the
    same: parameters, optimizer state, metric totals and losses bit for bit
    (deterministic algorithms keep the one-hot lookups' index_add_ in one
    order on both); the captured step holds the row-update kernels."""
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import node_counts, stamps_apart

    bs = 512
    cfg, eager = _capped_kaggle(bs, rule, cuda, host_routing=host_routing)
    _, chunk = _capped_kaggle(bs, rule, cuda, host_routing=host_routing)
    feeds, labels = random_batches(cfg, 6 * bs, seed=12)
    batches = [({k: v[i * bs:(i + 1) * bs] for k, v in feeds.items()}, labels[i * bs:(i + 1) * bs])
               for i in range(6)]
    if host_routing:
        batches = [({**f, **chunk.compute_routes(f)}, lbl) for f, lbl in batches]
    stack = {k: np.stack([f[k] for f, _ in batches]) for k in batches[0][0]}
    slabels = np.stack([lbl for _, lbl in batches])
    half = {op: {k: v * 0.5 for k, v in eager.get_weights(op).items()} for op in eager.get_parameters()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses = []
        for i, (f, lbl) in enumerate(batches):
            if i == 4:
                eager.set_learning_rate(0.02)
                eager.set_parameters(half)
            losses.append(eager.train_batch(f, lbl))
        first = chunk.train_chunk({k: v[:4] for k, v in stack.items()}, slabels[:4])
        chunk.set_learning_rate(0.02)
        chunk.set_parameters(half)
        graph = chunk._step_graph.graph
        last = chunk.train_chunk({k: v[4:] for k, v in stack.items()}, slabels[4:])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert chunk._step_graph.graph is graph  # set_learning_rate and set_parameters keep it
    assert torch.equal(first, losses[3]) and torch.equal(last, losses[5])
    for tree_e, tree_c in ((eager.get_parameters(), chunk.get_parameters()), (eager._opt_state, chunk._opt_state),
                           (eager._metrics_total, chunk._metrics_total)):
        te, tc = _tensors(tree_e), _tensors(tree_c)
        assert te.keys() == tc.keys()
        for k in te:
            assert torch.equal(te[k], tc[k]), k
    assert eager._step_count == chunk._step_count == 6
    nodes = node_counts(graph, kernel_names=True)
    row = sum(n for name, n in nodes["kernels"].items() if "row_update" in name)
    per_launch = 4 if rule == "adagrad" else 2
    assert row == per_launch * 10, nodes["kernels"]
    assert "host" not in nodes  # no host callback: the step never waits for the host
    assert stamps_apart(nodes)["phase_stamp"] == 8  # the step's start and its seven phases


def _replays_against_eager(cuda, make, bs, seed):
    """A chunk of 4 and a tail chunk of 2 against 6 eager steps from the
    same weights under deterministic algorithms: (eager, chunk, losses,
    the two chunk losses)."""
    cfg, eager = make()
    _, chunk = make()
    feeds, labels = random_batches(cfg, 6 * bs, seed=seed)
    stack = {k: v.reshape((6, bs) + v.shape[1:]) for k, v in feeds.items()}
    slabels = labels.reshape(6, bs, 1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses = [eager.train_batch({k: v[i] for k, v in stack.items()}, slabels[i]) for i in range(6)]
        first = chunk.train_chunk({k: v[:4] for k, v in stack.items()}, slabels[:4])
        last = chunk.train_chunk({k: v[4:] for k, v in stack.items()}, slabels[4:])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return eager, chunk, losses, (first, last)


def _assert_same(eager, chunk):
    for tree_e, tree_c in ((eager.get_parameters(), chunk.get_parameters()), (eager._opt_state, chunk._opt_state),
                           (eager._metrics_total, chunk._metrics_total)):
        te, tc = _tensors(tree_e), _tensors(tree_c)
        assert te.keys() == tc.keys()
        for k in te:
            assert torch.equal(te[k], tc[k]), k
    assert eager._step_count == chunk._step_count == 6


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "adagrad"])
def test_train_chunk_on_the_scatter_route_replays_eager_steps_bit_for_bit(cuda, rule):
    """Tables on the scatter route (packed_tables="off": the optimizer's
    fixed-size scatter rule) are captured: replays against eager steps bit
    for bit, under deterministic algorithms."""
    bs = 256

    def make():
        cfg = kaggle_config(batch_size=bs)
        cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
        m = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=13, packed_tables="off"), device=cuda)
        opt = {"sgd": SGDOptimizer(lr=0.05), "momentum": SGDOptimizer(lr=0.05, momentum=0.9),
               "adam": AdamOptimizer(alpha=0.001), "adagrad": RowWiseAdagradOptimizer(lr=0.01)}[rule]
        m.compile(opt, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY])
        assert m._sparse_ops and not any(op.kernel_route for op in m._sparse_ops)
        return cfg, m

    eager, chunk, losses, (first, last) = _replays_against_eager(cuda, make, bs, 13)
    assert chunk._step_graph is not None and chunk._step_graph.graph is not None
    assert torch.equal(first, losses[3]) and torch.equal(last, losses[5])
    _assert_same(eager, chunk)


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_midband_replays_eager_steps_and_matches_the_cpu(cuda, rule):
    """kaggle widths, vocabs capped at 20000, onehot_packed_threshold 2^20:
    the 10 large tables become mid-band (dense gradients); replays against
    eager steps bit for bit, and one step on CUDA against the CPU (f32
    compute: the same f32 operations in another order)."""
    bs = 256

    def make(device=cuda):
        cfg = kaggle_config(batch_size=bs)
        cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
        m = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=16, compute_dtype="float32",
                                          onehot_packed_threshold=1 << 20), device=device)
        m.compile(SGDOptimizer(lr=0.05) if rule == "sgd" else AdamOptimizer(alpha=0.001),
                  LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY])
        assert sum(op.onehot_packed for op in m.graph.compute_ops if hasattr(op, "onehot_packed")) == 10
        return cfg, m

    eager, chunk, losses, (first, last) = _replays_against_eager(cuda, make, bs, 16)
    assert torch.equal(first, losses[3]) and torch.equal(last, losses[5])
    _assert_same(eager, chunk)
    cfg, gpu = make()
    _, cpu = make("cpu")
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, labels = random_batches(cfg, bs, seed=17)
    np.testing.assert_allclose(float(gpu.train_batch(feeds, labels)), float(cpu.train_batch(feeds, labels)),
                               rtol=1e-5, atol=1e-6)
    for name in gpu.get_parameters():
        for k, w in gpu.get_weights(name).items():
            np.testing.assert_allclose(w, cpu.get_weights(name)[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("rule", ["sgd", "adagrad"])
def test_host_tail_steps_on_cuda_match_the_cpu(cuda, rule):
    """A small host-tail model (hot prefix 1000 of vocabs up to 20000,
    bags of 2) trains 3 steps on CUDA and on the CPU from the same weights
    and the same seeded stores: losses, hot prefixes and touched tail rows
    within f32 reordering (AdaGrad's rsqrt an ulp apart grows it); the
    host-tail model refuses train_chunk."""
    bs = 256
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    cfg.embedding_bag_size = 2
    models = {}
    for dev in (cuda, "cpu"):
        m = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=18, compute_dtype="float32", host_tail_threshold=1000,
                                          host_tail_cap_frac=0.5), device=dev)
        m.compile(SGDOptimizer(lr=0.05) if rule == "sgd" else RowWiseAdagradOptimizer(lr=0.01),
                  LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY])
        models[str(dev)] = m
    gpu, cpu = models[str(cuda)], models["cpu"]
    assert len(gpu._host_tail.entries) == sum(v > 1000 for v in cfg.embedding_size) == 15
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, labels = random_batches(cfg, 3 * bs, seed=18, zipf=1.05)
    tol = dict(rtol=1e-5, atol=1e-6) if rule == "sgd" else dict(rtol=1e-4, atol=1e-5)
    for i in range(3):
        b = ({k: v[i * bs:(i + 1) * bs] for k, v in feeds.items()}, labels[i * bs:(i + 1) * bs])
        np.testing.assert_allclose(float(gpu.train_batch(*b)), float(cpu.train_batch(*b)), **tol)
    for name in gpu.get_parameters():
        for k, w in gpu.get_weights(name).items():
            np.testing.assert_allclose(w, cpu.get_weights(name)[k], rtol=0, atol=tol["atol"])
    for name, (store, *_) in gpu._host_tail.entries.items():
        rows, vals, acc = store.state()
        c_rows, c_vals, c_acc = cpu._host_tail.entries[name][0].state()
        np.testing.assert_array_equal(rows, c_rows)
        np.testing.assert_allclose(vals, c_vals, rtol=0, atol=tol["atol"])
    assert gpu._host_tail.total == cpu._host_tail.total > 0
    with pytest.raises(RuntimeError, match="host-tail"):
        gpu.train_chunk({k: v[None, :bs] for k, v in feeds.items()}, labels[None, :bs])


def test_checkpoint_restored_between_chunks_resumes_bit_for_bit(cuda, tmp_path):
    """Save after 3 Adam steps, restore into a model that already has its
    step captured (in place: the graph stays), 2 more steps; against 5
    uninterrupted steps."""
    from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint

    bs = 512
    cfg, whole = _capped_kaggle(bs, "adam", cuda)
    _, first = _capped_kaggle(bs, "adam", cuda)
    _, resumed = _capped_kaggle(bs, "adam", cuda)
    feeds, labels = random_batches(cfg, 5 * bs, seed=14)
    stack = {k: v.reshape((5, bs) + v.shape[1:]) for k, v in feeds.items()}
    slabels = labels.reshape(5, bs, 1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = whole.train_chunk(stack, slabels)
        first.train_chunk({k: v[:3] for k, v in stack.items()}, slabels[:3])
        save_checkpoint(str(tmp_path / "ck"), first)
        resumed.train_chunk({k: v[:1] for k, v in stack.items()}, slabels[:1])  # captures
        graph = resumed._step_graph.graph
        restore_checkpoint(str(tmp_path / "ck"), resumed)
        got = resumed.train_chunk({k: v[3:] for k, v in stack.items()}, slabels[3:])
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed._step_graph.graph is graph and resumed._step_count == whole._step_count == 5
    assert torch.equal(got, want)
    for name in whole.get_parameters():
        for k, w in whole.get_weights(name).items():
            np.testing.assert_array_equal(w, resumed.get_weights(name)[k])


@pytest.mark.parametrize("use_pallas", ["auto", "on"])
def test_int8_predict_on_cuda_matches_the_cpu_port(cuda, use_pallas):
    """int8 tables take the plain quantized lookup under every use_pallas
    (no K4 or K5f launch); CUDA against the CPU from the same weights. The
    bound is E2E_ON_ATOL of chip_smoke.py: the MLPs round to bf16 on both
    sides, and under "on" each layer's output too."""
    cfg = mlperf_lite_config(batch_size=256, vocab_cap=20_000)
    models = {}
    for dev in (cuda, "cpu"):
        m = make_dlrm_model(cfg, FFConfig(batch_size=256, seed=15, use_pallas=use_pallas, packed_tables="off"),
                            device=dev)
        m.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
        models[str(dev)] = m
    gpu, cpu = models[str(cuda)], models["cpu"]
    cpu._ctx.use_pallas = gpu._ctx.use_pallas  # like with like, as chip_smoke.py's parity phases
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    assert gpu.quantize_embeddings("int8") == cpu.quantize_embeddings("int8") == cfg.num_tables
    for name in gpu.get_parameters():
        for k, t in gpu.get_parameters()[name].items():
            assert torch.equal(t.cpu(), cpu.get_parameters()[name][k]), (name, k)
    feeds, _ = random_batches(cfg, 2 * 256 + 37, seed=15)
    before = (embedding_bag.launches, onehot_embedding.launches)
    y_gpu = gpu.predict(feeds)
    assert (embedding_bag.launches, onehot_embedding.launches) == before
    y_cpu = cpu.predict(feeds)
    assert np.isfinite(y_gpu).all()
    np.testing.assert_allclose(y_gpu, y_cpu, rtol=0, atol=2.0**-7)



@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_replicated_tables_update_in_a_world_of_one(cuda, rule):
    """parallel/replicated_tables.py at a small size in an NCCL world of
    one: `replicated_sparse_update` on capped kaggle's 10 route tables (bf16
    on the row-update kernel) and a 256-example stream (int64 ids, bf16
    pooled gradients). At N = 1 its all-gathers copy, so it equals
    `apply_sparse_updates` on the same stream bit for bit, tables and slot
    states, with one K1 launch a table. Captured in a CUDA graph (after an
    eager warm-up on a side stream) its replay equals the eager call bit for
    bit. Under SGD the CUDA tables are held against the same update on the
    CPU (`apply_sparse_updates` there takes the kernel's plain version)
    within the row-update kernel's tolerance (`_row_tolerance`)."""
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.parallel.replicated_tables import replicated_sparse_update
    from dlrm_flexflow_tpu_torch.training.sparse_engine import apply_sparse_updates

    bs = 256
    _, model = _capped_kaggle(bs, rule, "cuda")
    ops = [op for op in model._sparse_ops if op.kernel_route]
    assert len(ops) == 10
    rng = np.random.default_rng(5)
    xs = {op.name: [torch.from_numpy(rng.integers(0, op.num_entries, (bs, 1))).cuda()] for op in ops}
    g = {op.name: [torch.from_numpy(rng.standard_normal((bs, op.out_dim)).astype(np.float32) * 0.1).cuda()
                   .to(torch.bfloat16)] for op in ops}
    opt = SGDOptimizer(lr=0.05) if rule == "sgd" else AdamOptimizer(alpha=0.001)
    lr = 0.05 if rule == "sgd" else 0.001
    weights = {op.name: model.get_parameters()[op.name]["weight"] for op in ops}

    def fresh(device="cuda"):
        return ({n: {"weight": w.clone().to(device)} for n, w in weights.items()},
                {op.name: op.sparse_state_init(opt, device) for op in ops})

    def leaves(params, states):
        return list(_tensors(params).values()) + list(_tensors(states).values())

    rate = torch.tensor(lr, device="cuda")  # made before the capture: no host copy inside it

    def update(params, states):
        return replicated_sparse_update(ops, params, xs, g, opt, states, model._ctx, lr=rate)[0]

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        wrapper = ru.row_update if rule == "sgd" else ru.row_update_adam
        (pa, sa), (pb, sb), (pc, sc), warm = fresh(), fresh(), fresh(), fresh()
        wrapper.launches = 0
        sa = update(pa, sa)
        assert wrapper.launches == len(ops)
        sb = apply_sparse_updates(ops, pb, xs, g, opt, sb, model._ctx, lr=rate)
        assert len(leaves(pa, sa)) == len(ops) * (1 if rule == "sgd" else 3)
        assert all(torch.equal(a, b) for a, b in zip(leaves(pa, sa), leaves(pb, sb)))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            update(*warm)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            sc = update(pc, sc)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(leaves(pa, sa), leaves(pc, sc)))
    finally:
        dist.destroy_process_group()
    if rule == "sgd":
        pd, sd = fresh("cpu")
        apply_sparse_updates(ops, pd, {n: [x[0].cpu()] for n, x in xs.items()},
                             {n: [y[0].cpu()] for n, y in g.items()}, opt, sd, model._ctx, lr=torch.tensor(lr))
        for op in ops:
            rows, src = xs[op.name][0].cpu().reshape(-1), g[op.name][0].float().cpu()
            tol = _row_tolerance(weights[op.name].cpu(), rows, src, 1, lr, True)
            err = (pa[op.name]["weight"].float().cpu() - pd[op.name]["weight"].float()).abs()
            assert torch.all(err <= tol), (op.name, float((err - tol).max()))


def test_tensor_parallel_dense_captured_in_a_group_of_one(cuda):
    """parallel/tensor_parallel.py on the card, in an NCCL subgroup of one
    (a model axis of one rank): `copy_in`, the port's `dense` (bf16 compute,
    ReLU) and `gather_out` give the output and the gradients of the input,
    the kernel and the bias of plain `dense` bit for bit (the gather and
    the backward's all-reduce move one rank's bytes), eagerly and as the
    replay of a CUDA graph that captured them after an eager warm-up on a
    side stream. Four cards run them over two and four ranks
    (tools/mesh_smoke.py's `2d` phase)."""
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.ffconst import ActiMode
    from dlrm_flexflow_tpu_torch.ops.dense import dense
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.tensor_parallel import copy_in, gather_out

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = make_mesh().subgroup([[0]])
        gen = torch.Generator(device="cuda").manual_seed(41)
        x, kernel, bias, w = (torch.randn(s, generator=gen, device="cuda") for s in
                              ((300, 96), (64, 96), (64,), (300, 64)))

        def step(tp):
            leaves = [t.detach().requires_grad_(True) for t in (x, kernel, bias)]
            xi = copy_in(leaves[0], group) if tp else leaves[0]
            y = dense(xi, leaves[1], leaves[2], ActiMode.AC_MODE_RELU, torch.bfloat16)
            y = gather_out(y, 1, 0, group) if tp else y
            return [y.detach()] + list(torch.autograd.grad((y * w).sum(), leaves))

        want, eager = step(False), step(True)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(True)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            got = step(True)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, want))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_add_rows_adds_in_one_order(cuda, dtype):
    """ops.common.index_add_rows on the card: 32768 adds into 1460 rows
    give the same bits on every call and as the replay of a CUDA graph
    that captured it, and agree with an f64 sum (bf16: about 22 adds a row, each of which
    may round to the 8-bit mantissa, so rtol 5e-2 and atol 0.1 on sums of
    magnitude up to about 20); the optimizers' scatter rules take it, so
    ranks that apply the same stream to a replicated table keep the same
    bits."""
    from dlrm_flexflow_tpu_torch.ops.common import index_add_rows

    gen = torch.Generator(device="cuda").manual_seed(43)
    idx = torch.randint(0, 1460, (32768,), generator=gen, device="cuda")
    src = torch.randn((32768, 16), generator=gen, device="cuda").to(dtype)
    zeros = torch.zeros((1460, 16), dtype=dtype, device="cuda")
    first = index_add_rows(zeros.clone(), idx, src)
    assert all(torch.equal(index_add_rows(zeros.clone(), idx, src), first) for _ in range(5))
    out = zeros.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        index_add_rows(out, idx, src)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out.zero_()
        index_add_rows(out, idx, src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    want = torch.zeros((1460, 16), dtype=torch.float64, device="cuda").index_add_(0, idx, src.double())
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (5e-2, 0.1)
    torch.testing.assert_close(first.double(), want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("name", ["moe_mlp", "transformer", "dropout", "mnist_cnn", "nmt"])
def test_zoo_train_chunk_replays_eager_steps_bit_for_bit(cuda, name):
    """moe_mlp (dispatch by slot index, its gradients summed over k in
    order), a transformer, a dropout model (the step's key read from the
    captured step's buffer), mnist_cnn (cuDNN's convolutions and pools) and
    nmt (the LSTMs' time loops, its tables on the sparse path) at small
    widths: 2 chunks of 4 graph replays against 8 eager steps under
    deterministic algorithms, every tensor of the state and every chunk's
    last loss bit for bit."""
    from dlrm_flexflow_tpu_torch.core.ffmodel import FFModel
    from dlrm_flexflow_tpu_torch.models import zoo
    from dlrm_flexflow_tpu_torch.tools.state import state_diff

    def make():
        cfg = FFConfig(batch_size=32, seed=9)
        if name == "moe_mlp":
            m = zoo.moe_mlp(batch_size=32, in_dim=48, num_classes=10, config=cfg)
        elif name == "transformer":
            m = zoo.transformer(batch_size=4, seq_len=8, hidden=16, num_heads=2, config=FFConfig(batch_size=4))
        elif name == "mnist_cnn":
            m = zoo.mnist_cnn(batch_size=8, config=FFConfig(batch_size=8, seed=9))
        elif name == "nmt":
            m = zoo.nmt(batch_size=4, src_len=6, dst_len=5, hidden_size=32, embed_size=24, vocab_size=50,
                        config=FFConfig(batch_size=4, seed=9, onehot_embedding_threshold=16))
        else:
            m = FFModel(cfg)
            m.dropout(m.dense(m.create_tensor([32, 48], name="x"), 16), 0.5)
        m.compile(AdamOptimizer(alpha=1e-3), LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
        return m

    eager, chunk = make(), make()
    rng = np.random.default_rng(3)
    x = {iop.name: (rng.integers(0, 50, (4,) + iop.outputs[0].shape).astype(np.int32) if name == "nmt"
                    else rng.standard_normal((4,) + iop.outputs[0].shape).astype(np.float32))
         for iop in eager.graph.inputs}
    y = rng.standard_normal((4,) + tuple(eager._out_spec.shape)).astype(np.float32)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses = [eager.train_batch({k: v[i % 4] for k, v in x.items()}, y[i % 4]) for i in range(8)]
        replayed = [chunk.train_chunk(x, y) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert chunk._step_graph is not None and ("_step" in chunk._step_graph.views) == (name == "dropout")
    assert not state_diff(eager, chunk)
    assert torch.equal(losses[3], replayed[0]) and torch.equal(losses[7], replayed[1])


def test_dropout_mask_on_the_card_is_the_cpus(cuda):
    """core/graph.py keep_mask: integer tensor arithmetic, the same bits on
    both devices."""
    from dlrm_flexflow_tpu_torch.core.graph import keep_mask, step_key

    for step in (0, 1, 12345):
        key = step_key(42, torch.tensor(step))
        want = keep_mask(key, (64, 257), 0.7)
        got = keep_mask(key.to(cuda), (64, 257), 0.7)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_on_the_card_keeps_its_own_math_whatever_the_global_flags(cuda, dtype, monkeypatch):
    """With cuDNN's TF32 on and benchmarking on globally, Conv2D's forward
    and its gradients on the card hold to the CPU port's: in f32 within f32
    rounding of the sums (TF32's 10-bit mantissa would miss by about 1e-3 of
    the terms); in bf16 within one bf16 step (2^-7 of a value) of a result
    both round once."""
    from dlrm_flexflow_tpu_torch.ops.conv import conv2d

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    outs = {}
    for dev in ("cpu", cuda):
        x = _x((8, 64, 14, 14), torch.float32, 1, dev).requires_grad_(True)
        w = _x((32, 64, 3, 3), torch.float32, 2, dev).requires_grad_(True)
        b = _x((32,), torch.float32, 3, dev).requires_grad_(True)
        y = conv2d(x, w, b, (1, 1), (1, 1), 1, ActiMode.AC_MODE_NONE, dtype)
        (y * _x(tuple(y.shape), torch.float32, 4, dev)).sum().backward()
        outs[str(dev)] = [t.detach().cpu() for t in (y, x.grad, w.grad, b.grad)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.benchmark
    for got, want in zip(outs["cuda"], outs["cpu"]):
        big = float(want.abs().max())
        if dtype == torch.float32:
            # sums of up to 64 * 9 * 8 * 196 products of unit normals
            tol = dict(rtol=1e-5, atol=1e-5 * big)
        else:
            tol = dict(rtol=2.0**-7, atol=2.0**-7 * big)
        torch.testing.assert_close(got, want, **tol)


# ------------------------------------------------------------------ spans and phase stamps
def _stamped_body(acc, a, out, reps=(2, 4, 6)):
    from dlrm_flexflow_tpu_torch.ops.kernels.phase_stamp import stamper

    stamp = stamper(acc, len(reps))
    stamp(-1)
    for slot, n in enumerate(reps):
        for _ in range(n):
            torch.mm(a, a, out=out)
        stamp(slot)


def test_phase_stamps_captured_in_a_graph_agree_with_cuda_events(cuda):
    """Three phases of 2, 4 and 6 products, stamped and captured, replayed
    50 times: each phase counts 50, and the phases' total is the replays'
    time by CUDA events within 2% (the gaps between replays are outside
    every phase); the phases stand 2 : 4 : 6 within 5%."""
    acc = torch.zeros(7, dtype=torch.int64, device=cuda)
    a = torch.randn(2048, 2048, device=cuda)
    out = torch.empty_like(a)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _stamped_body(acc, a, out)  # builds the kernel, sets up cuBLAS
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _stamped_body(acc, a, out)
    acc.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    got = acc.tolist()
    assert got[3:6] == [50, 50, 50]
    phases_ms = [ns / 1e6 for ns in got[:3]]
    events_ms = start.elapsed_time(end)
    assert abs(sum(phases_ms) - events_ms) <= 0.02 * events_ms, (phases_ms, events_ms)
    for ms, n in zip(phases_ms, (2, 4, 6)):
        assert ms / sum(phases_ms) == pytest.approx(n / 12, rel=0.05), phases_ms


def test_captured_kaggle_step_phases_sum_to_the_replayed_step_time(cuda):
    """The seven phases of a captured kaggle-shaped step at batch 65536,
    over 20 replays of device-resident stacks, sum to within 3% of the
    replayed step's time by CUDA events (what lies outside them: each
    step's copy into the static buffer and the gaps between replays)."""
    from dlrm_flexflow_tpu_torch.utils.profiling import PHASES, reset_spans, span_totals

    bs, k = 65536, 4
    cfg, m = _capped_kaggle(bs, "sgd", cuda)
    feeds, labels = random_batches(cfg, k * bs, seed=21)
    stack = {n: torch.as_tensor(v.reshape((k, bs) + v.shape[1:])).to(cuda) for n, v in feeds.items()}
    slabels = torch.as_tensor(labels.reshape(k, bs)).to(cuda)
    m.train_chunk(stack, slabels)  # the warm-up, the capture and 3 replays
    torch.cuda.synchronize()
    reset_spans()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        m.train_chunk(stack, slabels)
    end.record()
    torch.cuda.synchronize()
    tot = span_totals()
    assert [tot[p]["count"] for p in PHASES] == [5 * k] * len(PHASES)
    step_ms = start.elapsed_time(end) / (5 * k)
    phases_ms = {p: 1e3 * tot[p]["device_s"] / (5 * k) for p in PHASES}
    assert abs(sum(phases_ms.values()) - step_ms) <= 0.03 * step_ms, (phases_ms, step_ms)
    assert all(v > 0 for v in phases_ms.values()), phases_ms
    assert tot["train_chunk:replay"]["count"] == 5 and "train_chunk:capture" not in tot


def test_captured_dcn_step_cuts_the_cross_phases_and_counts_row_update_ids(cuda):
    """A DCN model (three cross layers of rank 512 over a 3456-wide x0, a
    bag size a table) captured and replayed: each phase and both cross
    sub-phases count one a replayed step; all of them sum to within 3% of
    the replayed step's time by CUDA events; the cross network's stamps
    are inside the graph (its sub-phases read more than zero); the row
    update's id counter adds B x the route tables' bags at every step,
    the captured ones included."""
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig
    from dlrm_flexflow_tpu_torch.training.sparse_engine import ROW_UPDATE_IDS
    from dlrm_flexflow_tpu_torch.utils.profiling import PHASES, SUB_PHASES, reset_spans, span_totals

    bs, k = 16384, 4
    bags = [3, 1, 100, 2] + [1] * 22
    cfg = DLRMConfig(sparse_feature_size=128, embedding_size=[200_000, 10_000, 300_000, 50] + [7000] * 22,
                     embedding_bag_size=bags, mlp_bot=[13, 512, 256, 128], mlp_top=[3456, 1024, 1024, 512, 256, 1],
                     arch_interaction_op="dcn", batch_size=bs, dcn_num_layers=3, dcn_low_rank_dim=512)
    m = make_dlrm_model(cfg, FFConfig(batch_size=bs, compute_dtype="bfloat16", table_dtype="bfloat16"), device=cuda)
    m.compile(SGDOptimizer(lr=0.01), LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY])
    feeds, labels = random_batches(cfg, k * bs, seed=24, zipf=1.05)
    stack = {n: torch.as_tensor(v.reshape((k, bs) + v.shape[1:])).to(cuda) for n, v in feeds.items()}
    slabels = torch.as_tensor(labels.reshape(k, bs)).to(cuda)
    m.train_chunk(stack, slabels)  # the warm-up, the capture and 3 replays
    torch.cuda.synchronize()
    reset_spans()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        m.train_chunk(stack, slabels)
    end.record()
    torch.cuda.synchronize()
    tot = span_totals()
    assert [tot[p]["count"] for p in PHASES + SUB_PHASES] == [3 * k] * (len(PHASES) + len(SUB_PHASES))
    step_ms = start.elapsed_time(end) / (3 * k)
    phases_ms = {p: 1e3 * tot[p]["device_s"] / (3 * k) for p in PHASES + SUB_PHASES}
    assert abs(sum(phases_ms.values()) - step_ms) <= 0.03 * step_ms, (phases_ms, step_ms)
    assert all(v > 0 for v in phases_ms.values()), phases_ms
    assert tot[ROW_UPDATE_IDS] == {"count": 3 * k, "total": 3 * k * bs * (3 + 1 + 100)}


def test_train_chunk_captures_once_a_layout_and_spans_under_capture_add_nothing(cuda):
    """Two chunks of one layout: one `train_chunk:capture`, every step but
    the warm-up stamped; a span opened inside the port's capture block adds
    no total."""
    from dlrm_flexflow_tpu_torch.utils.profiling import PHASES, capturing, reset_spans, span, span_totals

    bs, k = 512, 4
    cfg, m = _capped_kaggle(bs, "sgd", cuda)
    feeds, labels = random_batches(cfg, k * bs, seed=22)
    stack = {n: v.reshape((k, bs) + v.shape[1:]) for n, v in feeds.items()}
    reset_spans()
    m.train_chunk(stack, labels.reshape(k, bs))
    m.train_chunk(stack, labels.reshape(k, bs))
    tot = span_totals()
    assert tot["train_chunk:capture"]["count"] == 1 and tot["train_chunk:replay"]["count"] == 2
    assert tot["train_chunk:capture"]["parent"] == "train_chunk:replay"
    assert [tot[p]["count"] for p in PHASES] == [2 * k - 1] * len(PHASES)
    a = torch.randn(64, 64, device=cuda)
    torch.mm(a, a)
    graph = torch.cuda.CUDAGraph()
    with capturing(), torch.cuda.graph(graph):  # as _StepGraph.capture
        with span("captured"):
            torch.mm(a, a)
    assert "captured" not in span_totals()


def _replay_ms(graph, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _host_us(fn, n=20_000, reps=15):
    """The least of `reps` timings of `n` calls, in us a call."""
    for _ in range(1000):
        fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    return best


def test_tracing_costs_on_the_card_and_its_host(cuda):
    """What the port's tracing costs, printed as one JSON line (`-s` shows
    it):
    - host us with no profiler on: a span and an op range, against the
      floor of a `with` that does nothing, the least a timed block costs
      (two clock reads and two sums), and the raw `record_function` range
      the spans replaced (a span under a quarter of it);
    - %globaltimer's resolution, the greatest common divisor of the times
      between two stamps in a replayed graph: at most 1 us;
    - the 8 stamp nodes of a captured kaggle step at batch 65536, against
      the same step captured unstamped (`_step(timed=False)`), replayed in
      turn: at most 0.5% of the step, the budget;
    - the host cost of an eager step's phase machinery: 8 stamps and 7
      phase blocks (an eager step at batch 512 takes about 20 ms of host
      time, whose spread hides it end to end)."""
    from torch.profiler import record_function

    from dlrm_flexflow_tpu_torch.ops.kernels.phase_stamp import stamper
    from dlrm_flexflow_tpu_torch.utils.profiling import PHASES, op_range, reset_spans, span, step_phases

    class Bare:
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Timed:
        __slots__ = ("t0", "ns", "count")

        def __init__(self):
            self.ns = self.count = 0

        def __enter__(self):
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            self.ns += time.perf_counter_ns() - self.t0
            self.count += 1
            return False

    timed = Timed()

    def a_timed():
        with timed:
            pass

    def a_span():
        with span("cost:span"):
            pass

    def a_range():
        with op_range("cost:op_range"):
            pass

    def a_raw():
        with record_function("cost:raw"):
            pass

    def a_bare():
        with Bare():
            pass

    host = {"span_us": _host_us(a_span), "op_range_us": _host_us(a_range), "bare_with_us": _host_us(a_bare),
            "timed_floor_us": _host_us(a_timed), "record_function_us": _host_us(a_raw, n=2000)}
    reset_spans()

    acc = torch.zeros(3, dtype=torch.int64, device=cuda)
    stamp = stamper(acc, 1)
    stamp(-1)
    torch.cuda.synchronize()
    pair = torch.cuda.CUDAGraph()
    with torch.cuda.graph(pair):
        stamp(-1)
        stamp(0)
    deltas = []
    for _ in range(300):
        acc.zero_()
        pair.replay()
        deltas.append(int(acc[0]))
    step = int(np.gcd.reduce(deltas))  # the timer's resolution: every delta is a multiple of it

    bs, k = 65536, 4
    cfg, m = _capped_kaggle(bs, "sgd", cuda)
    feeds, labels = random_batches(cfg, k * bs, seed=23)
    stack = {n: torch.as_tensor(v.reshape((k, bs) + v.shape[1:])).to(cuda) for n, v in feeds.items()}
    m.train_chunk(stack, torch.as_tensor(labels.reshape(k, bs)).to(cuda))
    g = m._step_graph
    bare = torch.cuda.CUDAGraph()
    with torch.cuda.graph(bare, capture_error_mode="thread_local"):
        m._step(*g._args(), step=g.views.get("_step"), timed=False)
    stamped_ms, bare_ms = [], []
    for _ in range(4):  # stamped, bare, bare, stamped
        stamped_ms.append(_replay_ms(g.graph, 30))
        bare_ms += [_replay_ms(bare, 30), _replay_ms(bare, 30)]
        stamped_ms.append(_replay_ms(g.graph, 30))
    graph_us = 1e3 * (np.median(stamped_ms) - np.median(bare_ms))
    del m, g, bare, stack

    def eager_phases():  # an eager step's phase machinery: its start and seven phases stamped
        phase = step_phases(cuda)
        for name in PHASES:
            with phase(name):
                pass

    step_phases(cuda, timed=False)  # the phase clock, made as a first step makes it
    eager_us = _host_us(eager_phases, n=500, reps=9)
    torch.cuda.synchronize()
    reset_spans()
    out = {**host, "globaltimer_step_ns": step, "stamp_pair_min_ns": min(deltas),
           "graph_step_ms": float(np.median(bare_ms)), "graph_stamps_us": float(graph_us),
           "eager_phases_us": eager_us}
    print(f"tracing costs: {json.dumps(out)}")
    assert host["span_us"] < host["record_function_us"] / 4, out
    assert 0 < step <= 1000 and min(deltas) > 0, out
    assert graph_us <= 0.005 * 1e3 * np.median(bare_ms), out


# ------------------------------------------------------------------ the Dense products' bf16 route

# kaggle's seven Dense layers, (K, N): the bottom MLP 13-512-256-64-16, the top 432-512-256-1
KAGGLE_DENSE = {"bot0": (13, 512), "bot1": (512, 256), "bot2": (256, 64), "bot3": (64, 16),
                "top0": (432, 512), "top1": (512, 256), "top2": (256, 1)}


def _bf16_bits_alike(a: torch.Tensor, b: torch.Tensor) -> bool:
    """bf16 tensors equal bit for bit, NaN matching NaN (the kernel's
    rounding gives the canonical 0x7FFF, PyTorch's cast 0x7FC0)."""
    nan = torch.isnan(a.float())
    return torch.equal(nan, torch.isnan(b.float())) and torch.equal(a.view(torch.int16)[~nan], b.view(torch.int16)[~nan])


@pytest.mark.parametrize("m, n, offset", [(65536, 512, 0), (65536, 16, 0), (65536, 1, 0), (1000, 13, 0),
                                          (333, 64, 1), (4, 16, 0)])
def test_bf16_split_kernel_matches_plain_version_bit_for_bit(cuda, m, n, offset):
    """csrc/bf16_split.cu against its plain version: N a multiple of 8
    takes the 8-wide path, N = 1 and 13 the one-value path with the
    padding's zeros, a base 4 bytes off 16-byte alignment (offset 1) the
    one-value path too; the last case holds infinities, NaN, subnormals
    and values past bf16's largest."""
    from dlrm_flexflow_tpu_torch.ops.kernels.bf16_split import split_bf16x3, split_bf16x3_reference
    from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import padded_k

    flat = _x((m * n + offset,), torch.float32, m + n, cuda)
    g = flat[offset:].view(m, n)
    if m == 4:
        special = torch.tensor([float("inf"), -float("inf"), float("nan"), 3.4e38, -3.39e38, 1e-40, -1e-45,
                                2.0**-126, 0.0, -0.0, 1.0, 1 + 2.0**-23, 2.0**-110, 2.0**-120, 6e4, -7.5],
                               device=cuda)
        g = g.clone()
        g[:2] = special.view(1, 16)
    before = split_bf16x3.launches
    got = split_bf16x3(g, padded_k(n))
    assert split_bf16x3.launches == before + 1
    want = split_bf16x3_reference(g, padded_k(n))
    torch.cuda.synchronize()
    assert got.shape == (m, 3 * padded_k(n)) and _bf16_bits_alike(got, want)


@pytest.mark.parametrize("layer", list(KAGGLE_DENSE))
def test_bf16_route_matches_the_f32_products_at_kaggle_layers(cuda, layer):
    """`Bf16Product` on the card (bf16 operands on the tensor cores, f32
    sums and results; the cotangent split in three) against the plain f32
    products of the same bf16-rounded operands (TF32 off) at M = 65536, a
    cotangent with ReLU's zeros. Both sides sum the same exact products in
    another order. The plain f32 sum is within n u sum|terms| of the exact
    one; the tensor cores add a product block's terms aligned to the
    largest and truncated, within 2 n u sum|terms| (the split's 3N or 3M
    terms for the gradients): hence 7 n u sum|terms| for a gradient (n =
    N, M) and 3 K u for the forward. The gradients are rounded to bf16 on
    both sides, so where that gap crosses a rounding boundary they part by
    one bf16 step more. The share of gradient elements that differ at all:
    two f32 sums of M = 65536 terms part by about u sqrt(M) of their value,
    so about 2 u sqrt(M) / 2^-8, 0.7%, of the kernel gradient's elements
    can round apart (read on an H100: dX 0.0004-0.06%, dW 0-0.60%);
    bounded at 2%."""
    from dlrm_flexflow_tpu_torch.ops.dense import Bf16Product

    k, n = KAGGLE_DENSE[layer]
    m, u = 65536, 2.0**-24
    gen = torch.Generator(device=cuda).manual_seed(k * 1000 + n)
    x = torch.randn((m, k), generator=gen, device=cuda)
    w = torch.randn((n, k), generator=gen, device=cuda) * (2.0 / k) ** 0.5
    g = torch.relu(torch.randn((m, n), generator=gen, device=cuda)) * 1e-3
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    before = (Bf16Product.forwards, Bf16Product.backwards)
    y = Bf16Product.apply(xr, wr)
    dx, dw = torch.autograd.grad(y, (xr, wr), g)
    assert (Bf16Product.forwards, Bf16Product.backwards) == (before[0] + 1, before[1] + 1)
    xp = x.detach().requires_grad_(True)
    wp = w.detach().requires_grad_(True)
    yp = torch.matmul(xp.to(torch.bfloat16).float(), wp.to(torch.bfloat16).float().t())
    dxp, dwp = torch.autograd.grad(yp, (xp, wp), g)
    torch.cuda.synchronize()
    xa, wa, ga = x.to(torch.bfloat16).float().abs(), w.to(torch.bfloat16).float().abs(), g.abs()
    assert y.dtype == torch.float32 and y.shape == (m, n)
    assert bool(((y - yp).abs() <= 3 * k * u * (xa @ wa.t())).all())
    shares = {}
    for name, a, c, bound in (("dx", dx, dxp, 7 * n * u * (ga @ wa)), ("dw", dw, dwp, 7 * m * u * (ga.t() @ xa))):
        step = torch.ldexp(torch.ones_like(a), (torch.frexp(torch.maximum(a.abs(), c.abs())).exponent - 8).clamp(min=-133))
        gap = (a - c).abs()
        assert bool((gap <= bound + step).all()), (name, float((gap / (bound + step)).max()))
        shares[name] = float((a != c).float().mean())
    print(f"bf16 route {layer}: {json.dumps(shares)}")
    assert max(shares.values()) <= 0.02, shares


def test_kaggle_step_takes_the_bf16_route(cuda):
    """One eager kaggle step under a bf16 compute dtype: each of the 7 Dense
    layers runs `Bf16Product` forward and backward, with one split launch
    each (the first layer too: its kernel's gradient) and no f32 product;
    the captured step of `train_chunk` holds 7 split kernel nodes and no
    f32 SIMT GEMM (cuBLAS `sgemm` or `f32f32_f32f32` kernels)."""
    from dlrm_flexflow_tpu_torch.ops.dense import Bf16Product, dense
    from dlrm_flexflow_tpu_torch.ops.kernels.bf16_split import split_bf16x3
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import node_counts

    def counters():
        return (Bf16Product.forwards, Bf16Product.backwards, dense.f32_products, split_bf16x3.launches)

    bs = 512
    cfg, m = _capped_kaggle(bs, "sgd", cuda)
    feeds, labels = random_batches(cfg, 4 * bs, seed=23)
    before = counters()
    m.train_batch({k: v[:bs] for k, v in feeds.items()}, labels[:bs])
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, counters())) == (7, 7, 0, 7)
    stack = {k: v.reshape((4, bs) + v.shape[1:]) for k, v in feeds.items()}
    m.train_chunk(stack, labels.reshape(4, bs))
    kernels = node_counts(m._step_graph.graph, kernel_names=True)["kernels"]
    assert sum(c for name, c in kernels.items() if "split_bf16x3" in name) == 7, kernels
    assert not [name for name in kernels if "sgemm" in name or "f32f32_f32f32" in name], kernels
