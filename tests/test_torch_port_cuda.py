"""The PyTorch port's CUDA kernels on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so it runs where JAX is not installed; on such a machine
run it without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

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
    # f32 sums of h rows in bag order against torch's sum order; a bf16
    # table rounds the result once, possibly a bf16 step apart
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 2 * h * 2.0**-24
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
    # another order; a bf16 table rounds the result once
    rtol = 2.0**-7 if table_dtype == torch.bfloat16 else 12 * 2.0**-24
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
