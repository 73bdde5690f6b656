"""The PyTorch port's CUDA kernels on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so it runs where JAX is not installed; on such a machine
run it without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches, zipf_indices
from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config, make_dlrm_model, mlperf_lite_config
from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import (
    dot_interaction,
    dot_interaction_reference,
)
from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update, row_update_reference

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
    cpu = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=3, use_pallas="on"), device="cpu")
    for m in (gpu, cpu):
        m.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
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
