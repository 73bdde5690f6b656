"""The PyTorch port's CUDA kernels on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so it runs where JAX is not installed; on such a machine
run it without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu_torch import FFConfig, LossType
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model, mlperf_lite_config
from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import (
    dot_interaction,
    dot_interaction_reference,
)

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
