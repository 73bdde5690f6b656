"""The PyTorch port's dot-interaction kernel module against the JAX package.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there). Here the wrapper takes the plain version, because the
tensors lie on the CPU, and the JAX package's Pallas kernel runs in
interpret mode, as tests/test_pallas_kernels.py runs it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dlrm_flexflow_tpu.ops.pallas.dot_interaction import dot_interaction_pallas
from dlrm_flexflow_tpu_torch import _build
from dlrm_flexflow_tpu_torch.ops.kernels import resolve_use_pallas
from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import (
    MAX_FEATURES,
    dot_interaction,
    dot_interaction_backward,
    dot_interaction_reference,
)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 9, 16), (16, 27, 128)])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_plain_version_matches_pallas_interpret(shape, self_interaction):
    x = _x(shape, 0)
    ref = dot_interaction_pallas(jnp.asarray(x), self_interaction, 16, True)
    got = dot_interaction_reference(torch.from_numpy(x), self_interaction)
    # f32 dots over D in another order: rtol 1e-5 of the result, plus an
    # atol for the dots that cancel to near 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5 * shape[2])


@pytest.mark.parametrize("self_interaction", [False, True])
def test_backward_matches_jax_grad(self_interaction):
    x = _x((16, 6, 8), 1)

    def f_ref(xj):
        return jnp.sum(jnp.sin(dot_interaction_pallas(xj, self_interaction, 16, True)))

    g_ref = jax.grad(f_ref)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sin(dot_interaction(xt, self_interaction)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-5)


def test_backward_formula_matches_autograd_of_plain_version():
    x = torch.from_numpy(_x((5, 7, 4), 2)).requires_grad_(True)
    g = torch.from_numpy(_x((5, 21), 3))
    (dot_interaction_reference(x, False) * g).sum().backward()
    got = dot_interaction_backward(x.detach(), g, False)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-6)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_x((12, 27, 128), 4))
    before = dot_interaction.launches
    got = dot_interaction(x, False)
    assert dot_interaction.launches == before
    assert got.dtype == torch.float32 and got.shape == (12, 351)
    torch.testing.assert_close(got, dot_interaction_reference(x, False), rtol=0, atol=0)


def test_bf16_input_is_read_as_f32():
    x = torch.from_numpy(_x((8, 5, 16), 5)).to(torch.bfloat16)
    got = dot_interaction(x, False)
    assert got.dtype == torch.float32
    want = dot_interaction_reference(x.float(), False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "make, err",
    [
        (lambda: torch.zeros((4, MAX_FEATURES + 1, 8)), ValueError),
        (lambda: torch.zeros((4, 3, 8), dtype=torch.int32), TypeError),
        (lambda: torch.zeros((4, 8, 3)).transpose(1, 2), ValueError),
        (lambda: torch.zeros((4, 8)), ValueError),
    ],
    ids=["too-many-features", "int-dtype", "non-contiguous", "rank-2"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(make, err):
    with pytest.raises(err):
        dot_interaction(make(), False)


@pytest.mark.parametrize(
    "flag, device, want",
    [
        ("auto", "cpu", False),
        ("auto", "cuda", True),
        ("on", "cpu", True),
        ("off", "cuda", False),
    ],
)
def test_resolve_use_pallas_auto_means_cuda(flag, device, want):
    assert resolve_use_pallas(flag, torch.device(device)) is want


def test_resolve_use_pallas_rejects_unknown_flag():
    with pytest.raises(ValueError):
        resolve_use_pallas("maybe", torch.device("cpu"))


def test_kernel_build_needs_nvcc():
    """Where nvcc exists the kernel builds; where it does not, the build
    raises rather than falling back."""
    names = _build.kernel_names()
    assert names == ["bf16_split", "cross_epilogue", "dot_interaction", "embedding_bag", "fused_mlp",
                     "onehot_embedding", "phase_stamp", "row_gather", "row_update"]
    try:
        _build.nvcc_path()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build(names)
        return
    _build.build(names)
    assert all(_build.library_path(n).is_file() for n in names)
