"""Pairwise dot-product feature interaction: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel `_interaction_kernel`
(`dlrm_flexflow_tpu/ops/pallas/dot_interaction.py:42`, launched by
`_interaction_fwd`). x [B, F, D] (f32, or bf16 read as f32) ->
out [B, P] f32 with out[b, p] = sum_d x[b, r_p, d] * x[b, c_p, d] over the
pair list `np.tril_indices(F, -1)` (or `(F, 0)` with `self_interaction`),
row-major. The kernel is `csrc/dot_interaction.cu`; its source note gives
the design and the bound.

The gradient is the plain-torch form of the JAX package's `_bwd`
(`:105-118`): dx = (Zg + Zg^T) x, with Zg the pair gradient scattered back
to [B, F, F]. The JAX package computes it as an XLA einsum, so there is no
backward kernel to port.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import _build

MAX_FEATURES = 64  # the kernel's limit on F (csrc/dot_interaction.cu)


@functools.lru_cache(maxsize=None)
def pair_indices(f: int, self_interaction: bool, device: torch.device):
    """(rows, cols) of the kept triangle, row-major, as int64 tensors."""
    rows, cols = np.tril_indices(f, 0 if self_interaction else -1)
    return (
        torch.as_tensor(rows, dtype=torch.long, device=device),
        torch.as_tensor(cols, dtype=torch.long, device=device),
    )


def dot_interaction_reference(x: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """Plain version: bmm in f32, then the triangle by index."""
    b, f, _ = x.shape
    xf = x.float()
    z = torch.bmm(xf, xf.transpose(1, 2))
    rows, cols = pair_indices(f, self_interaction, x.device)
    return z.reshape(b, f * f)[:, rows * f + cols]


def dot_interaction_backward(
    x: torch.Tensor, g: torch.Tensor, self_interaction: bool
) -> torch.Tensor:
    """dx = (Zg + Zg^T) x in f32, returned in x.dtype. A diagonal pair
    (self_interaction) lands in both terms, giving 2 g x_i."""
    b, f, _ = x.shape
    rows, cols = pair_indices(f, self_interaction, x.device)
    zfull = torch.zeros((b, f * f), dtype=torch.float32, device=x.device)
    zfull[:, rows * f + cols] = g.float()
    zfull = zfull.reshape(b, f, f)
    zg = zfull + zfull.transpose(1, 2)
    return torch.bmm(zg, x.float()).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("dot_interaction")
    lib.dot_interaction_forward.argtypes = [
        ctypes.c_void_p,  # x
        ctypes.c_void_p,  # out
        ctypes.c_int,  # B
        ctypes.c_int,  # F
        ctypes.c_int,  # D
        ctypes.c_int,  # self_interaction
        ctypes.c_int,  # x is bf16
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.dot_interaction_forward.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, self_interaction: bool) -> torch.Tensor:
    b, f, d = x.shape
    n_pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    out = torch.empty((b, n_pairs), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dot_interaction_forward(
            x.data_ptr(), out.data_ptr(), b, f, d, int(self_interaction),
            int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"dot_interaction kernel failed: {msg} (cudaError {err})")
    dot_interaction.launches += 1
    return out


def _check(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"dot_interaction expects [B, F, D], got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dot_interaction takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dot_interaction needs a contiguous [B, F, D] tensor")
    if not 1 <= x.shape[1] <= MAX_FEATURES:
        raise ValueError(f"dot_interaction takes 1 <= F <= {MAX_FEATURES}, got F={x.shape[1]}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dot_interaction runs on cuda or cpu, got {x.device}")


class _DotInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, self_interaction):
        ctx.save_for_backward(x)
        ctx.self_interaction = self_interaction
        if x.is_cuda:
            return _launch(x, self_interaction)
        return dot_interaction_reference(x, self_interaction)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return dot_interaction_backward(x, g, ctx.self_interaction), None


def dot_interaction(x: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """x [B, F, D] -> [B, n_pairs] f32 pairwise dots. On CUDA it launches the
    kernel (and counts the launch in `dot_interaction.launches`); on the CPU
    it takes the plain version."""
    _check(x)
    return _DotInteraction.apply(x, self_interaction)


dot_interaction.launches = 0
