"""Fused dense layer: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel `_dense_kernel`
(`dlrm_flexflow_tpu/ops/pallas/fused_mlp.py:31`, launched by `dense_pallas`
at `:105`) as the JAX package's Dense calls it under use_pallas="on"
(`ops/dense.py:58-67`):

    out = cdt(act(f32acc(cdt(x) @ cdt(w)^T) + f32(cdt(b))))

then cast back to x's dtype. x is [M, K] (f32 or bf16), `kernel` the Dense
parameter [N, K] = [out, in] in f32 (the JAX package passes its transpose
to `dense_pallas`), `bias` [N] f32 or None, cdt bf16 or f32. The kernel is
`csrc/fused_mlp.cu` (bf16: `wgmma` fed by TMA through an mbarrier ring;
f32: FMAs on the CUDA cores); its source note gives the design and the
bound. For bf16 the wrapper allocates the kernel's scratch (`scratch_plan`):
w rounded to bf16 as [N, Kp], and, where TMA cannot read x as it lies, x
rounded to bf16 as [M, Kp] (Kp = K rounded up to 8).

The JAX package's `dense_pallas` has no gradient (no VJP is defined, and
`jax.grad` through it fails), so neither has this op: its backward raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import _build
from ...ffconst import ActiMode
from ..common import apply_activation

# the kernel's activation codes (csrc/fused_mlp.cu `Act`)
ACT_CODES = {
    ActiMode.AC_MODE_NONE: 0,
    ActiMode.AC_MODE_RELU: 1,
    ActiMode.AC_MODE_SIGMOID: 2,
    ActiMode.AC_MODE_TANH: 3,
    ActiMode.AC_MODE_GELU: 4,
}
NO_GRADIENT = (
    "the forced dense kernel has no gradient: the JAX package's dense_pallas "
    "defines none, so training under use_pallas='on' is a later slice of the port"
)


def padded_k(k: int) -> int:
    """K rounded up to 8: a bf16 row of Kp values is a whole number of
    16-byte units, as TMA needs."""
    return -(-k // 8) * 8


def x_goes_direct(k: int, dtype: torch.dtype, data_ptr: int) -> bool:
    """Whether TMA reads x as it lies: a row pitch of whole 16-byte units
    and a 16-byte aligned base (csrc `fused_dense_x_direct`, which the
    launch checks)."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return (k * itemsize) % 16 == 0 and data_ptr % 16 == 0


def scratch_plan(m: int, n: int, k: int, dtype: torch.dtype, data_ptr: int) -> dict:
    """The bf16 path's scratch: w in bf16 [N, Kp]; x in bf16 [M, Kp] where
    TMA cannot read it as it lies, else None."""
    kp = padded_k(k)
    return {"w": (n, kp), "x": None if x_goes_direct(k, dtype, data_ptr) else (m, kp)}


def fused_dense_reference(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    activation: ActiMode,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version: operands rounded to the compute dtype and multiplied
    in f32 (a product of two bf16 values is exact in f32), the bias rounded
    to the compute dtype, the activation in f32, the result rounded to the
    compute dtype and returned in x's dtype."""
    y = torch.matmul(x.to(compute_dtype).float(), kernel.to(compute_dtype).float().t())
    if bias is not None:
        y = y + bias.to(compute_dtype).float()
    return apply_activation(y, activation).to(compute_dtype).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    lib.fused_dense_forward.argtypes = [
        ctypes.c_void_p,  # x
        ctypes.c_void_p,  # kernel [N, K] f32
        ctypes.c_void_p,  # bias [N] f32, or NULL
        ctypes.c_void_p,  # out
        ctypes.c_int,  # M
        ctypes.c_int,  # N
        ctypes.c_int,  # K
        ctypes.c_int,  # activation code
        ctypes.c_int,  # x is bf16
        ctypes.c_int,  # compute dtype is bf16
        ctypes.c_void_p,  # w in bf16 [N, Kp] (scratch), or NULL for f32 compute
        ctypes.c_void_p,  # x in bf16 [M, Kp] (scratch), or NULL
        ctypes.c_int,  # Kp
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.fused_dense_forward.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, kernel, bias, activation, compute_dtype) -> torch.Tensor:
    m, k = x.shape
    n = kernel.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    w16 = x16 = None
    if compute_dtype == torch.bfloat16:
        plan = scratch_plan(m, n, k, x.dtype, x.data_ptr())
        w16 = torch.empty(plan["w"], dtype=torch.bfloat16, device=x.device)
        if plan["x"] is not None:
            x16 = torch.empty(plan["x"], dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_dense_forward(
            x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, n, k, ACT_CODES[activation], int(x.dtype == torch.bfloat16),
            int(compute_dtype == torch.bfloat16), None if w16 is None else w16.data_ptr(),
            None if x16 is None else x16.data_ptr(), padded_k(k), stream,
        )
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"fused_dense kernel failed: {msg} (cudaError {err})")
    fused_dense.launches += 1
    return out


def _check(x, kernel, bias, activation, compute_dtype) -> None:
    if x.dim() != 2 or kernel.dim() != 2 or x.shape[1] != kernel.shape[1]:
        raise ValueError(f"fused_dense takes x [M, K] and kernel [N, K], got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_dense takes float32 or bfloat16 x, got {x.dtype}")
    if kernel.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("fused_dense takes a float32 kernel and bias")
    if bias is not None and tuple(bias.shape) != (kernel.shape[0],):
        raise ValueError(f"fused_dense: bias {tuple(bias.shape)} does not match N={kernel.shape[0]}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_dense computes in float32 or bfloat16, got {compute_dtype}")
    if activation not in ACT_CODES:
        raise ValueError(f"fused_dense: unknown activation {activation}")
    if not all(t.is_contiguous() for t in (x, kernel) + (() if bias is None else (bias,))):
        raise ValueError("fused_dense needs contiguous x, kernel and bias")
    if max(x.shape[0], kernel.shape[0], x.shape[1]) >= 2**31:
        raise ValueError("fused_dense takes M, N and K below 2^31")
    dev = x.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_dense runs on cuda or cpu, got {dev}")
    if kernel.device != dev or (bias is not None and bias.device != dev):
        raise ValueError("fused_dense: x, kernel and bias must lie on one device")


class _FusedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, activation, compute_dtype):
        if x.is_cuda:
            return _launch(x, kernel, bias, activation, compute_dtype)
        return fused_dense_reference(x, kernel, bias, activation, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(NO_GRADIENT)


def fused_dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    activation: ActiMode,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """x [M, K] @ kernel[N, K].T + bias, activation, rounded to the compute
    dtype, in x's dtype. On CUDA it launches the kernel (counted in
    `fused_dense.launches`); on the CPU it takes the plain version."""
    _check(x, kernel, bias, activation, compute_dtype)
    return _FusedDense.apply(x, kernel, bias, activation, compute_dtype)


fused_dense.launches = 0
