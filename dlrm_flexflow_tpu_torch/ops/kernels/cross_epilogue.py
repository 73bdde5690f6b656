"""The DCN-V2 cross network's f32 epilogue, forward and backward: CUDA kernel
wrappers and plain versions.

Not a port of a TPU kernel: the JAX package leaves the cross network to XLA.
The port's cross network on the card (`ops/cross.py` `FusedCrossNet`) keeps
its products on the bf16 tensor cores and does the elementwise work between
them in one pass a layer each way, over f32 [M, d] tensors:

  cross_forward   x_{l+1} = x0 * (p + b) + x_l, with p = W v the W product's
                  f32 output, and bf16(x_{l+1}), the next V product's operand;
  cross_backward  G = g_in + bf16(dxv) (the residual stream's gradient, dxv
                  the layer above's f32 V-input gradient, which the Dense
                  route rounds to bf16), x0's running gradient gx0 (+)= G * (p + b)
                  in place, the exact three-way bf16 split of G * x0 in
                  `split_bf16x3`'s layout [hi | mid | lo], and b's gradient,
                  the column sums of G * x0;
  cross_fold      x0's gradient gx0 + (G + bf16(dxv)), in place.

The kernels are `csrc/cross_epilogue.cu`; its note gives the bounds and the
design. Each f32 operation is rounded once, as PyTorch's passes round it
on the card (the forward's multiply-add once, as `addcmul` does), so the
kernels equal the plain versions bit for bit but for the order of b's
column sums (fixed: it repeats run to run).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch

from ... import _build
from .bf16_split import split_bf16x3_reference


def cross_forward_reference(p, bias, x0, x, bf16_copy: bool, out=None):
    """Plain version of `cross_forward`."""
    y = torch.addcmul(x, x0, p + bias)
    if out is not None:
        y = out.copy_(y)
    return y, (y.to(torch.bfloat16) if bf16_copy else None)


def cross_backward_reference(g_in, dxv, p, bias, x0, gx0, first: bool, g_out=None):
    """Plain version of `cross_backward`."""
    g = g_in if dxv is None else g_in + dxv.to(torch.bfloat16).float()
    if dxv is not None and g_out is not None:
        g = g_out.copy_(g)
    t = g * (p + bias)
    gx0.copy_(t if first else gx0 + t)
    gy = g * x0
    return g, split_bf16x3_reference(gy, gy.shape[1]), gy.sum(0)


def cross_fold_reference(gx0, g, dxv):
    """Plain version of `cross_fold`."""
    return gx0.copy_(gx0 + (g + dxv.to(torch.bfloat16).float()))


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("cross_epilogue")
    p = ctypes.c_void_p
    lib.cross_row_blocks.argtypes = [ctypes.c_longlong]
    lib.cross_row_blocks.restype = ctypes.c_longlong
    lib.cross_sum_depth.argtypes = [ctypes.c_longlong]
    lib.cross_sum_depth.restype = ctypes.c_longlong
    # p, bias, x0, x, x_out, x_bf16, M, d, stream
    lib.cross_forward.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
    lib.cross_forward.restype = ctypes.c_int
    # g_in, dxv, p, bias, x0, gx0, g_out, g3, partial, bias_grad, M, d, first, stream
    lib.cross_backward.argtypes = [p] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
    lib.cross_backward.restype = ctypes.c_int
    # gx0 (in place), g, dxv, n, stream
    lib.cross_fold.argtypes = [p, p, p, ctypes.c_longlong, p]
    lib.cross_fold.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def bias_grad_depth(m: int) -> int:
    """The most f32 additions a term of `cross_backward`'s b gradient passes
    through for M rows (its thread's rows, its block's row groups, the row
    blocks): the sum is within that many roundings, 2^-24 each, of the sum of
    the terms' magnitudes from the exact column sum. Needs the CUDA build."""
    return int(_kernel_lib().cross_sum_depth(m))


def _check(name: str, x0: torch.Tensor, **tensors: Optional[torch.Tensor]) -> None:
    """Every tensor f32 on x0's device, contiguous and 16-byte aligned; x0
    [M, d] with d a multiple of 8; `bias` [d], the rest [M, d]."""
    if x0.dim() != 2 or x0.shape[1] % 8 or x0.shape[1] >= 2**31:
        raise ValueError(f"{name}: x0 must be [M, d] with d a multiple of 8, got {tuple(x0.shape)}")
    if x0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {x0.device}")
    for key, t in (("x0", x0), *tensors.items()):
        if t is None:
            continue
        shape = (x0.shape[1],) if key == "bias" else tuple(x0.shape)
        if (t.device != x0.device or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {key} must be a contiguous 16-byte aligned f32 {shape} on {x0.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(name: str, device: torch.device, call) -> None:
    lib = _kernel_lib()
    index = device.index
    with contextlib.nullcontext() if torch.cuda.current_device() == index else torch.cuda.device(index):
        err = call(lib, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel failed: {lib.cuda_error_string(err).decode()} (cudaError {err})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def cross_forward(p: torch.Tensor, bias: torch.Tensor, x0: torch.Tensor, x: torch.Tensor, bf16_copy: bool,
                  out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x0 * (p + bias) + x, its bf16 copy or None) for f32 [M, d] p, x0, x
    and f32 [d] bias, d a multiple of 8; written into `out` where given
    (`out` may be `x`). On CUDA one launch (counted in
    `cross_forward.launches`); on the CPU the plain version."""
    _check("cross_forward", x0, p=p, bias=bias, x=x, out=out)
    if x0.device.type == "cpu":
        return cross_forward_reference(p, bias, x0, x, bf16_copy, out)
    m, d = x0.shape
    out = torch.empty_like(x0) if out is None else out
    xb = torch.empty((m, d), dtype=torch.bfloat16, device=x0.device) if bf16_copy else None
    _launch("cross_forward", x0.device, lambda lib, s: lib.cross_forward(
        p.data_ptr(), bias.data_ptr(), x0.data_ptr(), x.data_ptr(), out.data_ptr(), _ptr(xb), m, d, s))
    cross_forward.launches += 1
    return out, xb


def cross_backward(g_in: torch.Tensor, dxv: Optional[torch.Tensor], p: torch.Tensor, bias: torch.Tensor,
                   x0: torch.Tensor, gx0: torch.Tensor, first: bool,
                   g_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cross layer's backward epilogue, for f32 [M, d] tensors: with
    G = g_in + bf16(dxv) (g_in where dxv is None), it sets gx0 to
    G * (p + bias) (`first`) or adds that to it, in place, and returns
    (G, G3, bias_grad): G written into `g_out` where dxv is given (a new
    tensor where `g_out` is None; `g_out` may be `g_in`), G3 [M, 3d] bf16
    the split of G * x0 (`split_bf16x3`'s layout), bias_grad [d] f32 its
    column sums. On CUDA two launches, the pass and the sums of its
    per-block partials in a fixed order (counted once in
    `cross_backward.launches`); on the CPU the plain version."""
    _check("cross_backward", x0, g_in=g_in, dxv=dxv, p=p, bias=bias, gx0=gx0, g_out=g_out)
    if x0.device.type == "cpu":
        return cross_backward_reference(g_in, dxv, p, bias, x0, gx0, first, g_out)
    m, d = x0.shape
    if dxv is None:
        g_out = None
    elif g_out is None:
        g_out = torch.empty_like(x0)
    g3 = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=x0.device)
    lib = _kernel_lib()
    partial = torch.empty((lib.cross_row_blocks(m), d), dtype=torch.float32, device=x0.device)
    bias_grad = torch.empty((d,), dtype=torch.float32, device=x0.device)
    _launch("cross_backward", x0.device, lambda lib, s: lib.cross_backward(
        g_in.data_ptr(), _ptr(dxv), p.data_ptr(), bias.data_ptr(), x0.data_ptr(), gx0.data_ptr(), _ptr(g_out),
        g3.data_ptr(), partial.data_ptr(), bias_grad.data_ptr(), m, d, int(first), s))
    cross_backward.launches += 1
    return (g_in if g_out is None else g_out), g3, bias_grad


def cross_fold(gx0: torch.Tensor, g: torch.Tensor, dxv: torch.Tensor) -> torch.Tensor:
    """gx0 + (g + bf16(dxv)) into gx0, for f32 [M, d] tensors: x0's whole
    gradient. On CUDA one launch (counted in `cross_fold.launches`); on the
    CPU the plain version."""
    _check("cross_fold", gx0, g=g, dxv=dxv)
    if gx0.device.type == "cpu":
        return cross_fold_reference(gx0, g, dxv)
    _launch("cross_fold", gx0.device, lambda lib, s: lib.cross_fold(
        gx0.data_ptr(), g.data_ptr(), dxv.data_ptr(), gx0.numel(), s))
    cross_fold.launches += 1
    return gx0


cross_forward.launches = 0
cross_backward.launches = 0
cross_fold.launches = 0
