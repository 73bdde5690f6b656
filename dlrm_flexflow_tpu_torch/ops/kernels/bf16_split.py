"""The exact three-way bf16 split of an f32 matrix: CUDA kernel wrapper and
plain version.

Not a port of a TPU kernel: the JAX package leaves the Dense products to
XLA. The port's Dense backward on the card (`ops/dense.py` `Bf16Product`)
multiplies the f32 cotangent g [M, N] on the bf16 tensor cores without
rounding it: g is split as hi = bf16(g), mid = bf16(g - hi),
lo = bf16(g - hi - mid), so hi + mid + lo == g bit for bit wherever g is a
multiple of 2^-133 (every finite |g| >= 2^-110), and each part's product
with a bf16 value is exact in f32. The parts lie side by side in one bf16
buffer G3 [M, 3 * Np] (row m is [hi | mid | lo], each Np = N rounded up to
8 wide, zeros past N). The kernel is `csrc/bf16_split.cu`; its note gives
the bound (4 bytes read and 6 written a element) and the design.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ... import _build


def split_bf16x3_reference(g: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Plain version: the same three roundings to nearest even, in PyTorch."""
    m, n = g.shape
    hi = g.to(torch.bfloat16)
    rest = torch.where(torch.isinf(hi), torch.zeros_like(g), g - hi.float())
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    out = torch.zeros((m, 3, n_pad), dtype=torch.bfloat16, device=g.device)
    out[:, :, :n] = torch.stack((hi, mid, lo), dim=1)
    return out.view(m, 3 * n_pad)


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("bf16_split")
    lib.split_bf16x3.argtypes = [
        ctypes.c_void_p,  # g [M, N] f32
        ctypes.c_void_p,  # out [M, 3 * n_pad] bf16
        ctypes.c_longlong,  # M
        ctypes.c_int,  # N
        ctypes.c_int,  # n_pad
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.split_bf16x3.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def split_bf16x3(g: torch.Tensor, n_pad: int) -> torch.Tensor:
    """G3 [M, 3 * n_pad] bf16 of a contiguous f32 g [M, N], n_pad >= N a
    multiple of 8. On CUDA it launches the kernel on the current stream
    (counted in `split_bf16x3.launches`); on the CPU it takes the plain
    version."""
    if g.dim() != 2 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"split_bf16x3 takes a contiguous f32 [M, N], got {g.dtype} {tuple(g.shape)}"
                         f"{'' if g.is_contiguous() else ' not contiguous'}")
    m, n = g.shape
    if n_pad < n or n_pad % 8 or n_pad >= 2**31:
        raise ValueError(f"split_bf16x3: n_pad {n_pad} is not a multiple of 8 at least N = {n}")
    if g.device.type == "cpu":
        return split_bf16x3_reference(g, n_pad)
    if g.device.type != "cuda":
        raise ValueError(f"split_bf16x3 runs on cuda or cpu, got {g.device}")
    if -(-m * n_pad // 256) >= 2**31:
        raise ValueError(f"split_bf16x3: [{m}, {n_pad}] needs more than 2^31 blocks")
    out = torch.empty((m, 3 * n_pad), dtype=torch.bfloat16, device=g.device)
    lib = _kernel_lib()
    index = g.device.index
    # a device switch only where the current device is not g's (an eager step makes 7 calls)
    with contextlib.nullcontext() if torch.cuda.current_device() == index else torch.cuda.device(index):
        err = lib.split_bf16x3(g.data_ptr(), out.data_ptr(), m, n, n_pad, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"split_bf16x3 kernel failed: {lib.cuda_error_string(err).decode()} (cudaError {err})")
    split_bf16x3.launches += 1
    return out


split_bf16x3.launches = 0
