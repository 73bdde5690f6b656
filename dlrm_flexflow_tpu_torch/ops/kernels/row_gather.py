"""Row gather: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel `_dma_gather_kernel`
(`scripts/bench_gather_probe.py:78`, launched by `dma_gather` at `:119`),
the per-row DMA gather of the forward-gather probe (the design study behind
the sparse lookup that kaggle training runs): out[i] = table[rows[i]], an
exact copy in the table's dtype, table [P, W] float32 or bfloat16, rows [K]
int32. The TPU kernel keeps `depth` row DMAs in flight; the CUDA kernel
(`csrc/row_gather.cu`, whose source note gives the design and the bound)
takes `depth` in DEPTHS as the number of 512-byte warp loads in flight
before any store. It takes any K and any W with W * itemsize % 16 == 0.
An index < 0 or >= P gives a NaN row (the TPU kernel has no contract
there; this is K4's), in the kernel and in the plain version alike, so the
two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build

DEPTHS = (1, 2, 4, 8)

F32, BF16 = torch.float32, torch.bfloat16


def row_gather_reference(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version: `index_select` of the rows, those outside [0, P) set
    to NaN."""
    r = rows.long()
    oob = (r < 0) | (r >= table.shape[0])
    out = table.index_select(0, torch.where(oob, torch.zeros_like(r), r))
    nan = torch.full((), float("nan"), dtype=table.dtype, device=table.device)
    return torch.where(oob[:, None], nan, out)


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("row_gather")
    lib.row_gather.argtypes = [
        ctypes.c_void_p,  # table
        ctypes.c_void_p,  # rows
        ctypes.c_void_p,  # out
        ctypes.c_longlong,  # K
        ctypes.c_longlong,  # P
        ctypes.c_longlong,  # row bytes
        ctypes.c_int,  # table is bf16
        ctypes.c_int,  # depth
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.row_gather.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(table: torch.Tensor, rows: torch.Tensor, depth: int) -> None:
    if table.dim() != 2 or table.dtype not in (F32, BF16):
        raise TypeError(f"row_gather takes a [P, W] float32 or bfloat16 table, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise TypeError(f"row_gather takes [K] int32 rows, got {tuple(rows.shape)} {rows.dtype}")
    if depth not in DEPTHS:
        raise ValueError(f"row_gather: depth must be one of {DEPTHS}, got {depth}")
    row_bytes = table.shape[1] * table.element_size()
    if not 1 <= table.shape[0] < 2**31 or row_bytes == 0 or row_bytes % 16:
        raise ValueError(f"row_gather takes 1 <= P < 2^31 rows of a multiple of 16 bytes, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if rows.numel() * (row_bytes // 16) >= 2**31:
        raise ValueError(f"row_gather: {rows.numel()} rows of {row_bytes} bytes is 2^31 "
                         "16-byte chunks or more")
    if not (table.is_contiguous() and rows.is_contiguous()):
        raise ValueError("row_gather needs a contiguous table and rows")
    if table.data_ptr() % 16:
        # row r of a bf16 table starts 16-byte aligned only if the table does
        raise ValueError("row_gather: the table's first element must be 16-byte aligned")
    if table.device.type not in ("cuda", "cpu") or rows.device != table.device:
        raise ValueError(f"row_gather runs on cuda or cpu with table and rows on one device, "
                         f"got {table.device} and {rows.device}")


def row_gather(table: torch.Tensor, rows: torch.Tensor, depth: int = 4) -> torch.Tensor:
    """table [P, W], rows [K] int32 -> [K, W] in the table's dtype, NaN rows
    for indices outside [0, P). On CUDA it launches the kernel (counted in
    `row_gather.launches`); on the CPU it takes the plain version."""
    _check(table, rows, depth)
    if not table.is_cuda:
        return row_gather_reference(table, rows)
    p, w = table.shape
    out = torch.empty((rows.numel(), w), dtype=table.dtype, device=table.device)
    if rows.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.row_gather(table.data_ptr(), rows.data_ptr(), out.data_ptr(), rows.numel(), p,
                             w * table.element_size(), int(table.dtype == BF16), depth, stream)
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"row_gather kernel failed: {msg} (cudaError {err})")
    row_gather.launches += 1
    return out


row_gather.launches = 0
