"""Sparse embedding row update: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernels `_update_kernel` and `_update_kernel_manual`
(`dlrm_flexflow_tpu/ops/pallas/packed_update.py:487,750`, launched by
`_packed_apply` and `_packed_apply_manual` through
`packed_row_update_batched`, `:1011`). For each table of a group,

    table[rows[k]] += round_s(scale * src[k // h])       for every k

with duplicate rows summed in f32, rows < 0 or >= V dropped, each delta
rounded to the stream dtype first (bf16 by default, as the JAX package
casts its update stream), and the table's dtype epilogue: an f32 table
adds the f32 sum; a bf16 table adds the sum rounded to bf16, in bf16
(`tp + acc.astype(tp.dtype)`, `:558`). The payload is `(src [B, D], h)`:
row k of it is `src[k // h]` (the unexpanded pooled gradient of
`bag_row_src`), or a `[K, D]` tensor, which is the same with h = 1. Tables
are updated in place.

On CUDA the rows are prepared in torch, as the JAX package prepares its
stream outside Pallas (`prep_sorted_routes`, `:238`): dropped rows map to
the sentinel V, and one stable sort over the group's [T, K] rows gives
`rows_sorted, order`. Then one kernel launch per table
(`csrc/row_update.cu`) sums each run of equal rows in sorted order and
writes the row once: no atomics, the same bits on every run. On the CPU
the plain version runs: dropped-row mask, stream rounding, `index_add_`
into an f32 copy of the touched rows, then the epilogue.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple, Union

import torch

from ... import _build

MAX_D = 128  # the kernel's limit on D (csrc/row_update.cu)

Payload = Union[torch.Tensor, Tuple[torch.Tensor, int]]


def _src_h(payload: Payload) -> Tuple[torch.Tensor, int]:
    if isinstance(payload, tuple):
        src, h = payload
        return src, int(h)
    return payload, 1


def row_update_reference(
    table: torch.Tensor,
    rows: torch.Tensor,
    payload: Payload,
    scale: torch.Tensor,
    stream_dtype: torch.dtype = torch.bfloat16,
) -> None:
    """Plain version, in place: `index_add_` of the rounded deltas into an
    f32 copy of the touched rows, then the table dtype's epilogue."""
    src, h = _src_h(payload)
    v, d = table.shape
    keep = torch.nonzero((rows >= 0) & (rows < v)).reshape(-1)
    if keep.numel() == 0:
        return
    delta = (scale.float() * src[keep // h].float()).to(stream_dtype).float()
    uniq, inv = torch.unique(rows[keep].long(), return_inverse=True)
    acc = torch.zeros((uniq.numel(), d), dtype=torch.float32, device=table.device)
    acc.index_add_(0, inv, delta)
    if table.dtype == torch.float32:
        table[uniq] = table[uniq] + acc
    else:
        table[uniq] = (table[uniq].float() + acc.to(table.dtype).float()).to(table.dtype)


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("row_update")
    lib.row_update.argtypes = [
        ctypes.c_void_p,  # table
        ctypes.c_int,  # table is bf16
        ctypes.c_void_p,  # rows_sorted int32
        ctypes.c_void_p,  # order int32
        ctypes.c_void_p,  # src f32
        ctypes.c_void_p,  # scale f32 (one value)
        ctypes.c_longlong,  # K
        ctypes.c_int,  # V
        ctypes.c_int,  # D
        ctypes.c_int,  # h
        ctypes.c_int,  # stream is bf16
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.row_update.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def sort_rows(tables: Sequence[torch.Tensor], rows_list: Sequence[torch.Tensor]):
    """The stream prep: rows out of [0, V) map to the sentinel V of their
    table; one stable sort over the group's [T, K] rows. Returns
    (rows_sorted, order), both [T, K] int32."""
    keyed = []
    for table, rows in zip(tables, rows_list):
        v = table.shape[0]
        r = rows.to(torch.int32)
        keyed.append(torch.where((r >= 0) & (r < v), r, torch.full_like(r, v)))
    rows_sorted, order = torch.sort(torch.stack(keyed), dim=1, stable=True)
    return rows_sorted, order.to(torch.int32)


def _launch(table, rows_sorted, order, src, h, scale, stream_dtype) -> None:
    v, d = table.shape
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.row_update(
            table.data_ptr(), int(table.dtype == torch.bfloat16),
            rows_sorted.data_ptr(), order.data_ptr(), src.data_ptr(), scale.data_ptr(),
            rows_sorted.numel(), v, d, h, int(stream_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"row_update kernel failed: {msg} (cudaError {err})")
    row_update.launches += 1


def _check(tables, rows_list, payloads, scale, stream_dtype) -> None:
    if not (len(tables) == len(rows_list) == len(payloads)) or not tables:
        raise ValueError("row_update takes equal, non-empty lists of tables, rows and payloads")
    dev = tables[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"row_update runs on cuda or cpu, got {dev}")
    if stream_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"row_update streams bfloat16 or float32, got {stream_dtype}")
    if scale.numel() != 1 or scale.dtype != torch.float32 or scale.device != dev:
        raise ValueError("row_update: scale must be one float32 value on the tables' device")
    k = rows_list[0].shape
    for table, rows, payload in zip(tables, rows_list, payloads):
        src, h = _src_h(payload)
        if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"row_update takes [V, D] float32 or bfloat16 tables, got "
                            f"{tuple(table.shape)} {table.dtype}")
        if not 1 <= table.shape[1] <= MAX_D or table.shape[0] >= 2**31 - 1:
            raise ValueError(f"row_update takes 1 <= D <= {MAX_D} and V < 2^31 - 1, "
                             f"got {tuple(table.shape)}")
        if rows.dim() != 1 or rows.shape != k or rows.dtype not in (torch.int32, torch.int64):
            raise ValueError("row_update: every table takes the same [K] integer rows")
        if src.dtype != torch.float32 or src.dim() != 2 or src.shape[1] != table.shape[1]:
            raise TypeError("row_update: the payload must be float32 rows of the table's D")
        if h < 1 or src.shape[0] * h != rows.shape[0]:
            raise ValueError(f"row_update: payload of {src.shape[0]} rows x h={h} "
                             f"does not cover K={rows.shape[0]}")
        if not (table.is_contiguous() and src.is_contiguous()):
            raise ValueError("row_update needs contiguous tables and payloads")
        if any(t.device != dev for t in (table, rows, src)):
            raise ValueError("row_update: all tensors must lie on one device")


def row_update(
    tables: List[torch.Tensor],
    rows_list: Sequence[torch.Tensor],
    payloads: Sequence[Payload],
    scale: torch.Tensor,
    stream_dtype: torch.dtype = torch.bfloat16,
) -> None:
    """table[rows] += round_s(scale * payload) for each table of a group,
    in place; every table shares K and the scale. On CUDA it sorts the
    group's rows once and launches the kernel once per table (counted in
    `row_update.launches`); on the CPU it takes the plain version."""
    _check(tables, rows_list, payloads, scale, stream_dtype)
    if not tables[0].is_cuda:
        for table, rows, payload in zip(tables, rows_list, payloads):
            row_update_reference(table, rows, payload, scale, stream_dtype)
        return
    if rows_list[0].numel() == 0:
        return
    rows_sorted, order = sort_rows(tables, rows_list)
    for i, (table, payload) in enumerate(zip(tables, payloads)):
        src, h = _src_h(payload)
        _launch(table, rows_sorted[i], order[i], src, h, scale, stream_dtype)


row_update.launches = 0
