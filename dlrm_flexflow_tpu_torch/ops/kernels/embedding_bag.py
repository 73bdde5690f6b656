"""Pooled embedding-bag lookup: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel `_bag_kernel`
(`dlrm_flexflow_tpu/ops/pallas/embedding_bag.py:38`, launched by `_bag_fwd`
at `:90`), which the JAX package's Embedding runs under use_pallas="on" for
a pooled table with D % 128 == 0 (`ops/embedding.py:155-162`): table
[R, D] (f32 or bf16; f16 after `quantize_embeddings("float16")`), idx
[M, H] or [M] with idx < 0 as padding, rows
summed in f32, AVG divided by max(#valid, 1), the result in the table's
dtype. An index >= R gives a NaN row, as the port's plain gather does; the
kernel never reads outside the table. The kernel is
`csrc/embedding_bag.cu`; its source note gives the design and the bound.

The gradient is the JAX package's `_bwd` (`:130-138`), an XLA scatter-add
there and plain torch here: a dense [R, D] f32 sum of each member's share
of the pooled gradient, rows < 0 or >= R dropped.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ...ffconst import AggrMode

# the table dtypes the kernel takes, in the order of its dtype code
TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _bags(idx: torch.Tensor) -> torch.Tensor:
    idx = idx.long()
    return idx[:, None] if idx.dim() == 1 else idx


def embedding_bag_reference(table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode) -> torch.Tensor:
    """Plain version: gather, padding to zero and indices >= R to NaN, an
    f32 sum over the bag, AVG's division, the table's dtype."""
    idx = _bags(idx)
    valid = idx >= 0
    oob = idx >= table.shape[0]
    rows = table[torch.where(valid & ~oob, idx, torch.zeros_like(idx))].float()
    rows = torch.where(valid[..., None], rows, torch.zeros((), device=rows.device))
    rows = torch.where(oob[..., None], torch.full((), float("nan"), device=rows.device), rows)
    pooled = rows.sum(dim=1)
    if aggr is AggrMode.AGGR_MODE_AVG:
        pooled = pooled / valid.sum(dim=1, keepdim=True).clamp_min(1).float()
    return pooled.to(table.dtype)


def embedding_bag_backward(idx: torch.Tensor, g: torch.Tensor, aggr: AggrMode, shape) -> torch.Tensor:
    """Dense [R, D] f32 gradient: every valid member of bag m receives
    g[m] (g[m] / count for AVG), through the op's `bag_row_grads` as the
    JAX package's `_bwd` goes through its own."""
    from ..embedding import bag_row_grads  # the op module imports this one

    r, d = shape
    rows, grads = bag_row_grads(idx, g, aggr, r)
    keep = rows < r  # padding is marked r; rows >= r are dropped too
    dtable = torch.zeros((r, d), dtype=torch.float32, device=g.device)
    dtable.index_add_(0, rows[keep], grads[keep])
    return dtable


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    lib.embedding_bag_forward.argtypes = [
        ctypes.c_void_p,  # table
        ctypes.c_void_p,  # idx
        ctypes.c_void_p,  # out
        ctypes.c_longlong,  # M
        ctypes.c_int,  # H
        ctypes.c_longlong,  # R
        ctypes.c_int,  # D
        ctypes.c_int,  # table dtype: 0 float32, 1 bfloat16, 2 float16
        ctypes.c_int,  # idx is int64
        ctypes.c_int,  # AVG
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.embedding_bag_forward.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode) -> torch.Tensor:
    r, d = table.shape
    m = idx.shape[0]
    h = 1 if idx.dim() == 1 else idx.shape[1]
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    if m == 0:
        return out
    if h == 0:
        return out.zero_()
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.embedding_bag_forward(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, h, r, d,
            TABLE_DTYPES.index(table.dtype), int(idx.dtype == torch.int64),
            int(aggr is AggrMode.AGGR_MODE_AVG), stream,
        )
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"embedding_bag kernel failed: {msg} (cudaError {err})")
    embedding_bag.launches += 1
    return out


def _check(table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode) -> None:
    if aggr not in (AggrMode.AGGR_MODE_SUM, AggrMode.AGGR_MODE_AVG):
        raise ValueError(f"embedding_bag is a pooled lookup (SUM or AVG), got {aggr}")
    if table.dim() != 2 or table.dtype not in TABLE_DTYPES:
        raise TypeError(f"embedding_bag takes a [R, D] float32, bfloat16 or float16 table, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if idx.dim() not in (1, 2) or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"embedding_bag takes int32 or int64 idx [M] or [M, H], got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if table.shape[0] < 1 or table.shape[1] >= 2**31 or (idx.dim() == 2 and idx.shape[1] >= 2**31):
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} or bag {tuple(idx.shape)} "
                         "out of the kernel's range")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("embedding_bag needs a contiguous table and idx")
    if table.device.type not in ("cuda", "cpu") or idx.device != table.device:
        raise ValueError(f"embedding_bag runs on cuda or cpu with table and idx on one device, "
                         f"got {table.device} and {idx.device}")


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, aggr):
        ctx.save_for_backward(idx)
        ctx.aggr, ctx.shape, ctx.dtype = aggr, tuple(table.shape), table.dtype
        if table.is_cuda:
            return _launch(table, idx, aggr)
        return embedding_bag_reference(table, idx, aggr)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return embedding_bag_backward(idx, g, ctx.aggr, ctx.shape).to(ctx.dtype), None, None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode) -> torch.Tensor:
    """Pooled lookup table [R, D], idx [M, H] or [M] -> [M, D] in the
    table's dtype. On CUDA it launches the kernel (counted in
    `embedding_bag.launches`); on the CPU it takes the plain version."""
    _check(table, idx, aggr)
    return _EmbeddingBag.apply(table, idx, aggr)


embedding_bag.launches = 0
