"""Small-vocabulary pooled lookup (the one-hot embedding's forward): CUDA
kernel wrapper and plain version.

Replaces the Pallas TPU kernel `_fwd_kernel`
(`dlrm_flexflow_tpu/ops/pallas/onehot_embedding.py:55`, launched by
`_onehot_fwd` at `:104`), which the JAX package's Embedding runs under
use_pallas="on" for a pooled table of at most `onehot_embedding_threshold`
rows (`ops/embedding.py:132-146`). The TPU kernel multiplies the pooled
one-hot matrix, cast to the compute dtype cdt, by the table cast to cdt
with an f32 accumulator (`_pooled_onehot`, `:40-52`). A one-hot product
selects rows exactly, so for each bag it is a sum over the bag's distinct
rows r < V of w_r * cdt(table[r]) in f32, in the table's dtype, with

    w_r = cdt(n_r)                      SUM
    w_r = cdt(n_r / max(cnt, 1))        AVG

n_r the row's multiplicity in the bag and cnt the bag's entries >= 0. An
index >= V adds nothing but counts in cnt; idx < 0 is padding. The AVG
weight is rounded per distinct row, which is not the plain one-hot path's
"sum, then divide" (`embedding_bag_onehot`): with bf16 and n_r = 3 the two
differ. The kernel is `csrc/onehot_embedding.cu`; its source note gives the
design and the bound.

The backward (K5b, `_bwd_kernel`) is a later slice of the port: the JAX
package reaches it only when training under use_pallas="on", where its
forced Dense kernel has no gradient. This op's backward raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ...ffconst import AggrMode

NO_BACKWARD = (
    "the one-hot embedding kernel's backward (K5b, `_bwd_kernel`) is a later slice of the "
    "port: training under use_pallas='on' is not ported yet"
)


def _onehot_weights(idx: torch.Tensor, v: int, aggr: AggrMode, compute_dtype: torch.dtype) -> torch.Tensor:
    """[B, H] f32 weight of each bag member: w_r at a row's first
    occurrence in its bag, 0 at later occurrences, padding and rows >= v."""
    idx = idx.long()
    if idx.dim() == 1:
        idx = idx[:, None]
    h = idx.shape[1]
    same = idx[:, :, None] == idx[:, None, :]  # [B, H, H]
    earlier = torch.ones((h, h), dtype=torch.bool, device=idx.device).tril(-1)
    first = ~(same & earlier).any(dim=2)
    n = same.sum(dim=2).float()
    if aggr is AggrMode.AGGR_MODE_AVG:
        n = n / (idx >= 0).sum(dim=1, keepdim=True).clamp_min(1).float()
    w = n.to(compute_dtype).float()
    return torch.where((idx >= 0) & (idx < v) & first, w, torch.zeros((), device=idx.device))


def onehot_embedding_reference(
    table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode, compute_dtype: torch.dtype
) -> torch.Tensor:
    """Plain version: the per-row weights above times the rows rounded to
    the compute dtype, summed in f32, in the table's dtype."""
    v = table.shape[0]
    w = _onehot_weights(idx, v, aggr, compute_dtype)
    idx = idx.long().reshape(w.shape)
    safe = torch.where((idx >= 0) & (idx < v), idx, torch.zeros_like(idx))
    rows = table[safe].to(compute_dtype).float()  # [B, H, D]
    return (w[..., None] * rows).sum(dim=1).to(table.dtype)


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("onehot_embedding")
    lib.onehot_embedding_forward.argtypes = [
        ctypes.c_void_p,  # table
        ctypes.c_void_p,  # idx
        ctypes.c_void_p,  # out
        ctypes.c_longlong,  # B
        ctypes.c_int,  # H
        ctypes.c_longlong,  # V
        ctypes.c_int,  # D
        ctypes.c_int,  # table is bf16
        ctypes.c_int,  # idx is int64
        ctypes.c_int,  # AVG
        ctypes.c_int,  # compute dtype is bf16
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.onehot_embedding_forward.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(table, idx, aggr, compute_dtype) -> torch.Tensor:
    v, d = table.shape
    b = idx.shape[0]
    h = 1 if idx.dim() == 1 else idx.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0:
        return out
    if h == 0:
        return out.zero_()
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.onehot_embedding_forward(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, h, v, d,
            int(table.dtype == torch.bfloat16), int(idx.dtype == torch.int64),
            int(aggr is AggrMode.AGGR_MODE_AVG), int(compute_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"onehot_embedding kernel failed: {msg} (cudaError {err})")
    onehot_embedding.launches += 1
    return out


def _check(table, idx, aggr, compute_dtype) -> None:
    if aggr not in (AggrMode.AGGR_MODE_SUM, AggrMode.AGGR_MODE_AVG):
        raise ValueError(f"onehot_embedding is a pooled lookup (SUM or AVG), got {aggr}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"onehot_embedding computes in float32 or bfloat16, got {compute_dtype}")
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"onehot_embedding takes a [V, D] float32 or bfloat16 table, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if idx.dim() not in (1, 2) or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"onehot_embedding takes int32 or int64 idx [B] or [B, H], got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if table.shape[0] < 1 or table.shape[1] >= 2**31 or (idx.dim() == 2 and idx.shape[1] >= 2**31):
        raise ValueError(f"onehot_embedding: table {tuple(table.shape)} or bag "
                         f"{tuple(idx.shape)} out of the kernel's range")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("onehot_embedding needs a contiguous table and idx")
    if table.device.type not in ("cuda", "cpu") or idx.device != table.device:
        raise ValueError(f"onehot_embedding runs on cuda or cpu with table and idx on one "
                         f"device, got {table.device} and {idx.device}")


class _OnehotEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, aggr, compute_dtype):
        if table.is_cuda:
            return _launch(table, idx, aggr, compute_dtype)
        return onehot_embedding_reference(table, idx, aggr, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(NO_BACKWARD)


def onehot_embedding(
    table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode, compute_dtype: torch.dtype
) -> torch.Tensor:
    """Pooled small-vocabulary lookup table [V, D], idx [B, H] or [B] ->
    [B, D] in the table's dtype. On CUDA it launches the kernel (counted in
    `onehot_embedding.launches`); on the CPU it takes the plain version."""
    _check(table, idx, aggr, compute_dtype)
    return _OnehotEmbedding.apply(table, idx, aggr, compute_dtype)


onehot_embedding.launches = 0
