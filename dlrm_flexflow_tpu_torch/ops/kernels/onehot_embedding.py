"""Small-vocabulary pooled lookup (the one-hot embedding) and its gradient:
CUDA kernel wrappers and plain versions.

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

The gradient replaces the Pallas TPU kernel `_bwd_kernel` (`:62`, launched
by `_onehot_bwd` at `:138`; K5b), the VJP of `onehot_embedding_pallas`:
dT [V, D] f32 = sum over bags b of w_{b,r} * cdt(g[b]), the transpose of the
same weighted one-hot product, accumulated in f32. The op is differentiable
with respect to the table, as `onehot_embedding_pallas` is; on CUDA its
backward launches the kernel (`onehot_embedding_backward`: no sort, tiles of
rows by segments of the member stream, `backward_plan`), on the CPU its
plain version (the weighted rows `index_add_`-ed into f32 zeros).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ... import _build
from ...ffconst import AggrMode

# the gradient kernel's constants (csrc/onehot_embedding.cu k<Name>)
WARPS = 8
TILE_ROWS = 64
COLS = 128
SPLIT_ROWS = 8
ROUND_MAX = 16384
# the plan's own targets
WARP_PICKS = 256  # picks of a uniform stream the busiest warp adds
MIN_BLOCKS = 132  # the H100's SMs


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


def onehot_embedding_backward_reference(
    idx: torch.Tensor, g: torch.Tensor, v: int, aggr: AggrMode, compute_dtype: torch.dtype
) -> torch.Tensor:
    """Plain version of the gradient: each kept member's weight times its
    bag's gradient rounded to the compute dtype (an f32 product), summed
    into f32 zeros by `index_add_`."""
    w = _onehot_weights(idx, v, aggr, compute_dtype)
    b, m = torch.nonzero(w > 0, as_tuple=True)
    rows = idx.long().reshape(w.shape)[b, m]
    weighted = w[b, m][:, None] * g[b].to(compute_dtype).float()
    dt = torch.zeros((v, g.shape[1]), dtype=torch.float32, device=g.device)
    return dt.index_add_(0, rows, weighted)


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
    lib.onehot_embedding_backward.argtypes = [
        ctypes.c_void_p,  # idx
        ctypes.c_void_p,  # g
        ctypes.c_void_p,  # dT f32
        ctypes.c_void_p,  # scratch f32 (the S partials), or NULL when S = 1
        ctypes.c_longlong,  # scratch floats
        ctypes.c_longlong,  # B
        ctypes.c_int,  # H
        ctypes.c_longlong,  # V
        ctypes.c_int,  # D
        ctypes.c_int,  # R, rows a tile
        ctypes.c_int,  # S, member segments
        ctypes.c_int,  # g is bf16
        ctypes.c_int,  # idx is int64
        ctypes.c_int,  # AVG
        ctypes.c_int,  # compute dtype is bf16
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.onehot_embedding_backward.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_if(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed: {msg} (cudaError {err})")


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
    _raise_if(lib, err, "onehot_embedding")
    onehot_embedding.launches += 1
    return out


class BackwardPlan(NamedTuple):
    """How the gradient kernel cuts its work (csrc `bwd_plan` derives the
    same from rows and segments and checks them)."""

    rows: int  # R, rows a tile
    tiles: int
    slices: int  # column slices of COLS
    segments: int  # S, runs of whole bags, each summed by its own blocks
    bags: int  # bags a segment
    split: bool  # tiles of at most SPLIT_ROWS rows, S > 1: a warp sums its own share of a segment
    smem: int  # dynamic shared memory a block, bytes
    scratch_floats: int  # the S partials [S, V, D] when S > 1

    @property
    def launches(self) -> int:
        return 1 if self.segments == 1 else 2


def backward_plan(b: int, h: int, v: int, d: int) -> BackwardPlan:
    """The gradient kernel's plan for idx [b, h] into v rows of width d.
    S is the least count of segments that leaves the busiest warp about
    WARP_PICKS picks of a uniform stream and, where the tiles alone would
    keep fewer than half of the card's MIN_BLOCKS SMs busy, gives MIN_BLOCKS
    blocks; then S * v <= max(b * h, v), so the partials hold no more rows
    than the stream has members. The sums' order depends on this plan and
    the shapes alone. Raises ValueError for a shape the kernel cannot take."""
    n = b * h
    if b < 1 or h < 1 or d < 1 or not 1 <= v < 2**31 - 1 or n >= 2**31:
        raise ValueError(f"onehot_embedding_backward: {b} bags of {h} into {v} rows of width {d} "
                         "out of the kernel's range (B * H < 2^31, 1 <= v < 2^31 - 1)")
    rows = min(TILE_ROWS, v)
    tiles, slices = -(-v // rows), -(-d // COLS)
    if tiles * slices >= 2**31:
        raise ValueError(f"onehot_embedding_backward: a [{v}, {d}] gradient needs more blocks "
                         "than a launch holds")
    hot = rows <= SPLIT_ROWS  # every row hot: a warp adds its own eighth of a segment
    # the busiest warp's share of a segment's picks: its own eighth, or the
    # stream's members in the rows it owns
    share = 1 / WARPS if hot else -(-rows // WARPS) / v
    s = max(1, math.ceil(n * share / WARP_PICKS))
    if 2 * tiles * slices < MIN_BLOCKS:
        s = max(s, -(-MIN_BLOCKS // (tiles * slices)))
    s = min(s, max(n, v) // v, b, 65535)
    bags = -(-b // s)
    s = -(-b // bags)  # no empty segment
    split = hot and s > 1  # with one segment the rows regime keeps member order
    round_ = min(ROUND_MAX, -(-bags * h // WARPS) * WARPS)
    smem = round_ * 4 + (WARPS * SPLIT_ROWS * COLS * 4 if split else round_ * 4)
    return BackwardPlan(rows, tiles, slices, s, bags, split, smem, s * v * d if s > 1 else 0)


def _launch_backward(idx, g, v, aggr, compute_dtype) -> torch.Tensor:
    b, d = g.shape
    h = 1 if idx.dim() == 1 else idx.shape[1]
    dt = torch.empty((v, d), dtype=torch.float32, device=g.device)
    if b == 0 or h == 0:
        return dt.zero_()
    plan = backward_plan(b, h, v, d)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=g.device) \
        if plan.segments > 1 else None
    lib = _kernel_lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.onehot_embedding_backward(
            idx.data_ptr(), g.data_ptr(), dt.data_ptr(), None if scratch is None else scratch.data_ptr(),
            plan.scratch_floats, b, h, v, d, plan.rows, plan.segments, int(g.dtype == torch.bfloat16),
            int(idx.dtype == torch.int64), int(aggr is AggrMode.AGGR_MODE_AVG),
            int(compute_dtype == torch.bfloat16), stream,
        )
    _raise_if(lib, err, "onehot_embedding_backward")
    onehot_embedding_backward.launches += 1
    return dt


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


def onehot_embedding_backward(
    idx: torch.Tensor, g: torch.Tensor, v: int, aggr: AggrMode, compute_dtype: torch.dtype
) -> torch.Tensor:
    """The gradient of `onehot_embedding` with respect to a table of v rows:
    idx [B, H] or [B] and the pooled output's gradient g [B, D] (f32 or
    bf16) -> dT [v, D] f32. On CUDA it launches the kernel, one CUDA launch
    or two by `backward_plan` (counted once in
    `onehot_embedding_backward.launches`); on the CPU it takes the plain
    version."""
    if g.dim() != 2 or g.dtype not in (torch.float32, torch.bfloat16) or g.shape[0] != idx.shape[0]:
        raise TypeError(f"onehot_embedding_backward takes a [B, D] float32 or bfloat16 gradient "
                        f"of the {idx.shape[0]} bags, got {tuple(g.shape)} {g.dtype}")
    if g.device != idx.device or not g.is_contiguous() or not 1 <= v < 2**31 - 1:
        raise ValueError("onehot_embedding_backward needs a contiguous g on idx's device and "
                         f"1 <= v < 2^31 - 1, got v = {v}")
    if not g.is_cuda:
        return onehot_embedding_backward_reference(idx, g, v, aggr, compute_dtype)
    return _launch_backward(idx, g, v, aggr, compute_dtype)


class _OnehotEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, aggr, compute_dtype):
        ctx.save_for_backward(idx)
        ctx.v, ctx.dtype, ctx.aggr, ctx.compute_dtype = table.shape[0], table.dtype, aggr, compute_dtype
        if table.is_cuda:
            return _launch(table, idx, aggr, compute_dtype)
        return onehot_embedding_reference(table, idx, aggr, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dt = onehot_embedding_backward(idx, g.contiguous(), ctx.v, ctx.aggr, ctx.compute_dtype)
        return dt.to(ctx.dtype), None, None, None


def onehot_embedding(
    table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode, compute_dtype: torch.dtype
) -> torch.Tensor:
    """Pooled small-vocabulary lookup table [V, D], idx [B, H] or [B] ->
    [B, D] in the table's dtype, differentiable with respect to the table.
    On CUDA it launches the kernel (counted in `onehot_embedding.launches`);
    on the CPU it takes the plain version."""
    _check(table, idx, aggr, compute_dtype)
    return _OnehotEmbedding.apply(table, idx, aggr, compute_dtype)


onehot_embedding.launches = 0
onehot_embedding_backward.launches = 0
