"""Column-parallel Dense layers over the mesh's "model" axis.

The counterpart of what GSPMD inserts for the JAX package's
`enable_parameter_parallel` specs (kernel [out, in] sharded on its output
rows, the output on [batch, ..., model]), and of the reference's replica
tensors and LINEAR_BWD2 reduction (`src/ops/linear.cu:769-960`). Model
index m of M holds the row block [m * out / M, (m + 1) * out / M) of the
kernel and of the bias, and a layer runs as

  1. `copy_in(x)`: the identity; in the backward the input gradient's
     partial sums (each rank's block of the output against its rows of the
     kernel) all-reduced over the model group;
  2. the port's `dense` on the block (bias and activation are elementwise,
     so they act on the block alone): [B, out / M];
  3. `gather_out(y)`: every rank's block all-gathered into [B, out], in
     model order; in the backward this rank's column block of the output
     gradient (the gradient after the layer is the same on every rank of
     the group, which computes the rest of the model alike).

NCCL gathers along dim 0 only, so the blocks come in as [M, B, out / M] and
the model axis is moved behind the batch. Each collective has a static
size, so a train step captured in a CUDA graph holds them
(`FFModel.train_chunk`). `group` is a process group of the model axis
(`Mesh.model_group()`; None: the default group, when the model axis is the
world). Each collective runs inside a span named in `RANGES`
(utils/profiling.py: host totals, and a `torch.profiler` range while a
profiler records), whose device time is the model group's NCCL time in a
profile (tools/mesh_smoke.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import span

# the spans of the model group's collectives
RANGES = ("tensor_parallel:all_gather", "tensor_parallel:all_reduce")


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        with span(RANGES[1]):
            dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, size: int, index: int):
        ctx.index, ctx.cols = index, y.shape[-1]
        lead = tuple(y.shape[:-1])
        flat = y.reshape(-1, ctx.cols).contiguous()
        parts = flat.new_empty((size * flat.shape[0], ctx.cols))
        with span(RANGES[0]):
            dist.all_gather_into_tensor(parts, flat, group=group)
        out = parts.reshape(size, flat.shape[0], ctx.cols).permute(1, 0, 2)
        return out.reshape(lead + (size * ctx.cols,))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.cols
        return g[..., lo:lo + ctx.cols].contiguous(), None, None, None


def copy_in(x: torch.Tensor, group=None) -> torch.Tensor:
    """x as it is; its gradient summed over the model group."""
    if not x.requires_grad:
        return x
    return _CopyIn.apply(x, group)


def gather_out(y: torch.Tensor, size: int, index: int, group=None) -> torch.Tensor:
    """[..., n] blocks of the `size` ranks of the model group -> [..., size *
    n], rank `index`'s block at columns [index * n, (index + 1) * n); its
    gradient is that column block of the output's."""
    return _GatherOut.apply(y, group, int(size), int(index))


def row_block(t: torch.Tensor, size: int, index: int) -> torch.Tensor:
    """Rank `index`'s block of `size` along dim 0 of a whole parameter (or
    of its optimizer state), a contiguous copy."""
    if t.shape[0] % size:
        raise ValueError(f"a dim of {t.shape[0]} does not split over a model axis of {size}")
    n = t.shape[0] // size
    return t[index * n:(index + 1) * n].contiguous()
