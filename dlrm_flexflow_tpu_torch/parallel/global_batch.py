"""The op library's graphs over a batch sharded on the data axis.

Under `compile(mesh=, plan=)` with a data axis of N > 1 each rank is fed
the global batch and stages its block, rows [d * B / N, (d + 1) * B / N)
of every feed (`Mesh.batch_slice`). The JAX package runs one program over
the global batch and GSPMD splits it; the port runs the graph on the
rank's block, so each op whose result couples rows, or whose forward reads
the global shape it was built with, computes over the global batch here:

- Flat and Reshape reshape the block to (T0 / N, *rest), T0 the target's
  leading dimension: the global tensor is the row-major concatenation of
  the rank blocks, so block d is rows [d * T0 / N, (d + 1) * T0 / N) of
  the target whenever N divides T0.
- Dropout (and attention's dropout) hashes each entry's global row-major
  index: the block's offset, data index x the block's volume, is added, so
  N ranks draw one card's mask.
- BatchNorm normalises by the global batch's statistics: the per-channel
  sums all-reduced over the data group for the mean, then the sums of the
  squared deviations for the variance (the one-card two-pass formula), by
  `all_reduce_sum`, whose backward is the same all-reduce.
- GroupBy and Aggregate give each token its global arrival rank within its
  expert: the rank's local positions plus the counts of the ranks before
  it (`preceding_counts`, one all-gather of [n] counts a step). A rank's
  kept tokens fill one range of each expert's global slots; the expert
  buffers ([capacity, D], the global capacity) hold only the rank's own
  slots, zeros elsewhere, and every op between a GroupBy and its Aggregate
  works row by row, so the gradients of the expert weights come out whole
  after the dense all-reduce. No token row moves between ranks.
- A constant whose leading dimension is the batch size is staged at the
  rank's block; a Cache serves its block of the cached batch.

`batch_ops` walks the graph once at compile and gives the ops that run on
a block, or raises NotImplementedError for what the port does not compute
over the global batch: a transpose, reverse, concat, split or softmax
along the batch axis, a reshape whose leading dimension N does not divide,
a non-row-wise op between a GroupBy and its Aggregate, an op that mixes a
block with a whole tensor that does not broadcast along the batch axis,
and a graph output that is not batch-sharded.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# a tensor's place under a data axis above 1: the rank's block of a
# batch-sharded tensor, the same whole tensor on every rank, or an MoE
# expert buffer that holds the rank's own slots
BATCH, WHOLE, SLOTS = "batch", "whole", "slots"
_REFUSED = "compile(mesh=) under a data axis of {n}: {what}; the port does not compute it over the global batch"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks of `group` (a new tensor); its gradient is
    the output gradient summed over the group: each rank's loss reads the
    sum, so every rank's input reaches every rank's loss."""
    return _AllReduceSum.apply(x, group)


def preceding_counts(counts: torch.Tensor, ranks: int, index: int, group=None) -> torch.Tensor:
    """[n] int64: the sum of `counts` ([n]) over the ranks of `group` before
    data index `index`, by one all-gather of every rank's counts."""
    c = counts.to(torch.int64).reshape(-1).contiguous()
    every = c.new_empty((ranks * c.numel(),))
    dist.all_gather_into_tensor(every, c, group=group)
    return every.reshape(ranks, -1)[:index].sum(0)


def _key(t) -> Tuple[int, int]:
    return t.owner_op.guid, t.owner_idx


def batch_ops(graph, constant_dims: Dict[str, tuple], batch_size: int, n: int) -> frozenset:
    """The names of the input ops staged at the rank's block under a data
    axis of n > 1 (every input but a constant, `constant_dims` {name:
    dims}, whose leading dimension is not the batch size) and of the ops
    with a batch-sharded input, after checking each op as the module note
    says; raises NotImplementedError with the reason otherwise."""
    from ..ops.dense import Dense
    from ..ops.elementwise import ElementBinary, ElementUnary
    from ..ops.moe import Aggregate, GroupBy
    from ..ops.regularizers import Dropout, Softmax
    from ..ops.shape_ops import Concat, Flat, Reshape, Reverse, Split, Transpose

    def refuse(what: str):
        raise NotImplementedError(_REFUSED.format(n=n, what=what))

    kind: Dict[Tuple[int, int], str] = {}
    out = set()
    for iop in graph.inputs:
        dims: Optional[tuple] = constant_dims.get(iop.name)
        kind[(iop.guid, 0)] = WHOLE if dims is not None and tuple(dims[:1]) != (batch_size,) else BATCH
        if kind[(iop.guid, 0)] == BATCH:
            out.add(iop.name)
    for op in graph.compute_ops:
        ks = [kind[_key(t)] for t in op.inputs]
        name = f"{type(op).__name__} {op.name!r}"
        if SLOTS in ks and not isinstance(op, Aggregate):
            if not isinstance(op, (Dense, ElementUnary, ElementBinary, Softmax, Dropout)) or BATCH in ks or (
                    isinstance(op, Softmax) and op.axis % op.inputs[0].num_dims == 0):
                refuse(f"{name} reads a GroupBy's expert buffers, where only row-wise ops (Dense, elementwise, "
                       "Softmax off the batch axis, Dropout) may stand between a GroupBy and its Aggregate")
            res = SLOTS
        elif BATCH not in ks:
            res = WHOLE
        else:
            out.add(op.name)
            res = BATCH
            lead = op.inputs[0].num_dims
            if isinstance(op, Transpose) and op.perm[0] != 0:
                refuse(f"{name} moves the batch axis (perm {op.perm})")
            if isinstance(op, Reverse) and op.axis == 0:
                refuse(f"{name} reverses the batch axis")
            if isinstance(op, (Concat, Split)) and op.axis == 0:
                refuse(f"{name} runs along the batch axis")
            if isinstance(op, Softmax) and op.axis % lead == 0:
                refuse(f"{name} normalises along the batch axis")
            if isinstance(op, (Flat, Reshape)) and op.outputs[0].shape[0] % n:
                refuse(f"{name}'s leading dimension {op.outputs[0].shape[0]} does not split into {n} blocks")
            if isinstance(op, GroupBy):
                if ks != [BATCH, BATCH]:
                    refuse(f"{name} takes a batch-sharded data and assignment")
                res = SLOTS
            elif isinstance(op, Aggregate):
                if ks[:4] != [BATCH] * 4 or not set(ks[4:]) <= {SLOTS, WHOLE}:
                    refuse(f"{name} takes batch-sharded gate tensors and a GroupBy's expert buffers")
            elif WHOLE in ks:
                whole = [t for t, k in zip(op.inputs, ks) if k == WHOLE]
                width = op.outputs[0].num_dims
                if not isinstance(op, ElementBinary) or any(
                        t.num_dims == width and t.shape[0] != 1 for t in whole):
                    refuse(f"{name} mixes a batch-sharded input with a whole one "
                           f"({', '.join(t.owner_op.name for t in whole)})")
        for i, _ in enumerate(op.outputs):
            kind[(op.guid, i)] = res
    if graph.compute_ops and kind[_key(graph.compute_ops[-1].outputs[0])] != BATCH:
        refuse("the graph's output is not batch-sharded (it does not follow the batch), so no rank holds a "
               "block of it")
    return frozenset(out)
