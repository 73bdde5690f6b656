"""Mixture-of-Experts ops: TopK, GroupBy, Aggregate, AggregateSpec.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/moe.py`.

TopK gives the k largest entries of the last axis and their indices
(int32), the lower index first among equal values as `jax.lax.top_k` gives
them: a stable descending sort, cut to k (`torch.topk` promises no order
among ties on CUDA).

GroupBy and Aggregate route token (b, j), the j-th expert choice of row b,
in arrival order over the flattened (b, j) sequence: its slot is its rank
among the earlier tokens of the same expert, and a token at or past the
capacity (alpha * k / n * B) is dropped, as are expert ids outside [0, n).
The JAX package writes this as a [B, K, n, capacity] one-hot mask and two
einsums (its `dispatch_mask`); at moe_mlp's batch of 16384 that mask would
hold 2.1e9 entries. The port computes the same function from the slot
indices (`dispatch_slots`, [B, K]): GroupBy writes each kept token's row
into its slot (a slot holds at most one token, so the einsum's sum is that
row plus exact zeros) and Aggregate gathers each (b, j)'s expert row from
its slot, weights it by the gate value and sums over j in order. Shapes
are static, with no host sync, so a CUDA graph captures both. A row sent to
k experts gets its gradient from k slots: GroupBy's backward gathers them
per (b, j) and sums over j in order, never by float atomics, so replays and
eager steps agree bit for bit.

Under a data axis above 1 (parallel/global_batch.py) a rank holds a block
of the batch and GroupBy keeps the capacity of the global batch it was
built with: each token's arrival rank within its expert is its local rank
plus the tokens of that expert on the ranks before it (one all-gather of
the [n] counts, `preceding_counts`), so the kept and dropped tokens are one
card's. The rank's kept tokens fill one range of each expert's global
slots; its expert buffers hold those slots and zeros elsewhere, and its
Aggregate reads only its own tokens. GroupBy and the Aggregate that reads
the same assignment share one dispatch an execution (`ctx.memo`).

The reference's load-balancing term is `moe_load_balance_loss`, which the
JAX package defines and never adds to training; Aggregate's `lambda_bal` is
kept and unused, as there.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..ffconst import DataType, OperatorType
from ..core.graph import Op
from ..core.tensor import TensorSpec
from ..parallel.global_batch import preceding_counts


def moe_capacity(k: int, n: int, batch: int, alpha: float) -> int:
    """reference: group_by.cu:64-67 — capacity factor alpha*k/n*batch."""
    return max(1, int(alpha * k / n * batch))


def dispatch_slots(assign: torch.Tensor, n: int, capacity: int, mesh=None) -> torch.Tensor:
    """assign [B, K] expert ids -> [B, K] int64: token (b, j)'s row in the
    n * capacity expert rows (expert e's slot c at e * capacity + c), or
    n * capacity where it is dropped (an id outside [0, n), or past the
    capacity in arrival order over the flattened (b, j) sequence). With
    `mesh`, assign is the rank's block of a batch sharded over its data
    axis, and the arrival order is the global batch's."""
    b, k = assign.shape
    e = assign.reshape(-1).long()
    valid = (e >= 0) & (e < n)
    ec = e.clamp(0, n - 1)
    # [n, BK]: a scan along the last axis (along the first, n columns wide,
    # CUDA's scan took 10 ms at BK = 32768 on an H100)
    onehot = ((ec[None, :] == torch.arange(n, device=e.device)[:, None]) & valid[None, :]).long()
    ranks = onehot.cumsum(1)
    pos = ranks.gather(0, ec[None, :])[0] - 1  # arrival rank within expert
    if mesh is not None:
        before = preceding_counts(ranks[:, -1], mesh.data_size, mesh.data_index, mesh.data_group())
        pos = pos + before[ec]
    keep = valid & (pos < capacity)
    return torch.where(keep, ec * capacity + pos, n * capacity).reshape(b, k)


class _Dispatch(torch.autograd.Function):
    """data [B, D] -> [slots, D]: row b at each of its kept slots, zeros
    elsewhere. Backward: each row's slot gradients gathered [B, K, D] and
    summed over K in order."""

    @staticmethod
    def forward(ctx, data, dest, slots: int):
        out = data.new_zeros((slots + 1, data.shape[1]))  # row `slots` takes the dropped tokens
        for j in range(dest.shape[1]):
            out.index_put_((dest[:, j],), data)
        ctx.save_for_backward(dest)
        return out[:slots]

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return g[dest].sum(1), None, None


def dispatch(data: torch.Tensor, dest: torch.Tensor, n: int, capacity: int) -> torch.Tensor:
    """[n, capacity, D]: data's rows at their slots (`dest` from
    `dispatch_slots`), zeros elsewhere."""
    return _Dispatch.apply(data, dest, n * capacity).reshape(n, capacity, data.shape[1])


def group_by(data: torch.Tensor, dest: torch.Tensor, n: int, capacity: int) -> List[torch.Tensor]:
    """n buckets [capacity, D] of data's rows at their slots (`dest` from
    `dispatch_slots`)."""
    grouped = dispatch(data, dest, n, capacity)
    return [grouped[e] for e in range(n)]


def aggregate(gate_preds: torch.Tensor, dest: torch.Tensor, exp_preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, D]: sum over j of gate_preds[b, j] times the expert row at token
    (b, j)'s slot (nothing for a dropped token), in f32, in the experts'
    dtype."""
    exp = torch.stack(list(exp_preds))  # [n, cap, D]
    n, cap, d = exp.shape
    flat = torch.cat([exp.reshape(n * cap, d), exp.new_zeros((1, d))])
    rows = flat[dest]  # [B, K, D]
    w = gate_preds.float() * (dest < n * cap)
    return (rows.float() * w[..., None]).sum(1).to(exp.dtype)


def _slots(op, spec: TensorSpec, assign: torch.Tensor, ctx) -> torch.Tensor:
    """`dispatch_slots` of the assignment `spec` (tensor `assign`) for op's
    n and capacity, once an execution (`ctx.memo`)."""
    key = ("dispatch", spec.owner_op.guid, spec.owner_idx, op.n, op.capacity)
    memo = ctx.memo if ctx.memo is not None else {}
    if key not in memo:
        memo[key] = dispatch_slots(assign, op.n, op.capacity, ctx.block_mesh(op))
    return memo[key]


class TopK(Op):
    op_type = OperatorType.OP_TOPK

    def __init__(self, name: str, input: TensorSpec, k: int, sorted: bool = True):
        super().__init__(name, [input])
        self.k = k
        self.sorted = sorted
        b = input.shape[0]
        self._out((b, k), input.dtype, idx=0)
        self._out((b, k), DataType.DT_INT32, idx=1)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
        return [values[..., : self.k], indices[..., : self.k].to(torch.int32)]


class GroupBy(Op):
    op_type = OperatorType.OP_GROUP_BY

    def __init__(
        self,
        name: str,
        data: TensorSpec,  # [B, D]
        assign: TensorSpec,  # [B, K] int expert ids
        n: int,
        alpha: float,
    ):
        super().__init__(name, [data, assign])
        b, d = data.shape
        k = assign.shape[1]
        self.n = n
        self.alpha = alpha
        self.capacity = moe_capacity(k, n, b, alpha)
        for e in range(n):
            self._out((self.capacity, d), data.dtype, idx=e)

    def forward(self, params, inputs, ctx):
        data, assign = inputs
        return group_by(data, _slots(self, self.inputs[1], assign, ctx), self.n, self.capacity)


class Aggregate(Op):
    """inputs: gate_preds [B,K], gate_assign [B,K], true_gate_assign [B,K],
    full_gate_gradients [B,n], exp_preds n x [cap, D] (the reference's
    signature, include/model.h:384; the two gradient-plumbing tensors are
    accepted and unused, as in the JAX package)."""

    op_type = OperatorType.OP_AGGREGATE

    def __init__(self, name: str, inputs: Sequence[TensorSpec], n: int, lambda_bal: float = 0.0):
        super().__init__(name, inputs)
        self.n = n
        self.lambda_bal = lambda_bal
        b, k = inputs[0].shape
        cap, d = inputs[4].shape
        self.capacity = cap
        self._out((b, d), inputs[4].dtype)

    def forward(self, params, inputs, ctx):
        gate_preds, gate_assign = inputs[0], inputs[1]
        dest = _slots(self, self.inputs[1], gate_assign, ctx)
        return [aggregate(gate_preds, dest, inputs[4 : 4 + self.n])]


class AggregateSpec(Aggregate):
    """reference: src/ops/aggregate_spec.cu — the variant used with
    replicated labels; its combination is Aggregate's."""

    op_type = OperatorType.OP_AGG_SPEC


def moe_load_balance_loss(gate_probs: torch.Tensor, assign: torch.Tensor, n: int) -> torch.Tensor:
    """Switch-style load-balancing loss: n * sum_e f_e * P_e, f_e the share
    of rows whose first choice is e, P_e the mean gate probability of e."""
    first = assign[:, 0].long()
    frac = (first[:, None] == torch.arange(n, device=first.device)).float().mean(0)
    return n * torch.sum(frac * gate_probs.float().mean(0))
