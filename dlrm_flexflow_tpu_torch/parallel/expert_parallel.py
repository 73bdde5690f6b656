"""Expert-parallel MoE: the experts sharded over the data group, the tokens
exchanged by one all-to-all each way.

The port of `dlrm_flexflow_tpu/parallel/expert_parallel.py`. The JAX
package writes the sharded part as a `shard_map` over the mesh's axis; the
port runs one process a rank (parallel/mesh.py), so `expert_parallel_ffn`
is that function's body on the rank's block of the batch and its shard of
the experts:

  1. the gate (`moe_gate`, replicated weights: their gradients join the
     dense all-reduce like any replicated parameter) gives each token its
     k experts and weights;
  2. dispatch: each local token goes to its slot of a [E, C, D] buffer of
     every global expert, C = `moe_capacity(k, E, B_loc, alpha)` a
     (shard, expert) capacity, in arrival order over the rank's flattened
     (b, j) tokens (ops/moe.py `dispatch_slots`; a token past C is
     dropped, as the reference's group_by drops it);
  3. `all_to_all_single` over the group: rank r receives the [E_loc, C, D]
     buffers of its own experts from every rank, [E_loc, N * C, D];
  4. the two-layer expert FFNs in f32 (the JAX package's f32 einsums);
  5. the reverse all-to-all, and the gate-weighted sum of each token's k
     expert rows in f32 (ops/moe.py `aggregate`).

Each all-to-all is an autograd function whose backward is the same
all-to-all (it is its own transpose), so the gradients of the expert
weights stay on their shard and those of the tokens come home. The
capacity is per (shard, expert), unlike the graph path's GroupBy, whose
capacity is the global batch's: that is what the reference does, and
`reference_moe_ffn(shards=N)` is its unsharded oracle with the same drops.
The products are plain PyTorch products: the JAX package computes them as
einsums outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ffconst import ActiMode
from ..ops.common import apply_activation
from ..ops.moe import aggregate, dispatch, dispatch_slots, moe_capacity
from ..utils.profiling import span

# the spans of the two all-to-alls, profiler ranges while a profiler records
# (tools/mesh_smoke.py times them)
RANGES = ("expert_parallel:dispatch", "expert_parallel:combine")


def moe_gate(x: torch.Tensor, gate_w: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The softmax gate and its top k (reference: moe.cc gate = dense +
    softmax + topk): x [B, D] @ gate_w [D, E] in f32, softmax, the k
    largest (the lower index first among equal values, as `jax.lax.top_k`),
    renormalised to sum to 1. Returns (gate values [B, k] in x's dtype,
    expert ids [B, k] int32)."""
    probs = torch.softmax(torch.matmul(x.float(), gate_w.float()), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return vals.to(x.dtype), idx.to(torch.int32)


class _AllToAll(torch.autograd.Function):
    """[N * m, ...] -> [N * m, ...]: chunk j of the input goes to rank j,
    chunk i of the output came from rank i. Backward: the same exchange of
    the gradient."""

    @staticmethod
    def forward(ctx, x, group, name: str):
        ctx.group, ctx.name = group, name
        return _exchange(x, group, name)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.name), None, None


def _exchange(x: torch.Tensor, group, name: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    with span(name):
        dist.all_to_all_single(out, x, group=group)
    return out


def _ffn(tokens, w1, b1, w2, b2, activation: ActiMode) -> torch.Tensor:
    """[E, C, D] tokens through each expert's two layers, in f32."""
    h = torch.bmm(tokens.float(), w1.float()) + b1.float()[:, None, :]
    h = apply_activation(h, activation)
    return torch.bmm(h, w2.float()) + b2.float()[:, None, :]


def _combine(slots_out: torch.Tensor, dest: torch.Tensor, gate_vals: torch.Tensor, dtype) -> torch.Tensor:
    """[B, D] in `dtype`: the gate-weighted sum of each token's expert rows
    (`slots_out` [E, C, D] at `dest`'s slots), in f32."""
    return aggregate(gate_vals, dest, slots_out.unbind(0)).to(dtype)


def expert_parallel_ffn(
    x: torch.Tensor,  # [B_loc, D], the rank's block of the batch
    gate_vals: torch.Tensor,  # [B_loc, k] (moe_gate)
    assign: torch.Tensor,  # [B_loc, k] int expert ids in [0, E)
    w1: torch.Tensor,  # [E_loc, D, H], the rank's shard of the experts
    b1: torch.Tensor,  # [E_loc, H]
    w2: torch.Tensor,  # [E_loc, H, D]
    b2: torch.Tensor,  # [E_loc, D]
    mesh,
    alpha: float = 2.0,
    activation: ActiMode = ActiMode.AC_MODE_RELU,
) -> torch.Tensor:
    """The rank's block [B_loc, D] of the experts' combined outputs, in x's
    dtype: E = N * E_loc experts over `mesh`'s data group (N its data
    axis), expert e on data index e // E_loc, and C = moe_capacity(k, E,
    B_loc, alpha) slots a (shard, expert)."""
    group, size = mesh.data_group(), mesh.data_size
    e_loc = w1.shape[0]
    e = e_loc * size
    b_loc, k = assign.shape
    d = x.shape[1]
    cap = moe_capacity(k, e, b_loc, alpha)
    dest = dispatch_slots(assign, e, cap)
    disp = dispatch(x, dest, e, cap)  # [E, C, D]: rank j's experts at rows j * E_loc ..
    got = _AllToAll.apply(disp, group, RANGES[0])  # [N (source), E_loc, C, D]
    tokens = got.reshape(size, e_loc, cap, d).transpose(0, 1).reshape(e_loc, size * cap, d)
    y = _ffn(tokens, w1, b1, w2, b2, activation).to(x.dtype)
    back = y.reshape(e_loc, size, cap, d).transpose(0, 1).contiguous()  # [N (dest), E_loc, C, D]
    back = _AllToAll.apply(back, group, RANGES[1]).reshape(e, cap, d)
    return _combine(back, dest, gate_vals, x.dtype)


def reference_moe_ffn(x, gate_vals, assign, w1, b1, w2, b2, alpha: float = 2.0,
                      activation: ActiMode = ActiMode.AC_MODE_RELU, shards: int = 1) -> torch.Tensor:
    """The unsharded oracle with expert_parallel_ffn's drops: the batch cut
    into `shards` blocks, each dispatched with its own capacity
    moe_capacity(k, E, B / shards, alpha) to the whole [E, ...] experts."""
    e = w1.shape[0]
    b, k = assign.shape
    b_loc = b // shards
    cap = moe_capacity(k, e, b_loc, alpha)
    outs = []
    for s in range(shards):
        sl = slice(s * b_loc, (s + 1) * b_loc)
        dest = dispatch_slots(assign[sl], e, cap)
        disp = dispatch(x[sl], dest, e, cap)
        y = _ffn(disp, w1, b1, w2, b2, activation)
        outs.append(_combine(y, dest, gate_vals[sl], x.dtype))
    return torch.cat(outs)
