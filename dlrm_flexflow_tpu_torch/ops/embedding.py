"""EmbeddingBag op (single table).

PyTorch counterpart of `Embedding`, `embedding_bag` and
`embedding_bag_onehot` in `dlrm_flexflow_tpu/ops/embedding.py`.

Semantics: integer indices [B] or [B, bag]; entries < 0 are padding. The
paths, chosen as the JAX package chooses them (`ops/embedding.py:116-163`):
- a table on the row-update kernel route (`kernel_route`, the JAX package's
  packed tables): an exact gather in the table's dtype. Indices >= vocab
  give zero rows, as the JAX package's packed lookup reads them from the
  packed table's zero padding (`packed_embedding_bag`).
- vocab <= ctx.onehot_threshold (and pooling): the JAX package multiplies a
  one-hot matrix by the table cast to the compute dtype, accumulating in
  f32. A one-hot product selects rows exactly, so this is a gather of rows
  rounded to the compute dtype, summed in f32. Indices >= vocab match no
  row and add zero. Under use_pallas="on" the one-hot kernel runs instead
  (`ops/kernels/onehot_embedding.py`, the port of K5f): it rounds an AVG
  weight per distinct row, as the TPU kernel does.
- otherwise: an exact gather in the table's dtype. Indices >= vocab give
  NaN rows, as `jnp.take`'s fill mode does. Under use_pallas="on" a pooled
  table with D % 128 == 0 takes the embedding-bag kernel instead
  (`ops/kernels/embedding_bag.py`, the port of K4): the same rows, summed in
  f32.
- a mid-band table (`onehot_packed`, set by FFModel.compile for a vocab
  in (onehot_embedding_threshold, onehot_packed_threshold]): the JAX
  package's one-hot matmul over pack lines (`packed_embedding_bag_onehot`,
  ops/embedding.py:333-383), which selects rows exactly as the narrow
  one-hot does: `embedding_bag_onehot` on the [V, D] table, under every
  use_pallas (the reference is plain XLA, with no Pallas gate). Its
  gradient is dense [V, D], for the dense optimizer.
- int8 serving tables (`FFModel.quantize_embeddings("int8")`: `weight_q`
  and `weight_scale` in place of `weight`), checked before any route, as
  the JAX package's `_forward_device` checks them (`ops/embedding.py:
  104-116`), so under every use_pallas: `quantized_embedding_bag`, plain
  torch as the JAX function is plain XLA. Indices >= vocab read row V-1,
  as its clip does.
All count every index >= 0 toward the AVG divisor, as the JAX package does.

Training (`bag_row_grads`, `bag_row_src`, `Embedding.sparse_update`,
`sparse_state_init`): a table on the sparse path gets its pooled-output
gradient turned into row updates, never a dense [V, D] gradient. Tables
and optimizer pools stay [V, D] (or [V]): the JAX package's packed
[V*D/128, 128] layout exists to fill TPU lanes. A table that
FFModel.compile puts on the row-update kernel route (`kernel_route`,
updated by training/sparse_engine.py) may be stored in `table_dtype`
(bf16); every other table, and every optimizer pool, stays f32.

Host-tail offload (`enable_host_tail`, parallel/host_tail.py): the table
keeps its hot prefix [0, hot) and the op takes two more inputs, the host's
pooled tail partials `pos` [K_cap] and `val` [K_cap, D]. The forward masks
indices >= hot to padding before the lookup (an index >= V reads a zero row
on the route and NaN off it, so neither can be relied on), then adds `val`
into the pooled rows at `pos`, dropping pos == B (`add_tail_partials`).
"""
from __future__ import annotations

import torch

from ..ffconst import AggrMode, DataType, OperatorType
from ..core.graph import Op
from ..core.initializers import GlorotUniform
from ..core.tensor import TensorSpec
from .kernels.embedding_bag import embedding_bag as embedding_bag_kernel
from .kernels.onehot_embedding import onehot_embedding


def _as_bags(idx: torch.Tensor):
    idx = idx.long()
    squeeze_bag = idx.dim() == 1
    return (idx[:, None] if squeeze_bag else idx), squeeze_bag


def _pool(rows: torch.Tensor, idx: torch.Tensor, aggr: AggrMode) -> torch.Tensor:
    pooled = rows.sum(dim=1)
    if aggr is AggrMode.AGGR_MODE_AVG:
        count = (idx >= 0).sum(dim=1, keepdim=True).clamp_min(1)
        pooled = pooled / count.to(pooled.dtype)
    return pooled


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode, out_of_range: float = float("nan")
) -> torch.Tensor:
    """Pooled lookup with negative-index padding, by exact gather. An index
    >= vocab gives a row of `out_of_range`: NaN, as `jnp.take` fills it, or
    0 for a kernel-route table, as the JAX package's packed lookup reads the
    packed table's zero padding."""
    idx, squeeze_bag = _as_bags(idx)
    valid = idx >= 0
    oob = idx >= table.shape[0]
    safe = torch.where(valid & ~oob, idx, torch.zeros_like(idx))
    rows = table[safe]  # [B, bag, D]
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    rows = torch.where(oob[..., None], torch.full((), out_of_range, dtype=rows.dtype, device=rows.device), rows)
    if aggr is AggrMode.AGGR_MODE_NONE:
        return rows[:, 0, :] if squeeze_bag else rows
    return _pool(rows, idx, aggr)


def embedding_bag_onehot(
    table: torch.Tensor,
    idx: torch.Tensor,
    aggr: AggrMode,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Small-vocab pooled lookup: the rows the JAX package's one-hot matmul
    selects, rounded to the compute dtype and summed in f32."""
    if aggr is AggrMode.AGGR_MODE_NONE:
        raise ValueError("one-hot path requires pooling")
    idx, _ = _as_bags(idx)
    hit = (idx >= 0) & (idx < table.shape[0])
    safe = torch.where(hit, idx, torch.zeros_like(idx))
    rows = _OnehotRows.apply(table, safe, compute_dtype)
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return _pool(rows, idx, aggr).to(table.dtype)


class _OnehotRows(torch.autograd.Function):
    """table[idx] rounded to the compute dtype, as f32. Its backward sums
    each row's gradient in f32 and rounds the sum to the compute dtype
    once, as the transpose of the JAX package's one-hot einsum over
    `table.astype(compute_dtype)` does; autograd through `.to(bf16)` would
    round every lookup's gradient before the sum instead."""

    @staticmethod
    def forward(ctx, table, idx, compute_dtype):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype, ctx.compute_dtype = table.shape, table.dtype, compute_dtype
        return table[idx].to(compute_dtype).float()

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        acc.index_add_(0, idx.reshape(-1), g.reshape(-1, ctx.shape[1]).float())
        return acc.to(ctx.compute_dtype).to(ctx.dtype), None, None


def add_tail_partials(pooled: torch.Tensor, pos: torch.Tensor, val: torch.Tensor, bag: int) -> torch.Tensor:
    """pooled [B, D] with val [K, D] added at rows pos [K], pos == B (the
    host's empty slots) dropped: the JAX package's `pooled.at[pos].add(
    val.astype(pooled.dtype), mode="drop")`. With bags of one no
    valid pos repeats, and one `index_add_` adds each partial once. With
    bags of `bag` > 1 an example may hold several tail lookups: the slots
    are ordered stably by pos (the host already gives them ascending) and
    added in `bag` passes, pass j taking each example's j-th partial, so
    that no pass adds twice to one row and an example's partials add in
    their order, as the reference's sequential scatter adds them, on every
    device and run alike (CUDA's `index_add_` of repeated rows adds by
    float atomics, in no fixed order). Returns a new [B, D] tensor."""
    b, d = pooled.shape
    pos = pos.long()
    ext = torch.cat([pooled, pooled.new_zeros((1, d))])  # row B takes what is dropped
    val = val.to(pooled.dtype)
    if bag == 1:
        ext.index_add_(0, pos.clamp(0, b), val)
    else:
        spos, order = torch.sort(pos.clamp(0, b), stable=True)
        sval = val[order]
        rank = torch.arange(spos.shape[0], device=pos.device) - torch.searchsorted(spos, spos)
        for j in range(bag):
            ext.index_add_(0, torch.where(rank == j, spos, b), sval)
    return ext[:b]


def quantize_table_int8(w: torch.Tensor):
    """[V, D] table -> (q [V, D] int8, scale [V] f32), per row: scale =
    max(max_d |w|, 1e-12) / 127 and q = clip(round(w / scale), -127, 127)
    (the JAX package's `quantize_table_int8`, ops/embedding.py:294-305,
    unpacked). Computed in f32 from the table widened exactly (a bf16 table
    included), with correctly rounded divisions on every device: the 127 is
    a tensor, as PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal instead."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=1), 1e-12) / torch.full((), 127.0, device=w.device)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def quantized_embedding_bag(q: torch.Tensor, scale: torch.Tensor, idx: torch.Tensor,
                            aggr: AggrMode) -> torch.Tensor:
    """Pooled lookup from int8 rows and per-row f32 scales (the JAX
    package's `quantized_embedding_bag`, ops/embedding.py:243-292, its
    unpacked branch): each member's row q[r] * scale[r] in f32, padding
    (idx < 0) zero, indices clipped into [0, V), summed in f32; AVG divides
    by max(#valid, 1). f32 out."""
    idx, squeeze_bag = _as_bags(idx)
    b, h = idx.shape
    valid = idx >= 0
    safe = idx.clamp(0, q.shape[0] - 1).reshape(-1)
    rows = (q[safe].float() * scale[safe][:, None]).reshape(b, h, q.shape[1])
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    if aggr is AggrMode.AGGR_MODE_NONE:
        return rows[:, 0, :] if squeeze_bag else rows
    return _pool(rows, idx, aggr)


def bag_row_grads(idx: torch.Tensor, g_pooled: torch.Tensor, aggr: AggrMode, num_entries: int):
    """Expand a pooled-output gradient [B, D] into per-row scatter operands:
    rows [B*H] (padding marked num_entries, to be dropped) and row_grads
    [B*H, D] f32. For AVG pooling each member gets g/count."""
    rows, src, h = bag_row_src(idx, g_pooled, aggr, num_entries)
    if h == 1:
        return rows, src
    b, d = src.shape
    return rows, src[:, None, :].expand(b, h, d).reshape(b * h, d)


def bag_row_src(idx: torch.Tensor, g_pooled: torch.Tensor, aggr: AggrMode, num_entries: int):
    """Like bag_row_grads but unexpanded: (rows [B*H], src [B, D] f32, h)
    with row k's gradient src[k // h]. The row-update kernel reads the
    pooled gradient through k // h, so the [B*H, D] expansion is never
    made."""
    idx, _ = _as_bags(idx)
    b, h = idx.shape
    valid = idx >= 0
    g = g_pooled.float()
    rows = torch.where(valid, idx, torch.full_like(idx, num_entries)).reshape(b * h)
    if aggr is AggrMode.AGGR_MODE_NONE:
        # per-token grads: no bag broadcast
        return rows, g.reshape(b * h, -1), 1
    if aggr is AggrMode.AGGR_MODE_AVG:
        count = valid.sum(dim=1, keepdim=True).clamp_min(1)
        g = g / count.to(g.dtype)
    return rows, g, h


class Embedding(Op):
    op_type = OperatorType.OP_EMBEDDING

    def __init__(
        self,
        name: str,
        input: TensorSpec,
        num_entries: int,
        out_dim: int,
        aggr: AggrMode = AggrMode.AGGR_MODE_SUM,
        kernel_initializer=None,
    ):
        super().__init__(name, [input])
        if input.dtype not in (DataType.DT_INT32, DataType.DT_INT64):
            raise TypeError(f"embedding input must be integer indices, got {input.dtype}")
        self.num_entries = int(num_entries)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        batch = input.shape[0]
        if aggr is AggrMode.AGGR_MODE_NONE and input.num_dims == 2 and input.shape[1] > 1:
            # per-token lookup (no pooling): [B, T] ids -> [B, T, D]
            self._out((batch, input.shape[1], out_dim))
        else:
            self._out((batch, out_dim))
        self._param(
            "weight",
            (self.num_entries, self.out_dim),
            kernel_initializer or GlorotUniform(),
        )
        # set by FFModel.compile: the sparse-update route of this table and
        # its storage dtype there (None: the parameter's f32); whether it is
        # a mid-band table
        self.kernel_route = False
        self.table_dtype = None
        self.onehot_packed = False
        # host-tail offload: the full vocab (num_entries is then the hot
        # prefix on the device); 0 when off
        self.host_tail_vocab = 0

    def enable_host_tail(self, full_vocab: int, pos_spec: TensorSpec, val_spec: TensorSpec) -> None:
        """Keep rows [0, num_entries) here and take the host's tail partials
        as two more inputs (the JAX package's `enable_host_tail`). SUM
        pooling only: the partials must add."""
        if self.aggr is not AggrMode.AGGR_MODE_SUM:
            raise ValueError(f"{self.name}: host-tail offload needs SUM pooling (the partials must add)")
        if not 0 < self.num_entries < full_vocab:
            raise ValueError(f"{self.name}: hot prefix {self.num_entries} not in (0, {full_vocab})")
        self.host_tail_vocab = int(full_vocab)
        self.inputs.extend([pos_spec, val_spec])

    def hot_indices(self, idx: torch.Tensor) -> torch.Tensor:
        """Indices at or above the hot prefix as padding (-1)."""
        return torch.where(idx >= self.num_entries, torch.full_like(idx, -1), idx)

    def forward(self, params, inputs, ctx):
        if self.host_tail_vocab:
            idx, pos, val = inputs
            (pooled,) = self._forward_device(params, [self.hot_indices(idx)], ctx)
            return [add_tail_partials(pooled, pos, val, idx.shape[1] if idx.dim() == 2 else 1)]
        return self._forward_device(params, inputs, ctx)

    def _forward_device(self, params, inputs, ctx):
        (idx,) = inputs
        if "weight_q" in params:
            return [quantized_embedding_bag(params["weight_q"], params["weight_scale"], idx, self.aggr)]
        table = params["weight"]
        pooled = self.aggr is not AggrMode.AGGR_MODE_NONE
        forced = ctx.use_pallas == "on"
        if self.kernel_route:
            return [embedding_bag(table, idx, self.aggr, out_of_range=0.0)]
        if self.onehot_packed:
            return [embedding_bag_onehot(table, idx, self.aggr, ctx.compute_dtype)]
        if 0 < self.num_entries <= ctx.onehot_threshold and pooled:
            if forced:
                return [onehot_embedding(table, idx.contiguous(), self.aggr, ctx.compute_dtype)]
            return [embedding_bag_onehot(table, idx, self.aggr, ctx.compute_dtype)]
        if forced and pooled and self.out_dim % 128 == 0:
            return [embedding_bag_kernel(table, idx.contiguous(), self.aggr)]
        return [embedding_bag(table, idx, self.aggr)]

    # ---- sparse-gradient path (see FFModel.compile) -------------------------
    def sparse_update(self, params, inputs, g_out_list, optimizer, sstate, ctx, lr=None):
        """Apply the pooled-output gradient to the touched rows through the
        optimizer's row rule (the scatter route), in place; returns the new
        slot state. Tables on the kernel route go through
        training/sparse_engine.py instead (whose kernels drop the rows >= V
        of a host-tail table's stream, as this masking does)."""
        idx = self.hot_indices(inputs[0]) if self.host_tail_vocab else inputs[0]
        rows, grads = bag_row_grads(idx, g_out_list[0], self.aggr, self.num_entries)
        return optimizer.sparse_row_update(params["weight"], sstate, rows, grads, lr=lr)

    def sparse_state_init(self, optimizer, device):
        """The optimizer's slot state for this table (JAX
        `sparse_state_init`, ops/embedding.py:183-212), f32 on `device`: a
        [V, D] momentum velocity, Adam's m and v ([2, V, D] on the scatter
        route; a dict {"m", "v"} of two [V, D] pools on the kernel route, as
        the JAX package keeps them), a [V] AdaGrad accumulator (the JAX
        package's packed copy replicates it over the row's D lanes), or
        None."""
        st = optimizer.sparse_init((self.num_entries, self.out_dim), device)
        if st is not None and self.kernel_route and st.dim() == 3:
            st = {"m": st[0], "v": st[1]}
        return st

    def cost_stats(self):
        lookups = self.inputs[0].volume
        row_bytes = 4.0 * self.out_dim
        return {
            "flops": float(lookups * self.out_dim),
            "bytes": row_bytes * lookups * 2.0 + 4.0 * lookups,
            "param_bytes": 4.0 * self.num_entries * self.out_dim,
        }
