"""EmbeddingBag op (single table).

PyTorch counterpart of `Embedding`, `embedding_bag` and
`embedding_bag_onehot` in `dlrm_flexflow_tpu/ops/embedding.py`.

Semantics: integer indices [B] or [B, bag]; entries < 0 are padding. Two
paths, chosen as the JAX package chooses them:
- vocab <= ctx.onehot_threshold (and pooling): the JAX package multiplies a
  one-hot matrix by the table cast to the compute dtype, accumulating in
  f32. A one-hot product selects rows exactly, so this is a gather of rows
  rounded to the compute dtype, summed in f32. Indices >= vocab match no
  row and add zero.
- otherwise: an exact gather in the table's dtype. Indices >= vocab give
  NaN rows, as `jnp.take`'s fill mode does.
Both count every index >= 0 toward the AVG divisor, as the JAX package does.

The JAX package's packed-table, host-tail and int8 branches belong to later
slices. So do its force-only Pallas lookups (`use_pallas="on"`:
`onehot_embedding_pallas`, `embedding_bag_pallas`); until they are ported,
"on" leaves the lookup on these plain paths, which compute the same pooled
sums.
"""
from __future__ import annotations

import torch

from ..ffconst import AggrMode, DataType, OperatorType
from ..core.graph import Op
from ..core.initializers import GlorotUniform
from ..core.tensor import TensorSpec


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


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, aggr: AggrMode) -> torch.Tensor:
    """Pooled lookup with negative-index padding, by exact gather."""
    idx, squeeze_bag = _as_bags(idx)
    valid = idx >= 0
    oob = idx >= table.shape[0]
    safe = torch.where(valid & ~oob, idx, torch.zeros_like(idx))
    rows = table[safe]  # [B, bag, D]
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    rows = torch.where(oob[..., None], torch.full((), float("nan"), dtype=rows.dtype, device=rows.device), rows)
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
    rows = table[safe].to(compute_dtype).float()
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return _pool(rows, idx, aggr).to(table.dtype)


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

    def forward(self, params, inputs, ctx):
        (idx,) = inputs
        table = params["weight"]
        if (
            0 < self.num_entries <= ctx.onehot_threshold
            and self.aggr is not AggrMode.AGGR_MODE_NONE
        ):
            return [embedding_bag_onehot(table, idx, self.aggr, ctx.compute_dtype)]
        return [embedding_bag(table, idx, self.aggr)]
