"""EmbeddingCollection: the fused tables of the hybrid-parallel path.

The port of `dlrm_flexflow_tpu/ops/embedding_collection_op.py`. The planner
pass (`parallel/passes.py` `fuse_embedding_tables`) replaces T Embedding
ops of one D and pooling by one collection that takes their T index inputs
and adopts their outputs. Its one parameter, "pool", is this rank's shard
[R_pad, D] under a mesh with a data axis above 1 (`shard` set), or the
whole flat pool [N * R_pad, D] otherwise (one device: the JAX package's
[N, R_pad, D] reshaped); the JAX package's packed [N, P, 128] is never
made. Tables are drawn one at a time from a generator of their own
(`init_params`), so a rank makes only its shard and the replicated
parameters draw the same numbers on every rank.

  forward        sharded: `sharded_embedding_lookup` (all-to-all exchange),
                 or `routed_embedding_lookup` under exchange="routed"
                 (parallel/routed_exchange.py, at the layout's
                 routed_cap_factor); flat: one gather over the whole pool,
                 the tables' indices moved to their rows in it (also
                 FFConfig.fuse_embeddings on one device); after int8
                 quantization (`pool_q`, `pool_scale`) the dequantizing
                 lookup over the flat pool.
  sparse_update  sharded: `sharded_embedding_sparse_update` (or the
                 routed one); flat: one update of the flat pool. All through
                 `local_pool_row_update`: the row-update kernel's rule when
                 the layout is on the kernel route (`packed_pool`), the
                 optimizer's scatter rule otherwise.
  sparse_state_init  the optimizer's slot state of the rows held here, the
                 JAX package's layouts with the pool's rows as [R_pad, D]
                 (or [R_pad]): Adam's m and v as {"m", "v"} on the kernel
                 route, [2, R, D] on the scatter route; AdaGrad [R], not the
                 JAX package's lane-replicated [N, P, 128].
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core.graph import Op
from ..core.initializers import GlorotUniform
from ..core.tensor import TensorSpec
from ..ffconst import AggrMode, OperatorType
from ..parallel.embedding_collection import (
    ShardedEmbeddingLayout,
    device_consts,
    local_pool_row_update,
    sharded_embedding_lookup,
    sharded_embedding_sparse_update,
)
from ..parallel.routed_exchange import routed_embedding_lookup, routed_embedding_sparse_update
from .embedding import embedding_bag, quantized_embedding_bag

_TABLE_SEED = 0x5EED_7AB1E  # mixes the model's seed with a table's id (`init_params`)


class EmbeddingCollection(Op):
    op_type = OperatorType.OP_EMBEDDING

    def __init__(
        self,
        name: str,
        inputs: Sequence[TensorSpec],
        layout: ShardedEmbeddingLayout,
        aggr: AggrMode = AggrMode.AGGR_MODE_SUM,
        table_initializers: Optional[Sequence] = None,
        adopt_outputs: Optional[Sequence[TensorSpec]] = None,
        table_names: Optional[Sequence[str]] = None,
        shard: Optional[int] = None,
    ):
        super().__init__(name, inputs)
        self.layout = layout
        self.aggr = aggr
        self.shard = shard  # this rank's shard under a data axis > 1, else None
        self.table_names: List[str] = list(table_names or [f"{name}:{t}" for t in range(layout.num_tables)])
        self.table_initializers = list(table_initializers or [GlorotUniform()] * layout.num_tables)
        # the pool's storage dtype (bf16 under config.table_dtype on the
        # kernel route with a data axis > 1; set by compile), None for f32
        self.table_dtype = None
        # the single-table update route of training/sparse_engine.py, which
        # the collection never takes: its own route is layout.packed_pool
        self.kernel_route = False
        if adopt_outputs is not None:
            for i, t in enumerate(adopt_outputs):
                t.owner_op = self
                t.owner_idx = i
                self.outputs.append(t)
        else:
            for i in range(layout.num_tables):
                self._out((inputs[0].shape[0], layout.dim), idx=i)
        rows = layout.r_pad * (1 if shard is not None else layout.num_shards)
        self._param("pool", (rows, layout.dim), None)

    @property
    def sharded(self) -> bool:
        return self.shard is not None

    def init_params(self, generator: torch.Generator, device) -> dict:
        """The pool held here, each table [vocab, D] drawn by its own
        initializer from a generator seeded by the model's seed and the
        table's id; `generator` is not drawn from."""
        seed = generator.initial_seed()

        def make_table(t):
            g = torch.Generator(device=device)
            g.manual_seed((seed * 1_000_003 + _TABLE_SEED + 7919 * t) % 2**63)
            return self.table_initializers[t](g, (self.layout.vocab_sizes[t], self.layout.dim),
                                              torch.float32, device)

        return {"pool": self.layout.init_pool(make_table, self.shard, device)}

    def _stacked(self, inputs) -> torch.Tensor:
        return torch.stack([x if x.dim() == 2 else x[:, None] for x in inputs], dim=1).long()

    def _flat_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """[B, T, H] per-table indices -> rows of the flat pool, -1 kept."""
        idx = self.layout.perm_rows(idx)
        base = device_consts(self.layout, idx.device)["bases"]
        return torch.where(idx >= 0, idx + base[None, :, None], -1)

    def forward(self, params, inputs, ctx):
        idx = self._stacked(inputs)  # [B, T, H]
        pool = params.get("pool")
        if self.sharded and self.layout.exchange == "routed":
            out = routed_embedding_lookup(self.layout, pool, idx, ctx.mesh, self.aggr,
                                          cap_factor=self.layout.routed_cap_factor)
        elif self.sharded:
            out = sharded_embedding_lookup(self.layout, pool, idx, ctx.mesh, self.aggr)
        elif "pool_q" in params:  # int8 serving (FFModel.quantize_embeddings), flat only
            b, t, h = idx.shape
            out = quantized_embedding_bag(params["pool_q"], params["pool_scale"],
                                          self._flat_rows(idx).reshape(b * t, h), self.aggr).reshape(b, t, -1)
        else:
            b, t, h = idx.shape
            out = embedding_bag(pool, self._flat_rows(idx).reshape(b * t, h), self.aggr).reshape(b, t, -1)
        return [out[:, t] for t in range(self.layout.num_tables)]

    # ---- sparse-gradient path (see FFModel.compile) -------------------------
    def sparse_state_init(self, optimizer, device):
        st = optimizer.sparse_init(tuple(self.params[0].shape), device)
        if st is not None and self.layout.packed_pool and st.dim() == 3:
            st = {"m": st[0], "v": st[1]}
        return st

    def sparse_update(self, params, inputs, g_out_list, optimizer, sstate, ctx, lr=None):
        """Apply the pooled-output gradients to the rows, in place; returns
        the new slot state."""
        idx = self._stacked(inputs)
        g = torch.stack(g_out_list, dim=1)  # [B, T, D]
        pool = params["pool"]
        if self.sharded and self.layout.exchange == "routed":
            return routed_embedding_sparse_update(self.layout, pool, sstate, idx, g, ctx.mesh, optimizer,
                                                  self.aggr, lr=lr, cap_factor=self.layout.routed_cap_factor)
        if self.sharded:
            return sharded_embedding_sparse_update(self.layout, pool, sstate, idx, g, ctx.mesh, optimizer,
                                                   self.aggr, lr=lr)
        b, t, h = idx.shape
        rows = self._flat_rows(idx)
        valid = rows >= 0
        g32 = g.float()
        if self.aggr is AggrMode.AGGR_MODE_AVG:
            g32 = g32 / valid.sum(dim=2, keepdim=True).clamp_min(1).to(g32.dtype)
        rows = torch.where(valid, rows, pool.shape[0]).reshape(b * t * h)
        return local_pool_row_update(self.layout, pool, sstate, rows,
                                     (g32.reshape(b * t, -1).contiguous(), h), optimizer, lr=lr)

    def cost_stats(self):
        lookups = sum(t.volume for t in self.inputs)
        d = self.layout.dim
        return {"flops": float(lookups * d), "bytes": 8.0 * lookups * d,
                "param_bytes": 4.0 * self.layout.num_shards * self.layout.r_pad * d}

    # ---- weights of the fused tables ----------------------------------------
    def owners(self, t: int) -> List[int]:
        """The shards that hold rows of table t."""
        return sorted({self.layout.owner[i] for i, (tt, _, _) in enumerate(self.layout.subs) if tt == t})

    def shard_rows(self, t: int, shard: int):
        """[(position start, length, row offset in the shard)] of table t's
        sub-tables on `shard`, positions in the table's permuted order."""
        return [(start, length, int(self.layout.row_offset[i]))
                for i, (tt, start, length) in enumerate(self.layout.subs)
                if tt == t and self.layout.owner[i] == shard]
