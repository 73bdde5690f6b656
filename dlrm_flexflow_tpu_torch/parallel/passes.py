"""Compile-time graph passes.

The port's counterpart of `dlrm_flexflow_tpu/parallel/passes.py`:
`offload_embedding_tails` (`:21-92`: placement from the plan's
`host_tail_rows`, else from `config.host_tail_threshold`) and
`fuse_embedding_tables` (`:95-164`), which puts the large tables into one
EmbeddingCollection for the hybrid-parallel path.
"""
from __future__ import annotations

import math
from typing import List, Optional

from ..core.graph import Graph, InputOp
from ..core.initializers import GlorotUniform, UniformInitializer
from ..ffconst import AggrMode, DataType
from ..ops.embedding import Embedding
from ..ops.embedding_collection_op import EmbeddingCollection
from .plan import ShardingPlan


def offload_embedding_tails(graph: Graph, plan: Optional[ShardingPlan], config) -> List[tuple]:
    """Rewrite each Embedding op to offload (SUM pooling) for host-tail
    offload: the device keeps rows [0, hot), rows [hot, vocab) live in a
    host store (parallel/host_tail.py), and the op gains the inputs
    `_hosttail:<op>:pos` [K_cap] int32 and `_hosttail:<op>:val` [K_cap, D]
    f32 that carry the host's pooled tail partials. K_cap is
    `host_tail_cap_frac` of the global batch's lookups, rounded up to a
    multiple of 8 (at least 8).

    Placement: `plan.host_tail_rows` where the plan has it (each Embedding
    op's device prefix in graph order, 0 or missing: the whole table on the
    device), else every table above `config.host_tail_threshold` keeps
    exactly that many rows. The decision taken from the threshold is written
    into `plan.host_tail_rows`, so that an exported strategy carries it, as
    the JAX package's pass does (`:27-43`, `:88-91`).

    The device table shrinks to the hot prefix here, before the parameters
    are made: the full table need never exist (292,775,614 x 128 in f32 is
    150 GB). Its rows must still be drawn like rows of the full [vocab, D]
    table, so a GlorotUniform initializer becomes UniformInitializer(+-limit)
    with the full table's fan, and the limit is kept as
    `op.host_tail_init_scale` for the store's rows.

    Returns [(op, index feed name, full vocab, hot, k_cap)]."""
    embeds = [op for op in graph.compute_ops if isinstance(op, Embedding)]
    tail_rows = plan.host_tail_rows if plan is not None else None
    thr = int(config.host_tail_threshold or 0)
    if tail_rows is None and thr <= 0:
        return []
    cap_frac = float(config.host_tail_cap_frac)
    out = []
    for t, e in enumerate(embeds):
        if tail_rows is not None:
            hot = int(tail_rows[t]) if t < len(tail_rows) else 0
        else:
            hot = thr if e.num_entries > thr else 0
        if e.host_tail_vocab or not 0 < hot < e.num_entries or e.aggr is not AggrMode.AGGR_MODE_SUM:
            continue
        full = e.num_entries
        idx_spec = e.inputs[0]
        bag = idx_spec.shape[1] if idx_spec.num_dims > 1 else 1
        k_cap = max(8, int(-(-idx_spec.shape[0] * bag * cap_frac // 8)) * 8)
        pos_in = graph.add_op(InputOp(f"_hosttail:{e.name}:pos", (k_cap,), DataType.DT_INT32))
        val_in = graph.add_op(InputOp(f"_hosttail:{e.name}:val", (k_cap, e.out_dim), DataType.DT_FLOAT))
        init = e.params[0].initializer
        if isinstance(init, GlorotUniform):
            limit = init.scale * math.sqrt(6.0 / (full + e.out_dim))
            e.params[0].initializer = UniformInitializer(min_val=-limit, max_val=limit)
            e.host_tail_init_scale = limit
        e.num_entries = hot
        e.params[0].shape = (hot, e.out_dim)
        e.enable_host_tail(full, pos_in.outputs[0], val_in.outputs[0])
        out.append((e, idx_spec.owner_op.name, full, hot, k_cap))
    if out and plan is not None and plan.host_tail_rows is None:
        hots = {id(e): hot for e, _, _, hot, _ in out}
        plan.host_tail_rows = [hots.get(id(e), 0) for e in embeds]
    return out


def fuse_embedding_tables(graph: Graph, plan: ShardingPlan, num_shards: int, min_vocab: int = 0,
                          shard: Optional[int] = None) -> Optional[EmbeddingCollection]:
    """Rewrite `graph` in place: the fusable Embedding ops become one
    EmbeddingCollection, spliced in at the first of them, which adopts
    their outputs so that their consumers stay wired. Returns the
    collection, or None with fewer than 2 such tables.

    Fusable: vocab above `min_vocab` (the one-hot tables at or under it
    stay replicated), or, where the plan names them, every table but
    `plan.replicated_tables`; no host-tail table; the first one's D and
    pooling. The layout is `plan.make_layout(..., num_shards)`; `shard` is
    this rank's shard under a data axis > 1 (the collection then holds only
    its shard), None on one device."""
    all_embeds = [op for op in graph.compute_ops if isinstance(op, Embedding)]
    if plan.replicated_tables is not None:
        excluded = set(plan.replicated_tables)
        embeds = [e for i, e in enumerate(all_embeds) if i not in excluded]
    else:
        embeds = [e for e in all_embeds if e.num_entries > min_vocab]
    embeds = [e for e in embeds if not e.host_tail_vocab]
    if len(embeds) < 2:
        return None
    dim, aggr = embeds[0].out_dim, embeds[0].aggr
    embeds = [e for e in embeds if e.out_dim == dim and e.aggr is aggr]
    if len(embeds) < 2:
        return None
    layout = plan.make_layout([e.num_entries for e in embeds], dim, num_shards)
    coll = EmbeddingCollection(
        graph.unique_name("embedding_collection"), [e.inputs[0] for e in embeds], layout, aggr,
        table_initializers=[e.params[0].initializer for e in embeds],
        adopt_outputs=[e.outputs[0] for e in embeds], table_names=[e.name for e in embeds],
        shard=shard,
    )
    first_pos = graph.ops.index(embeds[0])
    removed = {id(e) for e in embeds}
    new_ops = []
    for i, op in enumerate(graph.ops):
        if i == first_pos:
            new_ops.append(coll)
        if id(op) not in removed:
            new_ops.append(op)
    coll.guid = graph._next_guid
    graph._next_guid += 1
    graph.ops = new_ops
    return coll
