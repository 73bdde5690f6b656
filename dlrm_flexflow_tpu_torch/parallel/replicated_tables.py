"""Sparse tables outside the fused collection under a data axis above 1.

A table that the planner pass leaves out of the sharded EmbeddingCollection
(every table under `data_parallel_plan()`, a table of another D or pooling,
a lone table, a host-tail table's hot prefix) is replicated: every rank
holds all of it. The JAX package's GSPMD step updates such a table with the
gradient of the global batch. In the port each rank stages its own slice of
the global batch (`Mesh.batch_slice`), so a rank that updated its replica
from its slice alone would drift from the others.

`replicated_sparse_update` all-gathers each such table's index feeds
([B_local, ...]) and its pooled-output gradients ([B_local, ...], already
the rank's share of the global loss's gradient) into [B_global, ...]
tensors in data-index order, which is the global batch's order (on a 2-D
mesh over the data group: the ranks of one data index hold the same
slice and the same replicas, so nothing goes along the model axis): one
all-gather
for every table's indices (a dtype) and one more for every gradient,
whatever the number of tables. It then applies the global stream to this
rank's replica through the route it has on one card (the row-update kernel
K1, or the optimizer's scatter rule; `training/sparse_engine.py`), so every
rank makes the same update, equal to one card's at the global batch. The
collectives have static sizes and copy nothing from the host, so a train
step captured in a CUDA graph holds them (`FFModel.train_chunk`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..training.sparse_engine import apply_sparse_updates


def _all_gather_rows(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """[N * b, ...] of each [b, ...] part, every data index's rows in order
    (N the mesh's data axis, the gathers over its data group; with mesh
    None, every rank of the world): the parts of one dtype go as the
    columns of one [b, sum] tensor in one all-gather."""
    out: List[torch.Tensor] = [None] * len(parts)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, p in enumerate(parts):
        by_dtype.setdefault(p.dtype, []).append(i)
    world, group = (dist.get_world_size(), None) if mesh is None else (mesh.data_size, mesh.data_group())
    for ids in by_dtype.values():  # dict order: the same on every rank
        b = int(parts[ids[0]].shape[0])
        flat = torch.cat([parts[i].reshape(b, -1) for i in ids], dim=1)
        got = flat.new_empty((world * b, flat.shape[1]))
        dist.all_gather_into_tensor(got, flat, group=group)
        cols = got.split([parts[i][0].numel() for i in ids], dim=1)
        for i, c in zip(ids, cols):
            out[i] = c.reshape((world * b,) + tuple(parts[i].shape[1:])).contiguous()
    return out


@torch.no_grad()
def replicated_sparse_update(ops, params, sparse_xs, g_over, opt, sstates, ctx, lr=None,
                             routes=None) -> Tuple[dict, dict]:
    """Gather the replicated sparse ops' index feeds and pooled-output
    gradients from every rank ([B_local, ...] -> [B_global, ...]: one
    all-gather for every op's ids, a dtype, and one for every gradient) and
    update this rank's replicas and slot states in place with the global
    stream (`apply_sparse_updates`, whose arguments these are; `routes`,
    under host routing, are those of the global batch's feeds). Returns
    (the slot states, {op: the gathered gradients})."""
    names = [op.name for op in ops]
    xs = iter(_all_gather_rows([x for n in names for x in sparse_xs[n]], ctx.mesh))
    gs = iter(_all_gather_rows([g for n in names for g in g_over[n]], ctx.mesh))
    xs_g = {n: [next(xs) for _ in sparse_xs[n]] for n in names}
    g_g = {n: [next(gs) for _ in g_over[n]] for n in names}
    return apply_sparse_updates(ops, params, xs_g, g_g, opt, sstates, ctx, lr=lr, routes=routes), g_g
