"""ShardingPlan: the strategy container of the hybrid-parallel path.

The port of `dlrm_flexflow_tpu/parallel/plan.py`: the same fields, the same
placement rules (greedy, round-robin, host-aware for the hierarchical
exchange, splits striped from a per-table assignment) and the same JSON
strategy file, which loads in either package. The JAX package writes a
PartitionSpec as a list (a tuple entry as a list); the port keeps that list
form in `OpShardSpec`. The JAX-only parts (input shardings, output
constraints, placing parameters on a mesh) have no counterpart: one process
a device holds its own shard and batch slice (parallel/mesh.py).

Parameter specs: `enable_parameter_parallel` writes the JAX package's
column-parallel Dense specs (the kernel [out, in] sharded on its output
rows over the "model" axis, the bias with it, the output on [batch, ...,
model]); `tensor_parallel_ops` reads them back for `compile`, which runs
each such layer on parallel/tensor_parallel.py over a 2-D mesh. A spec of
any other form raises there: the port has no GSPMD to place it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .embedding_collection import (
    ShardedEmbeddingLayout,
    expand_subtables,
    round_robin_assignment,
)

def hierarchical_subtable_assignment(subs, sub_vocabs, num_shards: int, chips_per_host: int):
    """Host-aware placement for the hierarchical exchange: a table's split
    sub-tables go to distinct chips of one host (chunks of at most C), the
    host and the chips chosen by row load."""
    c = chips_per_host
    hosts = num_shards // c
    if hosts <= 1 or num_shards % c != 0:
        return greedy_subtable_assignment(subs, sub_vocabs, num_shards)
    by_table: Dict[int, List[int]] = {}
    for i, (t, _, _) in enumerate(subs):
        by_table.setdefault(t, []).append(i)
    host_load = [0] * hosts
    chip_load = [0] * num_shards
    owner = [0] * len(subs)
    order = sorted(by_table, key=lambda t: -sum(sub_vocabs[i] for i in by_table[t]))
    for t in order:
        members = by_table[t]
        for lo in range(0, len(members), c):
            chunk = members[lo:lo + c]
            h = int(np.argmin(host_load))
            chips = sorted(range(h * c, (h + 1) * c), key=lambda s: chip_load[s])
            for j, i in enumerate(chunk):
                s = chips[j]
                owner[i] = s
                chip_load[s] += sub_vocabs[i]
                host_load[h] += sub_vocabs[i]
    return owner


def greedy_subtable_assignment(subs, sub_vocabs, num_shards: int):
    """Memory-balancing placement over sub-tables that avoids putting two
    sub-tables of one table on one shard."""
    owner = [0] * len(subs)
    load = [0] * num_shards
    shard_tables = [set() for _ in range(num_shards)]
    for i in sorted(range(len(subs)), key=lambda i: -sub_vocabs[i]):
        t = subs[i][0]
        order = np.argsort(load, kind="stable")
        pick = next((int(s) for s in order if t not in shard_tables[int(s)]), int(order[0]))
        owner[i] = pick
        load[pick] += sub_vocabs[i]
        shard_tables[pick].add(t)
    return owner


@dataclasses.dataclass
class OpShardSpec:
    """One op's entry: a spec per output and per parameter, each in the JAX
    package's JSON list form (an axis name, None, or a list of names per
    dimension)."""

    output_specs: Optional[List[list]] = None
    param_specs: Optional[Dict[str, list]] = None

    def to_json(self):
        return {"outputs": [list(s) for s in (self.output_specs or [])],
                "params": {k: list(v) for k, v in (self.param_specs or {}).items()}}

    @staticmethod
    def from_json(d) -> "OpShardSpec":
        return OpShardSpec(output_specs=[list(s) for s in d.get("outputs", [])] or None,
                           param_specs={k: list(v) for k, v in d.get("params", {}).items()} or None)


@dataclasses.dataclass
class ShardingPlan:
    """Mesh geometry, per-op specs and table placement (the JAX package's
    fields and defaults)."""

    mesh_axes: Tuple[str, ...] = ("data",)
    batch_axis: str = "data"
    # "table_parallel": the large tables fused and sharded over the batch
    # axis; "replicated": every table replicated (pure data parallelism)
    embedding_mode: str = "table_parallel"
    table_assignment: Optional[List[int]] = None  # sub-table -> shard; None: by policy
    table_split: Optional[List[int]] = None  # per-table row-split degree
    replicated_tables: Optional[List[int]] = None  # graph-order tables kept out of the collection
    assignment_policy: str = "greedy"  # or "round_robin"
    chips_per_host: Optional[int] = None  # hierarchical exchange; None/0: flat
    exchange: str = "dense"  # or "routed" (a later slice of the port)
    routed_cap_factor: float = 2.0
    # the shard update takes the row-update kernel route (set by compile)
    packed_pool: Optional[bool] = None
    hash_rows: Optional[bool] = None  # None: on for routed exchange with splits
    host_tail_rows: Optional[List[int]] = None
    op_specs: Dict[str, OpShardSpec] = dataclasses.field(default_factory=dict)

    def make_layout(self, vocab_sizes: Sequence[int], dim: int, num_shards: int) -> ShardedEmbeddingLayout:
        """The layout of `vocab_sizes` on `num_shards` under this plan,
        recording an automatic assignment and hash_rows in the plan (the
        JAX package's `make_layout`)."""
        split = self.table_split
        if split is not None and len(split) != len(vocab_sizes):
            raise ValueError(f"table_split has {len(split)} entries for {len(vocab_sizes)} tables")
        subs = expand_subtables(vocab_sizes, split)
        cph = self.chips_per_host or None
        if cph and (num_shards % cph != 0 or num_shards == cph or cph <= 1):
            cph = None
        assignment = self.table_assignment
        if assignment is not None and len(assignment) == len(vocab_sizes) and len(subs) != len(vocab_sizes):
            # a per-table assignment with splits: each table's sub-tables
            # striped round robin from its shard (inside that shard's host
            # under the hierarchical exchange)
            counter: Dict[int, int] = {}
            expanded = []
            for (t, _, _) in subs:
                k = counter.get(t, 0)
                counter[t] = k + 1
                a = assignment[t]
                if cph:
                    expanded.append(a // cph * cph + (a % cph + k) % cph)
                else:
                    expanded.append((a + k) % num_shards)
            assignment = expanded
        if assignment is None:
            sub_vocabs = [length for (_, _, length) in subs]
            if self.assignment_policy == "round_robin":
                assignment = round_robin_assignment(len(subs), num_shards)
            elif cph:
                assignment = hierarchical_subtable_assignment(subs, sub_vocabs, num_shards, cph)
            else:
                assignment = greedy_subtable_assignment(subs, sub_vocabs, num_shards)
            self.table_assignment = assignment
        if len(assignment) != len(subs):
            raise ValueError(f"table_assignment has {len(assignment)} entries for {len(subs)} sub-tables")
        hash_rows = self.hash_rows
        if hash_rows is None:
            hash_rows = bool(self.exchange == "routed" and self.routed_cap_factor > 0
                             and split is not None and any(x > 1 for x in split))
            self.hash_rows = hash_rows
        return ShardedEmbeddingLayout(
            list(vocab_sizes), dim, num_shards, assignment,
            split=list(split) if split else None, chips_per_host=cph,
            exchange=self.exchange, routed_cap_factor=self.routed_cap_factor,
            packed_pool=bool(self.packed_pool), hash_rows=bool(hash_rows),
        )

    def save(self, path: str) -> None:
        """Write the strategy file (the JAX package's format, version 1)."""
        doc = {
            "version": 1,
            "mesh_axes": list(self.mesh_axes),
            "batch_axis": self.batch_axis,
            "embedding_mode": self.embedding_mode,
            "assignment_policy": self.assignment_policy,
            "table_assignment": self.table_assignment,
            "table_split": self.table_split,
            "replicated_tables": self.replicated_tables,
            "chips_per_host": self.chips_per_host,
            "exchange": self.exchange,
            "routed_cap_factor": self.routed_cap_factor,
            "packed_pool": self.packed_pool,
            "hash_rows": self.hash_rows,
            "host_tail_rows": self.host_tail_rows,
            "ops": {k: v.to_json() for k, v in self.op_specs.items()},
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)

    @staticmethod
    def load(path: str) -> "ShardingPlan":
        """Read a strategy file written by either package."""
        with open(path) as f:
            doc = json.load(f)
        return ShardingPlan(
            mesh_axes=tuple(doc["mesh_axes"]),
            batch_axis=doc["batch_axis"],
            embedding_mode=doc["embedding_mode"],
            assignment_policy=doc.get("assignment_policy", "greedy"),
            table_assignment=doc.get("table_assignment"),
            table_split=doc.get("table_split"),
            replicated_tables=doc.get("replicated_tables"),
            chips_per_host=doc.get("chips_per_host"),
            exchange=doc.get("exchange", "dense"),
            routed_cap_factor=doc.get("routed_cap_factor", 2.0),
            packed_pool=doc.get("packed_pool"),
            hash_rows=doc.get("hash_rows"),
            host_tail_rows=doc.get("host_tail_rows"),
            op_specs={k: OpShardSpec.from_json(v) for k, v in doc.get("ops", {}).items()},
        )


def data_parallel_plan() -> ShardingPlan:
    """Pure data parallelism: every table replicated."""
    return ShardingPlan(embedding_mode="replicated")


def dlrm_hybrid_plan(policy: str = "greedy") -> ShardingPlan:
    """The DLRM default: dense data parallelism and table-parallel
    embeddings."""
    return ShardingPlan(embedding_mode="table_parallel", assignment_policy=policy)


def enable_parameter_parallel(plan: ShardingPlan, graph, model_axis: str = "model",
                              min_out_dim: int = 64, only=None) -> ShardingPlan:
    """Tensor-parallel (the reference's parameter-parallel) specs for the
    Dense layers, the JAX package's rule (`parallel/plan.py:343-376`): every
    Dense with out_dim >= `min_out_dim` and an even out_dim (and, with
    `only`, named there) gets its kernel [out, in] sharded on the output
    rows over `model_axis`, its bias with them, and its output on [batch,
    ..., model]; `model_axis` joins `plan.mesh_axes`. Narrower layers and
    the odd ones (a final out_dim of 1) stay replicated."""
    from ..ops.dense import Dense

    if model_axis not in plan.mesh_axes:
        plan.mesh_axes = tuple(plan.mesh_axes) + (model_axis,)
    for op in graph.compute_ops:
        if not isinstance(op, Dense) or op.out_dim < min_out_dim:
            continue
        if only is not None and op.name not in only:
            continue
        if op.out_dim % 2 != 0:
            continue
        specs = {"kernel": [model_axis, None]}
        if op.use_bias:
            specs["bias"] = [model_axis]
        out_nd = len(op.outputs[0].shape)
        plan.op_specs[op.name] = OpShardSpec(
            output_specs=[[plan.batch_axis] + [None] * (out_nd - 2) + [model_axis]], param_specs=specs)
    return plan


def tensor_parallel_ops(plan: ShardingPlan, graph, axis_names: Sequence[str],
                        model_axis: str = "model") -> Dict[str, Tuple[str, ...]]:
    """{Dense op name: its sharded parameter keys} of the plan's op specs,
    each checked to be `enable_parameter_parallel`'s column-parallel form
    over `model_axis`. A spec naming an axis the mesh (`axis_names`) lacks
    raises ValueError; a spec of another form (another axis sharding a
    parameter, a row-parallel kernel, an op other than a Dense) raises
    NotImplementedError: the port places no other spec."""
    from ..ops.dense import Dense

    ops = {op.name: op for op in graph.compute_ops}
    out: Dict[str, Tuple[str, ...]] = {}
    for name, spec in plan.op_specs.items():
        named = {a for s in list((spec.param_specs or {}).values()) + list(spec.output_specs or [])
                 for x in s for a in (x if isinstance(x, (list, tuple)) else [x]) if a is not None}
        missing = named - set(axis_names)
        if missing:
            raise ValueError(f"the plan's spec of {name!r} names the axes {sorted(missing)}, which the mesh "
                             f"{tuple(axis_names)} lacks")
        if not spec.param_specs and all(a in (None, plan.batch_axis) for s in (spec.output_specs or [])
                                        for a in s):
            continue  # a batch-sharded output: what every op has
        op = ops.get(name)
        want = {"kernel": [model_axis, None]}
        if isinstance(op, Dense) and op.use_bias:
            want["bias"] = [model_axis]
        out_nd = len(op.outputs[0].shape) if op is not None else 0
        form = [[plan.batch_axis] + [None] * (out_nd - 2) + [model_axis]]
        if not (isinstance(op, Dense) and {k: list(v) for k, v in (spec.param_specs or {}).items()} == want
                and [list(s) for s in (spec.output_specs or form)] == form):
            raise NotImplementedError(
                f"the plan's spec of {name!r} ({spec.to_json()}): the port runs only the column-parallel "
                f"Dense spec of enable_parameter_parallel (kernel {want['kernel']}, bias [{model_axis!r}], "
                "output [batch, ..., model])")
        out[name] = tuple(want)
    return out
