"""The strategy search: graph -> cost spec -> native annealer -> plan decisions.

PyTorch counterpart of `dlrm_flexflow_tpu/autotune/search.py`, the same
functions over the port's graph: `graph_to_cost_spec` (one entry an op, a
table split into its sub-tables) and `autotune_plan` (the placement annealer
with an outer search over split degrees), `graph_to_cost_spec_v2` (one
entry a table, dense ops staged around the exchange, producer-consumer
edges) and `autotune_plan_joint` (the joint annealer over owner, split,
table mode and dense tensor parallelism, on the native core of
autotune/bindings.py). Their inputs are built from each op's `cost_stats`,
which give the JAX package's floats, so both packages hand the native core
the same numbers and, for one seed and budget, get the same plan.

The JAX package reads `pick_chunk_packs` and `rows_per_pack` from its
Pallas packed-update module for the selective-update term; the port keeps
its own copies of the two pure functions below, so the cost model's inputs
stay equal to the JAX package's.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..core.graph import Graph
from ..ffconst import AggrMode, OperatorType
from ..parallel.embedding_collection import expand_subtables
from . import bindings
from .machine import MachineSpec, op_cost_sig

LANES = 128


def rows_per_pack(d: int) -> int:
    """Rows of width d in one 128-lane pack of the JAX package's packed
    layout (`ops/pallas/packed_update.py:56`)."""
    assert LANES % d == 0, f"packed layout needs D | 128, got D={d}"
    return LANES // d


def pick_chunk_packs(v: int, d: int, k: int) -> int:
    """The JAX package's chunk size for a [v, d] table and k updates
    (`ops/pallas/packed_update.py:471`): C* = sqrt(P * 1.5 us * 2e14 /
    (2 * 128 * k)), clamped to [512, 4096], rounded up to 256."""
    p = -(-v // rows_per_pack(d))
    c = int((p * 1.5e-6 * 2.0e14 / (max(k, 1) * 2 * LANES)) ** 0.5)
    c = max(512, min(4096, c))
    return -(-c // 256) * 256


def iter_embedding_vocabs(graph: Graph) -> List[int]:
    """Vocab of every embedding table in graph order — the ONE enumeration
    shared by the cost spec and the mode-choice mask (indices must align)."""
    out: List[int] = []
    for op in graph.compute_ops:
        if op.op_type is OperatorType.OP_EMBEDDING and hasattr(op, "layout"):
            out.extend(op.layout.vocab_sizes)
        elif op.op_type is OperatorType.OP_EMBEDDING:
            out.append(op.num_entries)
    return out


def graph_to_cost_spec(
    graph: Graph, global_batch: int, table_split: Optional[List[int]] = None,
    min_vocab: int = 0, replicate_mask: Optional[List[bool]] = None,
    exchange_dtype_bytes: float = 4.0,
) -> Tuple[List[dict], List[str]]:
    """Lower graph ops to FFSimOp dicts. Returns (ops, embed_op_names) where
    embed_op_names lists the FFSIM_EMBED entries in order — one per
    SUB-table when `table_split` is given (row-range splitting spreads a
    table's lookups/rows uniformly over its sub-tables; see
    parallel/embedding_collection.py). Tables with vocab <= `min_vocab`
    stay out of the placement problem: they run as replicated one-hot MXU
    matmuls (data-parallel), so they are modeled as dense ops — matching
    the fusion pass's min_vocab exclusion (parallel/passes.py)."""
    ops: List[dict] = []
    embed_names: List[str] = []
    t_idx = 0  # over ALL tables (replicate_mask index)
    p_idx = 0  # over PLACED tables only (table_split index)

    def add_table(name, vocab, dim, lookups):
        nonlocal t_idx, p_idx
        replicated = (
            replicate_mask[t_idx] if replicate_mask is not None
            else vocab <= min_vocab
        )
        if replicated:
            # replicated one-hot path: dense DP work, not a placement var
            ops.append({
                "kind": bindings.KIND_DENSE,
                "flops": 2.0 * lookups * vocab * dim,
                "bytes": 4.0 * (lookups * dim + vocab * dim),
                "param_bytes": 4.0 * vocab * dim,
            })
            t_idx += 1
            return
        s = 1 if table_split is None else max(1, int(table_split[p_idx]))
        p_idx += 1
        # mirror expand_subtables exactly: a table yields at most `vocab`
        # sub-ranges (splitting a 3-row table 4 ways gives 3 subs), so the
        # owner vector the search returns always matches the layout
        subs = expand_subtables([vocab], [s])
        for k, (_, _, length) in enumerate(subs):
            ops.append({
                "kind": bindings.KIND_EMBED,
                "table_rows": float(length),
                "row_bytes": 4.0 * dim,
                "lookups": float(lookups) / len(subs),
                # pooled exchange slots are dense over the batch: each
                # sub-table slot ships global_batch pooled rows on the wire
                "pooled_rows": float(global_batch),
                "sub_count": float(len(subs)),
                # the exchange rides the compute dtype (bf16 halves it);
                # gather/scatter row_bytes stay f32 (params are f32)
                "wire_row_bytes": exchange_dtype_bytes * dim,
            })
            embed_names.append(f"{name}/{k}" if len(subs) > 1 else name)
        t_idx += 1

    for op in graph.compute_ops:
        stats = op.cost_stats()
        batch = op.outputs[0].shape[0] if op.outputs and op.outputs[0].shape else 1
        scale = global_batch / max(1, batch)
        if op.op_type is OperatorType.OP_EMBEDDING and hasattr(op, "layout"):
            # collection: one FFSIM_EMBED entry per (sub-)table
            lay = op.layout
            bag = op.inputs[0].shape[1] if op.inputs[0].num_dims > 1 else 1
            for t, vocab in enumerate(lay.vocab_sizes):
                add_table(f"{op.name}[{t}]", vocab, lay.dim, global_batch * bag)
        elif op.op_type is OperatorType.OP_EMBEDDING:
            bag = op.inputs[0].shape[1] if op.inputs[0].num_dims > 1 else 1
            add_table(op.name, op.num_entries, op.out_dim, global_batch * bag)
        else:
            kind = (
                bindings.KIND_DENSE
                if op.op_type in (OperatorType.OP_LINEAR, OperatorType.OP_CONV2D,
                                  OperatorType.OP_BATCHMATMUL,
                                  OperatorType.OP_MULTIHEAD_ATTENTION,
                                  OperatorType.OP_LSTM)
                else bindings.KIND_OTHER
            )
            ops.append({
                "kind": kind,
                "flops": stats["flops"] * scale,
                "bytes": stats["bytes"] * scale,
                "param_bytes": stats["param_bytes"],
            })
    return ops, embed_names


def _table_chunks(names, cph: int):
    """[[sub indices]] — one chunk per (table, host-sized group of subs)."""
    import collections

    groups = collections.defaultdict(list)
    for i, nm in enumerate(names):
        groups[nm.rsplit("/", 1)[0] if "/" in nm else nm].append(i)
    chunks = []
    for idxs in groups.values():
        for lo in range(0, len(idxs), cph):
            chunks.append(idxs[lo : lo + cph])
    return chunks


def _colocate_splits_by_host(owner, embed_ops, names, cph: int, n: int):
    """Canonicalize a searched owner vector for the hierarchical exchange:
    a split table's sub-tables move onto distinct chips of ONE host (the
    plurality host of where the MCMC put them; full-host chunks when the
    split exceeds chips_per_host), choosing the least-lookup-loaded chips.
    The cost model's DCN term assumes this grouping (ffsim.cc table_payload);
    the flat model is placement-indifferent, so this is cost-neutral there."""
    import collections

    load = [0.0] * n
    for i, o in enumerate(embed_ops):
        load[owner[i] % n] += o["lookups"] * o["row_bytes"]
    owner = [o % n for o in owner]
    for chunk in _table_chunks(names, cph):
        if len(chunk) <= 1:
            continue
        host_votes = collections.Counter(owner[i] // cph for i in chunk)
        h = host_votes.most_common(1)[0][0]
        for i in chunk:
            load[owner[i]] -= embed_ops[i]["lookups"] * embed_ops[i]["row_bytes"]
        chips = sorted(range(h * cph, (h + 1) * cph), key=lambda s: load[s])
        for j, i in enumerate(chunk):
            s = chips[j % cph]
            owner[i] = s
            load[s] += embed_ops[i]["lookups"] * embed_ops[i]["row_bytes"]
    return owner


def _lpt_colocated_assignment(embed_ops, names, cph: int, n: int):
    """From-scratch host-aware placement: LPT over hosts by lookup load,
    each table chunk on distinct least-loaded chips of its host. Ignores the
    MCMC owner entirely — often better when splits are mixed-degree, kept as
    a second candidate and the cheaper simulated layout wins."""
    chunks = _table_chunks(names, cph)
    chunks.sort(
        key=lambda c: -sum(
            embed_ops[i]["lookups"] * embed_ops[i]["row_bytes"] for i in c
        )
    )
    hosts = n // cph
    load = [0.0] * n
    owner = [0] * len(embed_ops)
    for chunk in chunks:
        h = min(range(hosts), key=lambda h: sum(load[h * cph : (h + 1) * cph]))
        chips = sorted(range(h * cph, (h + 1) * cph), key=lambda s: load[s])
        for j, i in enumerate(chunk):
            s = chips[j % cph]
            owner[i] = s
            load[s] += embed_ops[i]["lookups"] * embed_ops[i]["row_bytes"]
    return owner


def _waterfill_splits(loads, target_subs: int, cap: int, vocabs) -> List[int]:
    """LPT water-filling: repeatedly split the table with the highest
    per-sub load until ~target_subs sub-tables exist. Finds MIXED degrees
    (e.g. 26 tables onto 64 chips) that power-of-2 doubling cannot — the
    per-shard scatter bound only reaches its floor when every chip carries
    an equal slice of the total lookup work."""
    import heapq

    split = [1] * len(loads)
    heap = [(-loads[t], t) for t in range(len(loads))]
    heapq.heapify(heap)
    total = len(loads)
    stuck = 0
    while total < target_subs and heap and stuck < len(loads):
        negl, t = heapq.heappop(heap)
        if split[t] >= min(cap, max(int(vocabs[t]), 1)):
            stuck += 1
            continue  # table can't split further; leave it out of the heap
        stuck = 0
        split[t] += 1
        total += 1
        heapq.heappush(heap, (-loads[t] / split[t], t))
    return split


def _search_once(graph, machine, global_batch, split, budget, alpha, seed,
                 opt_state_factor, initial_owner=None, min_vocab=0,
                 replicate_mask=None, exchange_dtype_bytes=4.0):
    ops, embed_names = graph_to_cost_spec(
        graph, global_batch, split, min_vocab, replicate_mask,
        exchange_dtype_bytes,
    )
    n_sub = len(embed_names)
    m = machine.to_native()
    if n_sub == 0:
        return [], bindings.simulate(m, ops, [], opt_state_factor), {}, ops
    rr = [i % machine.num_chips for i in range(n_sub)]
    start = (
        list(initial_owner)
        if initial_owner is not None and len(initial_owner) == n_sub
        else list(rr)
    )
    rr_cost = bindings.simulate(m, ops, rr, opt_state_factor)
    best_owner, best_cost = bindings.mcmc_search(
        m, ops, start, budget=budget, alpha=alpha, seed=seed,
        opt_state_factor=opt_state_factor,
    )
    # hierarchical exchange: split sub-tables must be co-located per host
    # (the runtime layout and the model's DCN term both assume it). Score
    # every candidate POST-co-location so the outer split search compares
    # what will actually run; two grouping heuristics, cheaper wins.
    if (
        split is not None
        and any(s > 1 for s in split)
        and machine.hierarchical_a2a > 0
        and 1 < machine.chips_per_host < machine.num_chips
    ):
        embed_f = [o for o in ops if o["kind"] == bindings.KIND_EMBED]
        cands = [
            _colocate_splits_by_host(
                best_owner, embed_f, embed_names,
                machine.chips_per_host, machine.num_chips,
            ),
            _lpt_colocated_assignment(
                embed_f, embed_names, machine.chips_per_host, machine.num_chips
            ),
        ]
        best_owner, best_cost = min(
            ((o, bindings.simulate(m, ops, o, opt_state_factor)) for o in cands),
            key=lambda oc: oc[1],
        )
    report = {
        "tables": embed_names,
        "round_robin_us": rr_cost,
        "best_us": best_cost,
        "improvement": rr_cost / best_cost if best_cost > 0 else 1.0,
        "breakdown": bindings.breakdown(m, ops, best_owner, opt_state_factor),
    }
    return best_owner, best_cost, report, ops


def autotune_plan(
    graph: Graph,
    machine: MachineSpec,
    global_batch: int,
    budget: int = 20000,
    alpha: float = 0.05,
    seed: int = 0,
    opt_state_factor: float = 0.0,
    initial_owner: Optional[List[int]] = None,
    search_splits: bool = False,
    max_split: Optional[int] = None,
    min_vocab: int = 0,
    exchange_dtype_bytes: float = 4.0,
):
    """Run the MCMC placement search. Returns (owner, predicted_us, report).

    With `search_splits`, an outer greedy loop searches per-table row-split
    degrees (the parallelism-DEGREE axis of the reference's per-op search
    space, ParallelConfig dims): each round proposes doubling the split of
    the hottest tables, re-runs the placement MCMC on the expanded sub-table
    list, and keeps the change if the simulated step improves >1%. The
    report then carries "table_split" and per-SUB-table owners.
    """
    # table-mode choice (the per-op placement-vs-replication axis of the
    # reference's strategy space): compare "small tables replicated"
    # (min_vocab mask, the single-chip winner) against "all tables placed"
    # (kills the replicated tables' dense-grad allreduce at scale — PERF.md)
    vocabs_all = iter_embedding_vocabs(graph)
    default_mask = [v <= min_vocab for v in vocabs_all]
    owner, best_cost, report, ops = _search_once(
        graph, machine, global_batch, None, budget, alpha, seed,
        opt_state_factor, initial_owner=initial_owner,
        replicate_mask=default_mask, exchange_dtype_bytes=exchange_dtype_bytes,
    )
    chosen_mask = default_mask
    if machine.num_chips > 1 and any(default_mask):
        all_placed = [False] * len(vocabs_all)
        o2, c2, r2, ops2 = _search_once(
            graph, machine, global_batch, None, budget, alpha, seed + 1,
            opt_state_factor, replicate_mask=all_placed,
            exchange_dtype_bytes=exchange_dtype_bytes,
        )
        if c2 < best_cost * 0.99:
            owner, best_cost, report, ops = o2, c2, r2, ops2
            chosen_mask = all_placed
    n_tables = sum(1 for o in ops if o["kind"] == bindings.KIND_EMBED)
    split = [1] * n_tables
    if not search_splits or n_tables == 0 or machine.num_chips < 2:
        if report:
            report["table_split"] = split
            report["replicated_tables"] = [
                i for i, r in enumerate(chosen_mask) if r
            ]
        return owner, best_cost, report

    cap = max_split or machine.num_chips
    embed_ops = [o for o in ops if o["kind"] == bindings.KIND_EMBED]
    embed_load = [(o["lookups"] * o["row_bytes"], i) for i, o in enumerate(embed_ops)]
    vocab_of = [int(o["table_rows"]) for o in embed_ops]  # split=1 here
    # track the global best; allow a few cost-neutral "plateau" moves (the
    # per-shard max often stays flat until the split degree reaches a
    # divisor-friendly value, e.g. 26 tables on 32 chips needs s=16)
    g_split, g_owner, g_cost, g_report = split, owner, best_cost, report
    plateau = 0
    for _round in range(12):
        per_sub = [
            (embed_load[t][0] / split[t], t)
            for t in range(n_tables)
            if split[t] * 2 <= cap
        ]
        if not per_sub:
            break
        per_sub.sort(reverse=True)
        top = per_sub[0][0]
        # the max-shard cost only drops when every comparably-hot table
        # splits, so the primary proposal doubles the whole tie set
        tie_set = [t for load, t in per_sub if load >= 0.9 * top]
        # proposals: tie set x2, tie set x4 (x2 can be cost-neutral when
        # shard count ~ sub-table count), hottest alone x2
        proposals = [(tie_set, 2), (tie_set, 4)]
        if len(tie_set) > 1:
            proposals.append(([per_sub[0][1]], 2))
        moved = False
        for k, (ts, factor) in enumerate(proposals):
            cand = list(split)
            for t in ts:
                cand[t] = min(cand[t] * factor, cap, max(vocab_of[t], 1))
            if cand == split:
                continue
            o2, c2, r2, _ = _search_once(
                graph, machine, global_batch, cand,
                max(budget // 4, 500), alpha, seed + 17 * _round + k,
                opt_state_factor, replicate_mask=chosen_mask,
                exchange_dtype_bytes=exchange_dtype_bytes,
            )
            if c2 < best_cost * 0.99:
                split, owner, best_cost, report = cand, o2, c2, r2
                moved, plateau = True, 0
                break
            if c2 <= best_cost * 1.005 and plateau < 3:
                split, owner, best_cost, report = cand, o2, c2, r2
                moved, plateau = True, plateau + 1
                break
        if best_cost < g_cost:
            g_split, g_owner, g_cost, g_report = split, owner, best_cost, report
        if not moved:
            break
    split, owner, best_cost, report = g_split, g_owner, g_cost, g_report
    # water-filling proposals: mixed split degrees targeting ~k subs per
    # chip (the doubling loop above only reaches uniform powers of two; the
    # scatter bound needs every chip to carry an equal lookup slice while
    # the slot-exchange cost says don't over-split)
    loads = [embed_load[t][0] for t in range(n_tables)]
    n_chips = machine.num_chips
    tried = {tuple(split)}
    for target in (n_chips // 2, n_chips, 2 * n_chips):
        if target <= n_tables:
            continue
        cand = _waterfill_splits(loads, target, cap, vocab_of)
        if tuple(cand) in tried:
            continue
        tried.add(tuple(cand))
        o2, c2, r2, _ = _search_once(
            graph, machine, global_batch, cand,
            max(budget // 2, 1000), alpha, seed + 101 + target,
            opt_state_factor, replicate_mask=chosen_mask,
            exchange_dtype_bytes=exchange_dtype_bytes,
        )
        if c2 < best_cost:
            split, owner, best_cost, report = cand, o2, c2, r2
    if report:
        report["table_split"] = split
        report["replicated_tables"] = [i for i, r in enumerate(chosen_mask) if r]
    return owner, best_cost, report


# ============================ v2: joint search ==============================

def zipf_tail_fraction(vocab: int, hot: int, s: float = 1.05) -> float:
    """Fraction of lookups landing beyond rank `hot` under a Zipf(s) rank
    distribution (continuous-integral approximation). Frequency-ordered id
    spaces (MLPerf Criteo preprocessing) make the hot prefix absorb most
    lookups; this models how much tail traffic a host-tail split would
    carry (parallel/host_tail.py)."""
    if hot >= vocab or hot < 1:
        return 0.0 if hot >= vocab else 1.0

    def mass(a: float, b: float) -> float:
        if abs(s - 1.0) < 1e-9:
            return math.log(b / a)
        return (b ** (1.0 - s) - a ** (1.0 - s)) / (1.0 - s)

    return mass(hot, vocab) / mass(1.0, vocab)


def graph_to_cost_spec_v2(
    graph: Graph, global_batch: int, exchange_dtype_bytes: float = 4.0,
    dense_costs=None, host_tail_hot: int = 0, op_costs=None,
    table_dtype_bytes: float = 4.0,
):
    """Lower the graph for the JOINT search: one FFSIM_EMBED per TABLE
    (split/mode are annealer state, not lowering inputs), dense ops get a
    `stage` (0 = before the pooled exchange — overlaps the fwd all-to-all
    in the DAG schedule — 1 = after) and `act_bytes` (TP psum volume), and
    producer-consumer edges between dense ops carry tensor volumes for the
    propagate moves (reference: volume-weighted graph walks,
    model.h:287-289).

    Returns (ops, table_names, vocabs, num_dense, edges, dense_names,
    op_edges) — op_edges are producer-consumer pairs over the FFSimOp index
    space (every entry, including glue ops), from which the graph-generic
    task DAG is built (reference: the SimTask DAG follows the actual op
    graph, src/runtime/simulator.cc:328-498)."""
    ops: List[dict] = []
    table_names: List[str] = []
    vocabs: List[int] = []
    edges: List[tuple] = []
    op_edges: List[tuple] = []
    dense_names: List[str] = []
    dense_idx_of_op = {}
    ffop_idx_of_op = {}  # graph-op name -> [FFSimOp indices]
    past_exchange = False
    embed_producers = set()

    def add_table(name, vocab, dim, lookups, tail_ok=False):
        entry = {
            "kind": bindings.KIND_EMBED,
            "table_rows": float(vocab),
            "row_bytes": 4.0 * dim,
            "lookups": float(lookups),
            "pooled_rows": float(global_batch),
            "wire_row_bytes": exchange_dtype_bytes * dim,
            "stage": 0,
        }
        if 128 % max(1, dim) == 0:
            # packed-layout candidates: storage dtype (config.table_dtype)
            # scales the gather/table-pass HBM terms, and the selective
            # update dispatch touches only chunks that received entries —
            # uniform-draw expectation E[touched]/C = 1-(1-1/C)^K is the
            # UPPER bound (Zipf touches fewer)
            entry["table_row_bytes"] = table_dtype_bytes * dim
            packs = -(-int(vocab) // rows_per_pack(dim))
            cp = pick_chunk_packs(int(vocab), dim, int(lookups))
            n_chunks = max(1, -(-packs // cp))
            if n_chunks > 1:
                entry["upd_touched_frac"] = 1.0 - math.exp(
                    float(lookups) * math.log1p(-1.0 / n_chunks)
                )
        # host-tail candidacy (parallel/host_tail.py; mode 2): only tables
        # whose vocab dwarfs the hot prefix are worth splitting to the host
        if tail_ok and host_tail_hot > 0 and vocab > 4 * host_tail_hot:
            entry["tail_hot_rows"] = float(host_tail_hot)
            entry["tail_miss_frac"] = zipf_tail_fraction(vocab, host_tail_hot)
        ops.append(entry)
        table_names.append(name)
        vocabs.append(int(vocab))

    for op in graph.compute_ops:
        if any(t.owner_op.name in embed_producers for t in op.inputs):
            past_exchange = True
        i_lo = len(ops)
        stats = op.cost_stats()
        batch = op.outputs[0].shape[0] if op.outputs and op.outputs[0].shape else 1
        scale = global_batch / max(1, batch)
        if op.op_type is OperatorType.OP_EMBEDDING and hasattr(op, "layout"):
            lay = op.layout
            bag = op.inputs[0].shape[1] if op.inputs[0].num_dims > 1 else 1
            for t, vocab in enumerate(lay.vocab_sizes):
                add_table(f"{op.name}[{t}]", vocab, lay.dim, global_batch * bag)
            embed_producers.add(op.name)
        elif op.op_type is OperatorType.OP_EMBEDDING:
            bag = op.inputs[0].shape[1] if op.inputs[0].num_dims > 1 else 1
            add_table(
                op.name, op.num_entries, op.out_dim, global_batch * bag,
                # the runtime tail exchange is exact only for SUM pooling
                # (partials add; parallel/passes.py gate)
                tail_ok=getattr(op, "aggr", None) is AggrMode.AGGR_MODE_SUM,
            )
            embed_producers.add(op.name)
        else:
            kind = (
                bindings.KIND_DENSE
                if op.op_type in (OperatorType.OP_LINEAR, OperatorType.OP_CONV2D,
                                  OperatorType.OP_BATCHMATMUL,
                                  OperatorType.OP_MULTIHEAD_ATTENTION,
                                  OperatorType.OP_LSTM)
                else bindings.KIND_OTHER
            )
            out_vol = (
                op.outputs[0].volume * scale * 4.0 if op.outputs else 0.0
            )
            entry = {
                "kind": kind,
                "flops": stats["flops"] * scale,
                "bytes": stats["bytes"] * scale,
                "param_bytes": stats["param_bytes"],
                "stage": 1 if past_exchange else 0,
                "act_bytes": out_vol,
            }
            # measured per-shape dense cost replaces the roofline when the
            # calibration table has it (reference: per-(op,config) measured
            # kernels, model.cu:20-64)
            if (
                dense_costs
                and hasattr(op, "in_dim")
                and hasattr(op, "out_dim")
                and f"{op.in_dim}x{op.out_dim}" in dense_costs
            ):
                entry["fwd_us"] = (
                    dense_costs[f"{op.in_dim}x{op.out_dim}"] * global_batch
                )
            elif op_costs:
                # generic measured costs (conv/batch-matmul/attention) key
                # on the full shape signature
                sig = op_cost_sig(op)
                if sig in op_costs:
                    entry["fwd_us"] = op_costs[sig] * global_batch
            if kind == bindings.KIND_DENSE:
                j = sum(1 for o in ops if o["kind"] == bindings.KIND_DENSE)
                dense_names.append(op.name)
                seen = set()
                for t in op.inputs:
                    src = dense_idx_of_op.get(t.owner_op.name)
                    if src is not None and src[0] not in seen:
                        seen.add(src[0])
                        edges.append((src[0], j, src[1]))
                dense_idx_of_op[op.name] = (j, out_vol)
            else:
                # pass-through (concat/elementwise/...): inherit the dense
                # producer so propagate edges span shape glue
                for t in op.inputs:
                    src = dense_idx_of_op.get(t.owner_op.name)
                    if src is not None:
                        dense_idx_of_op[op.name] = (src[0], out_vol)
                        break
            ops.append(entry)
        my_idxs = list(range(i_lo, len(ops)))
        if my_idxs:
            seen_src = set()
            for t in op.inputs:
                for src in ffop_idx_of_op.get(t.owner_op.name, ()):
                    if src not in seen_src:
                        seen_src.add(src)
                        op_edges.extend((src, j) for j in my_idxs)
            ffop_idx_of_op[op.name] = my_idxs
        else:
            # zero-entry op (e.g. shape-only glue that lowered to nothing):
            # pass its producers through so edges span it
            inherited = []
            for t in op.inputs:
                inherited.extend(ffop_idx_of_op.get(t.owner_op.name, ()))
            ffop_idx_of_op[op.name] = list(dict.fromkeys(inherited))
    num_dense = sum(1 for o in ops if o["kind"] == bindings.KIND_DENSE)
    assert len(dense_names) == num_dense
    return ops, table_names, vocabs, num_dense, edges, dense_names, op_edges


def _greedy_owner(ops, vocabs, n: int) -> List[int]:
    """HBM/lookup-balancing seed (biggest load to least-loaded chip)."""
    embeds = [o for o in ops if o["kind"] == bindings.KIND_EMBED]
    load = [0.0] * n
    owner = [0] * len(embeds)
    for t in sorted(
        range(len(embeds)),
        key=lambda t: -embeds[t]["lookups"] * embeds[t]["row_bytes"],
    ):
        dev = min(range(n), key=lambda d: load[d])
        owner[t] = dev
        load[dev] += embeds[t]["lookups"] * embeds[t]["row_bytes"]
    return owner


def autotune_plan_joint(
    graph: Graph,
    machine: MachineSpec,
    global_batch: int,
    budget: int = 20000,
    alpha: float = 0.05,
    seed: int = 0,
    opt_state_factor: float = 0.0,
    min_vocab: int = 0,
    max_split: Optional[int] = None,
    exchange_dtype_bytes: float = 4.0,
    allow_splits: bool = True,
    enable_propagation: bool = True,
    host_tail_hot: int = 0,
    table_dtype_bytes: float = 4.0,
):
    """Joint annealer over (owner, split, mode[, dense tp]) in the native
    core — the reference's per-op ParallelConfig MCMC (model.cc:1928-1991)
    rebuilt with every axis in ONE move set, seeded from round-robin,
    greedy, and water-filled-split starts (the cheaper simulated result
    wins). Returns (per_table_owner, cost_us, report); report carries
    table_split / replicated_tables / tp / breakdown."""
    (ops, names, vocabs, num_dense, edges, dense_names,
     op_edges) = graph_to_cost_spec_v2(
        graph, global_batch, exchange_dtype_bytes,
        dense_costs=getattr(machine, "dense_costs", None),
        host_tail_hot=host_tail_hot,
        op_costs=getattr(machine, "op_costs", None),
        table_dtype_bytes=table_dtype_bytes,
    )
    if not enable_propagation:
        # reference parity: config-propagation moves along graph edges are
        # gated by --enable-propagation (model.cc:2255; propagate at 1830)
        edges = []
    nt = len(vocabs)
    n = machine.num_chips
    m = machine.to_native()
    base_mode = [1 if v <= min_vocab else 0 for v in vocabs]
    tp0 = [1] * num_dense
    if nt == 0:
        cost = bindings.simulate2(m, ops, [], [], [], tp0, opt_state_factor,
                                  op_edges=op_edges)
        return [], cost, {"tables": [], "tp": tp0}
    cap = min(max_split or n, n)
    if not allow_splits:
        cap = 1
    embeds = [o for o in ops if o["kind"] == bindings.KIND_EMBED]
    loads = [o["lookups"] * o["row_bytes"] for o in embeds]
    rr = [i % n for i in range(nt)]
    greedy = _greedy_owner(ops, vocabs, n)
    seeds = [
        (rr, [1] * nt, list(base_mode)),
        (greedy, [1] * nt, list(base_mode)),
    ]
    if cap > 1 and n > 1:
        wf = _waterfill_splits(loads, n, cap, vocabs)
        seeds.append((greedy, wf, list(base_mode)))
    tail_viable = [o.get("tail_hot_rows", 0.0) > 0 for o in embeds]
    if any(tail_viable):
        # seed with every viable table host-tailed: beyond-HBM configs are
        # infeasible (huge mem penalty) from the standard seeds, so the
        # annealer may never find the crossing on its own
        seeds.append((
            greedy, [1] * nt,
            [2 if tail_viable[i] else base_mode[i] for i in range(nt)],
        ))
    rr_cost = bindings.simulate2(
        m, ops, rr, [1] * nt, base_mode, tp0, opt_state_factor,
        op_edges=op_edges,
    )
    # the exchange mode (dense slot exchange vs routed capacity buckets,
    # parallel/routed_exchange.py) is itself a strategy axis: search under
    # both machine models and keep the cheaper plan
    modes = [0, 1] if (n > 1 and machine.routed_exchange == 0) else [
        machine.routed_exchange
    ]
    best = None
    best_routed = 0
    per_seed = max(200, budget // (len(seeds) * len(modes)))
    for routed_flag in modes:
        m_mode = machine.to_native()
        m_mode.routed_exchange = routed_flag
        for i, (o0, s0, mo0) in enumerate(seeds):
            o, s, mo, tp, c = bindings.search2(
                m_mode, ops, o0, s0, mo0, list(tp0), vocabs, edges,
                budget=per_seed, alpha=alpha, seed=seed + 31 * i,
                opt_state_factor=opt_state_factor, split_cap=cap,
                op_edges=op_edges,
            )
            if best is None or c < best[-1]:
                best = (o, s, mo, tp, c)
                best_routed = routed_flag
                m = m_mode
    owner, split, mode, tp, cost = best
    # the runtime collection holds only the PLACED tables (replicated ones
    # stay as one-hot ops — passes.py excludes plan.replicated_tables), so
    # the exported assignment/split vectors align with that subset
    placed = [i for i, mv in enumerate(mode) if mv == 0]
    report = {
        "tables": [names[i] for i in placed],
        "round_robin_us": rr_cost,
        "best_us": cost,
        "improvement": rr_cost / cost if cost > 0 else 1.0,
        "table_split": [split[i] for i in placed],
        "replicated_tables": [i for i, mv in enumerate(mode) if mv == 1],
        # host-tail decisions (mode 2): per-table device hot-prefix rows in
        # graph order, 0 = fully on device (plan.host_tail_rows contract)
        "host_tail_rows": [
            int(embeds[i].get("tail_hot_rows", 0)) if mode[i] == 2 else 0
            for i in range(nt)
        ],
        "tp": tp,
        "tp_ops": [dense_names[j] for j, x in enumerate(tp) if x > 1],
        "exchange": "routed" if best_routed else "dense",
        "breakdown": bindings.breakdown2(
            m, ops, owner, split, mode, tp, opt_state_factor,
            op_edges=op_edges,
        ),
    }
    return [owner[i] for i in placed], cost, report
