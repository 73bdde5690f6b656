"""Routed (capacity-bucketed) pooled-embedding exchange.

The port of `dlrm_flexflow_tpu/parallel/routed_exchange.py` onto
`torch.distributed`, one process a device. The dense slot exchange
(parallel/embedding_collection.py) ships every slot's [B, D] partial and
makes each owner process the whole global batch a slot. The routed one
ships only the lookups an owner needs:

  1. Each rank classifies its local lookups by destination sub-table
     (static row-range arithmetic), sorts them by (slot, row) within each
     table (one stable `torch.sort` of a combined key over [T, B_loc*H]),
     and places each slot's unique rows, in sorted order, into that slot's
     capacity bucket: a gather of contiguous runs of the sorted stream,
     no scatter.
  2. One index all-to-all ships the buckets to the owners ([N, C_max]
     int32 a rank).
  3. The owners gather the received rows and reply with a second
     all-to-all ([N, C_max, D]); each rank reads its entries back through
     the inverse of its sort. The backward mirrors it with gradients
     pre-summed a unique row, and the owner updates the received rows
     (`local_pool_row_update`: the row-update kernel on the kernel route).

Capacity is consumed per unique (slot, row) in sorted order: an unsplit
table's slot holds all B_loc*H lookups (it cannot overflow); a split
table's slot holds cap_factor * B_loc*H / s, rounded up to 8. A unique row
past its slot's capacity drops with all its occurrences, in the forward
and in the backward alike, as if it were padding; so do indices < 0 or
>= vocab, as in the dense exchange. cap_factor = 0 is exact mode (every
slot holds B_loc*H). `routed_drop_stats` counts the drops on the host.

Every tensor has a static shape (the plan's), and the two all-to-alls send
equal chunks, so a train step that holds the exchange is captured in a CUDA
graph as the dense one is. Duplicate rows' gradients are summed by a
segmented scan over the sorted stream: log2(B_loc*H) passes of elementwise
adds in f32, with no atomics and no floating-point cumsum (which has no
deterministic CUDA algorithm), so a run gives the same bits on every
device. The JAX package takes a cumulative-sum difference instead; the two
sum the same terms in other orders (the tests bound the difference).

SUM pooling only, as in the JAX package (the partials must sum exactly).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ffconst import AggrMode
from .embedding_collection import _a2a, local_pool_row_update


def _round8(x: int) -> int:
    return max(8, (int(x) + 7) // 8 * 8)


class RoutedPlan:
    """Static routing tables derived from (layout, B_loc, H, cap_factor);
    the JAX package's class, field for field."""

    def __init__(self, layout, b_loc: int, h: int, cap_factor: float):
        n = layout.num_shards
        subs = layout.subs
        s_count = len(subs)
        split = layout.split or [1] * layout.num_tables
        self.table_base = np.zeros(layout.num_tables, np.int32)  # each table's first sub
        self.table_chunk = np.zeros(layout.num_tables, np.int32)  # rows a sub: ceil(vocab / split)
        seen = set()
        for i, (t, _, _) in enumerate(subs):
            if t not in seen:
                seen.add(t)
                self.table_base[t] = i
            self.table_chunk[t] = -(-layout.vocab_sizes[t] // max(1, split[t]))
        self.slot_dest = np.asarray([layout.owner[i] for i in range(s_count)], np.int32)
        self.slot_lbase = np.asarray([int(layout.row_offset[i]) for i in range(s_count)], np.int32)
        self.slot_rstart = np.asarray([subs[i][1] for i in range(s_count)], np.int32)
        me = b_loc * h
        caps = []
        for t, _, _ in subs:
            s = max(1, split[t])
            caps.append(me if cap_factor <= 0 or s == 1 else min(me, _round8(int(cap_factor * me / s))))
        self.slot_cap = np.asarray(caps, np.int32)
        # destination block d holds its slots' buckets back to back; the
        # blocks pad to the largest, so the all-to-all sends equal chunks
        self.slot_bucket_off = np.zeros(s_count, np.int64)
        per_dest = np.zeros(n, np.int64)
        for i in range(s_count):
            d = self.slot_dest[i]
            self.slot_bucket_off[i] = per_dest[d]
            per_dest[d] += self.slot_cap[i]
        self.c_max = int(_round8(int(per_dest.max()) if s_count else 8))
        self.n = n
        self.h = h
        self.b_loc = b_loc
        self.s_count = s_count

    def step_bucket_bytes(self, dim: int, row_bytes: int, grad_bytes: int = 4) -> int:
        """The bytes a step's four all-to-alls carry between ranks, summed
        over the ranks: each rank sends the lookup's and the update's
        [N, C_max] int32 row buckets, the [N, C_max, D] rows in the pool's
        dtype (`row_bytes`) and the [N, C_max, D] gradients (f32), every
        destination's chunk padded to C_max; N - 1 of its N chunks leave
        it. `step_exchange_bytes` counts the lookups' entries instead."""
        return self.n * (self.n - 1) * self.c_max * (2 * 4 + dim * (row_bytes + grad_bytes))


def routed_plan(layout, b_loc: int, h: int, cap_factor: float) -> RoutedPlan:
    """The layout's plan for (B_loc, H, cap_factor), made once."""
    cache = layout.__dict__.setdefault("_routed_plans", {})
    key = (int(b_loc), int(h), float(cap_factor))
    if key not in cache:
        cache[key] = RoutedPlan(layout, b_loc, h, cap_factor)
    return cache[key]


def _plan_consts(plan: RoutedPlan, layout, device) -> dict:
    """The plan's arrays on `device`, made once a device (a step then
    copies nothing from the host): per table [1, T, 1] columns, per slot
    arrays with one more entry for the sentinel slot S, the slots' tables,
    and each bucket position's slot (-1: padding) and place in its slot's
    bucket."""
    cache = plan.__dict__.setdefault("_device_consts", {})
    key = str(torch.device(device))
    if key not in cache:
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def col(a):
            return t(a).reshape(1, -1, 1)

        split = layout.split or [1] * layout.num_tables
        bucket_slot = -np.ones(plan.n * plan.c_max, np.int64)
        bucket_q = np.zeros(plan.n * plan.c_max, np.int64)
        for i in range(plan.s_count):
            start = int(plan.slot_dest[i]) * plan.c_max + int(plan.slot_bucket_off[i])
            bucket_slot[start:start + int(plan.slot_cap[i])] = i
            bucket_q[start:start + int(plan.slot_cap[i])] = np.arange(int(plan.slot_cap[i]))
        cache[key] = {
            "chunk": col(np.maximum(plan.table_chunk, 1)), "base": col(plan.table_base),
            "nsub": col([max(1, split[tt]) for tt in range(layout.num_tables)]),
            "vocab": col(layout.vocab_sizes),
            "lbase": t(np.append(plan.slot_lbase, 0)), "rstart": t(np.append(plan.slot_rstart, 0)),
            "cap": t(np.append(plan.slot_cap, 0)), "dest": t(np.append(plan.slot_dest, 0)),
            "boff": t(np.append(plan.slot_bucket_off, 0)),
            "slot_table": t([tt for tt, _, _ in layout.subs]), "slot_id": t(np.arange(plan.s_count)),
            "bucket_slot": t(bucket_slot), "bucket_q": t(bucket_q),
        }
    return cache[key]


def _classify(plan: RoutedPlan, layout, idx_local: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx_local [B_loc, T, H] -> (slot [B_loc, T*H], the sentinel S for
    padding and out-of-vocab; lrow [B_loc, T*H], the row in the
    destination's pool, R_pad where dropped)."""
    b, t, h = idx_local.shape
    c = _plan_consts(plan, layout, idx_local.device)
    r = idx_local.long()
    valid = (r >= 0) & (r < c["vocab"])  # out-of-vocab drops, as in the dense exchange
    k = torch.minimum(torch.clamp(torch.div(r, c["chunk"], rounding_mode="floor"), min=0), c["nsub"] - 1)
    slot = torch.where(valid, c["base"] + k, plan.s_count)
    lrow = c["lbase"][slot] + r - c["rstart"][slot]
    lrow = torch.where(valid, lrow, layout.r_pad)
    return slot.reshape(b, t * h), lrow.reshape(b, t * h)


def _tmajor(plan: RoutedPlan, x_bth: torch.Tensor) -> torch.Tensor:
    """[B, T*H(, D)] -> [T, B*H(, D)]."""
    b = x_bth.shape[0]
    t = x_bth.shape[1] // plan.h
    trail = tuple(x_bth.shape[2:])
    x = x_bth.reshape((b, t, plan.h) + trail).movedim(1, 0)
    return x.reshape((t, b * plan.h) + trail)


def _route_sorted(plan: RoutedPlan, layout, slot_bth: torch.Tensor, lrow_bth: torch.Tensor):
    """Sort each table's entries by (destination slot, local row), stably
    (ties in the entries' order, as `jax.lax.sort` over (keys, rows, iota)
    with num_keys=2 orders them), and rank the unique rows: capacity is
    consumed per unique row, and duplicates share their representative's
    bucket position.

    Returns (ustart [S], uend [S]: each slot's run of unique ranks in the
    t-major compacted stream; keys_s, lrow_s, order [T, M]: the sorted
    slots, rows and the sort's permutation; uniq_rank [T, M]: each sorted
    entry's unique rank within its table; order2 [T, M]: compacted stream
    -> sorted positions, the first occurrences first, in rank order)."""
    keys = _tmajor(plan, slot_bth)
    lrows = _tmajor(plan, lrow_bth)
    t, m = keys.shape
    stride = layout.r_pad + 1  # lrow <= R_pad: (slot, row) -> one int64 key, in lexicographic order
    combined, order = torch.sort(keys * stride + lrows, dim=1, stable=True)
    keys_s = torch.div(combined, stride, rounding_mode="floor")
    lrow_s = combined - keys_s * stride
    first = torch.ones_like(combined, dtype=torch.bool)
    first[:, 1:] = combined[:, 1:] != combined[:, :-1]
    cum = torch.cumsum(first.to(torch.int64), dim=1)  # inclusive
    uniq_rank = cum - 1
    iota = torch.arange(m, device=keys.device).expand(t, m)
    # the compacted stream: first occurrences by rank, then duplicates
    _, order2 = torch.sort(torch.where(first, uniq_rank, m + iota), dim=1)
    c = _plan_consts(plan, layout, keys.device)
    rows = keys_s[c["slot_table"]]  # [S, M]: each slot's table's sorted keys
    s_lo = torch.searchsorted(rows, c["slot_id"][:, None]).reshape(-1)
    s_hi = torch.searchsorted(rows, c["slot_id"][:, None], right=True).reshape(-1)
    cum_t = torch.cat([torch.zeros((t, 1), dtype=cum.dtype, device=cum.device), cum], dim=1)
    lift = c["slot_table"] * m
    ustart = cum_t[c["slot_table"], s_lo] + lift
    uend = cum_t[c["slot_table"], s_hi] + lift
    return ustart, uend, keys_s, lrow_s, order, uniq_rank, order2


def _fill_buckets(plan: RoutedPlan, layout, flat_sorted: torch.Tensor, ustart, uend, sentinel) -> torch.Tensor:
    """Each slot's run of the compacted stream `flat_sorted` ([T*M(, D)],
    t-major) in its capacity bucket, the rest `sentinel`: one gather.
    Returns [N, C_max(, D)]."""
    c = _plan_consts(plan, layout, flat_sorted.device)
    bslot, q = c["bucket_slot"], c["bucket_q"]
    real = bslot >= 0
    safe = bslot.clamp(min=0)
    src = ustart[safe] + q
    keep = real & (q < uend[safe] - ustart[safe])
    vals = flat_sorted[src.clamp(max=flat_sorted.shape[0] - 1)]
    keep = keep.reshape((-1,) + (1,) * (vals.dim() - 1))
    out = torch.where(keep, vals, torch.full((), sentinel, dtype=vals.dtype, device=vals.device))
    return out.reshape((plan.n, plan.c_max) + tuple(flat_sorted.shape[1:]))


def _entry_bucket_pos(plan: RoutedPlan, layout, slot_sorted, uniq_rank, ustart) -> torch.Tensor:
    """For each sorted entry, the position of its unique representative in
    the [N*C_max] bucket space, or N*C_max where it drops (over capacity,
    padding): a dropped unique row drops all its occurrences."""
    t, m = slot_sorted.shape
    c = _plan_consts(plan, layout, slot_sorted.device)
    sls = slot_sorted.clamp(max=plan.s_count)
    uq_glob = uniq_rank + torch.arange(t, device=uniq_rank.device)[:, None] * m
    st = torch.cat([ustart, ustart.new_zeros(1)])
    pos_in_run = uq_glob - st[sls]
    ok = (slot_sorted < plan.s_count) & (pos_in_run < c["cap"][sls])
    pos = c["dest"][sls] * plan.c_max + c["boff"][sls] + pos_in_run
    return torch.where(ok, pos, plan.n * plan.c_max)


def _segment_sums(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """x [T, M, D] f32 along runs of equal `seg` [T, M] (each run
    contiguous): the inclusive segmented scan, by doubling (each pass adds
    the entry s back where it lies in the same run), so the last entry of
    a run holds the run's sum. Elementwise adds only: no atomics, the same
    bits on every device."""
    m = x.shape[1]
    s = 1
    while s < m:
        same = (seg[:, s:] == seg[:, :-s])[..., None]
        x = torch.cat([x[:, :s], x[:, s:] + torch.where(same, x[:, :-s], 0.0)], dim=1)
        s *= 2
    return x


def routed_lookup_local(plan: RoutedPlan, layout, pool: torch.Tensor, idx_local: torch.Tensor,
                        group=None) -> torch.Tensor:
    """One rank's routed pooled lookup: `pool` its shard [R_pad, D],
    `idx_local` its slice [B_loc, T, H] (rows already permuted), the
    exchange over `group` (the mesh's data group; None: the world).
    Returns [B_loc, T, D] in the pool's dtype."""
    b, t, h = idx_local.shape
    slot, lrow = _classify(plan, layout, idx_local)
    ustart, uend, keys_s, lrow_s, order, uq, order2 = _route_sorted(plan, layout, slot, lrow)
    lrow_u = lrow_s.gather(1, order2)  # compacted
    bucket = _fill_buckets(plan, layout, lrow_u.reshape(-1), ustart, uend, layout.r_pad)
    recv = _a2a(bucket.to(torch.int32), group).reshape(-1).long()  # rows of my sub-tables, [N_src * C_max]
    rows = pool[recv.clamp(max=layout.r_pad - 1)]
    rows = torch.where((recv < layout.r_pad)[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    reply = _a2a(rows.reshape(plan.n, plan.c_max, -1), group)  # my unique entries, bucket order
    d = reply.shape[-1]
    pos_sorted = _entry_bucket_pos(plan, layout, keys_s, uq, ustart)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)  # back to the entries' order
    reply_flat = reply.reshape(plan.n * plan.c_max, d)
    got = reply_flat[pos.reshape(-1).clamp(max=reply_flat.shape[0] - 1)]
    got = torch.where((pos.reshape(-1) < reply_flat.shape[0])[:, None], got,
                      torch.zeros((), dtype=got.dtype, device=got.device))
    got = got.reshape(t, b, h, d).movedim(0, 1)
    return got.float().sum(dim=2).to(got.dtype)


def routed_update_local(plan: RoutedPlan, layout, pool: torch.Tensor, sstate, idx_local: torch.Tensor,
                        g_local: torch.Tensor, optimizer, lr=None, group=None):
    """One rank's routed backward and row update: duplicate rows'
    gradients (an entry's is its table's pooled gradient, SUM pooling) are
    summed into their unique representative, so the wire carries one
    (row, gradient) a unique row; the owner updates its shard in place.
    The exchange runs over `group`, as `routed_lookup_local`'s. Returns the
    shard's slot state."""
    b, t, h = idx_local.shape
    d = g_local.shape[-1]
    slot, lrow = _classify(plan, layout, idx_local)
    ustart, uend, keys_s, lrow_s, order, uq, order2 = _route_sorted(plan, layout, slot, lrow)
    m = b * h
    lrow_u = lrow_s.gather(1, order2)
    # sorted entry j of table t is example order[t, j] // H's gradient
    g_s = g_local.movedim(1, 0).gather(1, (order // h)[..., None].expand(t, m, d)).float()
    sums = _segment_sums(g_s, uq)
    # compacted entry j's run ends where the next first occurrence starts
    # (the stream's end for the last run); entries past the unique count
    # are never read (their slots' runs end before them)
    n_uniq = uq[:, -1:] + 1
    ends = torch.where(torch.arange(1, m + 1, device=uq.device)[None, :] < n_uniq,
                       torch.cat([order2[:, 1:], order2.new_full((t, 1), m)], dim=1), m)
    g_u = sums.gather(1, (ends - 1)[..., None].expand(t, m, d))
    bucket_rows = _fill_buckets(plan, layout, lrow_u.reshape(-1), ustart, uend, layout.r_pad)
    bucket_g = _fill_buckets(plan, layout, g_u.reshape(-1, d), ustart, uend, 0.0)
    recv_rows = _a2a(bucket_rows.to(torch.int32), group).reshape(-1).long()
    recv_g = _a2a(bucket_g, group).reshape(-1, d)
    return local_pool_row_update(layout, pool, sstate, recv_rows, (recv_g, 1), optimizer, lr=lr)


def routed_drop_stats(layout, indices_np, num_shards: int = 0, cap_factor: float = None):
    """The routed exchange's dropped lookups for a global batch, on the
    host (numpy, the JAX package's `routed_drop_stats`): returns (dropped
    entries, valid entries, fraction). Capacity is consumed per unique
    (slot, row) a rank; a dropped unique row counts with its
    multiplicity."""
    n = num_shards or layout.num_shards
    cap_factor = layout.routed_cap_factor if cap_factor is None else cap_factor
    idx = np.asarray(indices_np)
    if idx.ndim == 2:
        idx = idx[:, :, None]
    b, t, h = idx.shape
    b_loc = b // n
    plan = RoutedPlan(layout, b_loc, h, cap_factor)
    split = layout.split or [1] * layout.num_tables
    vocab = np.asarray(layout.vocab_sizes)
    r = idx.astype(np.int64)
    if layout.hash_rows:  # the permutation is what the exchange sees
        a, bb = layout._hash_consts()
        rp = (r * a[None, :, None] + bb[None, :, None]) % np.maximum(vocab[None, :, None], 1)
        r = np.where((r >= 0) & (r < vocab[None, :, None]), rp, r)
    valid = (r >= 0) & (r < vocab[None, :, None])
    chunk = np.maximum(plan.table_chunk[None, :, None], 1)
    nsub = np.asarray([max(1, split[tt]) for tt in range(t)])[None, :, None]
    k = np.clip(r // chunk, 0, nsub - 1)
    slot = np.where(valid, plan.table_base[None, :, None] + k, -1)
    dropped = 0
    total = int(valid.sum())
    span = int(vocab.max()) + 1
    for c in range(n):
        sl = slot[c * b_loc:(c + 1) * b_loc].reshape(-1)
        rr = r[c * b_loc:(c + 1) * b_loc].reshape(-1)
        keep = sl >= 0
        pair = sl[keep].astype(np.int64) * span + rr[keep]
        uniq, counts = np.unique(pair, return_counts=True)
        usl = uniq // span
        order = np.argsort(usl, kind="stable")
        usl, counts = usl[order], counts[order]
        for s_id in np.unique(usl):
            mask = usl == s_id
            over = max(0, int(mask.sum()) - int(plan.slot_cap[s_id]))
            if over > 0:
                dropped += int(counts[mask][-over:].sum())
    return dropped, total, dropped / max(total, 1)


def _check(layout, mesh, aggr: AggrMode) -> None:
    if layout.num_shards != mesh.data_size:
        raise ValueError(f"the layout has {layout.num_shards} shards, the mesh's data axis {mesh.data_size}")
    if aggr is not AggrMode.AGGR_MODE_SUM:
        raise ValueError("the routed exchange needs SUM pooling (the partials must sum exactly)")


@torch.no_grad()
def routed_embedding_lookup(layout, pool: torch.Tensor, indices: torch.Tensor, mesh,
                            aggr: AggrMode = AggrMode.AGGR_MODE_SUM, cap_factor: float = 0.0) -> torch.Tensor:
    """The routed fused lookup on every rank: `pool` this rank's shard
    [R_pad, D], `indices` its slice of the batch [B_loc, T, H] (per-table
    indices, -1 padding). Returns the rank's pooled embeddings [B_loc, T,
    D] in the pool's dtype."""
    _check(layout, mesh, aggr)
    idx = layout.perm_rows(indices.long())
    plan = routed_plan(layout, idx.shape[0], idx.shape[2], cap_factor)
    return routed_lookup_local(plan, layout, pool, idx, mesh.data_group())


@torch.no_grad()
def routed_embedding_sparse_update(layout, pool: torch.Tensor, sstate, indices: torch.Tensor,
                                   g_pooled: torch.Tensor, mesh, optimizer,
                                   aggr: AggrMode = AggrMode.AGGR_MODE_SUM, lr=None, cap_factor: float = 0.0):
    """The backward of `routed_embedding_lookup` with the optimizer in it,
    on every rank: this rank's shard rows updated in place from every
    rank's kept lookups. Returns the shard's slot state."""
    _check(layout, mesh, aggr)
    idx = layout.perm_rows(indices.long())
    plan = routed_plan(layout, idx.shape[0], idx.shape[2], cap_factor)
    return routed_update_local(plan, layout, pool, sstate, idx, g_pooled, optimizer, lr=lr,
                               group=mesh.data_group())
