"""Table-sharded embedding collection with pooled all-to-all exchange.

The port of `dlrm_flexflow_tpu/parallel/embedding_collection.py` onto
`torch.distributed`, one process a device (NCCL on CUDA, gloo on the CPU).
The layout (`ShardedEmbeddingLayout` and the placement helpers) is the JAX
package's numpy arithmetic, copied, so that both packages place every table
row on the same shard at the same offset and a JAX pool converts to the
port's shards one to one (`convert.params_from_jax`).

Table i (or, with row splits, each row range of it) lives on one shard, its
owner. Each rank holds its shard's pool, [R_pad, D] (the JAX package keeps
the global [N, R_pad, D], or [N, P, 128] packed; the port never packs). The
embedding -> interaction boundary is an explicit exchange, two
`all_to_all_single` calls a lookup:

  1. index exchange  : int32 [B_loc, N*t_max, H] -> [N*B_loc, t_max, H]
  2. pooled exchange : pool dtype [N*B_loc, t_max, D] -> [B_loc, N*t_max, D]

and two for the sparse update: the indices again, and the pooled gradients
to the owners, where each shard's rows are updated in place
(`local_pool_row_update`: the row-update kernel's rules on the kernel route,
the optimizer's scatter rule otherwise). No dense table gradient exists.

A split table's slots each pool their row range's lookups (the others ride
as -1 padding) and the table's output is the f32 sum of its slots' partials
(exact for SUM pooling, the only pooling splits allow). With
`chips_per_host` C the pooled exchange is hierarchical, both ways: an
all-to-all inside each "host" of C ranks, the co-hosted slots of a table
combined in f32, then an all-to-all across hosts that carries one partial a
(host, table); the subgroups are made once, by `Mesh.subgroup` on every
rank. A degenerate C (1, not dividing N, or N itself) falls back to the
flat exchange, as the JAX package does.

The shards are the mesh's data indices: on a 2-D ("data", "model") mesh
every exchange runs over this rank's data group (`Mesh.data_group`, the
ranks of its model index), the hierarchical groups are the layout's
blocks of data indices taken at every model index (`Mesh.data_subgroup`),
and the ranks of one data index hold the same shard.

All functions here run outside autograd: the train step looks the
collection up without gradients and differentiates its pooled outputs
(core/ffmodel.py). Indices travel as int32, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ffconst import AggrMode
from ..ops.embedding import embedding_bag


def round_robin_assignment(num_tables: int, num_shards: int) -> List[int]:
    """Table i -> shard i % N (the reference's DLRM strategy)."""
    return [i % num_shards for i in range(num_tables)]


def greedy_assignment(vocab_sizes: Sequence[int], num_shards: int) -> List[int]:
    """Memory-balancing placement: the biggest table to the least-loaded
    shard."""
    owner = [0] * len(vocab_sizes)
    load = [0] * num_shards
    for i in sorted(range(len(vocab_sizes)), key=lambda i: -vocab_sizes[i]):
        s = int(np.argmin(load))
        owner[i] = s
        load[s] += vocab_sizes[i]
    return owner


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def expand_subtables(
    vocab_sizes: Sequence[int], split: Optional[Sequence[int]]
) -> List[Tuple[int, int, int]]:
    """[(table, row_start, row_len)], one entry a sub-table."""
    subs = []
    for t, v in enumerate(vocab_sizes):
        s = 1 if split is None else max(1, int(split[t]))
        chunk = -(-v // s)
        for k in range(s):
            start = k * chunk
            if start >= v:
                break
            subs.append((t, start, min(chunk, v - start)))
    return subs


@dataclasses.dataclass
class ShardedEmbeddingLayout:
    """Static layout of (vocab_sizes, dim, owner per sub-table[, split]);
    the JAX package's class, field for field.

    `packed_pool`: the shard's update takes the row-update kernel route
    (set by compile); r_pad then keeps the JAX package's packed-pool chunk
    alignment, so a JAX pool of the same layout converts 1:1."""

    vocab_sizes: List[int]
    dim: int
    num_shards: int
    owner: List[int]
    split: Optional[List[int]] = None
    # hierarchical exchange: shards [h*C, (h+1)*C) form host h; None, or a
    # C that does not divide num_shards: the flat exchange
    chips_per_host: Optional[int] = None
    exchange: str = "dense"
    routed_cap_factor: float = 2.0
    packed_pool: bool = False
    pool_chunk_packs: int = 2048
    # hash-permuted row placement: logical row r of table t lives at
    # position (a_t * r + b_t) mod vocab_t
    hash_rows: bool = False
    # derived
    t_max: int = 0  # max sub-tables a shard (exchange slots a shard)
    r_pad: int = 0  # padded rows a shard
    subs: Optional[List[Tuple[int, int, int]]] = None  # (table, start, len)
    row_offset: Optional[np.ndarray] = None  # [S] row offset in the owner's pool
    slot_sub: Optional[np.ndarray] = None  # [N*t_max] sub id or -1
    slot_tid: Optional[np.ndarray] = None  # [N*t_max] table id
    slot_start: Optional[np.ndarray] = None  # [N*t_max] row-range start
    slot_len: Optional[np.ndarray] = None  # [N*t_max] row-range length
    slot_offset_arr: Optional[np.ndarray] = None  # [N*t_max] pool offset
    # hierarchical derived (None unless hierarchical)
    th_max: int = 0  # max distinct tables a host
    host_tables: Optional[List[List[int]]] = None  # [H][<=th_max] table ids
    sel_host: Optional[np.ndarray] = None  # [H, C*t_max, th_max] slot -> host-table
    sel_global: Optional[np.ndarray] = None  # [H*th_max, T] host-table -> table

    def __post_init__(self):
        n = self.num_shards
        self.subs = expand_subtables(self.vocab_sizes, self.split)
        if len(self.owner) != len(self.subs):
            raise ValueError(f"owner must be per sub-table: {len(self.owner)} vs {len(self.subs)}")
        per_shard: List[List[int]] = [[] for _ in range(n)]
        for i, _ in enumerate(self.subs):
            per_shard[self.owner[i]].append(i)
        self.t_max = max(1, max(len(g) for g in per_shard))
        self.row_offset = np.zeros(len(self.subs), np.int64)
        rows = []
        nslot = n * self.t_max
        self.slot_sub = -np.ones(nslot, np.int64)
        self.slot_tid = np.zeros(nslot, np.int64)
        self.slot_start = np.zeros(nslot, np.int64)
        self.slot_len = np.zeros(nslot, np.int64)
        self.slot_offset_arr = np.zeros(nslot, np.int64)
        for s, group in enumerate(per_shard):
            off = 0
            for k, i in enumerate(group):
                t, start, length = self.subs[i]
                self.row_offset[i] = off
                slot = s * self.t_max + k
                self.slot_sub[slot] = i
                self.slot_tid[slot] = t
                self.slot_start[slot] = start
                self.slot_len[slot] = length
                self.slot_offset_arr[slot] = off
                off += length
            rows.append(off)
        self.r_pad = _round_up(max(max(rows), 1), 8)
        if self.packed_pool and 128 % self.dim != 0:
            self.packed_pool = False  # the JAX package's packed layout needs D | 128
        if self.packed_pool:
            rows_per_chunk = self.pool_chunk_packs * 128 // self.dim
            self.r_pad = _round_up(self.r_pad, rows_per_chunk)
        self._phys_chips_per_host = self.chips_per_host
        if self.chips_per_host is not None and (
            self.chips_per_host <= 1 or n % self.chips_per_host != 0 or n == self.chips_per_host
        ):
            self.chips_per_host = None  # degenerate: flat exchange
        if self.chips_per_host is not None:
            c = self.chips_per_host
            h_n = n // c
            self.host_tables = []
            for h in range(h_n):
                seen: List[int] = []
                for slot in range(h * c * self.t_max, (h + 1) * c * self.t_max):
                    if self.slot_sub[slot] >= 0:
                        t = int(self.slot_tid[slot])
                        if t not in seen:
                            seen.append(t)
                self.host_tables.append(seen)
            self.th_max = max(1, max(len(g) for g in self.host_tables))
            self.sel_host = np.zeros((h_n, c * self.t_max, self.th_max), np.float32)
            self.sel_global = np.zeros((h_n * self.th_max, self.num_tables), np.float32)
            for h in range(h_n):
                pos = {t: j for j, t in enumerate(self.host_tables[h])}
                for p in range(c * self.t_max):
                    slot = h * c * self.t_max + p
                    if self.slot_sub[slot] >= 0:
                        self.sel_host[h, p, pos[int(self.slot_tid[slot])]] = 1.0
                for t, j in pos.items():
                    self.sel_global[h * self.th_max + j, t] = 1.0

    # ---- hash-permuted row placement ---------------------------------------
    def _hash_consts(self):
        """Per-table affine bijection (a, b) on [0, vocab), gcd(a, vocab) = 1."""
        a_l, b_l = [], []
        for v in self.vocab_sizes:
            a = max(1, int(0.6180339887 * v)) | 1
            while math.gcd(a, v) != 1:
                a += 2
            a_l.append(a % max(v, 1))
            b_l.append(0x9E37 % max(v, 1))
        return np.asarray(a_l, np.int64), np.asarray(b_l, np.int64)

    def perm_rows(self, idx: torch.Tensor, table_axis: int = 1) -> torch.Tensor:
        """The row permutation of an index tensor [..., T, ...]: the JAX
        package's bijection (a * r + b) mod v, taken in int64 (r, a < v <
        2^31, so the product stays below 2^62). Identity when hash_rows is
        off; indices < 0 or >= vocab pass through."""
        if not self.hash_rows:
            return idx
        shape = [1] * idx.dim()
        shape[table_axis] = self.num_tables
        c = device_consts(self, idx.device)
        a, b, vocab = (c[k].reshape(shape) for k in ("hash_a", "hash_b", "vocab"))
        invalid = (idx < 0) | (idx >= vocab)
        r = torch.where(invalid, 0, idx).long()
        return torch.where(invalid, idx, ((r * a + b) % vocab.clamp_min(1)).to(idx.dtype))

    def perm_table_np(self, t: int) -> np.ndarray:
        """positions[r] = permuted row of logical row r."""
        v = self.vocab_sizes[t]
        if not self.hash_rows:
            return np.arange(v, dtype=np.int64)
        a, b = self._hash_consts()
        return (np.arange(v, dtype=np.int64) * a[t] + b[t]) % v

    @property
    def hierarchical(self) -> bool:
        return self.chips_per_host is not None

    @property
    def num_hosts(self) -> int:
        return self.num_shards // self.chips_per_host if self.hierarchical else 1

    def _host_groups(self):
        """[[shards of host 0], ...]: the intra-host all-to-all groups."""
        c = self.chips_per_host
        return [list(range(h * c, (h + 1) * c)) for h in range(self.num_hosts)]

    def _cross_host_groups(self):
        """[[chip c of every host], ...]: the cross-host all-to-all groups."""
        c = self.chips_per_host
        return [[h * c + j for h in range(self.num_hosts)] for j in range(c)]

    @property
    def num_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def has_splits(self) -> bool:
        return self.split is not None and any(s > 1 for s in self.split)

    def param_shape(self):
        """The JAX package's global parameter shape."""
        if self.packed_pool:
            return (self.num_shards, self.pool_packs, 128)
        return (self.num_shards, self.r_pad, self.dim)

    @property
    def pool_packs(self) -> int:
        return self.r_pad * self.dim // 128

    def hbm_bytes_per_shard(self, dtype_bytes: int = 4) -> int:
        return self.r_pad * self.dim * dtype_bytes

    # ---- exchange volumes ---------------------------------------------------
    def pooled_exchange_bytes(self, global_batch: int, dtype_bytes: int = 4) -> int:
        """Bytes that leave their rank in one pooled all-to-all (each shard
        keeps 1/N)."""
        n = self.num_shards
        total = global_batch * n * self.t_max * self.dim * dtype_bytes
        return total * (n - 1) // n

    def dcn_pooled_exchange_bytes(self, global_batch: int, dtype_bytes: int = 4) -> int:
        """Bytes of the pooled exchange that cross hosts: (N - C) / N of
        the slots' rows flat; one partial a (host, table), (H - 1) / H of
        the time, hierarchical."""
        n = self.num_shards
        if not self.hierarchical:
            c = self._phys_chips_per_host or 1
            if n % c != 0:
                c = 1
            total = global_batch * n * self.t_max * self.dim * dtype_bytes
            return total * (n - c) // n
        h = self.num_hosts
        total = global_batch * h * self.th_max * self.dim * dtype_bytes
        return total * (h - 1) // h

    def step_exchange_bytes(self, global_batch: int, bag: int = 1, dtype_bytes: int = 4) -> int:
        """Interconnect bytes of one training step's exchange, the JAX
        package's count (fwd + bwd: three pooled exchanges and two index
        exchanges; the routed mode's buckets for exchange == "routed")."""
        n = self.num_shards
        if self.exchange == "routed":
            total = 0
            split = self.split or [1] * self.num_tables
            for t in range(self.num_tables):
                s = max(1, split[t])
                cap = 1.0 if (s == 1 or self.routed_cap_factor <= 0) else self.routed_cap_factor
                entries = global_batch * bag * cap
                total += int(entries * (2 * 4 + 2 * self.dim * dtype_bytes))
            return total * (n - 1) // n
        idx_bytes = 4 * global_batch * n * self.t_max * bag * (n - 1) // n
        return 3 * self.pooled_exchange_bytes(global_batch, dtype_bytes) + 2 * idx_bytes

    def _inv_positions(self, t: int, start: int, length: int) -> np.ndarray:
        """Logical rows living at permuted positions [start, start+len)."""
        v = self.vocab_sizes[t]
        pos = np.arange(start, start + length, dtype=np.int64)
        if not self.hash_rows:
            return pos
        a, b = self._hash_consts()
        ainv = pow(int(a[t]), -1, v)
        return ((pos - b[t]) * ainv) % v

    # ---- parameters ---------------------------------------------------------
    def table_bases(self) -> np.ndarray:
        """[T] each table's first row in the flat [N * R_pad, D] pool (no
        splits)."""
        if self.has_splits:
            raise ValueError("a row-split layout has no flat pool: it needs a mesh")
        return np.asarray([self.owner[i] * self.r_pad + int(self.row_offset[i])
                           for i in range(self.num_tables)], np.int64)

    def init_pool(self, make_table, shard: Optional[int], device, dtype=torch.float32) -> torch.Tensor:
        """The pool of `shard` ([R_pad, D]), or of every shard ([N * R_pad,
        D]) when `shard` is None. `make_table(t)` gives table t as one
        standalone [vocab, D] table, drawn the same whatever the layout (so
        neither the placement nor a split changes a table's rows, as in the
        JAX package's `init_params`); only the tables with a row range on
        `shard` are made."""
        shards = range(self.num_shards) if shard is None else [shard]
        pool = torch.zeros((len(shards) * self.r_pad, self.dim), dtype=dtype, device=device)
        for t in range(self.num_tables):
            mine = [i for i, (tt, _, _) in enumerate(self.subs) if tt == t and self.owner[i] in shards]
            if not mine:
                continue
            table = make_table(t)
            for i in mine:
                _, start, length = self.subs[i]
                off = (self.owner[i] if shard is None else 0) * self.r_pad + int(self.row_offset[i])
                pos = torch.as_tensor(self._inv_positions(t, start, length), device=device)
                pool[off:off + length] = table[pos].to(dtype)
            del table
        return pool

    def extract_table(self, pool, t: int):
        """Table t as [vocab, D] in logical row order, from the global pool
        [N, R_pad, D] (or [N * R_pad, D]; numpy or torch)."""
        pool = pool.reshape(self.num_shards, self.r_pad, self.dim)
        parts = [pool[self.owner[i], int(self.row_offset[i]):int(self.row_offset[i]) + length]
                 for i, (tt, _, length) in enumerate(self.subs) if tt == t]
        if isinstance(pool, torch.Tensor):
            full = torch.cat(parts)
            return full[torch.as_tensor(self.perm_table_np(t), device=full.device)] if self.hash_rows else full
        full = np.concatenate(parts)
        return full[self.perm_table_np(t)] if self.hash_rows else full

    def table_select_matrix(self) -> np.ndarray:
        """[n_slots, T] 0/1: slot s contributes to table slot_tid[s]."""
        nslot = self.num_shards * self.t_max
        sel = np.zeros((nslot, self.num_tables), np.float32)
        for s in range(nslot):
            if self.slot_sub[s] >= 0:
                sel[s, int(self.slot_tid[s])] = 1.0
        return sel


# ------------------------------------------------------------------ the exchange


def _a2a(x: torch.Tensor, group=None) -> torch.Tensor:
    """all_to_all_single over dim 0 in equal chunks: chunk j goes to the
    group's j-th rank, and chunk j of the result came from it."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _check(layout: ShardedEmbeddingLayout, mesh, aggr: AggrMode) -> None:
    if layout.num_shards != mesh.data_size:
        raise ValueError(f"the layout has {layout.num_shards} shards, the mesh's data axis {mesh.data_size}")
    if layout.has_splits and aggr is not AggrMode.AGGR_MODE_SUM:
        raise ValueError("row-split tables need SUM pooling (per-slot partials sum exactly; "
                         "AVG counts would need a second exchange)")


def device_consts(layout: ShardedEmbeddingLayout, device) -> dict:
    """The layout's static arrays on `device`, made once a device (the
    layout is fixed once built), so that a step copies nothing from the
    host and a CUDA graph can capture it: the slot arrays, each table's
    slot where no table is split, the 0/1 selection matrices, the hash
    constants and vocabs (`perm_rows`), and each table's first row in the
    flat pool (`table_bases`, None with splits)."""
    cache = layout.__dict__.setdefault("_device_consts", {})
    key = str(torch.device(device))
    if key not in cache:
        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        out_slot = np.zeros(layout.num_tables, np.int64)
        for slot in np.nonzero(layout.slot_sub >= 0)[0]:
            out_slot[int(layout.slot_tid[slot])] = slot
        hash_a, hash_b = layout._hash_consts()
        cache[key] = {
            "hash_a": t(hash_a), "hash_b": t(hash_b), "vocab": t(layout.vocab_sizes),
            "bases": None if layout.has_splits else t(layout.table_bases()),
            "is_real": t(layout.slot_sub) >= 0, "tid": t(layout.slot_tid), "start": t(layout.slot_start),
            "len": t(layout.slot_len), "off": t(layout.slot_offset_arr), "out_slot": t(out_slot),
            "sel": t(layout.table_select_matrix(), torch.float32),
            "sel_host": None if layout.sel_host is None else t(layout.sel_host, torch.float32),
            "sel_global": None if layout.sel_global is None else t(layout.sel_global, torch.float32),
        }
    return cache[key]


def _expand_by_slot(layout: ShardedEmbeddingLayout, idx_local: torch.Tensor) -> torch.Tensor:
    """idx_local [B_loc, T, H] -> [B_loc, N*t_max, H]: a slot's table's
    indices remapped into its sub-table's pool rows; indices outside the
    slot's row range, padding and dead slots become -1."""
    c = device_consts(layout, idx_local.device)
    g = idx_local[:, c["tid"]]  # [B_loc, S, H]
    s, ln, o = c["start"][None, :, None], c["len"][None, :, None], c["off"][None, :, None]
    keep = (g >= s) & (g < s + ln) & c["is_real"][None, :, None]
    return torch.where(keep, g - s + o, -1)


def _exchange_indices(layout, idx: torch.Tensor, group=None) -> torch.Tensor:
    """Each owner's slots' indices from every rank of the data group:
    [B_loc, T, H] -> [N*B_loc, t_max, H] int64, rows in global batch
    order."""
    n, t_max = layout.num_shards, layout.t_max
    b_loc, _, h = idx.shape
    by_owner = _expand_by_slot(layout, idx).to(torch.int32)  # [B_loc, N*t_max, H]
    send = by_owner.reshape(b_loc, n, t_max, h).permute(1, 0, 2, 3)
    return _a2a(send, group).reshape(n * b_loc, t_max, h).long()


@torch.no_grad()
def sharded_embedding_lookup(
    layout: ShardedEmbeddingLayout,
    pool: torch.Tensor,
    indices: torch.Tensor,
    mesh,
    aggr: AggrMode = AggrMode.AGGR_MODE_SUM,
) -> torch.Tensor:
    """The sharded fused lookup on every rank: `pool` this rank's shard
    [R_pad, D], `indices` its slice of the batch [B_loc, T, H] (per-table
    indices, -1 padding). Returns the rank's pooled embeddings [B_loc, T,
    D] in the pool's dtype."""
    _check(layout, mesh, aggr)
    idx = layout.perm_rows(indices.long())
    n, t_max, d = layout.num_shards, layout.t_max, layout.dim
    b_loc, _, h = idx.shape
    sent = _exchange_indices(layout, idx, mesh.data_group())  # [nb, t_max, H]
    nb = n * b_loc
    pooled = embedding_bag(pool, sent.reshape(nb * t_max, h), aggr).reshape(nb, t_max, d)
    if layout.hierarchical:
        return _hierarchical_lookup_tail(layout, pooled, mesh, b_loc)
    back = _a2a(pooled, mesh.data_group()).reshape(n, b_loc, t_max, d).permute(1, 0, 2, 3).reshape(b_loc, n * t_max, d)
    c = device_consts(layout, back.device)
    if not layout.has_splits:
        return back[:, c["out_slot"]]  # one slot a table: a gather
    return torch.einsum("bsd,st->btd", back.float(), c["sel"]).to(back.dtype)


def _hierarchical_lookup_tail(layout, pooled: torch.Tensor, mesh, b_loc: int) -> torch.Tensor:
    """pooled [N*B_loc, t_max, D] (global batch blocks) -> [B_loc, T, D]:
    an intra-host all-to-all, co-hosted slots of a table combined in f32, a
    cross-host all-to-all of one partial a (host, table), the tables'
    sums."""
    hosts, c = layout.num_hosts, layout.chips_per_host
    t_max, d, th = layout.t_max, layout.dim, layout.th_max
    nb = hosts * c * b_loc
    # block c*H + h of the new order is block h*C + c of the batch, so the
    # chip split then the host split lands every rank its own block
    p = pooled.reshape(hosts, c, b_loc, t_max, d).transpose(0, 1).reshape(nb, t_max, d)
    intra = _a2a(p, mesh.data_subgroup(layout._host_groups()))  # [C(src), nb/C, t_max, D]
    intra = intra.reshape(c, nb // c, t_max, d).transpose(0, 1).reshape(nb // c, c * t_max, d)
    consts = device_consts(layout, p.device)
    sel1 = consts["sel_host"][mesh.data_index // c]
    part = torch.einsum("bsd,st->btd", intra.float(), sel1).to(pooled.dtype)  # [nb/C, th, D]
    inter = _a2a(part, mesh.data_subgroup(layout._cross_host_groups()))  # [H(src), B_loc, th, D]
    inter = inter.reshape(hosts, b_loc, th, d).transpose(0, 1).reshape(b_loc, hosts * th, d)
    return torch.einsum("bsd,st->btd", inter.float(), consts["sel_global"]).to(pooled.dtype)


def _hierarchical_grads(layout, g_local: torch.Tensor, mesh) -> torch.Tensor:
    """The backward mirror of `_hierarchical_lookup_tail`: g_local [B_loc,
    T, D] -> each owner slot's pooled gradient [N*B_loc, t_max, D] in
    global batch order; a table's gradient crosses hosts once a host."""
    hosts, c = layout.num_hosts, layout.chips_per_host
    t_max, d, th = layout.t_max, layout.dim, layout.th_max
    b_loc = g_local.shape[0]
    consts = device_consts(layout, g_local.device)
    # 0/1 gathers, no sums: the wire keeps the gradient's dtype
    # [B_loc, H*th, D]
    g_ht = torch.einsum("btd,st->bsd", g_local.float(), consts["sel_global"]).to(g_local.dtype)
    send = g_ht.reshape(b_loc, hosts, th, d).transpose(0, 1)
    inter = _a2a(send, mesh.data_subgroup(layout._cross_host_groups())).reshape(hosts * b_loc, th, d)
    sel1 = consts["sel_host"][mesh.data_index // c]
    expanded = torch.einsum("btd,st->bsd", inter.float(), sel1).to(g_local.dtype)  # [H*B_loc, C*t_max, D]
    send = expanded.reshape(hosts * b_loc, c, t_max, d).transpose(0, 1)
    intra = _a2a(send, mesh.data_subgroup(layout._host_groups()))  # [C(src), H*B_loc, t_max, D]
    return (intra.reshape(c, hosts, b_loc, t_max, d).transpose(0, 1)
            .reshape(hosts * c * b_loc, t_max, d))


def local_pool_row_update(layout: ShardedEmbeddingLayout, pool: torch.Tensor, sstate, rows,
                          payload, optimizer, lr=None):
    """One shard's row update, in place: `rows` [K] (>= R_pad dropped),
    `payload` (src [K / h, D] f32, h), entry k's gradient src[k // h].
    On the kernel route (`layout.packed_pool`) the row-update kernel's rule
    for the optimizer (its plain version on the CPU); otherwise the
    optimizer's scatter rule. Returns the slot state."""
    from ..training.sparse_engine import kernel_route_update

    if layout.packed_pool:
        kernel_route_update(optimizer, [pool], [sstate], [rows], [payload], lr)
        return sstate
    src, h = payload
    grads = src if h == 1 else src[:, None, :].expand(src.shape[0], h, src.shape[1]).reshape(-1, src.shape[1])
    return optimizer.sparse_row_update(pool, sstate, rows, grads, lr=lr)


@torch.no_grad()
def sharded_embedding_sparse_update(
    layout: ShardedEmbeddingLayout,
    pool: torch.Tensor,
    sstate,
    indices: torch.Tensor,
    g_pooled: torch.Tensor,
    mesh,
    optimizer,
    aggr: AggrMode = AggrMode.AGGR_MODE_SUM,
    lr=None,
):
    """The backward of `sharded_embedding_lookup` with the optimizer in it,
    on every rank: the indices exchanged again, the pooled gradients
    `g_pooled` [B_loc, T, D] sent to the owners (one all-to-all, flat or
    hierarchical), expanded over the bag members (AVG divides by the
    member count), and this rank's shard rows updated in place. Returns
    the shard's slot state."""
    _check(layout, mesh, aggr)
    idx = layout.perm_rows(indices.long())
    n, t_max, d = layout.num_shards, layout.t_max, layout.dim
    b_loc, _, h = idx.shape
    sent_idx = _exchange_indices(layout, idx, mesh.data_group())  # [nb, t_max, H]
    nb = n * b_loc
    if layout.hierarchical:
        sent_g = _hierarchical_grads(layout, g_pooled, mesh)
    else:
        c = device_consts(layout, g_pooled.device)
        # each slot receives its table's pooled gradient (its row range's
        # lookups use it; the others are padding and drop)
        g_by_slot = torch.where(c["is_real"][None, :, None], g_pooled[:, c["tid"]], 0)
        send = g_by_slot.reshape(b_loc, n, t_max, d).permute(1, 0, 2, 3)
        sent_g = _a2a(send, mesh.data_group()).reshape(nb, t_max, d)
    valid = sent_idx >= 0
    g = sent_g.float()
    if aggr is AggrMode.AGGR_MODE_AVG:
        g = g / valid.sum(dim=2, keepdim=True).clamp_min(1).to(g.dtype)
    rows = torch.where(valid, sent_idx, layout.r_pad).reshape(nb * t_max * h)
    return local_pool_row_update(layout, pool, sstate, rows, (g.reshape(nb * t_max, d).contiguous(), h),
                                 optimizer, lr=lr)
