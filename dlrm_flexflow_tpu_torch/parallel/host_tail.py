"""Host-tail embedding offload: tables beyond the card's memory.

The port's own copy of `dlrm_flexflow_tpu/parallel/host_tail.py` (numpy
only, no JAX), with the same arithmetic in the same order, so a store made
from one seed holds the same rows bit for bit in both packages. A huge
table keeps its hot row prefix on the device; the cold tail rows [hot,
vocab) live in a demand-allocated host store, and each step exchanges a
compact, capacity-capped sparse message:

  fwd : the host looks up the batch's tail rows and ships (pos [K_cap]
        int32, val [K_cap, D]); the device embedding op adds val into its
        pooled output at pos (exact for SUM pooling: each lookup's row
        lives on one side only)
  bwd : d(loss)/d(val) is the pooled-output gradient gathered at pos
        (computed on the sparse path anyway); the host applies the tail
        rows' updates

Rows materialize on first touch with a deterministic per-row init
(`_splitmix64` of (seed, row)), so host memory grows with the rows the
data touches, not with the vocab; untouched rows read their init values,
so training means the same as with one dense [vocab, D] table. A batch
with more tail lookups than K_cap drops the excess (example-major, the
order of `np.nonzero`), counted in `HostTailRuntime.dropped`
(`FFModel.host_tail_dropped`).

Under a data axis above 1 every rank keeps a replica of each store (one
seed, so the same rows) and runs the global batch's host half, as the JAX
package's single controller does: the same partials, drops, counters and
updates on every rank. A rank stages only its block of the partials
(`rank_block`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic per-key hash (uint64 -> uint64)."""
    z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def rank_block(pos: np.ndarray, val: np.ndarray, batch: int, rank: int, size: int) -> tuple:
    """This rank's block of a global batch's tail partials: (pos [K_cap]
    int32, val [K_cap, D]) of `build_feeds` for a global batch of `batch`
    examples, of which rank `rank` of `size` holds the contiguous slice
    [rank * b, (rank + 1) * b), b = batch / size (`Mesh.batch_slice`). The
    filled slots come first, their pos ascending (row-major `np.nonzero`),
    so the slice's partials are one contiguous run of them; they come first
    in the block with pos shifted by the slice start, and every other slot
    has pos b, which `add_tail_partials` drops, and a zero val. No slot of
    the block points outside [0, b]: the device clamps pos to [0, b], so a
    partial of another slice would land on a row of this one."""
    b = batch // size
    pos = np.asarray(pos)
    filled = int(np.count_nonzero(pos < batch))
    lo, hi = np.searchsorted(pos[:filled], [rank * b, (rank + 1) * b])
    out_pos = np.full(pos.shape, b, np.int32)
    out_val = np.zeros_like(val)
    out_pos[:hi - lo] = pos[lo:hi] - rank * b
    out_val[:hi - lo] = val[lo:hi]
    return out_pos, out_val


class HostTailStore:
    """Demand-allocated [vocab, D] tail rows (rows >= hot of one table).

    Rows materialize in a growable arena on first touch, initialized
    deterministically from (seed, row) — semantically a dense table of
    uniform(-scale, scale) rows, stored O(touched)."""

    def __init__(self, dim: int, scale: float, seed: int = 0,
                 initial_capacity: int = 1024, acc_init: float = 0.0):
        self.dim = int(dim)
        self.scale = float(scale)
        self.seed = int(seed)
        self.acc_init = float(acc_init)
        self._slot: Dict[int, int] = {}
        self._arena = np.zeros((initial_capacity, dim), np.float32)
        # per-row optimizer state (row-wise AdaGrad accumulator), grown
        # with the arena; plain SGD leaves it untouched
        self._acc = np.full(initial_capacity, acc_init, np.float32)
        self._n = 0

    @property
    def touched_rows(self) -> int:
        return self._n

    def _init_rows(self, rows: np.ndarray) -> np.ndarray:
        """Deterministic init values for absolute row ids [K] -> [K, D]."""
        k = rows.shape[0]
        base = _splitmix64(
            rows.astype(np.uint64) * np.uint64(1 << 32)
            + np.uint64(self.seed)
        )
        lanes = np.arange(self.dim, dtype=np.uint64)[None, :]
        h = _splitmix64(base[:, None] + lanes)
        u = (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
        return ((u * 2.0 - 1.0) * self.scale).astype(np.float32)

    def _slots_for(self, rows: np.ndarray, create: bool) -> np.ndarray:
        """Arena slots for absolute row ids; -1 for untouched when not
        creating."""
        out = np.empty(rows.shape[0], np.int64)
        new_rows = []
        for i, r in enumerate(rows.tolist()):
            s = self._slot.get(r, -1)
            if s < 0 and create:
                s = self._n
                self._slot[r] = s
                self._n += 1
                new_rows.append((i, r))
            out[i] = s
        if new_rows:
            while self._n > self._arena.shape[0]:
                self._arena = np.concatenate(
                    [self._arena, np.zeros_like(self._arena)], axis=0
                )
                self._acc = np.concatenate(
                    [self._acc,
                     np.full_like(self._acc, self.acc_init)], axis=0
                )
            idxs = np.asarray([r for (_, r) in new_rows], np.int64)
            slots = np.asarray([self._slot[int(r)] for r in idxs], np.int64)
            self._arena[slots] = self._init_rows(idxs)
        return out

    def lookup(self, rows: np.ndarray, create: bool = True) -> np.ndarray:
        """Absolute row ids [K] -> [K, D] f32. `create` touch-allocates
        (training); eval/serving reads untouched rows' init values without
        inserting them (no arena growth from eval-only ids)."""
        rows = np.asarray(rows, np.int64)
        uniq, inv = np.unique(rows, return_inverse=True)
        slots = self._slots_for(uniq, create=create)
        if create:
            return self._arena[slots][inv]
        out = np.empty((uniq.shape[0], self.dim), np.float32)
        hit = slots >= 0
        if hit.any():
            out[hit] = self._arena[slots[hit]]
        if (~hit).any():
            out[~hit] = self._init_rows(uniq[~hit])
        return out[inv]

    def scatter_add(self, rows: np.ndarray, deltas: np.ndarray) -> None:
        """Duplicate-safe row accumulation (the host half of the sparse
        update; mirrors the device scatter's SUM-pooling semantics)."""
        rows = np.asarray(rows, np.int64)
        uniq, inv = np.unique(rows, return_inverse=True)
        slots = self._slots_for(uniq, create=True)
        acc = np.zeros((uniq.shape[0], self.dim), np.float32)
        np.add.at(acc, inv, np.asarray(deltas, np.float32))
        self._arena[slots] += acc

    def rowwise_adagrad_step(self, rows: np.ndarray, grads: np.ndarray,
                             lr: float, epsilon: float) -> None:
        """Row-wise AdaGrad on tail rows, mirroring the device rule
        (training/optimizer.py RowWiseAdagradOptimizer.sparse_row_update):
        acc[r] += sum over duplicate occurrences of mean(g_k^2);
        w[r] -= lr * rsqrt(acc_new + eps) * G_r (summed duplicate grads,
        one post-update scale per row)."""
        rows = np.asarray(rows, np.int64)
        g = np.asarray(grads, np.float32)
        uniq, inv = np.unique(rows, return_inverse=True)
        slots = self._slots_for(uniq, create=True)
        gsq = np.zeros(uniq.shape[0], np.float32)
        np.add.at(gsq, inv, np.mean(np.square(g), axis=-1))
        self._acc[slots] += gsq
        G = np.zeros((uniq.shape[0], self.dim), np.float32)
        np.add.at(G, inv, g)
        scale = lr / np.sqrt(self._acc[slots] + epsilon)
        self._arena[slots] -= scale[:, None] * G

    # ---- checkpoint ---------------------------------------------------------
    def state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows = np.fromiter(self._slot.keys(), np.int64, len(self._slot))
        slots = np.fromiter(self._slot.values(), np.int64, len(self._slot))
        order = np.argsort(rows)
        return (rows[order], self._arena[slots[order]].copy(),
                self._acc[slots[order]].copy())

    def load_state(self, rows: np.ndarray, values: np.ndarray,
                   acc: Optional[np.ndarray] = None) -> None:
        self._slot = {int(r): i for i, r in enumerate(np.asarray(rows))}
        self._n = len(self._slot)
        cap = max(1024, self._n)
        self._arena = np.zeros((cap, self.dim), np.float32)
        self._arena[: self._n] = np.asarray(values, np.float32)
        self._acc = np.full(cap, self.acc_init, np.float32)
        if acc is not None:
            self._acc[: self._n] = np.asarray(acc, np.float32)


class HostTailRuntime:
    """Per-model host side of the tail exchange: builds the compact
    (pos, val) feeds before each step and applies the returned gradients.

    One entry per offloaded embedding op; `hot` is the device-resident
    prefix length, `k_cap` the static exchange capacity."""

    def __init__(self, rule: str = "sgd", epsilon: float = 1e-10):
        # op name -> (store, sparse_feed_name, hot, full_vocab, k_cap)
        self.entries: Dict[str, Tuple[HostTailStore, str, int, int, int]] = {}
        # op name -> miss rows of the LAST prepared batch (for the update)
        self._pending: Dict[str, np.ndarray] = {}
        self.dropped = 0  # lifetime dropped tail lookups (capacity overflow)
        self.total = 0  # lifetime tail lookups
        # tail-row update rule, matched to the model's sparse optimizer at
        # compile: "sgd" (plain -lr*g) or "rowwise_adagrad"
        self.rule = rule
        self.epsilon = epsilon

    def add(self, op_name: str, store: HostTailStore, sparse_feed: str,
            hot: int, full: int, k_cap: int) -> None:
        self.entries[op_name] = (store, sparse_feed, hot, full, k_cap)

    def feed_names(self, op_name: str) -> Tuple[str, str]:
        return f"_hosttail:{op_name}:pos", f"_hosttail:{op_name}:val"

    def build_feeds(self, feeds: Dict[str, np.ndarray],
                    train: bool = True) -> Dict[str, np.ndarray]:
        """Compute tail partial feeds for one batch. When `train`, also
        records the miss rows so apply_grads can route the step's
        gradients back and counts lookups/drops; eval/serving calls
        (train=False) leave the drop counters (the TRAINING drop-rate
        observability contract) and the pending-update state untouched."""
        out = {}
        for name, (store, sfeed, hot, full, k_cap) in self.entries.items():
            idx = np.asarray(feeds[sfeed])
            if idx.ndim == 1:
                idx = idx[:, None]
            b, h = idx.shape
            # tail lookups (example, member): out-of-vocab indices DROP
            # (the dense exchange's convention) — treating them as tail
            # rows would demand-allocate host rows for garbage ids
            ex, mem = np.nonzero((idx >= hot) & (idx < full))
            rows = idx[ex, mem].astype(np.int64)
            if train:
                self.total += rows.shape[0]
            if rows.shape[0] > k_cap:
                if train:
                    self.dropped += rows.shape[0] - k_cap
                ex, rows = ex[:k_cap], rows[:k_cap]
            k = rows.shape[0]
            pos = np.full(k_cap, b, np.int32)  # b = out-of-range -> dropped
            val = np.zeros((k_cap, store.dim), np.float32)
            pos[:k] = ex
            if k:
                val[:k] = store.lookup(rows, create=train)
            if train:
                self._pending[name] = rows
            pname, vname = self.feed_names(name)
            out[pname] = pos
            out[vname] = val
        return out

    def apply_grads(self, g_vals: Dict[str, np.ndarray], lr: float) -> None:
        """g_vals: op name -> [K_cap, D] d(loss)/d(val) from the device
        step (a gather of the pooled-output grad at pos). Tail rows follow
        self.rule — plain SGD (the reference's CPU-side embedding update,
        src/ops/embedding.cc backward) or row-wise AdaGrad matching the
        device's sparse optimizer."""
        for name, g in g_vals.items():
            store = self.entries[name][0]
            rows = self._pending.get(name)
            if rows is None or rows.shape[0] == 0:
                continue
            k = rows.shape[0]
            g_k = np.asarray(g, np.float32)[:k]
            if self.rule == "rowwise_adagrad":
                store.rowwise_adagrad_step(rows, g_k, lr, self.epsilon)
            else:
                store.scatter_add(rows, -lr * g_k)

    @property
    def drop_fraction(self) -> float:
        return self.dropped / max(self.total, 1)
