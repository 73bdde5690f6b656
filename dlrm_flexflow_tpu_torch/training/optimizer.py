"""Optimizers: SGD, Adam and row-wise AdaGrad, for dense parameters and
sparse embedding rows.

PyTorch counterpart of `dlrm_flexflow_tpu/training/optimizer.py`. The JAX
package's optimizers are pure (params, state) -> (params, state) maps; here
`update` and `sparse_row_update` change the parameters and the slot state
IN PLACE (under `torch.no_grad`) and return the new state, which saves a
copy of every table and pool per step. The arithmetic is the JAX
package's, operation by operation, in f32:
  dense SGD:      w <- w - lr * (g + wd * w), with momentum and nesterov
                  (optimizer.py:114-142);
  dense Adam:     m, v moments, w <- w - alpha_t * m / (sqrt(v) + eps) with
                  the bias-corrected alpha_t of the stepped count (:192-221);
  dense AdaGrad:  one accumulator per first-dim row, += the row's mean
                  squared gradient; w <- w - lr * rsqrt(acc + eps) * g
                  (:238-264); a mid-band table's accumulator has one entry
                  per 128-lane line, as the JAX package's packed table;
and the scatter rules for embedding rows (rows < 0 or >= V dropped):
  SGD:            table[rows] += -lr * (row_grads + wd * table[rows]) (:86-97);
  lazy momentum:  per touched row, v <- mu*v + G_r (G_r: the summed
                  duplicate gradients), w -= lr * v, or lr * (G_r + mu*v)
                  with nesterov (:98-112);
  lazy Adam:      per touched row, m and v take G_r and the summed squares
                  of the occurrences, decayed once (:169-190);
  row-wise AdaGrad: acc[r] += mean_d(g^2) per occurrence, then every
                  occurrence adds -lr * rsqrt(acc[r] + eps) * g (:266-278).
Every tensor of a scatter rule is sized by the stream's length K, never by
its data (`_segments`), so that a train step captured in a CUDA graph
replays it, and every scatter-add takes its repeated rows in one fixed
order (`ops.common.index_add_rows`) while the segment rules write each
touched row once (`_assign_rows`), so that ranks that apply the same
stream to a replicated table (the model peers of a 2-D mesh) keep the
same bits.
Tables on the row-update kernel route take the kernel's own rounding
sequence instead (training/sparse_engine.py). The learning rate lives in
the state as a 0-d f32 tensor on the device, so `FFModel.set_learning_rate`
changes it without a host sync in the step. What changes from step to step
(Adam's bias correction) is read from a small f32 device buffer that the
caller fills before the step (`step_scalars`, `update(..., scalars=)`), so
that one train step captured in a CUDA graph computes, replay after replay,
what the eager step computes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.common import index_add_rows


def _rate(lr, default: float, device) -> torch.Tensor:
    if lr is None:
        lr = default
    return torch.as_tensor(lr, dtype=torch.float32, device=device)


def _segments(rows: torch.Tensor, g32: torch.Tensor, num_rows: int, squares: bool = False):
    """The duplicate rows of an update stream folded into segments, every
    tensor sized by K = len(rows), none by the data, so that a CUDA graph
    can capture it (the counterpart of `_dedup_row_grads`, optimizer.py:
    25-38, whose `jnp.unique(size=K)` is fixed-size too). One stable sort of
    the K rows, the dropped ones (< 0 or >= V) keyed V so that they sort
    last; head flags and, from their cumulative sum, each entry's segment;
    per-segment sums of g (and of g * g) in [K, D], in the stream's order;
    the row of each segment from its head (`searchsorted`).

    Returns (row, valid, src, G, Sq): `row` [K] each slot's row in [0, V),
    `valid` [K] whether slot s is a real segment (s below the segment
    count, its row kept), `src` [K] the slot whose values slot s writes
    back: itself if valid, else slot 0. A write-back that assigns
    (`index_copy_` of values[src] at row[src]) then writes each real row
    once with its own values, and a padding slot repeats slot 0's write,
    the same bits to the same row, which is race-free; a stream that drops
    every entry has no real segment, and its callers write slot 0's old
    values back unchanged. Sq is None unless `squares`. The sums add each
    segment's entries in one fixed order (`index_add_rows`); a dropped
    entry adds into its own sorted position, a slot past the real
    segments, so that dropped entries form no run of one slot (a run is
    summed in one thread on the card)."""
    k, d = rows.shape[0], g32.shape[1]
    dev = g32.device
    key = torch.where((rows >= 0) & (rows < num_rows), rows.long(), num_rows)
    skey, order = torch.sort(key, stable=True)
    head = torch.ones(k, dtype=torch.bool, device=dev)
    head[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(head, 0) - 1
    gs = g32[order]
    slots = torch.arange(k, device=dev)
    into = torch.where(skey < num_rows, seg, slots)
    vals = torch.cat([gs, gs * gs], 1) if squares else gs  # one sum for both
    sums = index_add_rows(torch.zeros((k, vals.shape[1]), dtype=torch.float32, device=dev), into, vals)
    G, Sq = (sums[:, :d], sums[:, d:]) if squares else (sums, None)
    row = skey[torch.searchsorted(seg, slots).clamp_max(k - 1)]
    valid = (slots <= seg[-1]) & (row < num_rows)
    src = torch.where(valid, slots, 0)
    return row.clamp_max(num_rows - 1), valid, src, G, Sq


def _assign_rows(pool: torch.Tensor, row, valid, src, new_rows: torch.Tensor) -> None:
    """pool[row[s]] = new_rows[s] for every real segment s, in place and
    race-free (`_segments`): slot s writes slot src[s]'s values, and a
    slot that is not a real segment keeps its row's old values."""
    old = pool[row]
    vals = torch.where(valid.reshape((-1,) + (1,) * (old.dim() - 1)), new_rows, old)
    pool.index_copy_(0, row[src], vals[src])


def _kept(rows: torch.Tensor, num_rows: int):
    """(keep, safe) of an update stream: whether each entry's row is in
    [0, num_rows), and the row each entry adds to, a dropped entry's its
    slot's index mod num_rows, where it adds exactly 0.0: dropped entries
    spread over the rows form no long run of one row, which
    `index_add_rows` would sum in one thread on the card."""
    keep = (rows >= 0) & (rows < num_rows)
    spread = torch.arange(rows.shape[0], device=rows.device) % num_rows
    return keep, torch.where(keep, rows.long(), spread)


def _decayed(table, rows, row_grads, weight_decay: float) -> torch.Tensor:
    """row_grads + wd * table[rows] (the lazy decay of the touched rows;
    duplicates decay once per occurrence), as f32."""
    g32 = row_grads.float()
    if weight_decay != 0.0:
        decay = table[rows.clamp(0, table.shape[0] - 1)]
        g32 = g32 + weight_decay * decay.float()
    return g32


class Optimizer:
    # an optimizer that can update embedding rows in place of a dense
    # table gradient sets supports_sparse (FFModel.compile reads it)
    supports_sparse: bool = False

    def init(self, params: Dict[str, Dict[str, torch.Tensor]], device) -> dict:
        raise NotImplementedError

    def step_scalars(self, step: int) -> np.ndarray:
        """The f32 numbers the update of step `step` (1 for the first) reads
        from the device, computed on the host (none by default)."""
        return np.zeros(0, np.float32)

    def update(self, grads, state: dict, params, scalars=None) -> dict:
        """Apply `grads` ({op: {key: tensor}}) to `params` in place; returns
        the new state. `scalars`: `step_scalars` of this step on the device,
        where the rule has any."""
        raise NotImplementedError

    def sparse_init(self, pool_shape, device):
        """Per-table slot state for the sparse path (None if none)."""
        return None

    def sparse_row_update(self, table, state, rows, row_grads, lr=None):
        """Row-wise update of `table` in place: `rows` [K] (< 0 or >= V are
        dropped), `row_grads` [K, D] f32; `lr` overrides the static rate.
        Returns the new slot state."""
        raise NotImplementedError


@dataclasses.dataclass
class SGDOptimizer(Optimizer):
    """reference: include/optimizer.h:37-60."""

    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    supports_sparse = True

    def init(self, params, device) -> dict:
        state = {"step": 0, "lr": _rate(None, self.lr, device)}
        if self.momentum != 0.0:
            state["v"] = {
                op: {k: torch.zeros_like(p) for k, p in sub.items()}
                for op, sub in params.items()
            }
        return state

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None) -> dict:
        lr = state["lr"]
        wd = self.weight_decay
        for op, sub in grads.items():
            for k, g in sub.items():
                w = params[op][k]
                g = g + wd * w
                if self.momentum != 0.0:
                    v = state["v"][op][k]
                    v.mul_(self.momentum).add_(g)
                    g = g + self.momentum * v if self.nesterov else v
                w.sub_(lr * g)
        return {**state, "step": state["step"] + 1}

    def sparse_init(self, pool_shape, device):
        # momentum keeps a per-element velocity, updated lazily: only
        # touched rows decay (the sparse-momentum convention)
        if self.momentum != 0.0:
            return torch.zeros(tuple(pool_shape), dtype=torch.float32, device=device)
        return None

    @torch.no_grad()
    def sparse_row_update(self, table, state, rows, row_grads, lr=None):
        rate = _rate(lr, self.lr, table.device)
        if self.momentum == 0.0:
            # one add per kept entry, as the JAX scatter adds them; a
            # dropped entry adds exactly 0.0 (`_kept`)
            keep, safe = _kept(rows, table.shape[0])
            keep = keep[:, None]
            if self.weight_decay != 0.0:
                row_grads = row_grads + self.weight_decay * table[safe]
            delta = torch.where(keep, -rate * row_grads, 0.0)
            index_add_rows(table, safe, delta.to(table.dtype))
            return state
        g32 = _decayed(table, rows, row_grads, self.weight_decay)
        row, valid, src, G, _ = _segments(rows, g32, table.shape[0])
        v2 = self.momentum * state[row] + G
        step = G + self.momentum * v2 if self.nesterov else v2
        _assign_rows(state, row, valid, src, v2)
        _assign_rows(table, row, valid, src, table[row] + (-rate * step).to(table.dtype))
        return state


@dataclasses.dataclass
class AdamOptimizer(Optimizer):
    """reference: include/optimizer.h:62-85; m/v state per parameter, alpha_t
    bias correction recomputed each step (optimizer.cc). Embedding rows
    take lazy Adam: only the rows a batch touches update their m, v and
    weight (the sparse-Adam convention)."""

    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    supports_sparse = True

    def step_scalars(self, step: int) -> np.ndarray:
        """[sqrt(1 - beta2^t), 1 - beta1^t] at t = step, in f32: the bias
        correction of step `step`."""
        t = np.float32(step)
        corr = np.sqrt(np.float32(1.0) - np.power(np.float32(self.beta2), t))
        den = np.float32(1.0) - np.power(np.float32(self.beta1), t)
        return np.array([corr, den], np.float32)

    def alpha_t(self, base, step, device) -> torch.Tensor:
        """base * sqrt(1 - beta2^t) / (1 - beta1^t) in f32, the rate of a
        step (`base` a 0-d tensor or a float, None for alpha): at t = `step`
        (an int), or from that step's `step_scalars` already on the device
        (`step` a tensor)."""
        if not isinstance(step, torch.Tensor):
            step = torch.from_numpy(self.step_scalars(step)).to(device)
        return _rate(base, self.alpha, device) * step[0] / step[1]

    def init(self, params, device) -> dict:
        return {
            "step": 0,
            "lr": _rate(None, self.alpha, device),
            "m": {op: {k: torch.zeros_like(p) for k, p in sub.items()} for op, sub in params.items()},
            "v": {op: {k: torch.zeros_like(p) for k, p in sub.items()} for op, sub in params.items()},
        }

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None) -> dict:
        """`scalars`: this step's `step_scalars` on the device; computed
        here from the state's step count (a host-to-device copy) if None."""
        step = state["step"] + 1
        alpha_t = None
        for op, sub in grads.items():
            for k, g in sub.items():
                if alpha_t is None:
                    alpha_t = self.alpha_t(state["lr"], step if scalars is None else scalars, g.device)
                w, m, v = params[op][k], state["m"][op][k], state["v"][op][k]
                g = g + self.weight_decay * w
                m.mul_(self.beta1).add_((1.0 - self.beta1) * g)
                v.mul_(self.beta2).add_((1.0 - self.beta2) * g * g)
                w.sub_(alpha_t * m / (torch.sqrt(v) + self.epsilon))
        return {**state, "step": step}

    def sparse_init(self, pool_shape, device):
        # m and v stacked on a new leading axis: [2, *pool_shape]
        return torch.zeros((2,) + tuple(pool_shape), dtype=torch.float32, device=device)

    @torch.no_grad()
    def sparse_row_update(self, table, state, rows, row_grads, lr=None):
        """`lr` must be the bias-corrected alpha_t (FFModel computes it from
        the dense state's step count); falls back to raw alpha."""
        alpha_t = _rate(lr, self.alpha, table.device)
        g32 = _decayed(table, rows, row_grads, self.weight_decay)
        m, v = state[0], state[1]
        row, valid, src, G, Sq = _segments(rows, g32, table.shape[0], squares=True)
        m2 = self.beta1 * m[row] + (1.0 - self.beta1) * G
        v2 = self.beta2 * v[row] + (1.0 - self.beta2) * Sq
        upd = alpha_t * m2 / (torch.sqrt(v2) + self.epsilon)
        _assign_rows(m, row, valid, src, m2)
        _assign_rows(v, row, valid, src, v2)
        _assign_rows(table, row, valid, src, table[row] + (-upd).to(table.dtype))
        return state


@dataclasses.dataclass
class RowWiseAdagradOptimizer(Optimizer):
    """Row-wise AdaGrad, the usual DLRM embedding optimizer: one accumulator
    scalar per table row. Dense parameters get AdaGrad with a per-row
    (first-dim) accumulator."""

    lr: float = 0.01
    epsilon: float = 1e-10
    initial_accumulator: float = 0.0

    supports_sparse = True

    def init(self, params, device, line_rows: Optional[Dict[str, int]] = None) -> dict:
        """`line_rows` {op: rows per 128-lane line} names the tables the JAX
        package stores packed [P, 128] (mid-band): its dense AdaGrad keeps
        one accumulator per line of such a table, so they get [P] here."""
        line_rows = line_rows or {}

        def acc_like(op, w):
            shape = (-(-w.shape[0] // line_rows[op]),) if op in line_rows else tuple(w.shape[:1])
            return torch.full(shape, self.initial_accumulator, dtype=torch.float32, device=device)

        return {
            "step": 0,
            "lr": _rate(None, self.lr, device),
            "acc": {op: {k: acc_like(op, p) for k, p in sub.items()} for op, sub in params.items()},
        }

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None,
               line_rows: Optional[Dict[str, int]] = None) -> dict:
        """`line_rows`: the map `init` was given."""
        lr = state["lr"]
        line_rows = line_rows or {}
        for op, sub in grads.items():
            for k, g in sub.items():
                w, a = params[op][k], state["acc"][op][k]
                g32 = g.float()
                if op in line_rows:
                    # one accumulator per 128-lane line of the row-major
                    # [V, D] table (128 // D rows)
                    v, d = g.shape
                    lines = torch.nn.functional.pad(g32.reshape(-1), (0, a.shape[0] * 128 - v * d))
                    a.add_(torch.mean((lines * lines).reshape(-1, 128), dim=1))
                    shaped = torch.rsqrt(a + self.epsilon).repeat_interleave(line_rows[op])[:v].reshape(-1, 1)
                elif g.dim() > 1:
                    a.add_(torch.mean(g32 * g32, dim=tuple(range(1, g.dim()))))
                    shaped = torch.rsqrt(a + self.epsilon).reshape((-1,) + (1,) * (g.dim() - 1))
                else:
                    a.add_(g32 * g32)
                    shaped = torch.rsqrt(a + self.epsilon)
                w.sub_(lr * shaped * g)
        return {**state, "step": state["step"] + 1}

    def sparse_init(self, pool_shape, device):
        # one accumulator per row: pool_shape[:-1]
        return torch.full(tuple(pool_shape[:-1]), self.initial_accumulator,
                          dtype=torch.float32, device=device)

    @torch.no_grad()
    def sparse_row_update(self, table, acc, rows, row_grads, lr=None):
        # per entry, as the JAX rule: a dropped entry adds exactly 0.0 to
        # the accumulator and the table (`_kept`)
        rate = _rate(lr, self.lr, table.device)
        keep, r = _kept(rows, table.shape[0])
        g32 = row_grads.float()
        index_add_rows(acc, r, torch.where(keep, torch.mean(g32 * g32, dim=-1), 0.0))
        scale = -rate * torch.rsqrt(acc[r] + self.epsilon)
        index_add_rows(table, r, torch.where(keep[:, None], scale[:, None] * g32, 0.0).to(table.dtype))
        return acc
