"""Optimizers: SGD for dense parameters and sparse embedding rows.

PyTorch counterpart of `dlrm_flexflow_tpu/training/optimizer.py`. The JAX
package's optimizers are pure (params, state) -> (params, state) maps; here
`update` and `sparse_row_update` change the parameters IN PLACE (under
`torch.no_grad`) and return the new state, which saves a copy of every
table per step. The arithmetic is the JAX package's, operation by
operation, in f32:
  dense SGD:   w <- w - lr * (g + wd * w), with momentum and nesterov
               (optimizer.py:114-142);
  sparse SGD:  table[rows] += -lr * (row_grads + wd * table[rows]),
               duplicates summed, rows < 0 or >= V dropped (:86-97).
The learning rate lives in the state as a 0-d f32 tensor on the device, so
`FFModel.set_learning_rate` changes it without a host sync in the step.

The lazy sparse momentum, Adam and row-wise AdaGrad rules come with a
later slice: their classes exist so that code naming them imports, and a
model that would update tables with them raises at compile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

LATER_SLICE = "a later slice of the port (sparse momentum, Adam and row-wise AdaGrad)"


def _rate(lr, default: float, device) -> torch.Tensor:
    if lr is None:
        lr = default
    return torch.as_tensor(lr, dtype=torch.float32, device=device)


class Optimizer:
    # an optimizer that can update embedding rows in place of a dense
    # table gradient sets supports_sparse (FFModel.compile reads it)
    supports_sparse: bool = False

    def init(self, params: Dict[str, Dict[str, torch.Tensor]], device) -> dict:
        raise NotImplementedError

    def update(self, grads, state: dict, params) -> dict:
        """Apply `grads` ({op: {key: tensor}}) to `params` in place; returns
        the new state."""
        raise NotImplementedError

    def sparse_init(self, pool_shape):
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
    def update(self, grads, state, params) -> dict:
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

    def sparse_row_update(self, table, state, rows, row_grads, lr=None):
        if self.momentum != 0.0:
            raise NotImplementedError(f"sparse SGD with momentum is {LATER_SLICE}")
        rate = _rate(lr, self.lr, table.device)
        with torch.no_grad():
            keep = (rows >= 0) & (rows < table.shape[0])
            if self.weight_decay != 0.0:
                decay = table[rows.clamp(0, table.shape[0] - 1)]
                row_grads = row_grads + self.weight_decay * decay
            table.index_add_(0, rows[keep], (-rate * row_grads[keep]).to(table.dtype))
        return state


@dataclasses.dataclass
class AdamOptimizer(Optimizer):
    """reference: include/optimizer.h:62-85. Not ported yet."""

    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    supports_sparse = True

    def init(self, params, device) -> dict:
        raise NotImplementedError(f"AdamOptimizer is {LATER_SLICE}")


@dataclasses.dataclass
class RowWiseAdagradOptimizer(Optimizer):
    """Row-wise AdaGrad (one accumulator per table row). Not ported yet."""

    lr: float = 0.01
    epsilon: float = 1e-10
    initial_accumulator: float = 0.0

    supports_sparse = True

    def init(self, params, device) -> dict:
        raise NotImplementedError(f"RowWiseAdagradOptimizer is {LATER_SLICE}")
