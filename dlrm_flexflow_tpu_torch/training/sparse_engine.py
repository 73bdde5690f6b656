"""Sparse embedding-update engine.

PyTorch counterpart of `dlrm_flexflow_tpu/training/sparse_engine.py`:
routes the pooled-output gradients of the sparse embedding ops into row
updates, in place. Tables on the kernel route (`op.kernel_route`, set by
FFModel.compile) are grouped by (K, D) and go to the row-update kernels
(`ops/kernels/row_update.py`), one sort per group and one launch per table:
SGD, lazy momentum and Nesterov, lazy Adam (at the bias-corrected rate the
caller passes as `lr`), row-wise AdaGrad. Under host routing the caller
passes each route table's sorted stream (`routes`) and the group is not
sorted on the device. Every other table goes to `op.sparse_update`, the
optimizer's scatter rule.

Each call counts the ids its kernel route takes (`ROW_UPDATE_IDS`,
utils/profiling.py `count`; a captured step counts at each replay).

The two routes round differently, as in the JAX package: the kernel route
rounds each stream entry (-lr * g for SGD) to bf16 before it sums them in
f32; the scatter route adds f32 deltas.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.embedding import bag_row_src
from ..ops.kernels.row_update import (
    row_update,
    row_update_adagrad,
    row_update_adam,
    row_update_momentum,
)
from ..utils.profiling import count
from .optimizer import AdamOptimizer, RowWiseAdagradOptimizer, SGDOptimizer

# the counter of the ids (padding included) a step's row-update kernels take
ROW_UPDATE_IDS = "row_update:ids"


def _expand(src: torch.Tensor, h: int) -> torch.Tensor:
    """[B, D] pooled source -> [B*h, D] per-member rows (only the SGD
    weight-decay payload needs the expansion)."""
    if h == 1:
        return src
    b, d = src.shape
    return src[:, None, :].expand(b, h, d).reshape(b * h, d)


@torch.no_grad()
def apply_sparse_updates(
    sparse_ops,
    params: Dict[str, Dict[str, torch.Tensor]],
    sparse_xs: Dict[str, list],
    g_over: Dict[str, list],
    opt,
    sstates: Dict[str, object],
    ctx,
    lr=None,
    routes=None,
) -> Dict[str, object]:
    """Update the sparse ops' tables and slot states in place; returns the
    slot states. `g_over[op]` is the list of pooled-output gradients of op,
    `sparse_xs[op]` its index inputs, `lr` the rate of this step, a 0-d f32
    tensor on the device (for Adam, the bias-corrected alpha_t; FFModel
    passes one that exists before any step, so a captured step copies
    nothing from the host; None takes opt's own rate, a host-to-device
    copy), `routes` None or
    {op name: (rows_sorted, order)} for every kernel-route op, computed
    from this step's `sparse_xs` (FFModel.compute_routes)."""
    new_sstates = dict(sstates)
    kernel_ops = [op for op in sparse_ops if op.kernel_route]
    for op in sparse_ops:
        if not op.kernel_route:
            new_sstates[op.name] = op.sparse_update(
                params[op.name], sparse_xs[op.name], g_over[op.name], opt,
                sstates[op.name], ctx, lr=lr,
            )
    if not kernel_ops:
        return new_sstates
    if routes is not None and set(routes) != {op.name for op in kernel_ops}:
        raise ValueError(f"routes for {sorted(routes)}, but the kernel route has "
                         f"{sorted(op.name for op in kernel_ops)}")

    groups: Dict[tuple, List] = {}
    for op in kernel_ops:
        rows, src, h = bag_row_src(sparse_xs[op.name][0], g_over[op.name][0], op.aggr, op.num_entries)
        groups.setdefault((int(rows.shape[0]), op.out_dim), []).append((op, rows, src.contiguous(), h))
    count(ROW_UPDATE_IDS, sum(k * len(items) for (k, _), items in groups.items()))
    for items in groups.values():
        kernel_route_update(
            opt, [params[op.name]["weight"] for op, *_ in items], [sstates[op.name] for op, *_ in items],
            [rows for _, rows, _, _ in items], [(src, h) for _, _, src, h in items], lr,
            None if routes is None else [routes[op.name] for op, *_ in items])
    return new_sstates


_RATES: Dict[tuple, torch.Tensor] = {}


def _device_rate(lr, device) -> torch.Tensor:
    """`lr` as a 0-d f32 tensor on `device`; a host number becomes a
    tensor made once a (device, value) and kept, so that a step captured
    in a CUDA graph copies nothing from the host."""
    if isinstance(lr, torch.Tensor):
        return torch.as_tensor(lr, dtype=torch.float32, device=device)
    key = (str(torch.device(device)), float(lr))
    if key not in _RATES:
        _RATES[key] = torch.tensor(float(lr), dtype=torch.float32, device=device)
    return _RATES[key]


@torch.no_grad()
def kernel_route_update(opt, tables, states, rows_l, payloads, lr=None, routes=None) -> None:
    """One group of tables (equal K and D) through the row-update kernel's
    rule for `opt`, in place: `states` each table's slot state (None, a
    [V, D] velocity, Adam's {"m", "v"}, an AdaGrad [V]), `payloads` each
    (src, h), `lr` the step's rate as in `apply_sparse_updates`, `routes`
    None or one (rows_sorted, order) a table. Also the shard update of a
    sharded collection on the kernel route (parallel/embedding_collection.py)."""
    device = tables[0].device
    base = opt.alpha if isinstance(opt, AdamOptimizer) else getattr(opt, "lr", None)
    rate = _device_rate(base if lr is None else lr, device)
    if isinstance(opt, AdamOptimizer):
        row_update_adam(tables, [s["m"] for s in states], [s["v"] for s in states], rows_l,
                        payloads, rate, opt.beta1, opt.beta2, opt.epsilon, opt.weight_decay, routes)
    elif isinstance(opt, SGDOptimizer) and opt.momentum != 0.0:
        row_update_momentum(tables, states, rows_l, payloads, rate, opt.momentum,
                            opt.nesterov, opt.weight_decay, routes)
    elif isinstance(opt, SGDOptimizer):
        if opt.weight_decay != 0.0:
            # lazy decay on touched rows (duplicates decay once per
            # occurrence, as on the scatter route). The decay term is
            # taken in the table's dtype, as the JAX package's weakly
            # typed `weight_decay * rows` is, and forces the expanded
            # payload.
            payloads = [
                -rate * (
                    _expand(src, h)
                    + torch.full((), opt.weight_decay, dtype=t.dtype, device=device)
                    * t[rows.clamp(0, t.shape[0] - 1)]
                )
                for (src, h), rows, t in zip(payloads, rows_l, tables)
            ]
            scale = torch.ones((), dtype=torch.float32, device=device)
        else:
            scale = -rate
        row_update(tables, rows_l, payloads, scale, routes=routes)
    elif type(opt) is RowWiseAdagradOptimizer:
        row_update_adagrad(tables, states, rows_l, payloads, rate, opt.epsilon, routes)
    else:  # FFModel.compile keeps other optimizers off the kernel route
        raise TypeError(f"the row-update kernel route takes SGD (with momentum), Adam and "
                        f"row-wise AdaGrad, not {type(opt).__name__}")
