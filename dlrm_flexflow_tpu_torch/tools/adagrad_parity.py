"""Where CUDA and CPU training part under Adam with row-wise AdaGrad tables.

    python -m dlrm_flexflow_tpu_torch.tools.adagrad_parity [--lr 0.05] [--steps 3]

Trains the kaggle-shaped DLRM of `tests/test_torch_port_cuda.py`'s
`test_kaggle_shaped_training_under_each_rule_tracks_the_cpu[adam+adagrad]`
(26 tables at D = 16 with vocabs capped at 20000, 10 of them on the
row-update kernel route in bf16, bf16 compute, batch 128; dense Adam at
alpha 1e-3, row-wise AdaGrad on the tables at `--lr`) for a few steps
from one set of weights, three ways:

  cuda-kernel  on the card, the route tables updated by the row-update
               kernel's AdaGrad mode (the path under test);
  cuda-plain   on the card, the route tables updated by the kernel's plain
               PyTorch version (`adagrad_reference`) on the card's tensors;
  cpu          on the CPU, the plain versions throughout.

It prints one JSON line per pair: the largest weight error and where it
is (op, parameter, row, column, each side's value), the share of weights
within 2e-3, the shares that the CUDA test's bound asks for (the weights
row-wise AdaGrad does not normalize within 2e-3, all weights within
2e-3 + lr / 4), the largest loss difference, and per parameter the
largest error. cuda-kernel against cuda-plain isolates the kernel;
cuda-plain against cpu isolates the rest of the step (the MLPs in bf16 on
cuBLAS against the CPU's). It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from .. import AdamOptimizer, FFConfig, LossType, MetricsType, RowWiseAdagradOptimizer
from ..data.synthetic import random_batches
from ..models.dlrm import kaggle_config, make_dlrm_model
from ..ops.kernels import row_update as ru
from ..training import sparse_engine

SHARE_ATOL = 2e-3


def _plain_adagrad(tables, accums, rows_list, payloads, lr, epsilon, routes=None):
    """The AdaGrad wrapper's arithmetic by its plain version, on any device."""
    for t, a, rows, p in zip(tables, accums, rows_list, payloads):
        ru.adagrad_reference(t, a, rows, p, lr, epsilon)


def _model(cfg, bs: int, device, lr: float):
    m = make_dlrm_model(cfg, FFConfig(batch_size=bs, compute_dtype="bfloat16", table_dtype="bfloat16",
                                      packed_tables="on", seed=5), device=device)
    m.compile(AdamOptimizer(alpha=1e-3), LossType.LOSS_BINARY_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY], sparse_optimizer=RowWiseAdagradOptimizer(lr=lr))
    return m


def _weights(model) -> Dict[str, np.ndarray]:
    return {f"{op}/{k}": w for op in model.get_parameters() for k, w in model.get_weights(op).items()}


def compare(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray], init: Dict[str, np.ndarray],
            normalized: set, lr: float) -> dict:
    """The largest error of b against a, where it is, and the shares within
    SHARE_ATOL over all weights and over those not in `normalized` (the
    row-wise AdaGrad tables), and within SHARE_ATOL + lr / 4 over all."""
    errs = {name: np.abs(a[name] - b[name]) for name in a}
    flat = np.concatenate([e.reshape(-1) for e in errs.values()])
    rest = np.concatenate([e.reshape(-1) for n, e in errs.items() if n not in normalized])
    worst = max(errs, key=lambda n: errs[n].max())
    idx = np.unravel_index(int(np.argmax(errs[worst])), errs[worst].shape)
    over = {n: int((e > SHARE_ATOL).sum()) for n, e in errs.items() if (e > SHARE_ATOL).any()}
    return {
        "max_weight_err": float(flat.max()), "at": worst, "index": [int(i) for i in idx],
        "values": {"first": float(a[worst][idx]), "second": float(b[worst][idx]),
                   "initial": float(init[worst][idx])},
        "share_within_2e-3": float(np.mean(flat <= SHARE_ATOL)), "weights": int(flat.size),
        "share_not_adagrad_normalized_within_2e-3": float(np.mean(rest <= SHARE_ATOL)),
        "share_within_2e-3_plus_lr/4": float(np.mean(flat <= SHARE_ATOL + lr / 4)),
        "over_2e-3_by_param": over,
        "max_err_by_param": {n: float(e.max()) for n, e in errs.items() if e.max() > 0},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, default=0.05, help="row-wise AdaGrad's rate on the tables")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("adagrad_parity: needs a CUDA card", file=sys.stderr)
        return 1
    bs = args.batch
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    runs = {"cuda-kernel": _model(cfg, bs, "cuda", args.lr)}
    init = _weights(runs["cuda-kernel"])
    runs["cuda-plain"] = _model(cfg, bs, "cuda", args.lr)
    runs["cpu"] = _model(cfg, bs, "cpu", args.lr)
    for name in ("cuda-plain", "cpu"):
        runs[name].set_parameters({op: runs["cuda-kernel"].get_weights(op)
                                   for op in runs["cuda-kernel"].get_parameters()})
    feeds, labels = random_batches(cfg, args.steps * bs, seed=5)
    losses = {name: [] for name in runs}
    launches = ru.row_update_adagrad.launches
    for i in range(args.steps):
        sl = slice(i * bs, (i + 1) * bs)
        batch = {k: v[sl] for k, v in feeds.items()}
        for name, model in runs.items():
            if name == "cuda-plain":
                kernel, sparse_engine.row_update_adagrad = sparse_engine.row_update_adagrad, _plain_adagrad
                try:
                    losses[name].append(float(model.train_batch(batch, labels[sl])))
                finally:
                    sparse_engine.row_update_adagrad = kernel
            else:
                losses[name].append(float(model.train_batch(batch, labels[sl])))
    launches = ru.row_update_adagrad.launches - launches
    final = {name: _weights(model) for name, model in runs.items()}
    print(json.dumps({"lr": args.lr, "steps": args.steps, "batch": bs, "kernel_launches": launches,
                      "losses": losses}), flush=True)
    normalized = {f"{op.name}/weight" for op in runs["cpu"]._sparse_ops if op.kernel_route}
    for a, b in (("cpu", "cuda-kernel"), ("cpu", "cuda-plain"), ("cuda-plain", "cuda-kernel")):
        res = compare(final[a], final[b], init, normalized, args.lr)
        res["max_loss_err"] = max(abs(x - y) for x, y in zip(losses[a], losses[b]))
        print(json.dumps({"pair": f"{b} vs {a}", **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
