"""Mixture-of-experts classifier (the port's counterpart of examples/moe.py,
reference: examples/cpp/mixture_of_experts/moe.cc): a gate (dense, softmax,
top 2 of 4 experts), group_by, an MLP an expert, aggregate; trained on 10
clustered classes made from the seed.

    python -m dlrm_flexflow_tpu_torch.examples.moe [--device cpu] [--examples N] [--in-dim D] [FFConfig flags]

Runs on the card unless `--device cpu` is given; FFConfig's flags
(`--batch-size`, `--epochs`, `--lr`, `--seed`, ...) are read as the
reference spells them.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
from dlrm_flexflow_tpu_torch.models import zoo


def clustered(n: int, in_dim: int, seed: int, classes: int = 10):
    """Class ids and their points: a center a class plus noise of 0.3."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    centers = rng.randn(classes, in_dim).astype(np.float32)
    x = centers[y] + 0.3 * rng.randn(n, in_dim).astype(np.float32)
    return x, y.astype(np.int32)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    cfg = FFConfig(batch_size=64)
    rest = cfg.update_from_args(argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--examples", type=int, default=None, help="default: 32 batches")
    parser.add_argument("--in-dim", type=int, default=64)
    args = parser.parse_args(rest)
    model = zoo.moe_mlp(batch_size=cfg.batch_size, num_experts=4, k=2, in_dim=args.in_dim, num_classes=10,
                        config=cfg, device=args.device)
    model.compile(SGDOptimizer(lr=cfg.learning_rate), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [MetricsType.METRICS_ACCURACY])
    x, y = clustered(args.examples or cfg.batch_size * 32, args.in_dim, cfg.seed)
    hist = model.fit({"input": x}, y, epochs=cfg.epochs, verbose=True)
    print(hist)
    return hist


if __name__ == "__main__":
    main()
