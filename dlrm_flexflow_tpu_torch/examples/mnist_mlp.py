"""MNIST MLP, 784-512-512-10 (the port's counterpart of examples/mnist_mlp.py,
reference: examples/python/native/mnist_mlp.py), trained on synthetic
digit-like blobs made from the seed.

    python -m dlrm_flexflow_tpu_torch.examples.mnist_mlp [--device cpu] [--examples N] [FFConfig flags]

Runs on the card unless `--device cpu` is given; FFConfig's flags
(`--batch-size`, `--epochs`, `--lr`, `--seed`, `--compute-dtype`, ...) are
read as the reference spells them.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
from dlrm_flexflow_tpu_torch.models import zoo


def synthetic_mnist(n: int, seed: int):
    """Linearly separable digit-like blobs in 784 dims and their class ids."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    centers = rng.randn(10, 784).astype(np.float32) * 2.0
    x = centers[y] + rng.randn(n, 784).astype(np.float32) * 0.5
    return x, y.astype(np.int32)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    cfg = FFConfig(batch_size=64, epochs=2)
    rest = cfg.update_from_args(argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--examples", type=int, default=8192)
    args = parser.parse_args(rest)
    model = zoo.mnist_mlp(batch_size=cfg.batch_size, config=cfg, device=args.device)
    model.compile(SGDOptimizer(lr=cfg.learning_rate), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [MetricsType.METRICS_ACCURACY])
    x, y = synthetic_mnist(args.examples, cfg.seed)
    hist = model.fit({"image": x}, y, epochs=cfg.epochs, verbose=True)
    print(hist)
    return hist


if __name__ == "__main__":
    main()
