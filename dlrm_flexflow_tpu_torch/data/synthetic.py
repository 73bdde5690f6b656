"""Synthetic Criteo-like data generation (numpy only).

Counterpart of `dlrm_flexflow_tpu/data/synthetic.py`: the same draws in the
same order, so one seed gives bit-identical arrays in both packages.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models.dlrm import DLRMConfig


def zipf_indices(rng, vocab: int, size, s: float = 1.05) -> np.ndarray:
    """Truncated Zipf(s) ranks over [0, vocab) via the inverse CDF of the
    continuous approximation (hot low ranks, long tail)."""
    u = rng.random(size)
    if abs(s - 1.0) < 1e-9:
        r = np.exp(u * np.log(vocab))
    else:
        r = (1.0 + u * (float(vocab) ** (1.0 - s) - 1.0)) ** (1.0 / (1.0 - s))
    return np.minimum(r.astype(np.int64) - 1, vocab - 1).clip(0)


def random_batches(
    cfg: DLRMConfig, num_samples: int, seed: int = 0, learnable: bool = True,
    zipf: float = 0.0,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Returns (feeds, labels): feeds match the DLRM graph input names
    (dense_features + sparse_i); labels in {0, 1} float, shape [N, 1].

    With `learnable=True` the click probability depends on a random linear
    model over the dense features and a per-table "hot row" indicator; with
    False it is pure noise. With `zipf > 0` sparse indices follow a
    truncated Zipf(zipf) rank distribution instead of uniform.
    """
    rng = np.random.default_rng(seed)
    n_dense = cfg.mlp_bot[0]
    dense = rng.normal(0.0, 1.0, size=(num_samples, n_dense)).astype(np.float32)
    feeds: Dict[str, np.ndarray] = {"dense_features": dense}
    logit = np.zeros((num_samples,), np.float32)
    w = rng.normal(0.0, 1.0, size=(n_dense,)).astype(np.float32)
    if learnable:
        logit += dense @ w / np.sqrt(n_dense)
    for i, vocab in enumerate(cfg.embedding_size):
        if zipf > 0:
            idx = zipf_indices(rng, vocab, (num_samples, cfg.embedding_bag_size), zipf)
        else:
            idx = rng.integers(0, vocab, size=(num_samples, cfg.embedding_bag_size))
        feeds[f"sparse_{i}"] = idx.astype(np.int64)
        if learnable:
            # rows in the lowest decile of each table push the logit up
            hot = (idx < max(vocab // 10, 1)).any(axis=1)
            logit += np.where(hot, 0.5, -0.1).astype(np.float32)
    if learnable:
        prob = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(num_samples) < prob).astype(np.float32)
    else:
        labels = rng.integers(0, 2, size=(num_samples,)).astype(np.float32)
    return feeds, labels[:, None]
