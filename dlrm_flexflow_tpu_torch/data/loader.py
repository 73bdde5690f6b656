"""Host-staged data loading.

PyTorch counterpart of `dlrm_flexflow_tpu/data/loader.py` (reference: DLRM
C++ DataLoader, examples/cpp/DLRM/dlrm.cc:262-601): the whole dataset
stays in host numpy, batches are sliced from it, and `FFModel` stages each
batch to the device. Shuffling draws the same permutation from the same
seed as the JAX package, so both packages see the same batches. The JAX
package gathers a shuffled batch in its native threaded batcher
(native/ffdata); here numpy's fancy indexing does, until the port's own
binding of that library comes (a later slice).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class DataLoader:
    """next_batch iteration over a host-resident dataset.

    feeds: dict input-name -> [N, ...] numpy; labels: [N, ...]. Partial
    batches are dropped.
    """

    def __init__(
        self,
        feeds: Dict[str, np.ndarray],
        labels: np.ndarray,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        self.feeds = feeds
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        n = labels.shape[0]
        for k, v in feeds.items():
            if v.shape[0] != n:
                raise ValueError(f"{k} has {v.shape[0]} rows, labels {n}")
        if not drop_remainder:
            raise ValueError("partial batches are not supported (static shapes)")
        self.num_samples = n
        self.steps_per_epoch = n // batch_size
        if self.steps_per_epoch <= 0:
            raise ValueError(f"dataset ({n}) smaller than one batch ({batch_size})")
        self._order = np.arange(n)
        self._step = 0

    def reset(self) -> None:
        """New epoch: reshuffle (reference: next epoch re-seeds sample ids)."""
        self._step = 0
        if self.shuffle:
            self.rng.shuffle(self._order)

    def next_batch(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """reference: DataLoader::next_batch (dlrm.cc:482)."""
        i = self._step % self.steps_per_epoch
        sl = self._order[i * self.batch_size : (i + 1) * self.batch_size]
        self._step += 1
        if not self.shuffle:
            lo, hi = int(sl[0]), int(sl[-1]) + 1
            return {k: v[lo:hi] for k, v in self.feeds.items()}, self.labels[lo:hi]
        return {k: v[sl] for k, v in self.feeds.items()}, self.labels[sl]

    def epoch(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        self.reset()
        for _ in range(self.steps_per_epoch):
            yield self.next_batch()
