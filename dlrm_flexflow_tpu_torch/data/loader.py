"""Host-staged data loading.

PyTorch counterpart of `dlrm_flexflow_tpu/data/loader.py` (reference: DLRM
C++ DataLoader, examples/cpp/DLRM/dlrm.cc:262-601): the whole dataset
stays in host numpy, batches are sliced from it, and `FFModel` stages each
batch to the device. Shuffling draws the same permutation from the same
seed as the JAX package, so both packages see the same batches. A
shuffled batch is gathered by the native threaded batcher (native/ffdata)
through the port's own binding, `native_batcher.gather_batch`, as the JAX
package gathers it through its binding; that binding raises where the
library cannot be built, so there is no numpy fallback. `stacked_epoch`
gives the JAX package's [K, B, ...] super-batches.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from .native_batcher import gather_batch


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
        """reference: DataLoader::next_batch (dlrm.cc:482). A shuffled
        batch's permuted row gather runs in the native threaded batcher;
        an unshuffled batch is a free slice."""
        i = self._step % self.steps_per_epoch
        sl = self._order[i * self.batch_size : (i + 1) * self.batch_size]
        self._step += 1
        if not self.shuffle:
            lo, hi = int(sl[0]), int(sl[-1]) + 1
            return {k: v[lo:hi] for k, v in self.feeds.items()}, self.labels[lo:hi]
        keys = list(self.feeds)
        outs = gather_batch([self.feeds[k] for k in keys] + [self.labels], sl)
        return dict(zip(keys, outs[:-1])), outs[-1]

    def epoch(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        self.reset()
        for _ in range(self.steps_per_epoch):
            yield self.next_batch()

    def stacked_epoch(
        self, steps_per_call: int
    ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        """Super-batches [K, B, ...] of K = steps_per_call consecutive
        batches (the JAX package's input to its scanned train step); the
        epoch's tail shorter than K comes as a smaller stack."""
        self.reset()
        bs, steps = self.batch_size, self.steps_per_epoch
        done = 0
        while done < steps:
            k = min(steps_per_call, steps - done)
            sl = self._order[done * bs : (done + k) * bs]
            feeds = {name: v[sl].reshape((k, bs) + v.shape[1:]) for name, v in self.feeds.items()}
            labels = self.labels[sl].reshape((k, bs) + self.labels.shape[1:])
            done += k
            yield feeds, labels
