"""Weights from the seed, on the device, block by block.

Each parameter (a reference module's `Leaf`) is drawn uniform in
[-bound, bound] in blocks of at most BLOCK_ROWS rows, each block from a
`torch.Generator` of its own seeded by (seed, leaf index, block index), and
rounded to the leaf's storage dtype. So any block can be drawn again alone,
which lets the checks compare a state with the initial one a block at a
time, and the same seed gives the same weights on every run on one kind of
card.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

BLOCK_ROWS = 1 << 20
WEIGHTS_TAG = 0x5745  # keeps the weights' streams apart from the traffic's


def stream_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed from the run's seed and a path of small
    integers; any whole seed, negative or above 2**32, is taken."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF] + [int(x) for x in path]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def blocks(leaf) -> Iterator[Tuple[int, int]]:
    rows = leaf.shape[0]
    for start in range(0, rows, BLOCK_ROWS):
        yield start, min(rows, start + BLOCK_ROWS)


def draw_block(leaf, index: int, block: int, start: int, stop: int, seed: int,
               device) -> torch.Tensor:
    """Rows [start, stop) of leaf `index`, in its storage dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, WEIGHTS_TAG, index, block))
    shape = (stop - start,) + tuple(leaf.shape[1:])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    out.uniform_(-leaf.bound, leaf.bound, generator=gen)
    return out.to(_dtype(leaf.dtype))


def draw(leaf, index: int, seed: int, device) -> torch.Tensor:
    """The whole leaf, in its storage dtype, filled block by block (so the
    draw holds the leaf and at most one block besides)."""
    out = torch.empty(tuple(leaf.shape), dtype=_dtype(leaf.dtype), device=device)
    for b, (s, e) in enumerate(blocks(leaf)):
        out[s:e] = draw_block(leaf, index, b, s, e, seed, device)
    return out


def change_norm(leaf, index: int, seed: int, now: torch.Tensor) -> float:
    """The L2 norm of `now` minus the leaf's initial value, in float32,
    block by block (so the check holds at most one block of the initial
    value at a time)."""
    total = 0.0
    for b, (s, e) in enumerate(blocks(leaf)):
        w0 = draw_block(leaf, index, b, s, e, seed, now.device).float()
        total += float(torch.sum((now[s:e].float() - w0) ** 2))
        del w0
    return total ** 0.5


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
