"""Shared op helpers."""
from __future__ import annotations

import torch

from ..ffconst import ActiMode


def apply_activation(x: torch.Tensor, mode: ActiMode) -> torch.Tensor:
    """Fused activation epilogue. GELU is the tanh approximation, the
    default of `jax.nn.gelu` that the JAX package calls."""
    if mode is ActiMode.AC_MODE_NONE:
        return x
    if mode is ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if mode is ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if mode is ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if mode is ActiMode.AC_MODE_GELU:
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {mode}")


def index_add_rows(dst: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst[index[i]] += src[i] for every i, in place; returns dst. On the
    card the rows that repeat in `index` take their sums in one fixed
    order (`index_put_(accumulate=True)` sorts the index), where CUDA's
    `index_add_` adds them by float atomics, in no fixed order: two ranks
    that add the same rows get the same bits, so the state that a mesh's
    model axis replicates stays equal bit for bit, and a replayed step
    gives the eager step's bits. On the CPU `index_add_` adds in the
    index's order already."""
    if dst.is_cuda:
        return dst.index_put_((index.long(),), src, accumulate=True)
    return dst.index_add_(0, index, src)
