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
