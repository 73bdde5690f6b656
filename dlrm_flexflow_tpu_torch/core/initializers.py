"""Weight initializers.

PyTorch counterpart of `dlrm_flexflow_tpu/core/initializers.py`. Each
initializer draws from an explicit `torch.Generator` that lives on the
device the weight is made on, so a model's random weights are a function of
its seed and device alone. The numbers cannot match `jax.random`'s; weights
carry between the packages through `convert.params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


class Initializer:
    def __call__(
        self,
        generator: torch.Generator,
        shape: Tuple[int, ...],
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> torch.Tensor:
        raise NotImplementedError


class GlorotUniform(Initializer):
    """Xavier/Glorot uniform. The fans are read from an [out, in, ...]
    shape: fan_in = in * receptive, fan_out = out * receptive."""

    def __init__(self, seed: int = 0, scale: float = 1.0):
        self.seed = seed
        self.scale = scale

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        if len(shape) >= 2:
            receptive = 1
            for d in shape[2:]:
                receptive *= d
            fan_in = shape[1] * receptive
            fan_out = shape[0] * receptive
        else:
            fan_in = fan_out = shape[0] if shape else 1
        limit = self.scale * math.sqrt(6.0 / (fan_in + fan_out))
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(-limit, limit, generator=generator)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        return torch.zeros(shape, dtype=dtype, device=device)


class UniformInitializer(Initializer):
    def __init__(self, seed: int = 0, min_val: float = 0.0, max_val: float = 1.0):
        self.seed = seed
        self.min_val = min_val
        self.max_val = max_val

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        if not dtype.is_floating_point:
            return torch.randint(
                int(self.min_val), int(self.max_val) + 1, shape,
                generator=generator, dtype=dtype, device=device,
            )
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(self.min_val, self.max_val, generator=generator)


class NormInitializer(Initializer):
    def __init__(self, seed: int = 0, mean: float = 0.0, stddev: float = 1.0):
        self.seed = seed
        self.mean = mean
        self.stddev = stddev

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.normal_(self.mean, self.stddev, generator=generator)


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        return torch.full(shape, self.value, dtype=dtype, device=device)


DefaultWeightInit = GlorotUniform
DefaultBiasInit = ZeroInitializer
