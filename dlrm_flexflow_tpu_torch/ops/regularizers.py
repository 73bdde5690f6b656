"""Softmax and Dropout ops.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/regularizers.py`.

Softmax is max-subtracted, computed in f32 (the graph's activations are f32)
and returned in the input's dtype.

Dropout keeps each entry with probability 1 - rate and scales the kept ones
by 1 / (1 - rate) while training; at rate 0 and outside training it is the
identity. Its mask is `core/graph.py` `keep_mask` of the op's key this step
(`ctx.op_rng`): a function of (config.seed, the step count, the op's guid)
alone, computed with integer tensor ops, so the CPU and the card give one
mask and a CUDA-graph replay gives the eager step's. The JAX package draws
`jax.random.bernoulli` from a threefry key of the same three numbers; the
bits differ by design. With no step key (a graph executed by hand while
training) the op's own `seed` stands in for it, as in the JAX package.

Under a data axis above 1 a rank's block of a batch-sharded input hashes
its entries' global indices (`ctx.row_offset`), so the ranks' masks put
together are one card's (parallel/global_batch.py). The batch is always
the leading axis there: compile refuses every op that would move it.
"""
from __future__ import annotations

import torch

from ..ffconst import OperatorType
from ..core.graph import Op, hash32, keep_mask
from ..core.tensor import TensorSpec


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


def dropout(x: torch.Tensor, key: torch.Tensor, rate: float, offset: int = 0) -> torch.Tensor:
    """x with each entry kept (and scaled by 1 / keep) where `keep_mask` of
    `key` (at entry indices from `offset`) says, else 0, in x's dtype."""
    keep = 1.0 - rate
    mask = keep_mask(key, tuple(x.shape), keep, offset)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


class Softmax(Op):
    op_type = OperatorType.OP_SOFTMAX

    def __init__(self, name: str, input: TensorSpec, axis: int = -1):
        super().__init__(name, [input])
        self.axis = axis
        self._out(input.shape, input.dtype)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return [softmax(x, self.axis)]


class Dropout(Op):
    op_type = OperatorType.OP_DROPOUT

    def __init__(self, name: str, input: TensorSpec, rate: float, seed: int = 0):
        super().__init__(name, [input])
        self.rate = float(rate)
        self.seed = seed
        self.stochastic = self.rate > 0.0
        self._out(input.shape, input.dtype)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        if not ctx.training or self.rate <= 0.0:
            return [x]
        key = ctx.op_rng(self)
        if key is None:
            key = torch.tensor(hash32(self.seed), dtype=torch.int64, device=x.device)
        return [dropout(x, key, self.rate, ctx.row_offset(self, x.numel()))]
