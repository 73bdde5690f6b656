"""Low-rank cross network op (DCN-V2).

The cross network of DCN-V2 (Wang et al., arXiv:2008.13535) as TorchRec's
`LowRankCrossNet` computes it: from x0 [B, d], layer l maps x_l to

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

with V_l [r, d] (no bias), W_l [r -> d] with a bias b_l [d], and x_0 = x0.
Parameters are kept [out, in] as Dense's: `v_kernel_<l>` [r, d],
`w_kernel_<l>` [d, r], `bias_<l>` [d]. Each product is `ops/dense.py`'s
`dense` (on CUDA under a bf16 compute dtype the tensor-core route with f32
sums, its backward split in three); the sum, the product with x0 and the
residual add are f32.

Inside a train step the network is the sub-phase `phase:cross_forward` of
the step's forward, and its backward `phase:cross_backward` of the step's
backward (utils/profiling.py `SUB_PHASES`).
"""
from __future__ import annotations

import torch

from ..core.graph import Op
from ..core.initializers import DefaultBiasInit, GlorotUniform
from ..core.tensor import TensorSpec
from ..ffconst import ActiMode, OperatorType
from .dense import dense


class LowRankCrossNet(Op):
    op_type = OperatorType.OP_LINEAR

    def __init__(self, name: str, input: TensorSpec, num_layers: int, rank: int,
                 kernel_initializer=None, bias_initializer=None):
        super().__init__(name, [input])
        if input.num_dims != 2:
            raise ValueError(f"{name}: the cross network takes [B, d] inputs, got {input.shape}")
        if num_layers < 1 or rank < 1:
            raise ValueError(f"{name}: num_layers {num_layers} and rank {rank} must be positive")
        self.num_layers, self.rank = int(num_layers), int(rank)
        self.dim = int(input.shape[1])
        self._out(tuple(input.shape), input.dtype)
        for layer in range(self.num_layers):
            self._param(f"v_kernel_{layer}", (self.rank, self.dim), kernel_initializer or GlorotUniform())
            self._param(f"w_kernel_{layer}", (self.dim, self.rank), kernel_initializer or GlorotUniform())
            self._param(f"bias_{layer}", (self.dim,), bias_initializer or DefaultBiasInit())

    def _layers(self, params, x0: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        x = x0
        for layer in range(self.num_layers):
            v = dense(x, params[f"v_kernel_{layer}"], None, ActiMode.AC_MODE_NONE, cdt)
            y = dense(v, params[f"w_kernel_{layer}"], params[f"bias_{layer}"], ActiMode.AC_MODE_NONE, cdt)
            x = torch.addcmul(x, x0, y)
        return x

    def forward(self, params, inputs, ctx):
        (x0,) = inputs
        x0 = x0.float()
        cdt = ctx.compute_dtype
        if ctx.phases is None:
            return [self._layers(params, x0, cdt)]
        return [ctx.phases.cut("cross", x0, lambda x: self._layers(params, x, cdt))]

    def cost_stats(self):
        b = self.inputs[0].shape[0]
        product = 2.0 * b * self.dim * self.rank
        return {
            "flops": self.num_layers * (2.0 * product + 3.0 * b * self.dim),
            "bytes": 4.0 * self.num_layers * (6.0 * b * self.dim + 2.0 * b * self.rank
                                              + 2.0 * self.dim * self.rank),
            "param_bytes": 4.0 * self.num_layers * (2 * self.dim * self.rank + self.dim),
        }
