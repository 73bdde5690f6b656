"""Elementwise binary, unary and scalar ops.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/elementwise.py`: add, sub,
mul and div with numpy broadcasting; relu, sigmoid, tanh, GELU (the tanh
form, `jax.nn.gelu`'s default), exp, identity, ELU and the four scalar ops.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ffconst import OperatorType
from ..core.graph import Op
from ..core.tensor import TensorSpec

_BINARY_FNS = {
    OperatorType.OP_EW_ADD: torch.add,
    OperatorType.OP_EW_SUB: torch.sub,
    OperatorType.OP_EW_MUL: torch.mul,
    OperatorType.OP_EW_DIV: torch.div,
}

_UNARY_FNS = {
    OperatorType.OP_RELU: torch.relu,
    OperatorType.OP_SIGMOID: torch.sigmoid,
    OperatorType.OP_TANH: torch.tanh,
    OperatorType.OP_GELU: lambda x: F.gelu(x, approximate="tanh"),
    OperatorType.OP_EXP: torch.exp,
    OperatorType.OP_IDENTITY: lambda x: x,
    OperatorType.OP_ELU: F.elu,
}


class ElementBinary(Op):
    def __init__(self, name: str, op_type: OperatorType, x: TensorSpec, y: TensorSpec):
        super().__init__(name, [x, y])
        self.op_type = op_type
        out_shape = np.broadcast_shapes(tuple(x.shape), tuple(y.shape))
        self._out(out_shape, x.dtype)

    def forward(self, params, inputs, ctx):
        x, y = inputs
        return [_BINARY_FNS[self.op_type](x, y)]


class ElementUnary(Op):
    def __init__(
        self,
        name: str,
        op_type: OperatorType,
        x: TensorSpec,
        scalar: float = 0.0,
    ):
        super().__init__(name, [x])
        self.op_type = op_type
        self.scalar = scalar
        self._out(x.shape, x.dtype)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        t = self.op_type
        if t is OperatorType.OP_SCALAR_MULTIPLY:
            return [x * self.scalar]
        if t is OperatorType.OP_SCALAR_ADD:
            return [x + self.scalar]
        if t is OperatorType.OP_SCALAR_SUB:
            return [x - self.scalar]
        if t is OperatorType.OP_SCALAR_TRUE_DIV:
            return [x / self.scalar]
        return [_UNARY_FNS[t](x)]
