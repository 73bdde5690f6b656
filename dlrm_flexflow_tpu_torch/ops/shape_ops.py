"""Shape ops: concat.

PyTorch counterpart of `Concat` in `dlrm_flexflow_tpu/ops/shape_ops.py`;
the other shape ops of that file come with the slices that use them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ffconst import OperatorType
from ..core.graph import Op
from ..core.tensor import TensorSpec


class Concat(Op):
    op_type = OperatorType.OP_CONCAT

    def __init__(self, name: str, inputs: Sequence[TensorSpec], axis: int):
        super().__init__(name, inputs)
        self.axis = axis if axis >= 0 else axis + inputs[0].num_dims
        shape = list(inputs[0].shape)
        shape[self.axis] = sum(t.shape[self.axis] for t in inputs)
        self._out(tuple(shape), inputs[0].dtype)

    def forward(self, params, inputs, ctx):
        return [torch.cat(inputs, dim=self.axis)]
