"""Shape ops: concat, split, flat, reshape, transpose, reverse.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/shape_ops.py`. Transpose
returns a strided view, as `torch.permute` does; the ops that need a
contiguous input make it so.

Flat and Reshape on a rank's block of a batch sharded over a data axis of
N > 1 reshape it to (T0 / N, *rest), T0 the target's leading dimension
(parallel/global_batch.py: compile checks that N divides T0).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
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


class Split(Op):
    op_type = OperatorType.OP_SPLIT

    def __init__(self, name: str, input: TensorSpec, sizes: Sequence[int], axis: int):
        super().__init__(name, [input])
        self.axis = axis if axis >= 0 else axis + input.num_dims
        self.sizes = [int(s) for s in sizes]
        if sum(self.sizes) != input.shape[self.axis]:
            raise ValueError(f"split sizes {self.sizes} do not add up to {input.shape[self.axis]}")
        for i, s in enumerate(self.sizes):
            shape = list(input.shape)
            shape[self.axis] = s
            self._out(tuple(shape), input.dtype, idx=i)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return list(torch.split(x, self.sizes, dim=self.axis))


class Flat(Op):
    """Collapse all non-batch dims (reference: src/ops/flat.cu)."""

    op_type = OperatorType.OP_FLAT

    def __init__(self, name: str, input: TensorSpec):
        super().__init__(name, [input])
        self._out((input.shape[0], int(np.prod(input.shape[1:]))), input.dtype)

    def forward(self, params, inputs, ctx):
        return [_reshape(self, inputs[0], ctx)]


def _reshape(op: Op, x: torch.Tensor, ctx) -> torch.Tensor:
    """x reshaped to op's output shape, or to the rank's block of it."""
    shape = op.outputs[0].shape
    mesh = ctx.block_mesh(op)
    if mesh is not None:
        shape = (shape[0] // mesh.data_size,) + tuple(shape[1:])
    return x.reshape(shape)


class Reshape(Op):
    op_type = OperatorType.OP_RESHAPE

    def __init__(self, name: str, input: TensorSpec, shape: Sequence[int]):
        super().__init__(name, [input])
        shape = tuple(int(d) for d in shape)
        if int(np.prod(shape)) != input.volume:
            raise ValueError(f"reshape {tuple(input.shape)} to {shape}: the sizes differ")
        self._out(shape, input.dtype)

    def forward(self, params, inputs, ctx):
        return [_reshape(self, inputs[0], ctx)]


class Transpose(Op):
    op_type = OperatorType.OP_TRANSPOSE

    def __init__(self, name: str, input: TensorSpec, perm: Sequence[int]):
        super().__init__(name, [input])
        self.perm = tuple(int(p) for p in perm)
        if sorted(self.perm) != list(range(input.num_dims)):
            raise ValueError(f"transpose: {self.perm} is no permutation of {input.num_dims} dims")
        self._out(tuple(input.shape[p] for p in self.perm), input.dtype)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return [x.permute(self.perm)]


class Reverse(Op):
    op_type = OperatorType.OP_REVERSE

    def __init__(self, name: str, input: TensorSpec, axis: int):
        super().__init__(name, [input])
        self.axis = axis if axis >= 0 else axis + input.num_dims
        self._out(input.shape, input.dtype)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return [torch.flip(x, dims=(self.axis,))]
