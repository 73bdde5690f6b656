"""BatchMatmul op.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/batch_matmul.py`: C[b] =
A[b] @ B[b] over the leading batch dims. The operands are rounded to the
compute dtype and multiplied in f32 (the JAX package's
`preferred_element_type=f32`, as `ops/dense.py` does), the result cast to
A's dtype. Under the iteration config's `seq_length` (the reference's
FFIterationConfig, in its innermost-first dim convention: 0 the last axis,
1 the one before) the named axes of A and B are cut to that length, and the
product is padded with zeros back to the static output shape.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ffconst import OperatorType
from ..core.graph import Op
from ..core.tensor import TensorSpec


def _cut(x: torch.Tensor, seq_dim: int, seq: int) -> torch.Tensor:
    if seq_dim == 0:
        return x[..., :seq]
    if seq_dim == 1:
        return x[..., :seq, :]
    return x


def batch_matmul(a: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return torch.matmul(a.to(compute_dtype).float(), b.to(compute_dtype).float()).to(a.dtype)


class BatchMatmul(Op):
    op_type = OperatorType.OP_BATCHMATMUL

    def __init__(
        self,
        name: str,
        a: TensorSpec,
        b: TensorSpec,
        a_seq_length_dim: int = -1,
        b_seq_length_dim: int = -1,
    ):
        super().__init__(name, [a, b])
        if not (a.num_dims == b.num_dims >= 3 and a.shape[:-2] == b.shape[:-2]
                and a.shape[-1] == b.shape[-2]):
            raise ValueError(f"batch_matmul of {tuple(a.shape)} and {tuple(b.shape)}")
        if a_seq_length_dim not in (-1, 0, 1) or b_seq_length_dim not in (-1, 0, 1):
            raise ValueError("batch_matmul: a seq_length dim is one of the two innermost (0, 1) or -1")
        self.a_seq_length_dim = a_seq_length_dim
        self.b_seq_length_dim = b_seq_length_dim
        self._out(tuple(a.shape[:-1]) + (b.shape[-1],), a.dtype)

    def forward(self, params, inputs, ctx):
        a, b = inputs
        seq = ctx.seq_length
        if seq is not None and seq > 0:
            a = _cut(a, self.a_seq_length_dim, seq)
            b = _cut(b, self.b_seq_length_dim, seq)
        y = batch_matmul(a, b, ctx.compute_dtype)
        m, n = self.outputs[0].shape[-2:]
        if y.shape[-2:] != (m, n):
            y = F.pad(y, (0, n - y.shape[-1], 0, m - y.shape[-2]))
        return [y]
