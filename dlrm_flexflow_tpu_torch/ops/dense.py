"""Linear/Dense op.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/dense.py`. The JAX package
computes `jnp.dot(x.astype(cdt), w.T.astype(cdt),
preferred_element_type=f32)`: compute-dtype operands with an f32 result,
then the bias and the activation in f32. A plain bf16 `torch.matmul` rounds
its output to bf16, one rounding too many, so the operands are rounded to
the compute dtype and multiplied in f32: a product of two bf16 values is
exact in f32, which reproduces the XLA result up to the order of the sum.
On CUDA that needs full-f32 matmuls (`torch.backends.cuda.matmul.allow_tf32`
False, PyTorch's default).

Under use_pallas="on" a rank-2 input goes to the fused dense kernel
(`ops/kernels/fused_mlp.py`), as the JAX package sends it to `dense_pallas`
(`ops/dense.py:58-67`): that route also rounds the bias and the output to
the compute dtype.

A Dense named in `ctx.model_parallel` is column-parallel over the mesh's
"model" axis (parallel/tensor_parallel.py): its parameters are this rank's
row block, and it runs as copy-in, the same product on the block, then the
blocks gathered into the whole output.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ffconst import ActiMode, OperatorType, as_acti_mode
from ..core.graph import Op
from ..core.initializers import DefaultBiasInit, DefaultWeightInit
from ..core.tensor import TensorSpec
from ..parallel.tensor_parallel import copy_in, gather_out
from .common import apply_activation
from .kernels.fused_mlp import fused_dense


def dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    activation: ActiMode,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """x [..., in] @ kernel[out, in].T + bias, activation; result in x.dtype."""
    xc = x.to(compute_dtype).float()
    wc = kernel.to(compute_dtype).float()
    y = torch.matmul(xc, wc.t())
    if bias is not None:
        y = y + bias.float()
    return apply_activation(y, activation).to(x.dtype)


class Dense(Op):
    op_type = OperatorType.OP_LINEAR

    def __init__(
        self,
        name: str,
        input: TensorSpec,
        out_dim: int,
        activation=ActiMode.AC_MODE_NONE,
        use_bias: bool = True,
        kernel_initializer=None,
        bias_initializer=None,
    ):
        super().__init__(name, [input])
        self.out_dim = int(out_dim)
        self.in_dim = int(input.shape[-1])
        self.activation = as_acti_mode(activation)
        self.use_bias = use_bias
        self._out(tuple(input.shape[:-1]) + (self.out_dim,), input.dtype)
        # weight layout [out, in], as in the JAX package
        self._param(
            "kernel",
            (self.out_dim, self.in_dim),
            kernel_initializer or DefaultWeightInit(),
        )
        if use_bias:
            self._param("bias", (self.out_dim,), bias_initializer or DefaultBiasInit())

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        tp = self.name in ctx.model_parallel
        if tp:
            mesh = ctx.mesh
            x = copy_in(x, mesh.model_group())
        bias = params["bias"] if self.use_bias else None
        if ctx.use_pallas == "on" and x.dim() == 2:
            y = fused_dense(x.contiguous(), params["kernel"], bias, self.activation, ctx.compute_dtype)
        else:
            y = dense(x, params["kernel"], bias, self.activation, ctx.compute_dtype)
        if tp:
            y = gather_out(y, mesh.model_size, mesh.model_index, mesh.model_group())
        return [y]
