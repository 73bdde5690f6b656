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
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ffconst import ActiMode, OperatorType, as_acti_mode
from ..core.graph import Op
from ..core.initializers import DefaultBiasInit, DefaultWeightInit
from ..core.tensor import TensorSpec
from .common import apply_activation


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
        return [
            dense(
                x,
                params["kernel"],
                params["bias"] if self.use_bias else None,
                self.activation,
                ctx.compute_dtype,
            )
        ]
