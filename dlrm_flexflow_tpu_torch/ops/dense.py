"""Linear/Dense op.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/dense.py`. The JAX package
computes `jnp.dot(x.astype(cdt), w.T.astype(cdt),
preferred_element_type=f32)`: compute-dtype operands with an f32 result,
then the bias and the activation in f32. A plain bf16 `torch.matmul` rounds
its output to bf16, one rounding too many. So on the CPU, and on the card
for an f32 compute dtype, the operands are rounded to the compute dtype and
multiplied in f32: a product of two bf16 values is exact in f32, which
reproduces the XLA result up to the order of the sum (on CUDA in full f32,
`torch.backends.cuda.matmul.allow_tf32` False, PyTorch's default).

On CUDA under a bf16 compute dtype the product takes `Bf16Product`
instead: the bf16 operands go to the tensor cores with f32 sums and an f32
result (`torch.mm(..., out_dtype=torch.float32)`), the same products summed
in another order. Its backward keeps every product on the tensor cores
without rounding the f32 cotangent: `ops/kernels/bf16_split.py` splits it
exactly into three bf16 parts, and one product over the three gives each
gradient. The input and kernel gradients are then rounded to bf16, as
autograd through the rounded operands rounds them.

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
from .kernels.bf16_split import split_bf16x3
from .kernels.fused_mlp import fused_dense, padded_k


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with f32 sums and an f32 result: on CUDA on
    the tensor cores (no bf16 output, so no partial sum is rounded to
    bf16); on the CPU in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _bf16_padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t [r, c] rounded to bf16 as [rows, cols], zeros past its edge."""
    if tuple(t.shape) == (rows, cols):
        return t.to(torch.bfloat16).contiguous()
    out = t.new_zeros((rows, cols), dtype=torch.bfloat16)
    out[: t.shape[0], : t.shape[1]] = t
    return out


class Bf16Product(torch.autograd.Function):
    """x [M, K] @ kernel[N, K].T in f32 from bf16 operands. K and N are
    padded with zeros to multiples of 8, so every operand row is a whole
    number of 16-byte units. The backward splits the cotangent g into
    G3 = [hi | mid | lo] (`split_bf16x3`), so that
        dX = G3 @ [w; w; w]       and       dW = sum of the 3 blocks of G3^T @ x
    are f32 sums of exact products, then rounds both to bf16. `forwards`
    and `backwards` count the calls."""

    forwards = 0
    backwards = 0

    @staticmethod
    def forward(ctx, x, kernel):
        (m, k), n = x.shape, kernel.shape[0]
        kp, np_ = padded_k(k), padded_k(n)
        xb = _bf16_padded(x, m, kp)
        wb = _bf16_padded(kernel, np_, kp)
        ctx.save_for_backward(xb, wb)
        ctx.dims = (n, k, x.dtype, kernel.dtype)
        Bf16Product.forwards += 1
        y = _mm_f32(xb, wb.t())
        return y if np_ == n else y[:, :n].contiguous()

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        n, k, x_dtype, w_dtype = ctx.dims
        np_ = wb.shape[0]
        g3 = split_bf16x3(g.contiguous(), np_)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g3, torch.cat((wb, wb, wb)))[:, :k]
            dx = dx.to(torch.bfloat16).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(g3.t(), xb).view(3, np_, -1).sum(0)[:n, :k]
            dw = dw.to(torch.bfloat16).to(w_dtype)
        Bf16Product.backwards += 1
        return dx, dw


def dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    activation: ActiMode,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """x [..., in] @ kernel[out, in].T + bias, activation; result in x.dtype.
    On CUDA under a bf16 compute dtype the product is `Bf16Product` (a
    rank-3 input flattens its leading dimensions); else the rounded
    operands are multiplied in f32 (on CUDA counted in
    `dense.f32_products`)."""
    if x.is_cuda and compute_dtype == torch.bfloat16:
        y = Bf16Product.apply(x.reshape(-1, x.shape[-1]), kernel).view(*x.shape[:-1], kernel.shape[0])
    else:
        if x.is_cuda:
            dense.f32_products += 1
        y = torch.matmul(x.to(compute_dtype).float(), kernel.to(compute_dtype).float().t())
    if bias is not None:
        y = y + bias.float()
    return apply_activation(y, activation).to(x.dtype)


dense.f32_products = 0


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

    def cost_stats(self):
        batch_elems = 1
        for d in self.inputs[0].shape[:-1]:
            batch_elems *= d
        return {
            "flops": 2.0 * batch_elems * self.in_dim * self.out_dim,
            "bytes": 4.0 * (batch_elems * self.in_dim + batch_elems * self.out_dim + self.in_dim * self.out_dim),
            "param_bytes": 4.0 * (self.in_dim + 1) * self.out_dim,
        }
