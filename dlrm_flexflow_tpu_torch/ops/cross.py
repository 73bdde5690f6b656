"""Low-rank cross network op (DCN-V2).

The cross network of DCN-V2 (Wang et al., arXiv:2008.13535) as TorchRec's
`LowRankCrossNet` computes it: from x0 [B, d], layer l maps x_l to

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

with V_l [r, d] (no bias), W_l [r -> d] with a bias b_l [d], and x_0 = x0.
Parameters are kept [out, in] as Dense's: `v_kernel_<l>` [r, d],
`w_kernel_<l>` [d, r], `bias_<l>` [d]. The sum, the product with x0 and the
residual add are f32.

On CUDA under a bf16 compute dtype, with d and r multiples of 8, the
network is one autograd Function, `FusedCrossNet`: each product is the one
`ops/dense.py`'s `Bf16Product` makes (bf16 operands on the tensor cores
with f32 sums, the backward's f32 cotangent split exactly in three, the
input and kernel gradients rounded to bf16), and the f32 work between the
products is one pass a layer each way (`ops/kernels/cross_epilogue.py`,
`csrc/cross_epilogue.cu`). The V product's cotangent is the W product's
input gradient, already rounded to bf16, so its split would be itself and
two zero parts: its gradient products take it whole. It counts its layers in the counter
`cross:fused_layers` once a forward. Elsewhere (the CPU, an f32 compute
dtype, other widths) each product is `dense` and the epilogue PyTorch's
passes (`_layers`). On the card the two compute the same values but for
the order of f32 sums: b's gradient over the batch and x0's over the layers.

Inside a train step the network is the sub-phase `phase:cross_forward` of
the step's forward, and its backward `phase:cross_backward` of the step's
backward (utils/profiling.py `SUB_PHASES`).
"""
from __future__ import annotations

import functools

import torch

from ..core.graph import Op
from ..core.initializers import DefaultBiasInit, GlorotUniform
from ..core.tensor import TensorSpec
from ..ffconst import ActiMode, OperatorType
from ..utils.profiling import count
from .dense import _mm_f32, dense
from .kernels.cross_epilogue import cross_backward, cross_fold, cross_forward

FUSED_LAYERS = "cross:fused_layers"


class FusedCrossNet(torch.autograd.Function):
    """The cross network x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l over f32
    x0 [M, d], from the flat parameters (v_kernel_0, w_kernel_0, bias_0,
    v_kernel_1, ...), d and r multiples of 8. Forward, a layer: v =
    V bf16(x_l) and p = W bf16(v) in f32 from bf16 operands, then
    `cross_forward` makes x_{l+1} and the bf16 copy the next layer's V
    product takes. Saved: bf16(x_l), bf16(v), p (u = p + b is recomputed)
    and the bf16 kernels; no f32 x_l. Backward, from the last layer down:
    `cross_backward` makes the layer's gradient G from the one above and
    the V-input gradient of the layer above, adds G * u to x0's gradient
    and splits G * x0 in three for the W product's two gradient products;
    the V product's two take its cotangent dv, rounded to bf16, whole (its
    split's other parts are zero); `cross_fold` adds the residual and
    V-input gradients of layer 0 into x0's."""

    @staticmethod
    def forward(ctx, x0, *params):
        layers = len(params) // 3
        xb, x, saved = x0.to(torch.bfloat16), x0, []
        for layer in range(layers):
            v_kernel, w_kernel, bias = params[3 * layer:3 * layer + 3]
            vw, ww = v_kernel.to(torch.bfloat16), w_kernel.to(torch.bfloat16)
            vb = _mm_f32(xb, vw.t()).to(torch.bfloat16)
            p = _mm_f32(vb, ww.t())
            saved += [xb, vb, p, vw, ww]
            # x_l past layer 0 is kept by no one: x_{l+1} overwrites it
            x, xb = cross_forward(p, bias, x0, x, layer < layers - 1, out=x if layer else None)
        ctx.save_for_backward(x0, *saved, *params[2::3])
        ctx.dtypes = [t.dtype for t in params]
        return x

    @staticmethod
    def backward(ctx, g):
        x0, *rest = ctx.saved_tensors
        layers = len(ctx.dtypes) // 3
        saved, biases = rest[:5 * layers], rest[5 * layers:]
        g = g.contiguous()
        gx0 = torch.empty_like(x0)
        grads = []
        grad, dxv = g, None
        for layer in reversed(range(layers)):
            xb, vb, p, vw, ww = saved[5 * layer:5 * layer + 5]
            d = ww.shape[0]
            # the layer's G: the one above plus the above's V-input gradient, written over
            # the buffer of the one above (past the first: never over autograd's g)
            grad, g3, db = cross_backward(grad, dxv, p, biases[layer], x0, gx0, layer == layers - 1,
                                          g_out=None if grad is g else grad)
            dv = _mm_f32(g3, torch.cat((ww, ww, ww))).to(torch.bfloat16)
            dw = _mm_f32(g3.t(), vb).view(3, d, -1).sum(0)
            del g3  # 3 bf16 [M, d] parts: gone before the V product's gradients
            dxv = _mm_f32(dv, vw)
            dvk = _mm_f32(dv.t(), xb)
            grads[:0] = [dvk.to(torch.bfloat16), dw.to(torch.bfloat16), db]
        gx = cross_fold(gx0, grad, dxv) if ctx.needs_input_grad[0] else None
        return (gx, *(t.to(dtype) for t, dtype in zip(grads, ctx.dtypes)))


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

    def takes_fused(self, device: torch.device, cdt: torch.dtype) -> bool:
        """Whether the network runs as `FusedCrossNet`: on CUDA under a bf16
        compute dtype, with d and r multiples of 8."""
        return device.type == "cuda" and cdt == torch.bfloat16 and self.dim % 8 == 0 and self.rank % 8 == 0

    def _fused(self, params, x0: torch.Tensor) -> torch.Tensor:
        flat = [params[f"{key}_{layer}"] for layer in range(self.num_layers)
                for key in ("v_kernel", "w_kernel", "bias")]
        return FusedCrossNet.apply(x0.contiguous(), *flat)

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
        if self.takes_fused(x0.device, cdt):
            count(FUSED_LAYERS, self.num_layers)
            body = functools.partial(self._fused, params)
        else:
            body = functools.partial(self._layers, params, cdt=cdt)
        if ctx.phases is None:
            return [body(x0)]
        return [ctx.phases.cut("cross", x0, body)]

    def cost_stats(self):
        b = self.inputs[0].shape[0]
        product = 2.0 * b * self.dim * self.rank
        return {
            "flops": self.num_layers * (2.0 * product + 3.0 * b * self.dim),
            "bytes": 4.0 * self.num_layers * (6.0 * b * self.dim + 2.0 * b * self.rank
                                              + 2.0 * self.dim * self.rank),
            "param_bytes": 4.0 * self.num_layers * (2 * self.dim * self.rank + self.dim),
        }
