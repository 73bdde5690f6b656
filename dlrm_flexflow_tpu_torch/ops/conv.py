"""Conv2D, Pool2D and BatchNorm ops (NCHW, OIHW kernels).

PyTorch counterpart of `dlrm_flexflow_tpu/ops/conv.py`.

Conv2D. The JAX package casts both operands to the compute dtype and
convolves with no `preferred_element_type`: products summed in f32 and the
result rounded to the compute dtype once; then the result goes to f32 for
the bias and the activation and is cast to the input's dtype. The port
keeps that one rounding (unlike its `ops/dense.py`, whose products stay
f32). On the card cuDNN takes the compute-dtype operands as they are: it
sums in f32 and rounds its output once. On the CPU the operands are
widened to f32 and the result rounded to the compute dtype, the same
function, since a product of two bf16 values is exact in f32. The
gradients follow the JAX package's transposes: the output's cotangent is
rounded to the compute dtype, and the input's and the kernel's gradients
are convolutions in that dtype, rounded once.

cuDNN's global flags would otherwise decide the math: TF32 for f32 is on
by default (`torch.backends.cudnn.allow_tf32`), and its algorithms are
picked by benchmarking and may add by atomics. `conv_flags` sets TF32 off,
deterministic algorithms on and benchmarking off around every convolution
of this module, forward and backward. The backward runs when autograd
reaches it, outside any block around the forward, so the convolution is a
`torch.autograd.Function` whose backward sets the flags itself.

Pool2D. MAX pads with -inf; AVG divides by kh * kw, the padded cells
included (`count_include_pad=True`); floor-mode output sizes; the
activation after the pool. BatchNorm has no running statistics, as in the
JAX package: it normalises by the batch's own mean and biased variance, in
f32, in training and in `predict` alike, then scale, bias and an optional
ReLU. On a rank's block of a batch sharded over a data axis above 1 the
statistics are the global batch's, as GSPMD reduces them in the JAX
package: the per-channel sums all-reduced over the data group for the
mean, then the sums of the squared deviations for the variance, each an
all-reduce whose backward is the same all-reduce
(parallel/global_batch.py `all_reduce_sum`): two [C] f32 all-reduces
forward and two backward.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ffconst import ActiMode, OperatorType, PoolType, as_acti_mode
from ..core.graph import Op
from ..core.initializers import ConstantInitializer, DefaultBiasInit, DefaultWeightInit
from ..core.tensor import TensorSpec
from ..parallel.global_batch import all_reduce_sum
from .common import apply_activation


@contextlib.contextmanager
def conv_flags():
    """cuDNN on, TF32 off, deterministic algorithms, no benchmarking; the
    caller's flags come back after."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = True, False, True, False
    try:
        yield
    finally:
        cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = saved


def _widen(*ts: torch.Tensor):
    """On the CPU the operands in f32 (the products are exact there); on
    the card as they are."""
    return ts if ts[0].is_cuda else tuple(t.float() for t in ts)


def conv_forward(x: torch.Tensor, w: torch.Tensor, stride, padding, groups: int) -> torch.Tensor:
    """The convolution of compute-dtype operands, in the compute dtype."""
    with conv_flags():
        xw, ww = _widen(x, w)
        return F.conv2d(xw, ww, None, stride, padding, 1, groups).to(x.dtype)


def conv_backward(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, stride, padding, groups: int,
                  mask: Tuple[bool, bool]):
    """(dx, dw) in the compute dtype, None where `mask` says so."""
    with conv_flags():
        gyw, xw, ww = _widen(gy.to(x.dtype), x, w)
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gyw, xw, ww, None, list(stride), list(padding), [1, 1], False, [0, 0], groups,
            [mask[0], mask[1], False])
    return (None if gx is None else gx.to(x.dtype)), (None if gw is None else gw.to(w.dtype))


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return conv_forward(x, w, stride, padding, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw = conv_backward(gy, x, w, *ctx.conf, ctx.needs_input_grad[:2])
        return gx, gw, None, None, None


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    groups: int,
    activation: ActiMode,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """x [N, C, H, W] * kernel [O, C / groups, kh, kw], rounded to the
    compute dtype once, then bias and activation in f32; in x's dtype."""
    y = _Conv2d.apply(x.to(compute_dtype), kernel.to(compute_dtype), tuple(stride), tuple(padding),
                      groups).float()
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return apply_activation(y, activation).to(x.dtype)


def pool2d(x: torch.Tensor, kernel, stride, padding, pool_type: PoolType, activation: ActiMode) -> torch.Tensor:
    """MAX (padding of -inf) or AVG (a sum over kh * kw, the padded cells
    included) over floor-mode windows, then the activation; in x's dtype.
    Padding wider than half a window (which torch's pools refuse) is
    made explicit first."""
    kh, kw = kernel
    ph, pw = padding
    if ph > kh // 2 or pw > kw // 2:
        fill = float("-inf") if pool_type is PoolType.POOL_MAX else 0.0
        x_in = F.pad(x, (pw, pw, ph, ph), value=fill)
        ph = pw = 0
    else:
        x_in = x
    if pool_type is PoolType.POOL_MAX:
        y = F.max_pool2d(x_in, kernel, stride, (ph, pw))
    else:
        y = F.avg_pool2d(x_in, kernel, stride, (ph, pw), count_include_pad=True)
    return apply_activation(y, activation).to(x.dtype)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, relu: bool, eps: float,
               mesh=None) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias over the batch's own
    statistics per channel (biased variance), in f32; in x's dtype. With
    `mesh`, x is the rank's block of a batch sharded over its data axis,
    and the statistics are the global batch's."""
    x32 = x.float()
    dims = (0, 2, 3)
    if mesh is None:
        mean = x32.mean(dim=dims, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=dims, keepdim=True)
    else:
        count = x32.numel() // x32.shape[1] * mesh.data_size
        group = mesh.data_group()
        mean = all_reduce_sum(x32.sum(dim=dims, keepdim=True), group) / count
        var = all_reduce_sum(((x32 - mean) ** 2).sum(dim=dims, keepdim=True), group) / count
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale[None, :, None, None] + bias[None, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _out_hw(h: int, w: int, kernel, stride, padding) -> Tuple[int, int]:
    return ((h + 2 * padding[0] - kernel[0]) // stride[0] + 1,
            (w + 2 * padding[1] - kernel[1]) // stride[1] + 1)


class Conv2D(Op):
    op_type = OperatorType.OP_CONV2D

    def __init__(
        self,
        name: str,
        input: TensorSpec,  # [N, C, H, W]
        out_channels: int,
        kernel_h: int,
        kernel_w: int,
        stride_h: int = 1,
        stride_w: int = 1,
        padding_h: int = 0,
        padding_w: int = 0,
        activation=ActiMode.AC_MODE_NONE,
        groups: int = 1,
        use_bias: bool = True,
        kernel_initializer=None,
        bias_initializer=None,
    ):
        super().__init__(name, [input])
        if input.num_dims != 4:
            raise ValueError(f"conv2d expects NCHW, got {input.shape}")
        n, c, h, w = input.shape
        self.out_channels = out_channels
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.groups = groups
        self.activation = as_acti_mode(activation)
        self.use_bias = use_bias
        self._out((n, out_channels) + _out_hw(h, w, self.kernel, self.stride, self.padding), input.dtype)
        self._param("kernel", (out_channels, c // groups, kernel_h, kernel_w),
                    kernel_initializer or DefaultWeightInit())
        if use_bias:
            self._param("bias", (out_channels,), bias_initializer or DefaultBiasInit())

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        bias = params["bias"] if self.use_bias else None
        return [conv2d(x, params["kernel"], bias, self.stride, self.padding, self.groups, self.activation,
                       ctx.compute_dtype)]

    def cost_stats(self):
        n, co, oh, ow = self.outputs[0].shape
        ci = self.inputs[0].shape[1] // self.groups
        kh, kw = self.kernel
        return {
            "flops": 2.0 * n * co * oh * ow * ci * kh * kw,
            "bytes": 4.0 * (self.inputs[0].volume + self.outputs[0].volume),
            "param_bytes": 4.0 * (co * ci * kh * kw + co),
        }


class Pool2D(Op):
    op_type = OperatorType.OP_POOL2D

    def __init__(
        self,
        name: str,
        input: TensorSpec,
        kernel_h: int,
        kernel_w: int,
        stride_h: int = 1,
        stride_w: int = 1,
        padding_h: int = 0,
        padding_w: int = 0,
        pool_type: PoolType = PoolType.POOL_MAX,
        activation=ActiMode.AC_MODE_NONE,
    ):
        super().__init__(name, [input])
        n, c, h, w = input.shape
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.pool_type = pool_type
        self.activation = as_acti_mode(activation)
        self._out((n, c) + _out_hw(h, w, self.kernel, self.stride, self.padding), input.dtype)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return [pool2d(x, self.kernel, self.stride, self.padding, self.pool_type, self.activation)]


class BatchNorm(Op):
    op_type = OperatorType.OP_BATCHNORM

    def __init__(self, name: str, input: TensorSpec, relu: bool = True, eps: float = 1e-5):
        super().__init__(name, [input])
        if input.num_dims != 4:
            raise ValueError(f"batch_norm expects NCHW, got {input.shape}")
        c = input.shape[1]
        self.relu = relu
        self.eps = eps
        self._out(input.shape, input.dtype)
        self._param("scale", (c,), ConstantInitializer(1.0))
        self._param("bias", (c,), ConstantInitializer(0.0))

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return [batch_norm(x, params["scale"], params["bias"], self.relu, self.eps, ctx.block_mesh(self))]
