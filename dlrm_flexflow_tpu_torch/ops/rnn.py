"""LSTM op.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/rnn.py`. Parameters in
torch.nn.LSTM's layout: `wx` [4H, E], `wh` [4H, H] and one `bias` [4H],
gates in [i, f, g, o] order. The input-side gates of every step come from
one [B * T, E] x [E, 4H] product; then T sequential [B, H] x [H, 4H]
products, with the state (h, c) in f32. Each product is an f32 product of
compute-dtype-rounded operands (`preferred_element_type=f32` in the JAX
package, as the port's `ops/dense.py` computes it), and a step's gates are
(input gates + recurrent product) + bias, in that order.

The time loop is a plain Python loop over T, so a CUDA graph of the train
step (`FFModel.train_chunk`) captures its kernels. torch.nn.LSTM, cuDNN's
RNN and `_VF.lstm` compute another function: two biases, and their own
rounding of h @ Wh^T.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ffconst import OperatorType
from ..core.graph import Op
from ..core.initializers import DefaultBiasInit, DefaultWeightInit
from ..core.tensor import TensorSpec


def lstm(
    x: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    bias: torch.Tensor,
    h0: Optional[torch.Tensor],
    c0: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, E] -> (y [B, T, H], h_T [B, H], c_T [B, H]) in x's dtype;
    (h0, c0) [B, H] or both None (zeros)."""
    b, t, e = x.shape
    hsz = wh.shape[1]
    f32 = torch.float32
    if h0 is None:
        h = torch.zeros((b, hsz), dtype=f32, device=x.device)
        c = torch.zeros((b, hsz), dtype=f32, device=x.device)
    else:
        h, c = h0.float(), c0.float()
    wx_t = wx.to(compute_dtype).float().t()
    wh_t = wh.to(compute_dtype).float().t()
    bias = bias.float()
    xg = torch.matmul(x.reshape(b * t, e).to(compute_dtype).float(), wx_t).reshape(b, t, 4 * hsz)
    ys = []
    for s in range(t):
        gates = xg[:, s] + torch.matmul(h.to(compute_dtype).float(), wh_t) + bias
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h.to(x.dtype))
    return torch.stack(ys, dim=1), h.to(x.dtype), c.to(x.dtype)


class LSTM(Op):
    op_type = OperatorType.OP_LSTM

    def __init__(
        self,
        name: str,
        input: TensorSpec,
        hidden_size: int,
        h0: TensorSpec = None,
        c0: TensorSpec = None,
        kernel_initializer=None,
        recurrent_initializer=None,
        bias_initializer=None,
    ):
        """input [B, T, E]; an optional initial state h0, c0 [B, H] (both
        or neither; zeros when absent). Outputs: the hidden sequence [B, T,
        H], then h_T and c_T [B, H], so an encoder's final state feeds a
        decoder layer as plain graph edges."""
        if (h0 is None) != (c0 is None):
            raise ValueError("lstm: pass both h0 and c0 or neither")
        super().__init__(name, [input] + ([h0, c0] if h0 is not None else []))
        if input.num_dims != 3:
            raise ValueError(f"LSTM input must be [B, T, E], got {input.shape}")
        b, t, e = input.shape
        h = int(hidden_size)
        self.hidden_size = h
        self.in_dim = int(e)
        self.seq_len = int(t)
        if h0 is not None and (tuple(h0.shape) != (b, h) or tuple(c0.shape) != (b, h)):
            raise ValueError(f"lstm: the initial state must be [B, H]=({b}, {h}), got {h0.shape}/{c0.shape}")
        self._out((b, t, h))
        self._out((b, h), idx=1)
        self._out((b, h), idx=2)
        self._param("wx", (4 * h, e), kernel_initializer or DefaultWeightInit())
        self._param("wh", (4 * h, h), recurrent_initializer or DefaultWeightInit())
        self._param("bias", (4 * h,), bias_initializer or DefaultBiasInit())

    def forward(self, params, inputs, ctx):
        h0, c0 = (inputs[1], inputs[2]) if len(inputs) == 3 else (None, None)
        return list(lstm(inputs[0], params["wx"], params["wh"], params["bias"], h0, c0, ctx.compute_dtype))

    def cost_stats(self):
        b, t, _ = self.inputs[0].shape
        h, e = self.hidden_size, self.in_dim
        return {
            "flops": 2.0 * b * t * (4 * h) * (e + h),
            "bytes": 4.0 * (b * t * (e + 5 * h) + 4 * h * (e + h)),
            "param_bytes": 4.0 * (4 * h * (e + h + 1)),
        }
