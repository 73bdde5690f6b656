"""MultiHeadAttention op.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/attention.py`: separate q, k,
v and output projections (`wq`, `wk`, `wv`, `wo`, each [embed, in]; `bq` ..
`bo` zero-initialised, absent under bias=False), scaled dot-product scores,
a softmax in f32, dropout on the probabilities while training, the heads
joined and projected. Every product takes its operands rounded to the
compute dtype and multiplies them in f32 (the JAX package's
`preferred_element_type=f32` einsums; full-f32 matmuls on CUDA, where
`ops/dense.py` instead sends bf16-compute products to the tensor cores
through `Bf16Product`); the probabilities are rounded to the compute dtype before
the product with v, and the output is cast to the query's dtype. The
products stay plain `torch.matmul`, as the JAX package leaves them to XLA:
`F.scaled_dot_product_attention` would round elsewhere. `add_bias_kv` and
`add_zero_attn` are accepted and unused, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ffconst import OperatorType
from ..core.graph import Op
from ..core.initializers import DefaultWeightInit, ZeroInitializer
from ..core.tensor import TensorSpec
from .regularizers import dropout


def _mm(x: torch.Tensor, y: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x @ y of operands rounded to `cdt`, in f32."""
    return torch.matmul(x.to(cdt).float(), y.to(cdt).float())


def multihead_attention(q_in, k_in, v_in, params, num_heads: int, cdt: torch.dtype, bias: bool,
                        drop_rate: float = 0.0, key: Optional[torch.Tensor] = None,
                        block: int = 0) -> torch.Tensor:
    """[B, Sq, Dq], [B, Sk, Dk], [B, Sk, Dv] -> [B, Sq, E] in q_in's dtype;
    dropout on the probabilities where `key` is given and drop_rate > 0
    (the rows being block `block` of a batch sharded into equal blocks:
    the mask's entry indices start at block x the probabilities' volume)."""

    def proj(x, w, bkey):
        y = _mm(x, params[w].t(), cdt)
        return y + params[bkey] if bias else y

    e = params["wq"].shape[0]
    h, hd = num_heads, e // num_heads
    b, sq, _ = q_in.shape
    sk = k_in.shape[1]
    q = proj(q_in, "wq", "bq").reshape(b, sq, h, hd).transpose(1, 2)
    k = proj(k_in, "wk", "bk").reshape(b, sk, h, hd).transpose(1, 2)
    v = proj(v_in, "wv", "bv").reshape(b, sk, h, hd).transpose(1, 2)
    scores = _mm(q, k.transpose(-1, -2), cdt) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    if key is not None and drop_rate > 0.0:
        probs = dropout(probs, key, drop_rate, block * probs.numel())
    out = _mm(probs, v, cdt).transpose(1, 2).reshape(b, sq, e)
    y = _mm(out, params["wo"].t(), cdt)
    if bias:
        y = y + params["bo"]
    return y.to(q_in.dtype)


class MultiHeadAttention(Op):
    op_type = OperatorType.OP_MULTIHEAD_ATTENTION

    def __init__(
        self,
        name: str,
        query: TensorSpec,  # [B, Sq, Dq]
        key: TensorSpec,  # [B, Sk, Dk]
        value: TensorSpec,  # [B, Sk, Dv]
        embed_dim: int,
        num_heads: int,
        kdim: int = 0,
        vdim: int = 0,
        dropout: float = 0.0,
        bias: bool = True,
        add_bias_kv: bool = False,
        add_zero_attn: bool = False,
        kernel_initializer=None,
    ):
        super().__init__(name, [query, key, value])
        if embed_dim % num_heads:
            raise ValueError(f"attention: embed_dim {embed_dim} does not split into {num_heads} heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.dropout = dropout
        self.stochastic = dropout > 0.0
        b, sq, dq = query.shape
        self._out((b, sq, embed_dim))
        init = kernel_initializer or DefaultWeightInit()
        self._param("wq", (embed_dim, dq), init)
        self._param("wk", (embed_dim, key.shape[2]), init)
        self._param("wv", (embed_dim, value.shape[2]), init)
        self._param("wo", (embed_dim, embed_dim), init)
        if bias:
            for k in ("bq", "bk", "bv", "bo"):
                self._param(k, (embed_dim,), ZeroInitializer())
        self.bias = bias

    def forward(self, params, inputs, ctx):
        q_in, k_in, v_in = inputs
        key = ctx.op_rng(self) if ctx.training and self.dropout > 0.0 else None
        mesh = ctx.block_mesh(self)
        return [multihead_attention(q_in, k_in, v_in, params, self.num_heads, ctx.compute_dtype,
                                    self.bias, self.dropout, key, 0 if mesh is None else mesh.data_index)]

    def cost_stats(self):
        b, sq, dq = self.inputs[0].shape
        sk = self.inputs[1].shape[1]
        e = self.embed_dim
        proj = 2.0 * b * (sq * dq * e + sk * self.inputs[1].shape[2] * e + sk * self.inputs[2].shape[2] * e
                          + sq * e * e)
        attn = 2.0 * b * self.num_heads * sq * sk * self.head_dim * 2
        return {
            "flops": proj + attn,
            "bytes": 4.0 * (self.inputs[0].volume + self.outputs[0].volume),
            "param_bytes": 4.0 * sum(p.volume for p in self.params),
        }
