"""Operations and bytes of DLRM-DCNv2's work, from its sizes.

The MLPs are counted as `counts/dlrm.py` counts them. Each low-rank cross
layer x_{l+1} = x0 * (W (V x_l) + b) + x_l at width d = (tables + 1) x D
and rank r has two products forward ([B, d] x [d, r], [B, r] x [r, d]),
and backward each one's weight and input gradient (every input gradient is
needed: x0 holds the pooled rows). Its least time is those products, each
at the larger of its operations at the bf16 peak and its bytes at the HBM
peak (`counts/dlrm.py`), plus the elementwise epilogue's bytes at the HBM
peak, in float32, the dtype of the activations between layers: forward it
reads the product's output, x0 and x_l and writes x_{l+1}; backward it
reads the incoming gradient, x0 and the layer's sum W (V x_l) + b, writes
the product's cotangent, and reads and writes x0's running gradient: ten
[B, d] float32 tensors a layer.
"""
from __future__ import annotations

from . import dlrm
from .dlrm import mlp_least_seconds  # noqa: F401 (the MLPs are counted as for the DLRM family)

EPILOGUE_TENSORS = 10
ACT32_BYTES = 4


def width(cfg: dict) -> int:
    return (len(cfg["vocab_sizes"]) + 1) * cfg["sparse_feature_size"]


def cross_forward_flop_per_example(cfg: dict) -> int:
    return cfg["dcn_num_layers"] * 2 * (2 * width(cfg) * cfg["dcn_low_rank_dim"])


def forward_flop_per_example(cfg: dict) -> int:
    """Matrix-product operations of one example's forward pass."""
    return dlrm.forward_flop_per_example(cfg) + cross_forward_flop_per_example(cfg)


def train_flop_per_example(cfg: dict) -> int:
    """Matrix-product operations of one example's forward and backward."""
    return dlrm.train_flop_per_example(cfg) + 3 * cross_forward_flop_per_example(cfg)


def cross_least_seconds(cfg: dict, batch: int, peaks: dict) -> float:
    """The least seconds of the cross network's forward and backward for
    one batch: its products and its epilogue's bytes."""
    d, r = width(cfg), cfg["dcn_low_rank_dim"]
    act, grad = dlrm.ACT_BYTES, dlrm.GRAD_BYTES
    layer = (dlrm._product(batch, d, r, ACT32_BYTES, peaks)  # V x_l
             + dlrm._product(batch, r, d, ACT32_BYTES, peaks)  # W v
             + dlrm._product(d, batch, r, grad, peaks)  # dW = du^T v
             + dlrm._product(batch, d, r, act, peaks)  # dv = du W
             + dlrm._product(r, batch, d, grad, peaks)  # dV = dv^T x_l
             + dlrm._product(batch, r, d, act, peaks)  # dx_l = dv V
             + EPILOGUE_TENSORS * batch * d * ACT32_BYTES / peaks["hbm_byte_per_s"])
    return cfg["dcn_num_layers"] * layer
