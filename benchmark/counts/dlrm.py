"""Operations and bytes of a DLRM's matrix products, from its sizes.

A product [M, K] x [K, N] is 2 * M * K * N operations. The least time of
one product is the larger of its operations at the bf16 peak and its
bytes at the HBM peak, where each operand is read once and each result
written once: activations and weights at 2 bytes (bfloat16, the compute
dtype the configurations state), a weight gradient at 4 (float32, the
parameters' dtype). Training counts the forward products and, for each
layer, the weight gradient and the input gradient, except the input
gradient of the first bottom layer, which nothing needs (the dense
features are no parameter). The "dot" interaction counts the products of
its pairs only (F(F-1)/2 dots of D), forward, and twice that backward.
"""
from __future__ import annotations

from typing import List, Tuple

ACT_BYTES = 2
GRAD_BYTES = 4


def mlp_layers(cfg: dict) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of every Dense layer, bottom then top."""
    out = []
    for widths in (cfg["mlp_bot"], cfg["mlp_top"]):
        out += list(zip(widths[:-1], widths[1:]))
    return out


def interaction_pairs(cfg: dict) -> int:
    if cfg["arch_interaction_op"] != "dot":
        return 0
    f = len(cfg["vocab_sizes"]) + 1
    return f * (f - 1) // 2


def forward_flop_per_example(cfg: dict) -> int:
    """Matrix-product operations of one example's forward pass."""
    mlp = sum(2 * i * o for i, o in mlp_layers(cfg))
    return mlp + 2 * interaction_pairs(cfg) * cfg["sparse_feature_size"]


def train_flop_per_example(cfg: dict) -> int:
    """Matrix-product operations of one example's forward and backward."""
    layers = mlp_layers(cfg)
    weight_grads = sum(2 * i * o for i, o in layers)
    input_grads = sum(2 * i * o for i, o in layers[1:])
    pairs = 4 * interaction_pairs(cfg) * cfg["sparse_feature_size"]
    return forward_flop_per_example(cfg) + weight_grads + input_grads + pairs


def _product(m: int, k: int, n: int, out_bytes: int, peaks: dict) -> float:
    """The least seconds of [m, k] x [k, n]."""
    flop = 2.0 * m * k * n
    byts = ACT_BYTES * (m * k + k * n) + out_bytes * m * n
    return max(flop / peaks["bf16_flop_per_s"], byts / peaks["hbm_byte_per_s"])


def mlp_least_seconds(cfg: dict, batch: int, train: bool, peaks: dict) -> float:
    """The least seconds of the MLPs' products for one batch: the forward
    products, and under `train` the input and weight gradients too."""
    total = 0.0
    for n, (i, o) in enumerate(mlp_layers(cfg)):
        total += _product(batch, i, o, ACT_BYTES, peaks)  # y = x w^T
        if train:
            total += _product(o, batch, i, GRAD_BYTES, peaks)  # dw = dy^T x
            if n > 0:
                total += _product(batch, o, i, ACT_BYTES, peaks)  # dx = dy w
    return total
