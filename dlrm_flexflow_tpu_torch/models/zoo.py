"""Model zoo: the non-convolutional, non-recurrent models of the reference's
examples.

PyTorch counterpart of `dlrm_flexflow_tpu/models/zoo.py` for `mnist_mlp`,
`moe_mlp`, `transformer`, `candle_uno` and `bert_proxy`: the same graphs
(op names, order and parameter shapes), signatures and defaults, plus the
model's `device` ("cuda" by default, as `make_dlrm_model` has). Each
returns an uncompiled FFModel; callers pick optimizer, loss and metrics.
The CNN models and `nmt` are a later slice (ROADMAP.md Queue 1 item 9b).

`bert_proxy` has no softmax and no normalization, as its reference: with
unit-normal inputs its activations grow by orders of magnitude a layer, and
its default depth of 24 overflows f32 in the JAX package itself.
"""
from __future__ import annotations

from typing import Optional

from ..config import FFConfig
from ..core.ffmodel import FFModel
from ..ffconst import ActiMode


def mnist_mlp(batch_size: int = 64, config: Optional[FFConfig] = None, device="cuda") -> FFModel:
    """reference: examples/python/native/mnist_mlp.py — 784-512-512-10."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, 784], name="image")
    t = model.dense(x, 512, activation=ActiMode.AC_MODE_RELU)
    t = model.dense(t, 512, activation=ActiMode.AC_MODE_RELU)
    t = model.dense(t, 10)
    model.softmax(t)
    return model


def moe_mlp(
    batch_size: int = 64,
    num_experts: int = 4,
    k: int = 2,
    alpha: float = 2.0,
    lambda_bal: float = 0.0,
    in_dim: int = 784,
    num_classes: int = 10,
    config: Optional[FFConfig] = None,
    device="cuda",
) -> FFModel:
    """reference: examples/cpp/mixture_of_experts/moe.cc:101+ — gate
    (dense+softmax+topk), group_by, per-expert MLPs, aggregate."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, in_dim], name="input")
    gate = model.dense(x, 64, activation=ActiMode.AC_MODE_RELU, name="gate_h")
    gate = model.dense(gate, num_experts, name="gate_out")
    gate = model.softmax(gate, name="gate_probs")
    topk_vals, topk_idx = model.top_k(gate, k)
    buckets = model.group_by(x, topk_idx, num_experts, alpha)
    exp_preds = []
    for e in range(num_experts):
        t = model.dense(buckets[e], 64, activation=ActiMode.AC_MODE_RELU, name=f"expert{e}_h")
        t = model.dense(t, num_classes, name=f"expert{e}_out")
        exp_preds.append(model.softmax(t, name=f"expert{e}_probs"))
    # the reference's aggregate signature: preds, assign, true assign, full
    # gate grads, then the experts' outputs
    model.aggregate([topk_vals, topk_idx, topk_idx, gate] + exp_preds, num_experts, lambda_bal)
    return model


def transformer(
    batch_size: int = 8,
    seq_len: int = 64,
    hidden: int = 128,
    num_heads: int = 8,
    num_layers: int = 2,
    config: Optional[FFConfig] = None,
    device="cuda",
) -> FFModel:
    """reference: examples/cpp/Transformer/transformer.cc — stacked
    self-attention + 2-layer FFN blocks with residual adds."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    t = model.create_tensor([batch_size, seq_len, hidden], name="tokens")
    for i in range(num_layers):
        a = model.multihead_attention(t, t, t, hidden, num_heads, name=f"attn_{i}")
        t = model.add(a, t, name=f"res_attn_{i}")
        f = model.dense(t, hidden * 4, activation=ActiMode.AC_MODE_RELU, name=f"ffn1_{i}")
        f = model.dense(f, hidden, name=f"ffn2_{i}")
        t = model.add(f, t, name=f"res_ffn_{i}")
    return model


def candle_uno(
    batch_size: int = 64,
    dense_layers=(1000, 1000, 1000),
    dense_feature_layers=(1000, 1000, 1000),
    feature_shapes=None,
    config: Optional[FFConfig] = None,
    device="cuda",
) -> FFModel:
    """reference: examples/cpp/candle_uno/candle_uno.cc:48-124 — an encoder
    MLP tower for each input feature, concatenated into a regression head.
    Default shapes are the reference's: dose scalars (not encoded), cell
    rnaseq 942, drug descriptors 5270, fingerprints 2048."""
    if feature_shapes is None:
        feature_shapes = {"dose": 1, "cell.rnaseq": 942,
                          "drug.descriptors": 5270, "drug.fingerprints": 2048}
    input_features = {
        "dose1": "dose", "dose2": "dose",
        "cell.rnaseq": "cell.rnaseq",
        "drug1.descriptors": "drug.descriptors",
        "drug1.fingerprints": "drug.fingerprints",
        "drug2.descriptors": "drug.descriptors",
        "drug2.fingerprints": "drug.fingerprints",
    }
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    encoded = []
    for fname, kind in input_features.items():
        t = model.create_tensor([batch_size, feature_shapes[kind]], name=fname)
        if kind != "dose":
            for out_dim in dense_feature_layers:
                t = model.dense(t, out_dim, activation=ActiMode.AC_MODE_RELU)
        encoded.append(t)
    out = model.concat(encoded, 1)
    for out_dim in dense_layers:
        out = model.dense(out, out_dim, activation=ActiMode.AC_MODE_RELU)
    model.dense(out, 1)
    return model


def bert_proxy(
    batch_size: int = 8,
    seq_length: int = 128,
    hidden: int = 1024,
    num_heads: int = 16,
    num_layers: int = 24,
    config: Optional[FFConfig] = None,
    device="cuda",
) -> FFModel:
    """reference: examples/python/native/bert_proxy_native.py — attention as
    dense q, k, v, reshape, transpose and batch_matmul pairs (seq_length
    aware, in the runtime's innermost-first dim convention), GELU FFN
    blocks."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    t = model.create_tensor([batch_size, seq_length, hidden], name="tokens")
    kdim = vdim = hidden // num_heads
    for i in range(num_layers):
        q = model.dense(t, hidden, name=f"q_{i}")
        k = model.dense(t, hidden, name=f"k_{i}")
        v = model.dense(t, hidden, name=f"v_{i}")
        q = model.reshape(q, (batch_size, seq_length, num_heads, kdim))
        k = model.reshape(k, (batch_size, seq_length, num_heads, kdim))
        v = model.reshape(v, (batch_size, seq_length, num_heads, vdim))
        q = model.transpose(q, (0, 2, 1, 3))
        k = model.transpose(k, (0, 2, 3, 1))
        v = model.transpose(v, (0, 2, 1, 3))
        logits = model.batch_matmul(q, k, a_seq_length_dim=1, b_seq_length_dim=0)
        attn = model.batch_matmul(logits, v, a_seq_length_dim=0, b_seq_length_dim=1)
        attn = model.transpose(attn, (0, 2, 1, 3))
        attn = model.reshape(attn, (batch_size, seq_length, hidden))
        t = model.dense(attn, hidden, activation=ActiMode.AC_MODE_GELU, name=f"proj_{i}")
        t = model.dense(t, hidden, activation=ActiMode.AC_MODE_GELU, name=f"ffn_{i}")
    return model
