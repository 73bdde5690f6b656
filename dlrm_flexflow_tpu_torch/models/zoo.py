"""Model zoo: the models of the reference's examples.

PyTorch counterpart of `dlrm_flexflow_tpu/models/zoo.py`: `mnist_mlp`,
`mnist_cnn`, `cifar10_cnn`, `alexnet`, `moe_mlp`, `transformer`, `resnet`
(with `_bottleneck`), `inception_v3` (with `_inception_a` to
`_inception_e`), `nmt`, `candle_uno` and `bert_proxy`: the same graphs (op
names, order and parameter shapes), signatures and defaults, plus the
model's `device` ("cuda" by default, as `make_dlrm_model` has). Each
returns an uncompiled FFModel; callers pick optimizer, loss and metrics.

`bert_proxy` has no softmax and no normalization, as its reference: with
unit-normal inputs its activations grow by orders of magnitude a layer, and
its default depth of 24 overflows f32 in the JAX package itself.
"""
from __future__ import annotations

from typing import Optional

from ..config import FFConfig
from ..core.ffmodel import FFModel
from ..ffconst import ActiMode, AggrMode, DataType, PoolType


def mnist_mlp(batch_size: int = 64, config: Optional[FFConfig] = None, device="cuda") -> FFModel:
    """reference: examples/python/native/mnist_mlp.py — 784-512-512-10."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, 784], name="image")
    t = model.dense(x, 512, activation=ActiMode.AC_MODE_RELU)
    t = model.dense(t, 512, activation=ActiMode.AC_MODE_RELU)
    t = model.dense(t, 10)
    model.softmax(t)
    return model


def mnist_cnn(batch_size: int = 64, config: Optional[FFConfig] = None, device="cuda") -> FFModel:
    """reference: examples/python/native/mnist_cnn.py — 2xconv32, pool,
    2xconv64, pool, dense 128, dense 10."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, 1, 28, 28], name="image")
    t = model.conv2d(x, 32, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.conv2d(t, 32, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 2, 2, 2, 2)
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 2, 2, 2, 2)
    t = model.flat(t)
    t = model.dense(t, 128, activation=ActiMode.AC_MODE_RELU)
    t = model.dense(t, 10)
    model.softmax(t)
    return model


def cifar10_cnn(batch_size: int = 64, config: Optional[FFConfig] = None, device="cuda") -> FFModel:
    """reference: examples/python/native/cifar10_cnn.py."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, 3, 32, 32], name="image")
    t = model.conv2d(x, 32, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.conv2d(t, 32, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 2, 2, 2, 2)
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 2, 2, 2, 2)
    t = model.flat(t)
    t = model.dense(t, 512, activation=ActiMode.AC_MODE_RELU)
    t = model.dense(t, 10)
    model.softmax(t)
    return model


def alexnet(batch_size: int = 64, config: Optional[FFConfig] = None, device="cuda") -> FFModel:
    """reference: examples/cpp/AlexNet/alexnet.cc (229x229 input variant)."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, 3, 229, 229], name="image")
    t = model.conv2d(x, 64, 11, 11, 4, 4, 2, 2, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 3, 3, 2, 2)
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 3, 3, 2, 2)
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 3, 3, 2, 2)
    t = model.flat(t)
    t = model.dense(t, 4096, activation=ActiMode.AC_MODE_RELU)
    t = model.dense(t, 4096, activation=ActiMode.AC_MODE_RELU)
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


def _bottleneck(model: FFModel, t, out_channels: int, stride: int):
    """reference: examples/cpp/ResNet/resnet.cc:34-54 BottleneckBlock."""
    inp = t
    t = model.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0)
    t = model.relu(t)
    t = model.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1)
    t = model.relu(t)
    t = model.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    if stride > 1 or inp.shape[1] != 4 * out_channels:
        inp = model.conv2d(inp, 4 * out_channels, 1, 1, stride, stride, 0, 0)
    t = model.add(inp, t)
    return model.relu(t)


def resnet(batch_size: int = 64, config: Optional[FFConfig] = None, device="cuda") -> FFModel:
    """ResNet-50-style (reference: examples/cpp/ResNet/resnet.cc:85-106):
    3-4-6-3 bottlenecks at 224x224, no BatchNorm, as the reference builds
    it."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, 3, 224, 224], name="image")
    t = model.conv2d(x, 64, 7, 7, 2, 2, 3, 3, activation=ActiMode.AC_MODE_RELU)
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1)
    for _ in range(3):
        t = _bottleneck(model, t, 64, 1)
    for i in range(4):
        t = _bottleneck(model, t, 128, 2 if i == 0 else 1)
    for i in range(6):
        t = _bottleneck(model, t, 256, 2 if i == 0 else 1)
    for i in range(3):
        t = _bottleneck(model, t, 512, 2 if i == 0 else 1)
    t = model.pool2d(t, 7, 7, 1, 1, 0, 0, pool_type=PoolType.POOL_AVG)
    t = model.flat(t)
    t = model.dense(t, 10)
    model.softmax(t)
    return model


def _inception_a(model, t, pool_features: int):
    """reference: examples/cpp/InceptionV3/inception.cc:26-41."""
    relu = ActiMode.AC_MODE_RELU
    t1 = model.conv2d(t, 64, 1, 1, 1, 1, 0, 0, activation=relu)
    t2 = model.conv2d(t, 48, 1, 1, 1, 1, 0, 0, activation=relu)
    t2 = model.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, activation=relu)
    t3 = model.conv2d(t, 64, 1, 1, 1, 1, 0, 0, activation=relu)
    t3 = model.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation=relu)
    t3 = model.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation=relu)
    t4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type=PoolType.POOL_AVG)
    t4 = model.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, activation=relu)
    return model.concat([t1, t2, t3, t4], 1)


def _inception_b(model, t):
    """reference: inception.cc:43-55."""
    t1 = model.conv2d(t, 384, 3, 3, 2, 2, 0, 0)
    t2 = model.conv2d(t, 64, 1, 1, 1, 1, 0, 0)
    t2 = model.conv2d(t2, 96, 3, 3, 1, 1, 1, 1)
    t2 = model.conv2d(t2, 96, 3, 3, 2, 2, 0, 0)
    t3 = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    return model.concat([t1, t2, t3], 1)


def _inception_c(model, t, channels: int):
    """reference: inception.cc:56-74 (1x7 and 7x1 factorized convs)."""
    t1 = model.conv2d(t, 192, 1, 1, 1, 1, 0, 0)
    t2 = model.conv2d(t, channels, 1, 1, 1, 1, 0, 0)
    t2 = model.conv2d(t2, channels, 1, 7, 1, 1, 0, 3)
    t2 = model.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t3 = model.conv2d(t, channels, 1, 1, 1, 1, 0, 0)
    t3 = model.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = model.conv2d(t3, channels, 1, 7, 1, 1, 0, 3)
    t3 = model.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = model.conv2d(t3, 192, 1, 7, 1, 1, 0, 3)
    t4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type=PoolType.POOL_AVG)
    t4 = model.conv2d(t4, 192, 1, 1, 1, 1, 0, 0)
    return model.concat([t1, t2, t3, t4], 1)


def _inception_d(model, t):
    """reference: inception.cc:75-89."""
    t1 = model.conv2d(t, 192, 1, 1, 1, 1, 0, 0)
    t1 = model.conv2d(t1, 320, 3, 3, 2, 2, 0, 0)
    t2 = model.conv2d(t, 192, 1, 1, 1, 1, 0, 0)
    t2 = model.conv2d(t2, 192, 1, 7, 1, 1, 0, 3)
    t2 = model.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t2 = model.conv2d(t2, 192, 3, 3, 2, 2, 0, 0)
    t3 = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    return model.concat([t1, t2, t3], 1)


def _inception_e(model, t):
    """reference: inception.cc:90-108."""
    t1 = model.conv2d(t, 320, 1, 1, 1, 1, 0, 0)
    t2i = model.conv2d(t, 384, 1, 1, 1, 1, 0, 0)
    t2 = model.conv2d(t2i, 384, 1, 3, 1, 1, 0, 1)
    t3 = model.conv2d(t2i, 384, 3, 1, 1, 1, 1, 0)
    t3i = model.conv2d(t, 448, 1, 1, 1, 1, 0, 0)
    t3i = model.conv2d(t3i, 384, 3, 3, 1, 1, 1, 1)
    t4 = model.conv2d(t3i, 384, 1, 3, 1, 1, 0, 1)
    t5 = model.conv2d(t3i, 384, 3, 1, 1, 1, 1, 0)
    t6 = model.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type=PoolType.POOL_AVG)
    t6 = model.conv2d(t6, 192, 1, 1, 1, 1, 0, 0)
    return model.concat([t1, t2, t3, t4, t5, t6], 1)


def inception_v3(batch_size: int = 32, config: Optional[FFConfig] = None, device="cuda") -> FFModel:
    """reference: examples/cpp/InceptionV3/inception.cc:120-170."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = model.create_tensor([batch_size, 3, 299, 299], name="image")
    t = model.conv2d(x, 32, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 32, 3, 3, 1, 1, 0, 0)
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 80, 1, 1, 1, 1, 0, 0)
    t = model.conv2d(t, 192, 3, 3, 1, 1, 1, 1)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = _inception_a(model, t, 32)
    t = _inception_a(model, t, 64)
    t = _inception_a(model, t, 64)
    t = _inception_b(model, t)
    t = _inception_c(model, t, 128)
    t = _inception_c(model, t, 160)
    t = _inception_c(model, t, 160)
    t = _inception_c(model, t, 192)
    t = _inception_d(model, t)
    t = _inception_e(model, t)
    t = _inception_e(model, t)
    t = model.pool2d(t, 8, 8, 1, 1, 0, 0, pool_type=PoolType.POOL_AVG)
    t = model.flat(t)
    t = model.dense(t, 10)
    model.softmax(t)
    return model


def nmt(
    batch_size: int = 64,
    src_len: int = 20,
    dst_len: int = 20,
    hidden_size: int = 2048,
    embed_size: int = 2048,
    vocab_size: int = 20 * 1024,
    num_layers: int = 2,
    config: Optional[FFConfig] = None,
    device="cuda",
) -> FFModel:
    """reference: the legacy NMT stand-alone (nmt/nmt.cc:33-47 defaults:
    batch 64, 2 LSTM layers, length 20, hidden and embed 2048, vocab 20k;
    graph nmt/rnn.cu:298-327): unpooled src and dst token embeddings feed
    a stacked encoder-decoder LSTM, each encoder layer's final (h_T, c_T)
    the initial state of the decoder layer beside it; the decoder's top
    sequence goes through a vocab linear and a softmax. Compile with
    LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY and the dst tokens [B,
    dst_len] as labels (teacher forcing)."""
    model = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    src = model.create_tensor([batch_size, src_len], dtype=DataType.DT_INT32, name="src_tokens")
    dst = model.create_tensor([batch_size, dst_len], dtype=DataType.DT_INT32, name="dst_tokens")
    enc = model.embedding(src, vocab_size, embed_size, aggr=AggrMode.AGGR_MODE_NONE, name="src_embed")
    dec = model.embedding(dst, vocab_size, embed_size, aggr=AggrMode.AGGR_MODE_NONE, name="dst_embed")
    for i in range(num_layers):
        enc, h_t, c_t = model.lstm(enc, hidden_size, name=f"enc_lstm_{i}")
        dec, _, _ = model.lstm(dec, hidden_size, initial_state=(h_t, c_t), name=f"dec_lstm_{i}")
    logits = model.dense(dec, vocab_size, name="vocab_linear")
    model.softmax(logits, name="softmax_dp")
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
