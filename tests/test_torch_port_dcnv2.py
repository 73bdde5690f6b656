"""DLRM-DCNv2 in the port on the CPU: a bag size a table and the "dcn"
interaction (`models/dlrm.py`, `ops/cross.py`) held against the benchmark's
plain reference (`benchmark/reference/dcnv2.py`) on the same seeded
weights; the tables drawn one at a time in their storage dtype
(`FFModel.compile`) with the bits of a draw of every parameter in f32; and
the cross network's sub-phases and the row update's id counter
(`utils/profiling.py`)."""
import math

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu_torch as port
from benchmark.reference import dcnv2 as ref
from benchmark.weights import draw
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
from dlrm_flexflow_tpu_torch.training.sparse_engine import ROW_UPDATE_IDS
from dlrm_flexflow_tpu_torch.utils.profiling import SUB_PHASES, reset_spans, span_totals

BATCH = 64
VOCABS = [50, 20000, 30, 9000]  # two tables on the row-update route (above 8192 rows), two one-hot
BAGS = [3, 1, 5, 2]
LR = 0.01


def _cfg(dtype: str) -> dict:
    return {"sparse_feature_size": 16, "vocab_sizes": VOCABS, "embedding_bag_size": BAGS,
            "mlp_bot": [13, 32, 16], "mlp_top": [80, 32, 1], "arch_interaction_op": "dcn",
            "dcn_num_layers": 2, "dcn_low_rank_dim": 8, "compute_dtype": dtype, "table_dtype": dtype,
            "onehot_embedding_threshold": 8192}


def _model(cfg: dict):
    dc = pdlrm.DLRMConfig(sparse_feature_size=cfg["sparse_feature_size"], embedding_size=cfg["vocab_sizes"],
                          embedding_bag_size=cfg["embedding_bag_size"], mlp_bot=cfg["mlp_bot"],
                          mlp_top=cfg["mlp_top"], arch_interaction_op="dcn", batch_size=BATCH,
                          dcn_num_layers=cfg["dcn_num_layers"], dcn_low_rank_dim=cfg["dcn_low_rank_dim"])
    m = pdlrm.make_dlrm_model(dc, port.FFConfig(batch_size=BATCH, packed_tables="on",
                                                compute_dtype=cfg["compute_dtype"],
                                                table_dtype=cfg["table_dtype"]), device="cpu")
    m.compile(port.SGDOptimizer(lr=LR), port.LossType.LOSS_BINARY_CROSSENTROPY)
    return dc, m


def _weights(cfg: dict, seed: int = 11):
    return {(leaf.op, leaf.key): draw(leaf, i, seed, "cpu") for i, leaf in enumerate(ref.leaves(cfg))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_the_plain_reference(dtype):
    """The probabilities of one batch and each leaf's first SGD gradient,
    read from the state as (W0 - W1) / lr, against the reference from the
    same weights (gaps seen: f32 1.4e-6, tables 3.8e-4; bf16 2.9e-3,
    bf16 tables 3.6e-2). f32: the sums differ in order and the row update
    rounds each stream entry to bf16 before it adds them
    (sparse_engine.py), so the tables' gradients agree to 2^-10 and the
    rest to 1e-5. bf16: every product's operands are rounded to bf16 (2^-9
    each), so the probabilities agree to 5e-3 and the first gradients of
    the parameters stored in f32 to 1e-2 in norm; a bf16 table's state
    shows a step's rounding flips, to 0.1."""
    cfg = _cfg(dtype)
    dc, m = _model(cfg)
    assert [op.name for op in m._sparse_ops if op.kernel_route] == ["table_1", "table_3"]
    p = _weights(cfg)
    for op in {leaf.op for leaf in ref.leaves(cfg)}:
        m.set_weights(op, {k: v for (o, k), v in p.items() if o == op})
    feeds, labels = random_batches(dc, BATCH, seed=5, zipf=1.05)
    assert [feeds[f"sparse_{i}"].shape for i in range(4)] == [(BATCH, b) for b in BAGS]
    dense = torch.as_tensor(feeds["dense_features"])
    sparse = [torch.as_tensor(feeds[f"sparse_{i}"]) for i in range(4)]
    got = m.forward(feeds).float().numpy()
    with ref.plain_matmuls():
        emb = [ref.lookup(cfg, p[(f"table_{i}", "weight")], sparse[i], "float32") for i in range(4)]
        want = ref.forward(cfg, p, dense, emb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if dtype == "float32" else 5e-3)

    m.train_batch(feeds, labels)
    params = m.get_parameters()
    after = {k: v.clone() for k, v in p.items()}
    with ref.plain_matmuls():
        ref.sgd_step(cfg, after, dense, sparse, torch.as_tensor(labels), LR)
    for leaf in ref.leaves(cfg):
        key = (leaf.op, leaf.key)
        w0 = p[key].float()
        g_port = float(torch.linalg.vector_norm(w0 - params[leaf.op][leaf.key].float())) / LR
        g_ref = float(torch.linalg.vector_norm(w0 - after[key].float())) / LR
        assert g_ref > 0, key
        table = leaf.op.startswith("table_")
        if dtype == "float32":
            tol = 2.0**-10 if table else 1e-5
        else:
            tol = 0.1 if table and leaf.dtype == "bfloat16" else 1e-2
        assert abs(g_port - g_ref) <= tol * g_ref, (key, g_port, g_ref)


@pytest.mark.parametrize("make", [pdlrm.kaggle_config, pdlrm.mlperf_lite_config])
def test_tables_made_one_at_a_time_draw_the_same_bits(make):
    """`compile` makes each table in its storage dtype before the next op
    draws; every parameter holds the bits of one f32 draw of all of them
    in graph order, cast afterwards (the draw before this order)."""
    cfg = make(batch_size=BATCH)
    cfg.embedding_size = [min(v, 30000) for v in cfg.embedding_size]
    m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=BATCH, packed_tables="on",
                                                 table_dtype="bfloat16"), device="cpu")
    m.compile(port.SGDOptimizer(lr=LR), port.LossType.LOSS_BINARY_CROSSENTROPY, seed=3)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    drawn = m.graph.init_params(gen, torch.device("cpu"))
    routed = {op.name for op in m._sparse_ops if op.kernel_route}
    assert routed and any(t.dtype == torch.float32 for sub in drawn.values() for t in sub.values())
    for name, sub in m.get_parameters().items():
        for k, t in sub.items():
            want = drawn[name][k].to(torch.bfloat16) if name in routed else drawn[name][k]
            assert t.dtype == want.dtype and torch.equal(t, want), (name, k)


def test_cross_phases_and_row_update_ids_on_the_cpu():
    """Three steps of a DCN model: each of the two cross sub-phases counts
    one a step, and the forward and backward around them still count one a
    step; the row update's id counter adds B x bag of each route table a
    step. A model without a cross network stamps no sub-phase."""
    dc, m = _model(_cfg("bfloat16"))
    feeds, labels = random_batches(dc, 3 * BATCH, seed=7)
    stack = {k: torch.as_tensor(v.reshape((3, BATCH) + v.shape[1:])) for k, v in feeds.items()}
    reset_spans()
    m.train_chunk(stack, torch.as_tensor(labels.reshape(3, BATCH)))
    tot = span_totals()
    for name in SUB_PHASES + ("phase:forward", "phase:backward"):
        assert tot[name]["count"] == 3 and tot[name]["device_s"] > 0, name
    assert tot[ROW_UPDATE_IDS] == {"count": 3, "total": 3 * BATCH * (BAGS[1] + BAGS[3])}
    flat = pdlrm.DLRMConfig(sparse_feature_size=8, embedding_size=[100, 20000], mlp_bot=[4, 8],
                            mlp_top=[24, 1], batch_size=BATCH)
    m = pdlrm.make_dlrm_model(flat, port.FFConfig(batch_size=BATCH, packed_tables="on"), device="cpu")
    m.compile(port.SGDOptimizer(lr=LR), port.LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, labels = random_batches(flat, BATCH, seed=8)
    reset_spans()
    m.train_batch(feeds, labels)
    tot = span_totals()
    assert tot["phase:forward"]["count"] == 1 and not set(SUB_PHASES) & set(tot)
    assert tot[ROW_UPDATE_IDS] == {"count": 1, "total": BATCH}
    reset_spans()


def test_dcnv2_config_is_mlperfs_shape():
    cfg = pdlrm.dcnv2_config()
    assert sum(cfg.embedding_size) == 204_184_588 and sum(cfg.bag_sizes()) == 214
    assert cfg.top_in_dim() == cfg.mlp_top[0] == 27 * 128
    cross = 2 * 2 * 3456 * 512 * cfg.dcn_num_layers
    widths = list(zip(cfg.mlp_bot[:-1], cfg.mlp_bot[1:])) + list(zip(cfg.mlp_top[:-1], cfg.mlp_top[1:]))
    assert cross + sum(2 * i * o for i, o in widths) == 32_060_928
    assert math.isclose(cross / 32_060_928, 0.6623, abs_tol=1e-4)
    with pytest.raises(ValueError, match="bag sizes"):
        pdlrm.DLRMConfig(embedding_size=[10, 10], embedding_bag_size=[1, 2, 3])
    with pytest.raises(ValueError, match="bottom MLP must end"):
        pdlrm.DLRMConfig(sparse_feature_size=16, mlp_bot=[13, 8], arch_interaction_op="dcn")
