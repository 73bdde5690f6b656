"""The yardstick's counts, the generator and the weights against hand
counts and their own promises."""
import json

import pytest
import torch

from benchmark import harness
from benchmark.counts import dlrm as counts
from benchmark.counts import peaks
from benchmark.traffic import generator
from benchmark.weights import BLOCK_ROWS, change_norm, draw, draw_block
from benchmark.reference import dlrm as ref


def config(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def test_kaggle_matmul_counts():
    cfg = config("dlrm-kaggle")
    # bottom 13-512-256-64-16 and top 432-512-256-1: 507,648 multiply-adds
    assert counts.forward_flop_per_example(cfg) == 1_015_296
    # + weight gradients (1,015,296) + input gradients but the first layer's (1,001,984)
    assert counts.train_flop_per_example(cfg) == 3_032_576


def test_mlperf_lite_forward_counts():
    cfg = config("dlrm-mlperf-lite")
    mlp = 2 * (13 * 512 + 512 * 256 + 256 * 128 + 479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    assert mlp == 4_730_368
    assert counts.interaction_pairs(cfg) == 351
    assert counts.forward_flop_per_example(cfg) == 4_730_368 + 89_856


def test_least_time_of_one_product():
    cfg = {"mlp_bot": [4, 8], "mlp_top": [8, 2], "arch_interaction_op": "cat", "vocab_sizes": [],
           "sparse_feature_size": 8}
    pk = {"bf16_flop_per_s": 1e12, "hbm_byte_per_s": 1e9}
    # bytes bound: [B, 4] x [4, 8] reads 2(4B + 32), writes 2 * 8B; [B, 8] x [8, 2] likewise
    b = 1000
    want = (2 * (4 * b + 32) + 2 * 8 * b) / 1e9 + (2 * (8 * b + 16) + 2 * 2 * b) / 1e9
    assert counts.mlp_least_seconds(cfg, b, False, pk) == pytest.approx(want)


def test_h100_peaks():
    assert peaks("NVIDIA H100 80GB HBM3")["bf16_flop_per_s"] == 989e12
    assert peaks("cpu") is None


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_batches_repeat_for_a_seed(seed):
    mix = {"ids": {"dist": "zipf", "s": 1.05}}
    a = generator.batches([100, 5000], 13, 1, 2, 64, mix, seed, "cpu")
    b = generator.batches([100, 5000], 13, 1, 2, 64, mix, seed, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["sparse_1"].min() >= 0 and a["sparse_1"].max() < 5000
    assert a["dense_features"].shape == (2, 64, 13) and a["labels"].shape == (2, 64, 1)


def test_two_seeds_differ_and_zipf_is_skewed():
    mix = {"ids": {"dist": "zipf", "s": 1.05}}
    a = generator.batches([1000], 13, 1, 1, 4096, mix, 1, "cpu")
    b = generator.batches([1000], 13, 1, 1, 4096, mix, 2, "cpu")
    for k in a:
        assert not torch.equal(a[k], b[k])
    ids = a["sparse_0"].reshape(-1)
    # rank 0 is the hottest row: far above the uniform share of 1/1000
    assert (ids == 0).float().mean() > 0.05
    u = generator.batches([1000], 13, 1, 1, 4096, {"ids": {"dist": "uniform"}}, 1, "cpu")
    assert (u["sparse_0"] == 0).float().mean() < 0.01


def test_weights_by_block_match_the_whole_leaf():
    leaf = ref.Leaf("t", "weight", (BLOCK_ROWS + 10, 2), "bfloat16", 0.5)
    whole = draw(leaf, 3, 99, "cpu")
    assert whole.dtype == torch.bfloat16 and whole.shape == leaf.shape
    assert torch.equal(draw_block(leaf, 3, 1, BLOCK_ROWS, BLOCK_ROWS + 10, 99, "cpu"), whole[BLOCK_ROWS:])
    assert change_norm(leaf, 3, 99, whole) == 0.0
    moved = whole.clone()
    moved[-1, 0] += 1.0
    assert change_norm(leaf, 3, 99, moved) == pytest.approx(1.0, rel=1e-2)
    assert not torch.equal(draw(leaf, 3, 100, "cpu"), whole)
