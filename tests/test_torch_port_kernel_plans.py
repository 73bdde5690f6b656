"""What the row-update, fused-dense and one-hot gradient wrappers compute
in Python for their CUDA kernels: the scratch, padding and tile plans.

The kernels run only on the card (tests/test_torch_port_cuda.py and
chip_smoke.py hold them against their plain versions there); each checks
at launch that what it is handed matches its own count. Here the plans are
held against the kernels' sources and the shapes of mlperf-lite's layers.
"""
import re

import pytest
import torch

from dlrm_flexflow_tpu_torch import _build
from dlrm_flexflow_tpu_torch.ops.kernels import fused_mlp
from dlrm_flexflow_tpu_torch.ops.kernels import onehot_embedding as oh
from dlrm_flexflow_tpu_torch.ops.kernels import row_update as ru

# mlperf-lite's Dense layers as (K, N): bottom 13-512-256-128, top
# 479-1024-1024-512-256-1
MLPERF_LITE = [(13, 512), (512, 256), (256, 128), (479, 1024), (1024, 1024), (1024, 512), (256, 1)]


def test_row_update_chunk_is_the_kernels():
    text = (_build.CSRC_DIR / "row_update.cu").read_text()
    assert ru.CHUNK == int(re.search(r"constexpr int kChunk = (\d+);", text).group(1))


@pytest.mark.parametrize("k, chunks", [(1, 1), (63, 1), (64, 1), (65, 2), (65536, 1024)])
@pytest.mark.parametrize("rule, n_acc, per_chunk", [("sgd", 1, 0), ("momentum", 1, 0), ("adam", 2, 0),
                                                    ("adagrad", 1, 4)])
def test_row_update_scratch_holds_two_edge_pieces_a_chunk(k, chunks, rule, n_acc, per_chunk):
    """[n_chunks, 2, n_acc, D] f32 for the run pieces at chunk edges, and
    AdaGrad's mean-square partials and scales, [n_chunks, 2] each."""
    d = 16
    assert ru.scratch_floats(k, d, rule) == chunks * (2 * n_acc * d + per_chunk)


def test_fused_dense_pads_k_to_whole_16_byte_bf16_rows():
    assert [fused_mlp.padded_k(k) for k in (1, 8, 13, 479, 480, 1024)] == [8, 8, 16, 480, 480, 1024]


@pytest.mark.parametrize("k, n", MLPERF_LITE)
def test_fused_dense_plan_of_the_mlperf_lite_layers(k, n):
    """f32 x at M = 16384: w in bf16 [N, Kp] always; x in bf16 [M, Kp] only
    where TMA cannot read its rows (K = 13 and 479: 52- and 1916-byte
    pitches)."""
    plan = fused_mlp.scratch_plan(16384, n, k, torch.float32, 256)
    kp = fused_mlp.padded_k(k)
    assert plan == {"w": (n, kp), "x": None if k % 4 == 0 else (16384, kp)}


@pytest.mark.parametrize("k, dtype, ptr, direct", [
    (40, torch.bfloat16, 0, True),
    (44, torch.bfloat16, 0, False),  # an 88-byte pitch
    (44, torch.float32, 0, True),
    (1024, torch.float32, 4, False),  # a base 4 bytes past a 16-byte boundary
    (1024, torch.float32, 16, True),
])
def test_fused_dense_reads_x_as_it_lies_only_where_tma_can(k, dtype, ptr, direct):
    assert fused_mlp.x_goes_direct(k, dtype, ptr) == direct
    plan = fused_mlp.scratch_plan(7, 3, k, dtype, ptr)
    assert plan["x"] == (None if direct else (7, fused_mlp.padded_k(k)))


# mlperf-lite's 13 tables of at most 8192 rows (the one-hot route)
MLPERF_LITE_SMALL_VOCABS = [7424, 7122, 2209, 1543, 976, 155, 108, 63, 36, 14, 10, 4, 3]


@pytest.mark.parametrize("name", ["WARPS", "TILE_ROWS", "COLS", "SPLIT_ROWS", "ROUND_MAX"])
def test_onehot_backward_plan_constants_are_the_kernels(name):
    text = (_build.CSRC_DIR / "onehot_embedding.cu").read_text()
    kname = {"WARPS": "kWarps", "TILE_ROWS": "kTileRows", "COLS": "kCols", "SPLIT_ROWS": "kSplitRows",
             "ROUND_MAX": "kRoundMax"}[name]
    if name == "WARPS":
        assert getattr(oh, name) * 32 == int(re.search(r"constexpr int kBwdThreads = (\d+);", text).group(1))
        assert "constexpr int kWarps = kBwdThreads / 32;" in text
    else:
        assert getattr(oh, name) == int(re.search(rf"constexpr int {kname} = (\d+);", text).group(1))


def test_onehot_backward_takes_one_segment_and_one_launch_at_the_largest_vocab():
    plan = oh.backward_plan(16384, 1, 7424, 128)
    assert (plan.rows, plan.tiles, plan.segments, plan.launches, plan.scratch_floats) == (64, 116, 1, 1, 0)
    assert not plan.split and plan.smem <= 227 * 1024


@pytest.mark.parametrize("v", MLPERF_LITE_SMALL_VOCABS)
def test_onehot_backward_plan_at_the_mlperf_lite_vocabs(v):
    """Partials no larger than the stream (S * v <= max(B * H, v)), no block
    over its member cap (the busiest warp's picks of a uniform stream), the
    card filled where the shape allows, and hot rows over many segments."""
    b, h, d = 16384, 1, 128
    plan = oh.backward_plan(b, h, v, d)
    assert plan.segments * v <= max(b * h, v)
    assert plan.scratch_floats == (plan.segments * v * d if plan.segments > 1 else 0)
    assert plan.tiles * plan.slices * plan.segments >= oh.MIN_BLOCKS // 2
    members = plan.bags * h
    share = 1 / oh.WARPS if plan.rows <= oh.SPLIT_ROWS else -(-plan.rows // oh.WARPS) / v
    assert members * share <= oh.WARP_PICKS
    assert plan.launches == (1 if v in (7424, 7122) else 2)
    assert plan.split == (v <= oh.SPLIT_ROWS)
    assert plan.smem <= 227 * 1024


@pytest.mark.parametrize("v", [3, 4, 10])
def test_onehot_backward_splits_hot_rows_across_segments(v):
    plan = oh.backward_plan(16384, 1, v, 128)
    assert plan.segments > 1 and plan.bags * plan.segments >= 16384 and plan.bags <= 512


@pytest.mark.parametrize("b, h, v, d, segments", [
    (1000, 1, 100_000, 128, 1),  # v far above B * H: one segment, partials never larger
    (1, 1, 3, 128, 1),  # one bag: the rows regime, member order
    (65536, 1, 5683, 16, 1),  # kaggle's shape
    (999, 6, 500, 37, 11),  # a ragged D
])
def test_onehot_backward_plan_at_the_edges(b, h, v, d, segments):
    plan = oh.backward_plan(b, h, v, d)
    assert plan.segments == segments and plan.segments * v <= max(b * h, v)
    assert plan.slices == -(-d // oh.COLS) and not (plan.split and plan.segments == 1)


@pytest.mark.parametrize("b, h, v, d", [(2**30, 2, 3, 1), (1, 1, 2**31 - 1, 1), (1, 1, 0, 1), (1, 1, 3, 0)])
def test_onehot_backward_plan_refuses_what_the_kernel_cannot_take(b, h, v, d):
    with pytest.raises(ValueError):
        oh.backward_plan(b, h, v, d)


def test_onehot_backward_plan_takes_a_stream_just_under_2_31_members():
    plan = oh.backward_plan(2**31 - 1, 1, 3, 1)
    assert plan.segments <= 65535 and plan.segments * 3 <= 2**31 - 1
