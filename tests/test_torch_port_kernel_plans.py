"""What the row-update and fused-dense wrappers compute in Python for their
CUDA kernels: the scratch and padding plans.

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
