"""Smoke run of the PyTorch port (dlrm_flexflow_tpu_torch) on one CUDA card.

    python chip_smoke.py        # from the root of a checkout, on a machine with an H100

Phases, each of which ends the run with a non-zero exit if it fails:
  1. device  - needs CUDA (else exits 1 and prints no result); prints the
               card's name and power limit as nvidia-smi gives them.
  2. build   - builds every kernel under dlrm_flexflow_tpu_torch/csrc with
               nvcc, one process per source, all at once.
  3. kernels - holds each kernel against its plain PyTorch version on the
               card and times kernel, plain version, a library call and the
               bound: the dot interaction at the serving shapes and a ragged
               one; the row update in the K1 regime (65536 rows into the
               10,131,227-row kaggle table, f32 and bf16 tables and
               streams), on a Zipf(1.05) stream, in the K2 regime (16 rows),
               with rows < 0 and >= V, and twice for bit-identical results.
               The fused dense layer, the embedding bag and the one-hot
               lookup follow in phase 10.
  4. path    - serves mlperf-lite DLRM at full width (26 tables, D=128,
               vocabs capped at 2M, batch 16384) through make_dlrm_model ->
               compile -> predict on 4 full requests and a ragged one.
  5. parity  - a D=128 DLRM with small vocabs: predict on CUDA (kernel path)
               against the CPU with the same weights, both on the routes of
               use_pallas="auto".
  6. path-on - the same serving path with every op on its forced kernel
               (use_pallas="on", packed_tables="off"): 8 Dense layers on the
               fused dense kernel, 13 small tables on the one-hot lookup, 13
               large ones on the embedding bag, the interaction on its kernel.
  7. parity-on - mlperf-lite widths with vocabs capped at 20000: predict
               under "on" on CUDA against the CPU with the same weights.
  8. train   - trains the kaggle DLRM at full width (26 tables, 33,762,577
               rows, 10 of them on the row-update kernel route in bf16,
               bf16 compute, SGD, batch 65536) through make_dlrm_model ->
               compile -> train_batch: 3 warm-up and 20 timed steps (each of
               the 7 Dense layers on the bf16 route of ops/dense.py forward
               and backward, one cotangent split each, no f32 product);
               then 5 steps under torch.profiler (kernel time per step, the
               device's busy share) and one step's time by phase.
  9. train parity - kaggle widths with vocabs capped at 20000: 5 SGD steps
               on CUDA against the CPU from the same weights.
 10. train-adam - the train path of phase 8 with dense Adam and lazy sparse
               Adam (alpha 0.001): the 10 route tables in bf16 with f32 m and
               v pools on the row-update kernel's Adam mode; the same
               timings, profile, breakdown and peak memory.
 11. train-optim - the same model a few steps each under sparse momentum,
               Nesterov, row-wise AdaGrad, and Adam with a row-wise AdaGrad
               sparse optimizer: launch counts, finite losses, step time.
 12. train-parity-optim - phase 9 once per rule: momentum 0.9, Nesterov,
               Adam, and Adam with sparse row-wise AdaGrad.
 13. onehot-grad - the gradient of the one-hot lookup (K5f forward, K5b
               backward) through torch.autograd at mlperf-lite's 13 tables
               of at most 8192 rows, batch 16384.
 14. gather-probe - the forward-gather probe's port
               (dlrm_flexflow_tpu_torch/tools/bench_gather_probe.py) at its
               defaults (10 tables, V = 1,000,000, D = 16, packed [125952,
               128], 65536 lookups) with a few steps, in-process: the torch
               gathers, the row-gather kernel (K7) at each depth in f32 and
               bf16, and K4 at H = 1; sums that must agree bit for bit.
 15. train-host - phase 8's kaggle model compiled with host_routing=True:
               20 timed steps with the routes precomputed and staged as the
               bench stages them, against host routing off, in turn; then
               with the routes computed inside train_batch (from numpy
               batches, then from batches on the card); no sort on the
               card when host-routed; the time by phase both ways.
 16. train-parity-host - phase 9's model, host-routed against
               device-sorted on CUDA (bit-identical losses and weights), and
               against the CPU.
 17. train-chunk - phase 8's kaggle model trained by FFModel.train_chunk
               (one train step captured in a CUDA graph, replayed; K = 4
               over the 4 staged batches) against eager train_batch steps
               from the same weights, under SGD and Adam, and host-routed
               with the routes stacked as the bench stages them: ms a step
               both ways, kernel time and busy share, the row-update
               launches counted from the graph's kernel nodes times the
               replays (tools/graph_nodes.py; the Python counts see no
               replay), 7 cotangent-split nodes; then 20 eager steps against 5 chunks under
               deterministic algorithms, bit for bit in every loss and every
               tensor of the state. fit-chunk: one fit(steps_per_call=4)
               epoch with finite history.
 18. serve-quant - mlperf-lite serving at full width (batch 16384, 4 full
               requests and a ragged one) under "auto", in f32 and after
               quantize_embeddings to bf16, f16 and int8, each held against
               the f32 model (atol 0.05, 0.05 / 8 and 0.08): table bytes,
               memory allocated, warm examples/s; the same under "on"
               (packed_tables="off") with K6, K4, K5f and K3 counted, int8
               with K4 and K5f at zero.
 19. checkpoint - kaggle widths, vocabs capped at 20000, Adam: 3 steps,
               save, restore into a fresh model, 2 steps, against 5 steps,
               bit for bit.
 20. train-full - mlperf-full (26 tables, the unclipped Criteo Terabyte
               vocabs, 882,774,559 rows, D = 128) under host-tail offload at
               hot = 2^20 (6 tables offloaded, 7,408,088 rows on the card),
               Zipf(1.05) ids, batch 65536, bf16: 3 warm-up and 10 timed
               train_batch steps under SGD, then with the tables under
               row-wise AdaGrad; the row-update and interaction launches
               counted; the step by phase (build_feeds, copy, device step,
               g_val readback, apply_grads), kernel time and busy share,
               touched tail rows, drop fraction, peak memory, host RSS.
 21. host-tail-parity - a small host-tail model against the same model
               with whole tables on the card, and against the CPU, under
               SGD and row-wise AdaGrad.
 22. train-midband - kaggle at full width with onehot_packed_threshold
               2^20 (5 mid-band tables): eager steps against graph replays,
               timed, then bit for bit; CUDA against the CPU at capped
               vocabs.
 23. train-chunk-scatter - kaggle at full width with all 10 large tables
               on the scatter route: the same, SGD and Adam.
 24. mesh-1  - the hybrid-parallel path (parallel/, ops/embedding_collection_op.py)
               in an in-process NCCL world of one, destroyed after: kaggle
               at full width through compile(mesh=make_mesh(),
               plan=dlrm_hybrid_plan()), which at a data axis of 1 is the
               flat collection of the 10 large tables on the flat scatter
               (f32, no kernel), a warm-up and 3 timed steps under SGD and
               Adam; train_chunk replays against eager steps (timed, then
               bit for bit under deterministic algorithms); at capped
               vocabs with every table fused, 5 steps on CUDA against
               FFConfig(fuse_embeddings=True) on the CPU; then
               sharded_embedding_lookup and sharded_embedding_sparse_update
               called directly at N = 1 on a kernel-route layout of the 10
               tables ([r_pad, 16] bf16, 65536 lookups a table): the lookup
               bit for bit against the flat gather, the update (K1, SGD)
               against the row-update kernel's plain version, its launches
               counted (the kernels line's `mesh_launches`); the routed
               exchange in exact mode on the same layout against the dense
               one (the lookup bit for bit; the update's K1 against its
               plain version on the routed stream, and against the dense
               update within twice the row-update tolerance); both
               exchanges and an all-reduce captured in a CUDA graph and
               replayed, bit for bit against eager calls (K1's nodes:
               `mesh_captured_k1_nodes`); the sharded checkpoint's gather
               to rank 0 and restore's own-shard pick called directly on
               that bf16 pool and an Adam m and v, bit for bit; the
               replicated tables' update (parallel/replicated_tables.py,
               the path of a sparse table outside the collection under a
               data axis > 1, which at N = 1 the model does not reach)
               called directly on kaggle's 10 route tables at batch 65536,
               SGD and Adam: bit for bit against apply_sparse_updates on the
               same stream, its K1 launches counted (`mesh_launches`), and
               captured in a CUDA graph, the replay bit for bit; the
               checkpoint round trip (of the flat collection: at a data
               axis of 1 nothing is sharded) and int8 serving of the fused
               collection at capped vocabs; the strategy search inside
               compile(mesh=, plan=dlrm_hybrid_plan()) with search_budget >
               0 on the h100 preset (rank 0 calibrates this card into the
               machine file beside the exported strategy, in a temporary
               directory), and one step of the searched model against a
               model compiled with no search under the plan it chose.
 25. bench   - python -m dlrm_flexflow_tpu_torch.bench --quick, as a
               subprocess: kaggle training (host-routed, graph replays), the
               same with --zipf 1.05, with --optimizer adam and with
               --onehot-packed-threshold 1048576, mlperf-full training
               (host-tail offload, eager steps), and mlperf-lite serving in
               f32 and with int8 tables.
 26. kernels, continued - as phase 3: the fused dense layer at the 8
               mlperf-lite layer shapes at M = 16384 (bf16), at M = 1000, in
               f32, without bias; the embedding bag at [16384, 1] into a
               2,000,000 x 128 table, with bags of 4 (AVG, padding, a fully
               padded bag), a bf16 table, indices past the table, an f16
               table (quantized serving); the one-hot lookup at V = 7424,
               D = 128, B = 16384 (SUM, AVG, duplicates, indices >= V, f32
               and bf16 compute, bf16 and f16 tables; each table timed
               beside F.embedding_bag on it) and its gradient (K5b) at
               the same shape, with bags of 4, at V = 3 and 4 (hot rows over
               many segments) and at kaggle's shape, bit for bit against
               the CPU where one segment holds the stream, and at each of
               mlperf-lite's 13 small vocabularies held against its plain
               version, its CUDA work a call counted from a CUDA graph of
               the call, its whole call timed; the row-update kernel's
               optimizer modes at phase 3's K1 shape (momentum, Nesterov,
               Adam with and without weight decay, row-wise AdaGrad;
               momentum, Adam and AdaGrad on a Zipf(1.05) stream, each timed
               beside index_add_ on the same stream; rows < 0 and >= V),
               each run twice for bit-identical results; the row-gather
               kernel (K7) bit for bit
               at the probe's shape in f32 and bf16 at every depth, at a
               ragged K, on the narrow [1000000, 16] table, at widths of 5
               and 6 chunks, with indices < 0 and >= P, twice; the Dense
               backward's cotangent split (csrc/bf16_split.cu) at kaggle's 7
               cotangents [65536, N], bit for bit against its plain version
               and timed beside it.
 27. zoo-moe  - models/zoo.py's moe_mlp at its default widths (784 in, 4
               experts, top 2, alpha 2.0, 64-wide gate and experts, 10
               classes), batch 16384, on examples/moe.py's clustered data:
               Adam, sparse CE, 3 warm-up and 20 timed eager steps (the
               loss must fall), kernel time and busy share; train_chunk
               (K = 4) against eager steps bit for bit; recompile drops the
               captured step and the next chunk captures again; predict of
               4 x 16384 + 1000 under "on" (K6: 10 a chunk) against "auto"
               on the rows the two route alike (under 1% may route
               otherwise: a bf16 near-tie in the gate).
 28. zoo-candle - candle_uno at its defaults, batch 8192: 3 warm-up
               and 10 timed SGD steps on MSE, replays bit for bit, predict
               under "on" (K6: 19 a chunk) against "auto".
 29. zoo-attention - transformer (seq 64, hidden 128, 8 heads, 2 layers) at
               batch 64 and bert_proxy (batch 8, seq 128, hidden 1024, 16
               heads) cut to 2 layers (24 overflow f32 in the JAX package
               itself): timed Adam steps, replays bit for bit, predict; a
               fresh bert_proxy at seq_length 64 gives zeros past row 64;
               mnist_mlp served under "on" (K6: 3).
 30. zoo-cnn  - resnet (ResNet-50, no BatchNorm, as the reference) at
               batch 64 on 224 x 224 images that carry their class, SGD:
               eager steps (the loss must fall), replays bit for bit with
               eager steps, the replays' kernel time; alexnet (batch 64) and
               inception_v3 (batch 32), a few eager steps each; ms a step,
               TFLOP/s, busy share, the top kernels, peak memory.
 31. zoo-nmt  - nmt at the reference's defaults (batch 64, length 20,
               hidden and embed 2048, vocab 20480, 2 layers) on the copy
               task, SGD, its tables on the sparse path's scatter rule: the
               same figures, the loss falling, replays bit for bit.
 32. zoo-cnn-on - alexnet served at a batch of 256 (4 x 256 + 100 images)
               under "on" (K6: 3 a chunk) against "auto".
 33. zoo-parity - the zoo models at small widths, CUDA against the CPU
               port from the same weights: predict under "auto" and, for
               the rank-2 models, "on"; 5 SGD steps; a dropout model's masks
               alike on both devices and its replays bit for bit; then
               mnist_cnn, cifar10_cnn, a small nmt (its tables sparse), a
               ResNet bottleneck at stride 2, each Inception block and a
               BatchNorm / Pool2D model: predict and 5 SGD steps.
 34. kernels, continued - K6 at the zoo's 16 Dense shapes at their path's M
               (the CNN heads at M = 256) against its plain version, timed
               beside addmm with its bound, the rounding pass's share where
               x cannot go to TMA as it lies (K = 942, 5270, 5002), and a
               moe bucket of half zero rows.
 35. autotune - the strategy search's machine model and per-op profiling
               (autotune/machine.py, utils/profiling.py), in a temporary
               directory: calibrate, calibrate_packed (K1 at the JAX
               package's four points), calibrate_dense at kaggle's Dense
               shapes (batch 65536) and calibrate_graph_ops (ResNet-50's
               convolutions, nmt's LSTMs, the transformer's attention and a
               batch-matmul) on the h100 preset, each constant printed
               beside the limit the card sets on it; kaggle's step
               residual (calibrate_step_residual, 8 train_chunk replays at
               batch 65536, bf16 tables, SGD; every state tensor bit for
               bit before and after) and `fit` of the same model under
               config.profiling (one "[Type] name forward time" line an
               op); mlperf-lite at 16384 under use_pallas="on" served op by
               op (op_timing_report: K6, K5f, K4 and K3 launched),
               export_task_graph, check_numerics and trace.
 36. frontends - the model-import frontends (frontends/) through the
               entry points a user calls, after phase 35 and before the
               kernel checks: a Keras Sequential mnist_mlp (784-512-512-10)
               trained by Model.fit at 64 for 3 epochs of load_mnist's
               surrogate past VerifyMetrics("accuracy", 0.9), bit for bit
               with zoo.mnist_mlp given its weights, served at 16384 under
               "on" (K6: 3 a request) against "auto"; a Keras functional
               cifar10_cnn with the zoo model's op types and parameter
               shapes, bit for bit with it, a few Model.fit epochs on
               load_cifar10 with the loss falling; AlexNet as an nn.Module
               traced by torch_to_ir, through save_ir / load_ir, applied
               in f32 against the module's own forward (TF32 off) within
               the bound of its f32 sums, served at 256 under "on" (K6: 3 a
               chunk); the port's examples/import_models.py torch tour;
               a duck-typed ONNX cifar10_cnn (Split / Concat, Reshape to
               -1) bit for bit with the zoo's; a duck-typed tf.keras
               Sequential (channels-first conv stem, mnist_mlp's widths)
               through from_tf_keras and load_tf_weights against a plain
               f32 computation of its arrays; a Keras model of a 7424-row
               and a 2,000,000-row table (D = 128) and 13 dense features
               into Dense 256 and Dense 1, served at 16384 under "on"
               (K5f, K4 and two K6 a request) against "auto". The card has
               no tensorflow and no onnx: those models come as stand-ins.
 37. summary - a {"kernels": [...]} line (K6's entry with the zoo's
               launches; K6's, K4's and K5f's with the frontends'; the
               cotangent split's with phase 8's launches and phase 17's
               kernel nodes), then
               the last line {"ok": true, "device": {...}}.
Around each path (4, 6, 8, 10, 11, 13, 14, 15, 18, 20, 24, 27-30, 32, 35 and 36) the
kernel launch counts are zeroed just before and read just after, and must
show every kernel of that path; phase 17 counts its replays' launches from
the graph.
The script imports nothing of JAX: it runs the port alone.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH = 16384
TRAIN_BATCH = 65536
TRAIN_WARMUP, TRAIN_STEPS, PROFILED_STEPS = 3, 20, 5
KAGGLE_BIG_TABLES = 10  # kaggle tables with more than 8192 rows
# the output widths of kaggle's 7 Dense layers (bottom 13-512-256-64-16, top
# 432-512-256-1): each backward splits a [batch, N] cotangent once
KAGGLE_DENSE_NS = [512, 256, 64, 16, 512, 256, 1]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# mlperf-lite's Dense layers as (K, N, activation): bottom 13-512-256-128,
# top 479-1024-1024-512-256-1 with a sigmoid last
MLPERF_LITE_LAYERS = [(13, 512, "relu"), (512, 256, "relu"), (256, 128, "relu"),
                      (479, 1024, "relu"), (1024, 1024, "relu"), (1024, 512, "relu"),
                      (512, 256, "relu"), (256, 1, "sigmoid")]
MLPERF_LITE_TABLES = 13  # mlperf-lite tables on each forced lookup (<= 8192 rows, and more)
# K3 sums D products in f32 in another order than cuBLAS's bmm. Each result
# is within gamma_D * sum_d |x_r,d * x_c,d| of the exact dot (gamma_D ~
# D * 2^-24), so the two differ by at most twice that: the tolerance of an
# element is 2 * D * 2^-24 times the same dot taken over |x|.
F32_UNIT = 2.0**-24
BF16_UNIT = 2.0**-8
F16_UNIT = 2.0**-11
# CUDA-vs-CPU end to end: both round the MLP operands to bf16 and sum in f32;
# the f32 sums differ in order only, but a difference that flips the bf16
# rounding of an activation moves it by one bf16 step (2^-8 relative) and
# that carries through the next layers. Bound on the sigmoid output, and in
# training on the loss and on every weight after 5 steps (a flipped
# rounding of a row delta moves a bf16 table entry by one bf16 step of a
# value of about 0.02):
E2E_ATOL = 2e-3
# Under use_pallas="on" every layer's output, the sigmoid included, is
# rounded to bf16: a flipped rounding of the output itself moves it by one
# bf16 step, 2^-8 in [0.5, 1). Two steps:
E2E_ON_ATOL = 2.0**-7
ADAM_ALPHA = 0.001
# Adam moves a weight by alpha_t * m / (sqrt(v) + eps) a step, at most about
# alpha * (1 - beta1) / sqrt(1 - beta2) = 3.2 alpha on the first step and a
# few alpha after, whatever the gradient's size: where CUDA's and the CPU's
# summation orders give a gradient component near 0 different signs, the two
# weights move apart by up to that. Bound over the parity run's 5 steps (the
# loss keeps E2E_ATOL: such a weight's gradient is near 0, so the loss does
# not feel it to first order):
ADAM_E2E_ATOL = 5 * 3.2 * ADAM_ALPHA + E2E_ATOL
ADAGRAD_LR = 0.01
# Row-wise AdaGrad moves a weight by lr * |g_d| * rsqrt(acc + eps), at most
# lr * sqrt(D) = 4 lr a step at D = 16, since acc holds at least the step's
# own mean over D of g^2: the same holds for a row whose gradient is near 0.
# Both bounds are loose; the parity phase also asks that all but 1 in 1000
# weights agree within E2E_ATOL.
ADAGRAD_E2E_ATOL = 5 * 4 * ADAGRAD_LR + E2E_ATOL
# the wrapper each sparse rule's kernel-route tables launch
RULE_WRAPPER = {"sgd": "row_update", "momentum": "row_update_momentum",
                "nesterov": "row_update_momentum", "adam": "row_update_adam",
                "adagrad": "row_update_adagrad", "adam+adagrad": "row_update_adagrad"}
PROBE_STEPS = 5  # the gather probe's captured steps (its default is 20)
PROBE_TABLES = 10
BENCH_TIMEOUT_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms with the host out of the way: `reps`
    calls captured in one CUDA graph, replayed between CUDA events. For a
    kernel shorter than its host launch (Python, ctypes, the stream lookup),
    `cuda_ms` measures the launch rate instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    # full-f32 products in the plain versions and the MLPs (PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from dlrm_flexflow_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build(_build.kernel_names())
    log(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.3f} s")
    for name, text in sorted(logs.items()):
        # ptxas -v: one "Used N registers" and one spill line per kernel instance
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", text)] or [0]
        log(f"[build] {name}: {len(regs)} kernel instances, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {max(smem)} B shared memory at most, "
            f"{max(spills, default=0)} B spilled at most")


def check_dot_interaction(x: torch.Tensor, self_interaction: bool) -> dict:
    from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import (
        dot_interaction, dot_interaction_reference,
    )

    got = dot_interaction(x, self_interaction)
    ref = dot_interaction_reference(x, self_interaction)
    tol = 2.0 * x.shape[2] * F32_UNIT * dot_interaction_reference(x.abs(), self_interaction)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    res = {
        "shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
        "self_interaction": self_interaction,
        "max_abs_err": err.max().item(),
        "max_rel_err": (err.max() / ref.abs().max().clamp_min(1e-30)).item(),
        "max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item(),
    }
    log(f"[kernels] dot_interaction {json.dumps(res)}")
    if not torch.isfinite(got).all() or res["max_err_over_tol"] > 1.0:
        raise AssertionError(f"dot_interaction disagrees with its plain version: {res}")
    return res


def phase_kernels() -> dict:
    from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import (
        dot_interaction, dot_interaction_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main = torch.randn((BATCH, 27, 128), generator=gen, device="cuda")
    errs = [
        check_dot_interaction(main, False),
        check_dot_interaction(main, True),
        check_dot_interaction(torch.randn((1000, 5, 16), generator=gen, device="cuda"), False),
        check_dot_interaction(main.to(torch.bfloat16), False),
    ]
    b, f, d = main.shape
    n_pairs = f * (f - 1) // 2
    bytes_moved = main.numel() * main.element_size() + b * n_pairs * 4
    flops = 2.0 * b * n_pairs * d
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    timing = {
        "ms": cuda_ms(lambda: dot_interaction(main, False)),
        "plain_ms": cuda_ms(lambda: dot_interaction_reference(main, False)),
        # one library call that computes every pairwise dot (all F*F of
        # them; the plain version adds the triangle gather to it)
        "library_ms": cuda_ms(lambda: torch.bmm(main, main.transpose(1, 2))),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(f"[kernels] dot_interaction timing at [{b},{f},{d}] f32: {json.dumps(timing)}")
    return {"max_abs_err": max(e["max_abs_err"] for e in errs), **timing}


def row_update_tolerance(table, rows, src, h, scale) -> torch.Tensor:
    """The kernel sums each row's deltas in sorted order, the plain version
    with index_add_'s atomics in any order: each within n * 2^-24 * (|t| +
    sum |delta|) of the exact sum of n terms, so within twice that of each
    other; a bf16 table adds one bf16 step of the sum and one of the result
    (2^-8 relative each), where that difference flips a bf16 rounding."""
    v, _ = table.shape
    keep = (rows >= 0) & (rows < v)
    k = torch.arange(rows.numel(), device=rows.device)[keep]
    r = rows[keep]
    mag = table.float().abs()
    mag.index_add_(0, r, (scale * src[k // h]).abs())
    n = torch.ones(v, device=rows.device)
    n.index_add_(0, r, torch.ones(r.numel(), device=rows.device))
    tol = 2.0 * n[:, None] * F32_UNIT * mag
    if table.dtype == torch.bfloat16:
        tol += 2.0 * BF16_UNIT * mag
    return tol


def check_row_update(name, table, rows, src, stream, timed: bool) -> dict:
    """One row-update case: the kernel against its plain version from the
    same table, a repeat for bit-identity, and (if timed) the times."""
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import (
        _launch, row_update, row_update_reference, sort_rows,
    )

    h = rows.numel() // src.shape[0]
    scale = torch.tensor(-0.01, device="cuda")
    want = table.clone()
    row_update_reference(want, rows, (src, h), scale, stream)
    got = table.clone()
    row_update([got], [rows], [(src, h)], scale, stream)
    again = table.clone()
    row_update([again], [rows], [(src, h)], scale, stream)
    tol = row_update_tolerance(table, rows, src, h, scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    keep = (rows >= 0) & (rows < table.shape[0])
    uniq = torch.unique(rows[keep]).numel()
    res = {
        "case": name, "V": table.shape[0], "D": table.shape[1], "K": rows.numel(), "h": h,
        "table": str(table.dtype).replace("torch.", ""),
        "stream": str(stream).replace("torch.", ""),
        "dropped": int((~keep).sum()), "unique_rows": uniq,
        "max_abs_err": err.max().item(),
        "max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item(),
        "bit_identical_repeat": bool(torch.equal(got.view(torch.uint8), again.view(torch.uint8))),
    }
    if not torch.isfinite(got.float()).all() or res["max_err_over_tol"] > 1.0:
        raise AssertionError(f"row_update disagrees with its plain version: {res}")
    if not res["bit_identical_repeat"]:
        raise AssertionError(f"row_update is not bit-reproducible: {res}")
    if timed:
        rows_sorted, order = sort_rows([table], [rows])
        t32 = table.to(torch.float32, copy=True)
        k_ok = torch.arange(rows.numel(), device="cuda")[keep]
        deltas = (scale * src[k_ok // h]).contiguous()
        r_ok = rows[keep]
        t_bytes = (rows.numel() * 8 + src.numel() * 4
                   + uniq * table.shape[1] * 2 * table.element_size()) / HBM_BYTES_PER_S * 1e3
        launch = lambda: _launch(got, rows_sorted[0], order[0], src, h, scale, stream)  # noqa: E731
        res.update({
            "ms": graph_ms(launch),
            "eager_ms": cuda_ms(launch),  # one wrapper call after another: host-bound
            "prep_ms": cuda_ms(lambda: sort_rows([table], [rows])),
            # torch.unique syncs with the host, so no graph here
            "plain_ms": cuda_ms(lambda: row_update_reference(want, rows, (src, h), scale, stream)),
            # one library call that adds the same (pre-formed) deltas
            "library_ms": graph_ms(lambda: t32.index_add_(0, r_ok, deltas)),
            "bound_ms": t_bytes,
            "bound_by": "bytes",
        })
        del t32
    log(f"[kernels] row_update {json.dumps(res)}")
    return res


def phase_row_update() -> dict:
    """Row-update cases at the shapes of the train path (K1: 65536 rows into
    the largest kaggle table) and of K2's sparse regime (16 rows)."""
    from dlrm_flexflow_tpu_torch.data.synthetic import zipf_indices

    v, d, k = 10_131_227, 16, TRAIN_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    base = (torch.rand((v, d), generator=gen, device="cuda") - 0.5) * 0.02
    src = torch.randn((k, d), generator=gen, device="cuda")
    uniform = torch.randint(0, v, (k,), generator=gen, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    zipf = torch.from_numpy(zipf_indices(rng, v, k, 1.05)).cuda()
    dropped = uniform.clone()
    dropped[: k // 16] = -1 - torch.arange(k // 16, device="cuda") % 7
    dropped[k // 16 : k // 8] = v + torch.arange(k // 16, device="cuda") % 7
    b16 = base.to(torch.bfloat16)
    cases = {}
    for table, stream in ((b16, torch.bfloat16), (b16, torch.float32),
                          (base, torch.bfloat16), (base, torch.float32)):
        name = f"a-k1-{str(table.dtype)[6:]}-table-{str(stream)[6:]}-stream"
        cases[name] = check_row_update(name, table, uniform, src, stream, timed=True)
    cases["b-zipf"] = check_row_update("b-zipf", b16, zipf, src, torch.bfloat16, timed=True)
    cases["c-k2"] = check_row_update("c-k2", b16, uniform[:16], src[:16], torch.bfloat16, timed=True)
    cases["d-dropped"] = check_row_update("d-dropped", b16, dropped, src, torch.bfloat16, timed=False)
    # (e) every case above ran the kernel twice from the same table and
    # compared the bits; a bag of 2 reads src through k // h
    cases["e-bag2"] = check_row_update("e-bag2", b16, uniform, src[: k // 2], torch.bfloat16,
                                      timed=False)
    del base, b16
    torch.cuda.empty_cache()
    return cases


def randn(shape, gen, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def dense_tolerance(x, w, b, want, cdt) -> torch.Tensor:
    """The tensor cores sum exact bf16 products in f32 in another order than
    the plain f32 matmul and may truncate rather than round each addition:
    each within K * 2^-23 * sum |term| of the exact sum, so within 4 * K *
    2^-24 of each other (1.2 x that through a GELU); a result rounded to
    bf16 may then land one bf16 step (2^-7 of its value, at most) away."""
    k = x.shape[1]
    mag = x.to(cdt).float().abs() @ w.to(cdt).float().abs().t()
    if b is not None:
        mag = mag + b.abs()
    tol = 1.2 * 4 * k * F32_UNIT * mag + 4 * F32_UNIT * want.float().abs()
    if cdt == torch.bfloat16:
        tol = tol + 2.0 * BF16_UNIT * want.float().abs()
    return tol


def check_fused_dense(name, x, w, b, act, cdt) -> dict:
    from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense, fused_dense_reference

    got = fused_dense(x, w, b, act, cdt)
    want = fused_dense_reference(x, w, b, act, cdt)
    tol = dense_tolerance(x, w, b, want, cdt)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    res = {
        "case": name, "M": x.shape[0], "K": x.shape[1], "N": w.shape[0], "act": act.name,
        "bias": b is not None, "compute": str(cdt).replace("torch.", ""),
        "max_abs_err": err.max().item(),
        "max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item(),
        "rounded_to_compute_dtype": bool(torch.equal(got, got.to(cdt).to(got.dtype))),
    }
    log(f"[kernels] fused_dense {json.dumps(res)}")
    if not torch.isfinite(got).all() or res["max_err_over_tol"] > 1.0 or not res["rounded_to_compute_dtype"]:
        raise AssertionError(f"fused_dense disagrees with its plain version: {res}")
    return res


def phase_fused_dense() -> dict:
    """K6 at the 8 mlperf-lite layer shapes at M = 16384 in bf16 (timed as
    one forward's worth), then M = 1000, f32 compute, no bias."""
    from dlrm_flexflow_tpu_torch import ActiMode
    from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense, fused_dense_reference

    acts = {"relu": ActiMode.AC_MODE_RELU, "sigmoid": ActiMode.AC_MODE_SIGMOID}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs, layers = [], []
    for k, n, act in MLPERF_LITE_LAYERS:
        x = randn((BATCH, k), gen)
        w = randn((n, k), gen, scale=k**-0.5)
        b = randn((n,), gen, scale=0.1)
        errs.append(check_fused_dense("mlperf-lite", x, w, b, acts[act], torch.bfloat16))
        layers.append((x, w, b, acts[act]))
    x, w, b, act = layers[4]
    errs.append(check_fused_dense("ragged-M", x[:1000].contiguous(), w, b, act, torch.bfloat16))
    errs.append(check_fused_dense("f32", x[:1000].contiguous(), w, b, act, torch.float32))
    x, w, b, act = layers[3]
    errs.append(check_fused_dense("no-bias", x, w, None, act, torch.bfloat16))
    x, w, b, act = layers[7]
    errs.append(check_fused_dense("f32-sigmoid-N1", x, w, None, act, torch.float32))

    per_layer, t_bytes, t_ops = [], 0.0, 0.0
    for x, w, b, act in layers:
        m, k = x.shape
        n = w.shape[0]
        xb, wb, bb = x.to(torch.bfloat16), w.to(torch.bfloat16).t(), b.to(torch.bfloat16)
        lb = (m * k + n * k + n + m * n) * 4 / HBM_BYTES_PER_S * 1e3
        lo = 2.0 * m * n * k / BF16_FLOP_PER_S * 1e3
        t_bytes, t_ops = t_bytes + lb, t_ops + lo
        per_layer.append({
            "K": k, "N": n,
            "ms": graph_ms(lambda: fused_dense(x, w, b, act, torch.bfloat16)),
            "plain_ms": graph_ms(lambda: fused_dense_reference(x, w, b, act, torch.bfloat16)),
            # one library call: bf16 operands cast beforehand, a bf16 result
            "library_ms": graph_ms(lambda: torch.addmm(bb, xb, wb)),
            "bound_ms": max(lb, lo), "bound_by": "bytes" if lb >= lo else "operations",
        })
        log(f"[kernels] fused_dense timing at M={m} K={k} N={n} bf16: {json.dumps(per_layer[-1])}")
    timing = {key: sum(layer[key] for layer in per_layer)
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    timing["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[kernels] fused_dense timing, the 8 mlperf-lite layers at M={BATCH} summed: "
        f"{json.dumps(timing)}")
    del layers
    torch.cuda.empty_cache()
    return {"max_abs_err": max(e["max_abs_err"] for e in errs), **timing}


def check_lookup(kind, name, table, idx, aggr, cdt=None) -> dict:
    """One pooled-lookup case against its plain version. Both sum in f32,
    in another order for bags of more than one: each within n * 2^-24 of
    the sum of |terms|, so within twice that of each other; a bf16 output
    may then land one bf16 step away."""
    from dlrm_flexflow_tpu_torch.ops.kernels import embedding_bag as k4
    from dlrm_flexflow_tpu_torch.ops.kernels import onehot_embedding as k5f

    if kind == "embedding_bag":
        run = lambda t: k4.embedding_bag(t, idx, aggr)  # noqa: E731
        ref = lambda t: k4.embedding_bag_reference(t, idx, aggr)  # noqa: E731
    else:
        run = lambda t: k5f.onehot_embedding(t, idx, aggr, cdt)  # noqa: E731
        ref = lambda t: k5f.onehot_embedding_reference(t, idx, aggr, cdt)  # noqa: E731
    got = run(table).float()
    want = ref(table).float()
    h = idx.shape[1] if idx.dim() == 2 else 1
    tol = 2.0 * h * F32_UNIT * ref(table.float().abs()).float()
    if table.dtype in (torch.bfloat16, torch.float16):  # the output's one rounding, a step apart
        unit = BF16_UNIT if table.dtype == torch.bfloat16 else F16_UNIT
        tol = tol + 2.0 * unit * want.abs()
    torch.cuda.synchronize()
    nan_same = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    res = {
        "case": name, "rows": table.shape[0], "D": table.shape[1], "bags": idx.shape[0], "H": h,
        "aggr": aggr.name, "table": str(table.dtype).replace("torch.", ""),
        "compute": None if cdt is None else str(cdt).replace("torch.", ""),
        "padded": int((idx < 0).sum()), "past_the_table": int((idx >= table.shape[0]).sum()),
        "max_abs_err": err.max().item() if err.numel() else 0.0,
        "max_err_over_tol": (err / tol[fin].clamp_min(1e-30)).max().item() if err.numel() else 0.0,
        "nan_where_plain_is_nan": nan_same,
    }
    log(f"[kernels] {kind} {json.dumps(res)}")
    if res["max_err_over_tol"] > 1.0 or not nan_same:
        raise AssertionError(f"{kind} disagrees with its plain version: {res}")
    return res


def lookup_bound(table, idx) -> tuple:
    """Bytes: the indices, the distinct rows they name, the output; operations:
    one f32 add a member and column."""
    rows = idx[(idx >= 0) & (idx < table.shape[0])]
    d, item = table.shape[1], table.element_size()
    t_bytes = (idx.numel() * idx.element_size() + torch.unique(rows).numel() * d * item
               + idx.shape[0] * d * item) / HBM_BYTES_PER_S * 1e3
    t_ops = rows.numel() * d / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_lookups() -> tuple:
    """K4 at mlperf-lite's largest table shape and K5f at its largest small
    table, each with its edge cases, then timed at the main-path shape."""
    import torch.nn.functional as F

    from dlrm_flexflow_tpu_torch import AggrMode
    from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import embedding_bag, embedding_bag_reference
    from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import (
        onehot_embedding, onehot_embedding_reference,
    )

    SUM, AVG = AggrMode.AGGR_MODE_SUM, AggrMode.AGGR_MODE_AVG
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    big = randn((2_000_000, 128), gen, scale=0.05)
    main = torch.randint(0, big.shape[0], (BATCH, 1), generator=gen, device="cuda")
    bags = torch.randint(0, big.shape[0], (BATCH, 4), generator=gen, device="cuda")
    bags[::5, 2:] = -1  # padding
    bags[7] = -1  # a fully padded bag
    errs = [
        check_lookup("embedding_bag", "mlperf-lite", big, main, SUM),
        check_lookup("embedding_bag", "bag4-avg-padding", big, bags, AVG),
        check_lookup("embedding_bag", "bf16-table", big.to(torch.bfloat16), bags, SUM),
        check_lookup("embedding_bag", "past-the-table", big[:1000].contiguous(), bags % 1100, AVG),
        # quantize_embeddings("float16") tables
        check_lookup("embedding_bag", "f16-table", big.to(torch.float16), main, SUM),
        check_lookup("embedding_bag", "f16-table-bag4-avg", big.to(torch.float16), bags, AVG),
    ]
    bound, bound_by = lookup_bound(big, main)
    big16 = big.to(torch.float16)
    k4 = {
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "ms": graph_ms(lambda: embedding_bag(big, main, SUM)),
        "plain_ms": graph_ms(lambda: embedding_bag_reference(big, main, SUM)),
        "library_ms": graph_ms(lambda: F.embedding_bag(main, big, mode="sum")),
        "bound_ms": bound, "bound_by": bound_by,
        # the f16 table of quantized serving, the same lookup
        "f16_ms": graph_ms(lambda: embedding_bag(big16, main, SUM)),
        "f16_plain_ms": graph_ms(lambda: embedding_bag_reference(big16, main, SUM)),
        "f16_library_ms": graph_ms(lambda: F.embedding_bag(main, big16, mode="sum")),
        "f16_bound_ms": lookup_bound(big16, main)[0],
    }
    log(f"[kernels] embedding_bag timing at [{BATCH}, 1] into {list(big.shape)} f32 (f16_*: an f16 "
        f"table): {json.dumps(k4)}")
    del big, big16, bags

    small = randn((7424, 128), gen, scale=0.05)
    v = small.shape[0]
    one = torch.randint(0, v, (BATCH, 1), generator=gen, device="cuda")
    dup = torch.randint(0, v, (BATCH, 6), generator=gen, device="cuda")
    dup[:, 1] = dup[:, 0]  # n_r >= 2
    dup[::3, 2] = dup[::3, 0]  # n_r = 3
    dup[::5, 3] = -1
    dup[::4, 4] = v + 2  # matches no row, counts in AVG's divisor
    errs = [
        check_lookup("onehot_embedding", "mlperf-lite", small, one, SUM, torch.bfloat16),
        check_lookup("onehot_embedding", "dup-sum-bf16", small, dup, SUM, torch.bfloat16),
        check_lookup("onehot_embedding", "dup-avg-bf16", small, dup, AVG, torch.bfloat16),
        check_lookup("onehot_embedding", "dup-avg-f32", small, dup, AVG, torch.float32),
        check_lookup("onehot_embedding", "bf16-table", small.to(torch.bfloat16), dup, AVG, torch.bfloat16),
        check_lookup("onehot_embedding", "f16-table", small.to(torch.float16), one, SUM, torch.bfloat16),
        check_lookup("onehot_embedding", "f16-table-dup-avg", small.to(torch.float16), dup, AVG, torch.bfloat16),
    ]
    bound, bound_by = lookup_bound(small, one)
    small_c, small16 = small.to(torch.bfloat16), small.to(torch.float16)
    k5f = {
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "ms": graph_ms(lambda: onehot_embedding(small, one, SUM, torch.bfloat16)),
        "plain_ms": graph_ms(lambda: onehot_embedding_reference(small, one, SUM, torch.bfloat16)),
        # one library call on a table cast to bf16 beforehand (a bf16 result)
        "library_ms": graph_ms(lambda: F.embedding_bag(one, small_c, mode="sum")),
        "bound_ms": bound, "bound_by": bound_by,
        "f16_ms": graph_ms(lambda: onehot_embedding(small16, one, SUM, torch.bfloat16)),
        "f16_plain_ms": graph_ms(lambda: onehot_embedding_reference(small16, one, SUM, torch.bfloat16)),
        # one library call on the f16 table (an f16 result)
        "f16_library_ms": graph_ms(lambda: F.embedding_bag(one, small16, mode="sum")),
        "f16_bound_ms": lookup_bound(small16, one)[0],
    }
    log(f"[kernels] onehot_embedding timing at [{BATCH}, 1] into {list(small.shape)} f32, "
        f"bf16 compute (f16_*: an f16 table): {json.dumps(k5f)}")
    del small, small_c, small16
    torch.cuda.empty_cache()
    return k4, k5f


def launch_counts() -> dict:
    """Every kernel wrapper of the port, by name: each carries `launches`."""
    from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import dot_interaction
    from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import embedding_bag
    from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense
    from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import (
        onehot_embedding, onehot_embedding_backward,
    )
    from dlrm_flexflow_tpu_torch.ops.kernels.row_gather import row_gather
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import (
        row_update, row_update_adagrad, row_update_adam, row_update_momentum,
    )

    return {"dot_interaction": dot_interaction, "fused_dense": fused_dense,
            "embedding_bag": embedding_bag, "onehot_embedding": onehot_embedding,
            "onehot_embedding_backward": onehot_embedding_backward, "row_update": row_update,
            "row_update_momentum": row_update_momentum, "row_update_adam": row_update_adam,
            "row_update_adagrad": row_update_adagrad, "row_gather": row_gather}


def dense_route() -> dict:
    """The Dense products' route counters (ops/dense.py): bf16 forwards and
    backwards, f32 products on the card, cotangent-split launches."""
    from dlrm_flexflow_tpu_torch.ops.dense import Bf16Product, dense
    from dlrm_flexflow_tpu_torch.ops.kernels.bf16_split import split_bf16x3

    return {"bf16_forwards": Bf16Product.forwards, "bf16_backwards": Bf16Product.backwards,
            "f32_products": dense.f32_products, "split_launches": split_bf16x3.launches}


def phase_path() -> int:
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model, mlperf_lite_config

    cfg = mlperf_lite_config(batch_size=BATCH)
    t0 = time.perf_counter()
    model = make_dlrm_model(cfg, FFConfig(batch_size=BATCH, seed=SEED))
    model.compile(
        loss_type=LossType.LOSS_BINARY_CROSSENTROPY,
        metrics=[MetricsType.METRICS_ACCURACY, MetricsType.METRICS_AUC_ROC],
    )
    torch.cuda.synchronize()
    n = 4 * BATCH + 1000
    feeds, _ = random_batches(cfg, n, seed=SEED)
    log(f"[path] mlperf-lite: {cfg.num_tables} tables, {sum(cfg.embedding_size)} rows, "
        f"D={cfg.sparse_feature_size}, bot {cfg.mlp_bot}, top {cfg.mlp_top}; "
        f"set-up {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()

    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = model.predict(feeds)
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}

    chunks = -(-n // BATCH)
    if out.shape != (n, 1):
        raise AssertionError(f"predict shape {out.shape} != {(n, 1)}")
    if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError("predict gave values outside [0, 1] or not finite")
    # "auto" keeps Dense and the lookups on their plain paths, as the JAX
    # package's "auto" does
    if launches != {**{name: 0 for name in counts}, "dot_interaction": chunks}:
        raise AssertionError(f"the auto path launched {launches} for {chunks} chunks")

    warm_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = model.predict(feeds)
        warm_s.append(time.perf_counter() - t0)
    path = {
        "examples": n, "chunks": chunks, "launches": launches,
        "first_predict_s": first_s, "warm_predict_s": warm_s,
        "warm_examples_per_s": n / float(np.median(warm_s)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "repeat_max_abs_diff": float(np.abs(again - out).max()),
        "mean_score": float(out.mean()),
    }
    log(f"[path] {json.dumps(path)}")
    log(f"[path] device ms by op kind, one warm batch of {BATCH}: "
        f"{json.dumps(op_breakdown(model, feeds))}")
    del model
    torch.cuda.empty_cache()
    return launches["dot_interaction"]


def op_breakdown(model, feeds) -> dict:
    """Device time of each op of one forward, between CUDA events recorded
    around its launch, summed by op kind."""
    graph = model.graph
    batch = {k: v[:BATCH] for k, v in feeds.items()}
    times: dict = {}
    with torch.inference_mode():
        staged = model._stage(batch)
        env = {(iop.guid, 0): staged[iop.name] for iop in graph.inputs}
        marks = []
        for op in graph.compute_ops:
            xs = [env[(t.owner_op.guid, t.owner_idx)] for t in op.inputs]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ys = op.forward(model.get_parameters().get(op.name, {}), xs, model._ctx)
            end.record()
            marks.append((type(op).__name__, start, end))
            for i, y in enumerate(ys):
                env[(op.guid, i)] = y
        torch.cuda.synchronize()
    for kind, start, end in marks:
        times[kind] = times.get(kind, 0.0) + start.elapsed_time(end)
    return times


def phase_parity() -> None:
    from dlrm_flexflow_tpu_torch import FFConfig, LossType
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model, mlperf_lite_config
    from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import dot_interaction

    bs = 256
    # mlperf-lite widths and depth of MLPs, vocabs capped at 20000 rows:
    # 13 tables take the one-hot path (<= 8192 rows), 13 the gather
    cfg = mlperf_lite_config(batch_size=bs, vocab_cap=20_000)
    gpu = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=SEED + 1))
    cpu = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=SEED + 1), device="cpu")
    for m in (gpu, cpu):
        m.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
    # like with like: "auto" resolves to "off" on the CPU; set it back so that
    # the CPU model takes the CUDA model's routes (the interaction's f32
    # kernel path, plain Dense and lookups)
    cpu._ctx.use_pallas = "auto"
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    n = 2 * bs + 37
    feeds, _ = random_batches(cfg, n, seed=SEED + 1)
    before = dot_interaction.launches
    y_gpu = gpu.predict(feeds)
    gpu_launches = dot_interaction.launches - before
    y_cpu = cpu.predict(feeds)
    err = float(np.abs(y_gpu - y_cpu).max())
    res = {"examples": n, "gpu_launches": gpu_launches, "max_abs_err": err, "atol": E2E_ATOL}
    log(f"[parity] CUDA vs CPU under auto (the interaction kernel and its plain f32 version): "
        f"{json.dumps(res)}")
    if gpu_launches != 3:
        raise AssertionError(f"CUDA parity model launched the kernel {gpu_launches} times, not 3")
    if not np.isfinite(y_gpu).all() or err > E2E_ATOL:
        raise AssertionError(f"CUDA and CPU predictions disagree: {res}")


def forced_model(cfg, batch: int, seed: int, device="cuda"):
    from dlrm_flexflow_tpu_torch import FFConfig, LossType
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model

    model = make_dlrm_model(cfg, FFConfig(batch_size=batch, seed=seed, use_pallas="on",
                                          packed_tables="off"), device=device)
    model.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
    return model


def forced_launches(chunks: int) -> dict:
    """Launches of one forced-kernel mlperf-lite predict of `chunks` chunks."""
    return {**{name: 0 for name in launch_counts()},
            "dot_interaction": chunks, "fused_dense": len(MLPERF_LITE_LAYERS) * chunks,
            "embedding_bag": MLPERF_LITE_TABLES * chunks,
            "onehot_embedding": MLPERF_LITE_TABLES * chunks}


def phase_path_on() -> dict:
    """mlperf-lite serving at full width with every op on its forced kernel."""
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import mlperf_lite_config

    cfg = mlperf_lite_config(batch_size=BATCH)
    small = sum(1 for v in cfg.embedding_size if v <= 8192)
    if small != MLPERF_LITE_TABLES or cfg.num_tables != 2 * MLPERF_LITE_TABLES:
        raise AssertionError(f"mlperf-lite has {small} of {cfg.num_tables} tables at <= 8192 rows")
    t0 = time.perf_counter()
    model = forced_model(cfg, BATCH, SEED)
    torch.cuda.synchronize()
    n = 4 * BATCH + 1000
    feeds, _ = random_batches(cfg, n, seed=SEED)
    log(f"[path-on] mlperf-lite under use_pallas='on', packed_tables='off'; "
        f"set-up {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()

    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = model.predict(feeds)
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}

    chunks = -(-n // BATCH)
    if out.shape != (n, 1):
        raise AssertionError(f"predict shape {out.shape} != {(n, 1)}")
    if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError("predict gave values outside [0, 1] or not finite")
    if launches != forced_launches(chunks):
        raise AssertionError(f"the forced path launched {launches}, not {forced_launches(chunks)}")

    warm_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = model.predict(feeds)
        warm_s.append(time.perf_counter() - t0)
    path = {
        "examples": n, "chunks": chunks, "launches": launches,
        "first_predict_s": first_s, "warm_predict_s": warm_s,
        "warm_examples_per_s": n / float(np.median(warm_s)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "repeat_max_abs_diff": float(np.abs(again - out).max()),
        "mean_score": float(out.mean()),
    }
    log(f"[path-on] {json.dumps(path)}")
    log(f"[path-on] device ms by op kind, one warm batch of {BATCH}: "
        f"{json.dumps(op_breakdown(model, feeds))}")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_parity_on() -> None:
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import mlperf_lite_config

    bs = 256
    # mlperf-lite widths, vocabs capped at 20000 rows: 13 tables take the
    # one-hot kernel (<= 8192 rows), 13 the embedding-bag kernel
    cfg = mlperf_lite_config(batch_size=bs, vocab_cap=20_000)
    gpu = forced_model(cfg, bs, SEED + 6)
    cpu = forced_model(cfg, bs, SEED + 6, device="cpu")
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    n = 2 * bs + 37
    feeds, _ = random_batches(cfg, n, seed=SEED + 6)
    counts = launch_counts()
    before = {name: fn.launches for name, fn in counts.items()}
    y_gpu = gpu.predict(feeds)
    launches = {name: fn.launches - before[name] for name, fn in counts.items()}
    y_cpu = cpu.predict(feeds)
    err = float(np.abs(y_gpu - y_cpu).max())
    res = {"examples": n, "gpu_launches": launches, "max_abs_err": err, "atol": E2E_ON_ATOL}
    log(f"[parity-on] CUDA forced kernels vs CPU plain versions: {json.dumps(res)}")
    if launches != forced_launches(-(-n // bs)):
        raise AssertionError(f"CUDA parity model launched {launches}")
    if not np.isfinite(y_gpu).all() or err > E2E_ON_ATOL:
        raise AssertionError(f"CUDA and CPU predictions under 'on' disagree: {res}")


def optimizers(rule: str) -> tuple:
    """(optimizer, sparse_optimizer or None) of a training rule."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, RowWiseAdagradOptimizer, SGDOptimizer

    return {
        "sgd": (SGDOptimizer(lr=0.01), None),
        "momentum": (SGDOptimizer(lr=0.01, momentum=0.9), None),
        "nesterov": (SGDOptimizer(lr=0.01, momentum=0.9, nesterov=True), None),
        "adam": (AdamOptimizer(alpha=ADAM_ALPHA), None),
        "adagrad": (RowWiseAdagradOptimizer(lr=ADAGRAD_LR), None),
        "adam+adagrad": (AdamOptimizer(alpha=ADAM_ALPHA), RowWiseAdagradOptimizer(lr=ADAGRAD_LR)),
    }[rule]


def compile_for(model, rule: str, **kw) -> None:
    from dlrm_flexflow_tpu_torch import LossType, MetricsType

    opt, sopt = optimizers(rule)
    model.compile(opt, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                  sparse_optimizer=sopt, **kw)


def kaggle_model(cfg, batch: int, seed: int, device="cuda", rule: str = "sgd", **ffkw):
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model

    model = make_dlrm_model(cfg, FFConfig(
        batch_size=batch, seed=seed, compute_dtype="bfloat16", table_dtype="bfloat16", **ffkw,
    ), device=device)
    compile_for(model, rule)
    return model


def kaggle_batches(model, cfg) -> tuple:
    """4 batches of uniform indices and noise labels: the first as numpy, as
    a user feeds it, and all 4 staged on the card (the JAX package's bench
    pre-stages too)."""
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches

    feeds, labels = random_batches(cfg, 4 * TRAIN_BATCH, seed=SEED, learnable=False)
    batches = []
    for i in range(4):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        batches.append(({k: v[sl] for k, v in feeds.items()}, labels[sl]))
    return batches, [(model._stage(f), model._stage_labels(lbl)) for f, lbl in batches]


def check_route(model, cfg) -> dict:
    routed = {op.name: str(model.get_parameters()[op.name]["weight"].dtype)
              for op in model._sparse_ops if op.kernel_route}
    big = {f"table_{i}" for i, v in enumerate(cfg.embedding_size) if v > 8192}
    if set(routed) != big or len(big) != KAGGLE_BIG_TABLES or set(routed.values()) != {"torch.bfloat16"}:
        raise AssertionError(f"kernel route {routed} is not the {KAGGLE_BIG_TABLES} large tables in bf16")
    return routed


def phase_train(rule: str = "sgd") -> tuple:
    """The kaggle train path at full width under `rule` ("sgd": phase 8,
    "adam": phase 10). Returns the launches of the rule's kernel and the
    ms a step."""
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    tag = "[train]" if rule == "sgd" else f"[train-{rule}]"
    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    t0 = time.perf_counter()
    model = kaggle_model(cfg, TRAIN_BATCH, SEED, rule=rule)
    torch.cuda.synchronize()
    routed = check_route(model, cfg)
    batches, staged = kaggle_batches(model, cfg)
    log(f"{tag} kaggle: {cfg.num_tables} tables, {sum(cfg.embedding_size)} rows, "
        f"D={cfg.sparse_feature_size}, bot {cfg.mlp_bot}, top {cfg.mlp_top}, batch {TRAIN_BATCH}, "
        f"{type(model.optimizer).__name__} / {type(model.sparse_optimizer).__name__}; "
        f"kernel route {sorted(routed)}; set-up {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    losses = [float(model.train_batch(*batches[0]))]
    for i in range(1, TRAIN_WARMUP):
        model.train_batch(*staged[i % 4])
    torch.cuda.synchronize()

    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    route0 = dense_route()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss = model.train_batch(*staged[i % 4])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    route = {k: v - route0[k] for k, v in dense_route().items()}

    losses.append(float(loss))
    # one launch per kernel-route table and step; kaggle's cat interaction
    # and "auto" reach no other kernel
    want = {**{name: 0 for name in counts}, RULE_WRAPPER[rule]: TRAIN_STEPS * KAGGLE_BIG_TABLES}
    if launches != want:
        raise AssertionError(f"the train path launched {launches}, not {want}")
    layers = TRAIN_STEPS * len(KAGGLE_DENSE_NS)
    if route != {"bf16_forwards": layers, "bf16_backwards": layers, "f32_products": 0, "split_launches": layers}:
        raise AssertionError(f"the train path's Dense layers took {route}, not the bf16 route {layers} times")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    res = {
        "steps": TRAIN_STEPS, "seconds": dt, "examples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
        "ms_per_step": dt / TRAIN_STEPS * 1e3, "launches": launches, "dense_route": route,
        "first_loss": losses[0], "last_loss": losses[-1], "metrics": model.get_metrics(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"{tag} {json.dumps(res)}")
    log(f"{tag} device kernels over {PROFILED_STEPS} profiled steps: "
        f"{json.dumps(train_profile(model, staged, res['ms_per_step']))}")
    log(f"{tag} device ms by phase, one step of {TRAIN_BATCH}: "
        f"{json.dumps(train_breakdown(model, *staged[0]))}")
    del model, staged
    torch.cuda.empty_cache()
    return launches[RULE_WRAPPER[rule]], res["ms_per_step"], route["split_launches"]


def train_profile(model, staged, ms_per_step: float, steps: int = PROFILED_STEPS,
                  route_tables: int = KAGGLE_BIG_TABLES) -> dict:
    """Kernel time per step on the device, from torch.profiler (CUPTI) over
    a few steps, against the unprofiled step time: the device's busy share.
    Sums kernel rows only: op rows carry their kernels' time again, copies
    and fills (Memcpy, Memset rows) are summed on their own, and the step's
    phase ranges (`STEP_PHASES`) are read apart: each phase's host time
    (profiled, so a little slower than unprofiled) and the span of the
    device work launched in it, where the profiler records one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dlrm_flexflow_tpu_torch.core.ffmodel import STEP_PHASES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            model.train_batch(*staged[i % len(staged)])
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device = [e for e in rows if e.device_type == DeviceType.CUDA and e.key not in STEP_PHASES
              and not getattr(e, "is_user_annotation", False)]  # the port's ranges mirrored on the card
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if e not in copies]
    spans = {e.key: e.device_time_total / 1e3 / steps for e in rows
             if e.device_type == DeviceType.CUDA and e.key in STEP_PHASES}
    phases = {e.key.split(":")[1]: {"host_ms": e.cpu_time_total / 1e3 / steps,
                                    "device_span_ms": spans.get(e.key, "not measured")}
              for e in rows if e.device_type == DeviceType.CPU and e.key in STEP_PHASES}
    per_step = {e.key: e.self_device_time_total / 1e3 / steps for e in kernels}
    busy = sum(per_step.values())
    if busy == 0.0:
        return {"kernel_ms_per_step": "not measured (the profiler saw no device time)", "phases": phases}
    # a row-update wrapper launch runs 2 to 4 CUDA kernels, all named row_update_*
    row = [e for e in kernels if "row_update" in e.key]
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    by_kind = {}
    for name, ms in per_step.items():
        kind = kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {
        "kernel_ms_per_step": busy,
        "busy_share_of_unprofiled_step": busy / ms_per_step,
        "copy_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / steps for e in copies},
        "row_update_kernel_ms_per_launch": (
            sum(e.self_device_time_total for e in row) / 1e3 / (steps * route_tables)),
        "top_kernels_ms_per_step": {k[:60]: v for k, v in top},
        "kernel_ms_per_step_by_kind": by_kind,
        "phases": phases,
    }


def kernel_kind(name: str) -> str:
    """A CUDA kernel's kind by its name: cuDNN's layout transposes, its
    convolutions, GEMMs (cuBLAS, CUTLASS), pools, reductions, elementwise
    kernels, the rest."""
    low = name.lower()
    for kind, marks in (("layout", ("nchwtonhwc", "nhwctonchw")),
                        ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn")),
                        ("gemm", ("gemm", "xmma", "cutlass")), ("pool", ("pool",)), ("reduce", ("reduce",)),
                        ("elementwise", ("elementwise",))):
        if any(m in low for m in marks):
            return kind
    return "other"


def train_breakdown(model, feeds, labels, routes=None) -> dict:
    """One train step, phase by phase as FFModel.train_batch runs it, with
    CUDA events around each phase (the span includes any time the card
    waits for the host to launch the phase's work). With `routes` ({op:
    (rows_sorted, order)} on the card, host routing) the row-update prep
    sorts nothing: its phase is "route_prep"."""
    from dlrm_flexflow_tpu_torch.ops.embedding import bag_row_src
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import sort_rows
    from dlrm_flexflow_tpu_torch.training import losses as losses_lib

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    params, sparse_ops = model.get_parameters(), model._sparse_ops
    names = {op.name for op in sparse_ops}
    ctx = dataclasses.replace(model._ctx, training=True)
    mark("start")
    with torch.no_grad():
        over = {
            op.name: [y.requires_grad_(True) for y in op.forward(
                params[op.name], [feeds[t.owner_op.name] for t in op.inputs], ctx)]
            for op in sparse_ops
        }
    mark("sparse_lookups")
    leaves = {n: {k: p.detach().requires_grad_(True) for k, p in sub.items()}
              for n, sub in params.items() if n not in names}
    ctx.overrides = over
    (logits,) = model.graph.execute(leaves, feeds, ctx, fetch=[model._out_spec])
    loss = losses_lib.compute_loss(model.loss_type, logits, labels)
    mark("dense_forward_and_loss")
    flat = [p for sub in leaves.values() for p in sub.values()]
    grads = torch.autograd.grad(loss, flat + [y for v in over.values() for y in v],
                                allow_unused=True, materialize_grads=True)
    mark("backward")
    it = iter(grads)
    g_dense = {n: {k: next(it) for k in sub} for n, sub in leaves.items()}
    g_over = {op.name: next(it) for op in sparse_ops}
    st = model._opt_state
    scalars = torch.from_numpy(model._scalar_table(model._step_count + 1, 1)[0]).cuda()
    dstate = model._dense_update(g_dense, st["dense"], {n: params[n] for n in g_dense}, scalars)
    model._advance(1)
    mark("dense_update")
    with torch.no_grad():
        ops = [op for op in sparse_ops if op.kernel_route]
        prep = [bag_row_src(feeds[op.inputs[0].owner_op.name], g_over[op.name], op.aggr,
                            op.num_entries) for op in ops]
        tables = [params[op.name]["weight"] for op in ops]
        if routes is None:
            rows_sorted, order = sort_rows(tables, [p[0] for p in prep])
        else:
            rows_sorted, order = zip(*(routes[op.name] for op in ops))
        sopt = model.sparse_optimizer
        rate = model._sparse_rate(dstate, scalars)
        mark("sort_prep" if routes is None else "route_prep")
        for i, (op, t, (_, src, h)) in enumerate(zip(ops, tables, prep)):
            launch_rule(sopt, t, st["sparse"][op.name], rows_sorted[i], order[i],
                        src.contiguous(), h, rate)
        mark("row_update_kernel")
    torch.cuda.synchronize()
    out = {name: prev[1].elapsed_time(ev) for prev, (name, ev) in zip(marks, marks[1:])}
    out["total"] = marks[0][1].elapsed_time(marks[-1][1])
    return out


def launch_rule(sopt, table, state, rows_sorted, order, src, h, rate) -> None:
    """One table's kernel launch of the sparse optimizer's rule, as
    training/sparse_engine.py makes it (without weight decay)."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, SGDOptimizer
    from dlrm_flexflow_tpu_torch.ops.kernels import row_update as ru

    if isinstance(sopt, AdamOptimizer):
        ru._launch_adam(table, state["m"], state["v"], rows_sorted, order, src, h, rate,
                        sopt.beta1, sopt.beta2, sopt.epsilon, sopt.weight_decay)
    elif isinstance(sopt, SGDOptimizer) and sopt.momentum != 0.0:
        ru._launch_momentum(table, state, rows_sorted, order, src, h, rate, sopt.momentum,
                            sopt.nesterov, sopt.weight_decay)
    elif isinstance(sopt, SGDOptimizer):
        ru._launch(table, rows_sorted, order, src, h, -rate, torch.bfloat16)
    else:
        ru._launch_adagrad(table, state, rows_sorted, order, src, h, rate, sopt.epsilon)


def phase_train_optims() -> dict:
    """Phase 11: the full-width kaggle model a few steps under each other
    sparse rule. Returns each rule's launches of its kernel."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config, make_dlrm_model

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    model = make_dlrm_model(cfg, FFConfig(batch_size=TRAIN_BATCH, seed=SEED, compute_dtype="bfloat16",
                                          table_dtype="bfloat16"), device="cuda")
    out = {}
    for rule in ("momentum", "nesterov", "adagrad", "adam+adagrad"):
        compile_for(model, rule)
        check_route(model, cfg)
        if rule == "momentum":
            batches, staged = kaggle_batches(model, cfg)
        torch.cuda.reset_peak_memory_stats()
        losses = [float(model.train_batch(*batches[0]))]  # warm-up, from numpy
        counts = launch_counts()
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for i in range(3):
            loss = model.train_batch(*staged[(i + 1) % 4])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counts.items()}
        losses.append(float(loss))
        want = {**{name: 0 for name in counts}, RULE_WRAPPER[rule]: 3 * KAGGLE_BIG_TABLES}
        res = {"rule": rule, "steps": 3, "ms_per_step": dt / 3 * 1e3, "launches": launches,
               "first_loss": losses[0], "last_loss": losses[-1],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[train-optim] {json.dumps(res)}")
        if launches != want:
            raise AssertionError(f"the {rule} train path launched {launches}, not {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{rule} train losses not finite: {losses}")
        out[rule] = launches[RULE_WRAPPER[rule]]
    del model, staged
    torch.cuda.empty_cache()
    return out


def phase_train_parity(rule: str = "sgd") -> None:
    """Phase 9 (SGD) or 12 (the other rules): kaggle widths with vocabs
    capped, 5 steps on CUDA against the CPU from the same weights."""
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    tag = "[train-parity]" if rule == "sgd" else "[train-parity-optim]"
    wrapper = launch_counts()[RULE_WRAPPER[rule]]
    bs, steps = 256, 5
    # kaggle widths and depth, vocabs capped at 20000 rows: 16 tables take
    # the one-hot path (<= 8192 rows), 10 the row-update kernel route
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    gpu = kaggle_model(cfg, bs, SEED + 3, rule=rule, packed_tables="on")
    cpu = kaggle_model(cfg, bs, SEED + 3, device="cpu", rule=rule, packed_tables="on")
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, labels = random_batches(cfg, steps * bs, seed=SEED + 3)
    errs, launches = [], 0
    for i in range(steps):
        sl = slice(i * bs, (i + 1) * bs)
        batch = {k: v[sl] for k, v in feeds.items()}
        before = wrapper.launches
        loss_gpu = float(gpu.train_batch(batch, labels[sl]))
        launches += wrapper.launches - before
        errs.append(abs(loss_gpu - float(cpu.train_batch(batch, labels[sl]))))
    w_errs = np.concatenate([
        np.abs(w - cpu.get_weights(name)[k]).reshape(-1)
        for name in gpu.get_parameters() for k, w in gpu.get_weights(name).items()
    ])
    w_atol = {"adam": ADAM_E2E_ATOL, "adam+adagrad": ADAGRAD_E2E_ATOL}.get(rule, E2E_ATOL)
    res = {"rule": rule, "steps": steps, "batch": bs, "gpu_launches": launches,
           "max_loss_err": max(errs), "max_weight_err": float(w_errs.max()),
           "share_within_e2e_atol": float(np.mean(w_errs <= E2E_ATOL)),
           "atol": E2E_ATOL, "weight_atol": w_atol}
    log(f"{tag} CUDA kernel route vs CPU plain: {json.dumps(res)}")
    if launches != steps * KAGGLE_BIG_TABLES:
        raise AssertionError(f"CUDA parity model launched {RULE_WRAPPER[rule]} {launches} times")
    if max(errs) > E2E_ATOL or res["max_weight_err"] > w_atol or res["share_within_e2e_atol"] < 0.999:
        raise AssertionError(f"CUDA and CPU training disagree: {res}")


# ------------------------------------------------------------------ optimizer modes of K1

OPTIM_RULES = {  # case -> (rule, weight decay)
    "momentum": ("momentum", 0.0), "nesterov": ("nesterov", 0.0), "adam": ("adam", 0.0),
    "adam-wd": ("adam", 0.01), "adagrad": ("adagrad", 0.0),
}
# bytes each touched row's pools move, read and written (D = the table's width)
POOL_BYTES = {"momentum": lambda d: 2 * d * 4, "nesterov": lambda d: 2 * d * 4,
              "adam": lambda d: 4 * d * 4, "adagrad": lambda d: 2 * 4}
# operations an entry and lane, and a touched row and lane, of each rule
RULE_OPS = {"momentum": (2, 4), "nesterov": (2, 8), "adam": (8, 8), "adagrad": (6, 4)}


def case_optimizer(rule: str, wd: float):
    """The sparse optimizer of a kernel case (its rate is passed apart)."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, RowWiseAdagradOptimizer, SGDOptimizer

    if rule in ("momentum", "nesterov"):
        return SGDOptimizer(momentum=0.9, nesterov=rule == "nesterov", weight_decay=wd)
    if rule == "adam":
        return AdamOptimizer(weight_decay=wd)
    return RowWiseAdagradOptimizer()


def rule_pools(rule, v, d, gen) -> list:
    """Optimizer pools as a few steps of training leave them."""
    if rule in ("momentum", "nesterov"):
        return [torch.randn((v, d), generator=gen, device="cuda") * 1e-3]
    if rule == "adam":
        return [torch.randn((v, d), generator=gen, device="cuda") * 1e-3,
                torch.rand((v, d), generator=gen, device="cuda") * 1e-6]
    return [torch.rand((v,), generator=gen, device="cuda") * 0.1]


def pool_state(pools: list):
    """The slot state of one kernel-route table, as the engine keeps it."""
    return {"m": pools[0], "v": pools[1]} if len(pools) == 2 else pools[0]


def rule_call(opt, table, pools, rows, src, h, rate, plain: bool) -> None:
    """The optimizer's wrapper (plain=False) or plain version on one table."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, SGDOptimizer
    from dlrm_flexflow_tpu_torch.ops.kernels import row_update as ru

    p = (src, h)
    if isinstance(opt, SGDOptimizer):
        args = (rate, opt.momentum, opt.nesterov, opt.weight_decay)
        if plain:
            ru.momentum_reference(table, pools[0], rows, p, *args)
        else:
            ru.row_update_momentum([table], [pools[0]], [rows], [p], *args)
    elif isinstance(opt, AdamOptimizer):
        args = (rate, opt.beta1, opt.beta2, opt.epsilon, opt.weight_decay)
        if plain:
            ru.adam_reference(table, pools[0], pools[1], rows, p, *args)
        else:
            ru.row_update_adam([table], [pools[0]], [pools[1]], [rows], [p], *args)
    elif plain:
        ru.adagrad_reference(table, pools[0], rows, p, rate, opt.epsilon)
    else:
        ru.row_update_adagrad([table], [pools[0]], [rows], [p], rate, opt.epsilon)


def rule_tolerance(rule, table, pools, want_t, want_pools, rows, src, h, rate) -> tuple:
    """Per element of the table and of each pool. The kernel sums a row's
    entries in sorted order, the plain version with index_add_'s atomics in
    any order: two f32 sums of n terms within 2 * n * 2^-24 * sum |term| of
    each other (AdaGrad's mean over D adds 2 * D * 2^-24 of each term, and
    the plain version's torch.rsqrt is CUDA's approximate one, within 2 ulp
    of the kernel's correctly rounded __frsqrt_rn). The pools carry such a
    difference into the weight's delta, and where it crosses a bf16 rounding
    (each stream entry, the delta, the table's epilogue) the value moves by
    one bf16 step, at most 2^-7 of its magnitude: the table's tolerance is
    two such steps of |t| + |t'| + the sum of the row's |delta|. Adam near
    v = 0 amplifies nothing: v sums positive terms, so its relative
    difference stays 2 n 2^-24, and eps bounds 1 / (sqrt(v) + eps)."""
    v, d = table.shape
    keep = (rows >= 0) & (rows < v)
    r = rows[keep]
    x = src[torch.arange(rows.numel(), device="cuda")[keep] // h]

    def rowsum(vals):
        out = torch.zeros((v,) + tuple(vals.shape[1:]), device="cuda")
        return out.index_add_(0, r, vals)

    n = rowsum(torch.ones(r.numel(), device="cuda")) + 1.0
    nd = n[:, None]
    t0 = table.float().abs()
    deltas = torch.zeros((v, 1), device="cuda")
    if rule in ("momentum", "nesterov"):
        pool_tols = [2 * nd * F32_UNIT * (pools[0].abs() + rowsum(x.abs() + t0[r] * 0.01))]
    elif rule == "adam":
        g = x.abs() + t0[r] * 0.01
        pool_tols = [2 * nd * F32_UNIT * (pools[0].abs() + rowsum(0.1 * g)),
                     2 * nd * F32_UNIT * (pools[1] + rowsum(1e-3 * g * g))]
    else:
        pool_tols = [2 * (n + d) * F32_UNIT * (pools[0] + rowsum((x * x).mean(dim=1)))]
        deltas = (rate.abs() * torch.rsqrt(want_pools[0] + 1e-10))[:, None] * rowsum(x.abs())
    mag = t0 + want_t.float().abs() + deltas
    return 2.0 * 2.0**-7 * mag, pool_tols


def check_rule(case, table, rows, src, timed: bool, gen) -> dict:
    """One optimizer-mode case of the row-update kernel against its plain
    version from the same table and pools, a repeat for bit-identity, the
    rows it must leave as they were, and (if timed) the times and bound."""
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import sort_rows

    rule, wd = OPTIM_RULES.get(case.split(":")[0], (case.split(":")[0], 0.0))
    opt = case_optimizer(rule, wd)
    v, d = table.shape
    h = rows.numel() // src.shape[0]
    pools = rule_pools(rule, v, d, gen)
    rate = torch.tensor(3e-3 if rule == "adam" else 0.01, device="cuda")
    want_t, want_p = table.clone(), [p.clone() for p in pools]
    rule_call(opt, want_t, want_p, rows, src, h, rate, plain=True)
    runs = []
    for _ in range(2):
        t, ps = table.clone(), [p.clone() for p in pools]
        rule_call(opt, t, ps, rows, src, h, rate, plain=False)
        runs.append((t, ps))
    torch.cuda.synchronize()
    (got_t, got_p), (again_t, again_p) = runs
    tol_t, tol_p = rule_tolerance(rule, table, pools, want_t, want_p, rows, src, h, rate)
    err_t = (got_t.float() - want_t.float()).abs()
    keep = (rows >= 0) & (rows < v)
    touched = torch.zeros(v, dtype=torch.bool, device="cuda")
    touched[rows[keep]] = True
    same = lambda a, b: bool(torch.equal(a.view(torch.uint8), b.view(torch.uint8)))  # noqa: E731
    res = {
        "case": case, "V": v, "D": d, "K": rows.numel(), "h": h,
        "table": str(table.dtype).replace("torch.", ""), "weight_decay": wd,
        "dropped": int((~keep).sum()), "unique_rows": int(touched.sum()),
        "max_abs_err": err_t.max().item(),
        "max_err_over_tol": max([(err_t / tol_t.clamp_min(1e-30)).max().item()] + [
            ((g - w).abs() / tl.clamp_min(1e-30)).max().item()
            for g, w, tl in zip(got_p, want_p, tol_p)]),
        "exact_share_touched": (got_t == want_t)[touched].float().mean().item(),
        "untouched_unchanged": same(got_t[~touched], table[~touched]) and all(
            same(g[~touched], p[~touched]) for g, p in zip(got_p, pools)),
        "bit_identical_repeat": same(got_t, again_t) and all(same(a, b) for a, b in zip(got_p, again_p)),
    }
    finite = bool(torch.isfinite(got_t.float()).all()) and all(bool(torch.isfinite(g).all()) for g in got_p)
    if not finite or res["max_err_over_tol"] > 1.0 or not res["untouched_unchanged"]:
        raise AssertionError(f"row_update {rule} disagrees with its plain version: {res}")
    if not res["bit_identical_repeat"]:
        raise AssertionError(f"row_update {rule} is not bit-reproducible: {res}")
    if timed:
        rows_sorted, order = sort_rows([table], [rows])
        uniq = res["unique_rows"]
        t_bytes = (rows.numel() * 8 + src.numel() * 4 + uniq * (2 * d * table.element_size()
                   + POOL_BYTES[rule](d))) / HBM_BYTES_PER_S * 1e3
        per_entry, per_row = RULE_OPS[rule]
        t_ops = (int(keep.sum()) * d * per_entry + uniq * d * per_row) / F32_FLOP_PER_S * 1e3
        state = pool_state(got_p)
        launch = lambda: launch_rule(opt, got_t, state, rows_sorted[0], order[0], src, h, rate)  # noqa: E731
        t32 = table.to(torch.float32, copy=True)
        k_ok = torch.arange(rows.numel(), device="cuda")[keep]
        deltas = (rate * src[k_ok // h]).contiguous()
        r_ok = rows[keep]
        res.update({
            "ms": graph_ms(launch),
            "eager_ms": cuda_ms(launch),
            "prep_ms": cuda_ms(lambda: sort_rows([table], [rows])),
            # torch.unique syncs with the host, so no graph here
            "plain_ms": cuda_ms(lambda: rule_call(opt, want_t, want_p, rows, src, h, rate, True)),
            "library_ms": None,  # no one PyTorch call does a lazy optimizer update
            # SGD's library call on this stream, for scale: the pre-formed
            # deltas added into an f32 copy of the table
            "index_add_ms": graph_ms(lambda: t32.index_add_(0, r_ok, deltas)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        del t32, deltas, r_ok
    log(f"[kernels] row_update_{rule} {json.dumps(res)}")
    del want_t, want_p, runs, got_t, got_p, again_t, again_p, pools
    return res


def phase_optim_kernels() -> dict:
    """The row-update kernel's optimizer modes at the K1 shape of phase 3:
    65536 rows into the 10,131,227-row bf16 kaggle table, f32 pools; on
    uniform rows and on a Zipf(1.05) stream."""
    from dlrm_flexflow_tpu_torch.data.synthetic import zipf_indices

    v, d, k = 10_131_227, 16, TRAIN_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    table = ((torch.rand((v, d), generator=gen, device="cuda") - 0.5) * 0.02).to(torch.bfloat16)
    src = torch.randn((k, d), generator=gen, device="cuda") * 1e-2
    uniform = torch.randint(0, v, (k,), generator=gen, device="cuda")
    zipf = torch.from_numpy(zipf_indices(np.random.default_rng(SEED + 7), v, k, 1.05)).cuda()
    dropped = uniform.clone()
    dropped[: k // 16] = -1 - torch.arange(k // 16, device="cuda") % 7
    dropped[k // 16 : k // 8] = v + torch.arange(k // 16, device="cuda") % 7
    cases = {}
    for case in OPTIM_RULES:
        cases[case] = check_rule(case, table, uniform, src, timed=True, gen=gen)
    for rule in ("momentum", "adam", "adagrad"):  # SGD's Zipf case is phase 3's b-zipf
        cases[f"{rule}:zipf"] = check_rule(f"{rule}:zipf", table, zipf, src, timed=True, gen=gen)
    for rule in ("momentum", "adam", "adagrad"):
        cases[f"{rule}:dropped"] = check_rule(f"{rule}:dropped", table, dropped, src, timed=False, gen=gen)
    cases["adagrad:bag2"] = check_rule("adagrad:bag2", table, uniform, src[: k // 2].contiguous(),
                                       timed=False, gen=gen)
    del table
    torch.cuda.empty_cache()
    return cases


# ------------------------------------------------------------------ K5b


def check_onehot_backward(name, v, d, idx, g, aggr, cdt, gen) -> dict:
    """K5b through torch.autograd.grad of the op against its plain version.
    Both sum exact products (bf16) or f32 products rounded alike in f32 in
    another order: within 2 * n * 2^-24 * sum |w * g| of each other, n the
    row's weight sum (at least its bag count). Where the plan gives one
    segment the kernel adds a row's terms in member order, as the plain
    version's index_add_ does on the CPU: there the two must agree bit for
    bit."""
    from dlrm_flexflow_tpu_torch import AggrMode
    from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import (
        backward_plan, onehot_embedding, onehot_embedding_backward_reference,
    )

    table = randn((v, d), gen, scale=0.05).requires_grad_(True)
    grads = [torch.autograd.grad(onehot_embedding(table, idx, aggr, cdt), [table], grad_outputs=g)[0]
             for _ in range(2)]
    want = onehot_embedding_backward_reference(idx, g, v, aggr, cdt)
    ones = torch.ones((idx.shape[0], 1), device="cuda")
    n = onehot_embedding_backward_reference(idx, ones, v, AggrMode.AGGR_MODE_SUM, torch.float32)
    tol = 2.0 * n * F32_UNIT * onehot_embedding_backward_reference(idx, g.float().abs(), v, aggr, cdt)
    torch.cuda.synchronize()
    got = grads[0]
    err = (got - want).abs()
    plan = backward_plan(idx.shape[0], idx.shape[1], v, d)
    res = {
        "case": name, "rows": v, "D": d, "bags": idx.shape[0], "H": idx.shape[1],
        "idx": str(idx.dtype).replace("torch.", ""),
        "aggr": aggr.name, "compute": str(cdt).replace("torch.", ""),
        "g": str(g.dtype).replace("torch.", ""),
        "segments": plan.segments, "split": plan.split,
        "padded": int((idx < 0).sum()), "past_the_table": int((idx >= v).sum()),
        "rows_untouched": int((want == 0).all(dim=1).sum()),
        "max_abs_err": err.max().item(),
        "max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item(),
        "bit_identical_repeat": bool(torch.equal(bits(grads[0]), bits(grads[1]))),
    }
    if plan.segments == 1:
        cpu = onehot_embedding_backward_reference(idx.cpu(), g.cpu(), v, aggr, cdt)
        res["bit_identical_cpu"] = bool(torch.equal(bits(got.cpu()), bits(cpu)))
    log(f"[kernels] onehot_embedding_backward {json.dumps(res)}")
    if (not torch.isfinite(got).all() or res["max_err_over_tol"] > 1.0
            or not res["bit_identical_repeat"] or got.dtype != torch.float32
            or not res.get("bit_identical_cpu", True)):
        raise AssertionError(f"onehot_embedding_backward disagrees with its plain version: {res}")
    return res


def cuda_kernels_of(fn, reps: int = 20) -> dict:
    """The CUDA kernels a call of fn runs, by name: launches a call and
    device us a launch, from torch.profiler over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]:
            {"a_call": e.count / reps, "us": e.self_device_time_total / e.count}
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def time_onehot_backward(v, idx, g) -> dict:
    """The whole call onehot_embedding_backward(idx, g, v, SUM, bf16) in a
    CUDA graph beside its bound (idx and g read once, dT written once) and
    index_add_ of the pre-weighted rows into zeros. It takes any version of
    the wrapper (`tools/onehot_backward_ab.py` times an earlier one)."""
    from dlrm_flexflow_tpu_torch import AggrMode
    from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import (
        _onehot_weights, onehot_embedding_backward,
    )

    SUM, bf16 = AggrMode.AGGR_MODE_SUM, torch.bfloat16
    d = g.shape[1]
    w = _onehot_weights(idx, v, SUM, bf16)
    b, m = torch.nonzero(w > 0, as_tuple=True)
    rows_kept = idx[b, m]
    weighted = w[b, m][:, None] * g[b].to(bf16).float()
    dt0 = torch.zeros((v, d), device="cuda")
    t_bytes = (idx.numel() * idx.element_size() + g.numel() * g.element_size() + v * d * 4) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * rows_kept.numel() * d / F32_FLOP_PER_S * 1e3
    res = {
        "V": v,
        "ms": graph_ms(lambda: onehot_embedding_backward(idx, g, v, SUM, bf16)),
        # one library call that adds the pre-weighted rows into zeros
        "library_ms": graph_ms(lambda: dt0.index_add_(0, rows_kept, weighted)),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    res["over_bound"] = res["ms"] / res["bound_ms"]
    return res


def phase_onehot_backward() -> dict:
    """K5b at the largest mlperf-lite small table (V = 7424, D = 128, B =
    16384, H = 1, SUM, bf16 compute), bags of 4 with AVG, duplicates,
    indices >= V, padding and a fully padded bag, a ragged D, the hot
    vocabularies V = 3 and 4, and kaggle's shape (D = 16, B = 65536, int32
    idx, bf16 g); then at each of mlperf-lite's 13 small vocabularies the
    same check, the CUDA work of one call counted and the whole call
    timed."""
    from dlrm_flexflow_tpu_torch import AggrMode
    from dlrm_flexflow_tpu_torch.models.dlrm import mlperf_lite_config
    from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import (
        backward_plan, onehot_embedding_backward, onehot_embedding_backward_reference,
    )
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import graph_nodes

    SUM, AVG = AggrMode.AGGR_MODE_SUM, AggrMode.AGGR_MODE_AVG
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    v, d = 7424, 128
    one = torch.randint(0, v, (BATCH, 1), generator=gen, device="cuda")
    g = randn((BATCH, d), gen)
    bags = torch.randint(0, v, (BATCH, 4), generator=gen, device="cuda")
    bags[:, 1] = bags[:, 0]  # n_r >= 2
    bags[::3, 2] = bags[::3, 0]  # n_r = 3
    bags[::5, 3] = -1
    bags[::4, 2] = v + 2  # matches no row, counts in AVG's divisor
    bags[7] = -1  # a fully padded bag
    kaggle_v, kaggle_b = 5683, TRAIN_BATCH
    errs = [
        check_onehot_backward("mlperf-lite", v, d, one, g, SUM, torch.bfloat16, gen),
        check_onehot_backward("bag4-avg-f32", v, d, bags, g, AVG, torch.float32, gen),
        check_onehot_backward("bag4-sum-bf16-g", v, d, bags, g.to(torch.bfloat16), SUM,
                              torch.bfloat16, gen),
        check_onehot_backward("bag4-avg-ragged-D", 500, 37, torch.where(bags >= 0, bags % 520, bags),
                              g[:, :37].contiguous(), AVG, torch.bfloat16, gen),
        check_onehot_backward("hot-v3", 3, d, one % 3, g, SUM, torch.bfloat16, gen),
        check_onehot_backward("hot-v4-bag4-avg", 4, d, torch.where(bags >= 0, bags % 6, bags), g, AVG,
                              torch.bfloat16, gen),
        check_onehot_backward("kaggle-int32-bf16-g", kaggle_v, 16,
                              torch.randint(0, kaggle_v, (kaggle_b, 1), generator=gen, device="cuda",
                                            dtype=torch.int32),
                              randn((kaggle_b, 16), gen, dtype=torch.bfloat16), SUM, torch.bfloat16, gen),
    ]
    # each of the 13 vocabs against its plain version; the work one call puts
    # on the card, from a CUDA graph of it: the plan's kernels and nothing
    # else (no sort); the whole call timed
    vocabs = [vv for vv in mlperf_lite_config(batch_size=BATCH).embedding_size if vv <= 8192]
    for vv in vocabs:
        ix = one % vv
        errs.append(check_onehot_backward(f"mlperf-lite-v{vv}", vv, d, ix, g, SUM, torch.bfloat16, gen))
        nodes = graph_nodes(lambda: onehot_embedding_backward(ix, g, vv, SUM, torch.bfloat16))
        want_nodes = {"kernel": backward_plan(BATCH, 1, vv, d).launches}
        if nodes != want_nodes:
            raise AssertionError(f"K5b at V = {vv} put {nodes} on the card, not {want_nodes}")
        log(f"[kernels] onehot_embedding_backward timing, mlperf-lite vocab: "
            f"{json.dumps({**time_onehot_backward(vv, ix, g), 'graph_nodes': nodes})}")
    main = time_onehot_backward(v, one, g)
    k5b = {
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        **main,
        "segments": backward_plan(BATCH, 1, v, d).segments,
        "eager_ms": cuda_ms(lambda: onehot_embedding_backward(one, g, v, SUM, torch.bfloat16)),
        "plain_ms": cuda_ms(lambda: onehot_embedding_backward_reference(one, g, v, SUM, torch.bfloat16)),
    }
    log(f"[kernels] onehot_embedding_backward timing at [{BATCH}, 1] into [{v}, {d}], "
        f"f32 g, bf16 compute, the whole call: {json.dumps(k5b)}")
    del g, bags, one
    torch.cuda.empty_cache()
    return k5b


def onehot_grad_inputs() -> tuple:
    """mlperf-lite's 13 tables of at most 8192 rows (D = 128), an index
    batch of 16384 for each and the pooled output's gradient g, from a seed:
    (tables, idx, g)."""
    from dlrm_flexflow_tpu_torch.models.dlrm import mlperf_lite_config

    cfg = mlperf_lite_config(batch_size=BATCH)
    vocabs = [v for v in cfg.embedding_size if v <= 8192]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    tables = [randn((v, cfg.sparse_feature_size), gen, scale=0.05).requires_grad_(True) for v in vocabs]
    idx = [torch.randint(0, v, (BATCH, 1), generator=gen, device="cuda") for v in vocabs]
    return tables, idx, randn((BATCH, cfg.sparse_feature_size), gen)


def onehot_grad_pass(tables, idx, g):
    """The pass a user runs: each table's lookup (SUM, bf16 compute) and its
    gradient through torch.autograd.grad."""
    from dlrm_flexflow_tpu_torch import AggrMode
    from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import onehot_embedding

    return [torch.autograd.grad(onehot_embedding(t, ix, AggrMode.AGGR_MODE_SUM, torch.bfloat16),
                                [t], grad_outputs=g)[0] for t, ix in zip(tables, idx)]


def onehot_grad_times(grad_pass, reps: int = 20) -> dict:
    """A pass's time by the host's clock over `reps`, by CUDA events, and as
    its kernels' device time (torch.profiler)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        grad_pass()
    torch.cuda.synchronize()
    ms_a_pass = (time.perf_counter() - t0) / reps * 1e3
    kernels = cuda_kernels_of(grad_pass, reps=5)
    return {"ms_a_pass": ms_a_pass, "events_ms_a_pass": cuda_ms(grad_pass),
            "kernel_ms_a_pass": sum(k["a_call"] * k["us"] for k in kernels.values()) / 1e3,
            "kernels_a_pass": {name: k["a_call"] for name, k in kernels.items()}}


def phase_onehot_grad() -> int:
    """Phase 13: the one-hot lookup's gradient through torch.autograd, as a
    user differentiates the op, at mlperf-lite's 13 tables of at most 8192
    rows (D = 128, batch 16384, SUM, bf16 compute): one counted pass, then
    the pass's time over more. Returns K5b's launches."""
    tables, idx, g = onehot_grad_inputs()
    vocabs = [t.shape[0] for t in tables]

    def grad_pass():
        return onehot_grad_pass(tables, idx, g)

    torch.cuda.synchronize()
    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    grads = grad_pass()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    want = {**{name: 0 for name in counts}, "onehot_embedding": len(vocabs),
            "onehot_embedding_backward": len(vocabs)}
    res = {"tables": len(vocabs), "rows": sum(vocabs), "batch": BATCH, "seconds": dt,
           **onehot_grad_times(grad_pass), "launches": launches}
    log(f"[onehot-grad] {json.dumps(res)}")
    if launches != want or len(vocabs) != MLPERF_LITE_TABLES:
        raise AssertionError(f"the one-hot gradient launched {launches}, not {want}")
    for t, gt in zip(tables, grads):
        if gt.shape != t.shape or gt.dtype != torch.float32 or not torch.isfinite(gt).all():
            raise AssertionError(f"one-hot gradient {tuple(gt.shape)} {gt.dtype} is not a finite "
                                 f"f32 gradient of the {tuple(t.shape)} table")
    return launches["onehot_embedding_backward"]


# ------------------------------------------------------------------ K7, host routing, the bench


def bits(x: torch.Tensor) -> torch.Tensor:
    """The bit pattern of a float tensor (NaN rows compare too)."""
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def check_gather(name, table, rows) -> dict:
    """K7 at each depth against its plain version, bit for bit, run twice."""
    from dlrm_flexflow_tpu_torch.ops.kernels.row_gather import DEPTHS, row_gather, row_gather_reference

    want = row_gather_reference(table, rows)
    res = {"case": name, "rows": table.shape[0], "W": table.shape[1],
           "table": str(table.dtype).replace("torch.", ""), "K": rows.numel(),
           "out_of_range": int(((rows < 0) | (rows >= table.shape[0])).sum())}
    same = True
    for depth in DEPTHS:
        got, again = row_gather(table, rows, depth), row_gather(table, rows, depth)
        torch.cuda.synchronize()
        same = same and bool(torch.equal(bits(got), bits(want))) and bool(torch.equal(bits(again), bits(got)))
    fin = torch.isfinite(want)
    res["bit_exact_and_repeatable"] = same
    res["max_abs_err"] = (got.float() - want.float()).abs()[fin].max().item() if fin.any() else 0.0
    log(f"[kernels] row_gather {json.dumps(res)}")
    if not same:
        raise AssertionError(f"row_gather disagrees with its plain version: {res}")
    return res


def phase_gather() -> dict:
    """K7 at the probe's shape (K = 65536 rows of a [125952, 128] table, f32
    and bf16, every depth), at a ragged K, on the narrow [1000000, 16]
    table, at widths of 5 and 6 chunks, with indices < 0 and >= P; timed at
    the probe's shape."""
    from dlrm_flexflow_tpu_torch.ops.kernels.row_gather import DEPTHS, row_gather, row_gather_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    packed = randn((125952, 128), gen, scale=0.01)
    narrow = randn((1_000_000, 16), gen, scale=0.01)
    idx = torch.randint(0, 1_000_000, (TRAIN_BATCH,), generator=gen, device="cuda", dtype=torch.int32)
    rows = idx // 8  # the probe's packed rows
    bad = rows.clone()
    bad[::7] = -1 - bad[::7] % 5
    bad[3::11] = packed.shape[0] + bad[3::11] % 5
    cases = []
    for table in (packed, packed.to(torch.bfloat16)):
        cases.append(check_gather("probe", table, rows))
        cases.append(check_gather("ragged-K", table, rows[:TRAIN_BATCH - 37].contiguous()))
        cases.append(check_gather("out-of-range", table, bad))
    for table in (narrow, narrow.to(torch.bfloat16)):
        cases.append(check_gather("narrow", table, idx))
        cases.append(check_gather("narrow-ragged-out-of-range", table, torch.cat([idx[:999], bad[:18] * 8])))
    # a row of 96 or 80 bytes: 6 or 5 chunks, the divide instance
    for table in (randn((5000, 24), gen), randn((5000, 40), gen, dtype=torch.bfloat16)):
        cases.append(check_gather("odd-width", table, torch.cat([idx[:4000] % 5000, bad[:11]])))

    # bytes: the indices, the distinct rows they name, the output. The calls
    # of a timing go round 4 copies of the table (258 MB f32, 129 MB bf16),
    # so that each finds its table cold in the 50 MB L2, as each of the
    # probe's 10 tables is; "same_table" repeats one table (the bf16 one
    # fits in L2)
    timing = {}
    for table in (packed, packed.to(torch.bfloat16)):
        dt = str(table.dtype).replace("torch.", "")
        copies = itertools.cycle([table] + [table.clone() for _ in range(3)])
        row_b = table.shape[1] * table.element_size()
        t_bytes = (rows.numel() * 4 + torch.unique(rows).numel() * row_b
                   + rows.numel() * row_b) / HBM_BYTES_PER_S * 1e3
        timing[dt] = {
            **{f"ms_depth{d}": graph_ms(lambda d=d: row_gather(next(copies), rows, d)) for d in DEPTHS},
            "ms_depth4_same_table": graph_ms(lambda: row_gather(table, rows, 4)),
            "plain_ms": graph_ms(lambda: row_gather_reference(next(copies), rows)),
            # one library call, the gather alone (no out-of-range handling)
            "library_ms": graph_ms(lambda: torch.index_select(next(copies), 0, rows)),
            "bound_ms": t_bytes, "bound_by": "bytes",
        }
        log(f"[kernels] row_gather timing at K={rows.numel()} into {list(table.shape)} {dt}: "
            f"{json.dumps(timing[dt])}")
        del copies
    del packed, narrow
    torch.cuda.empty_cache()
    f32 = timing["float32"]
    return {"max_abs_err": max(c["max_abs_err"] for c in cases), "ms": f32["ms_depth4"],
            **{k: f32[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by")}}


def phase_bf16_split() -> dict:
    """The Dense backward's cotangent split (csrc/bf16_split.cu) at each of
    kaggle's cotangents [65536, N]: bit for bit against its plain version,
    hi + mid + lo equal to g, then the kernel and the plain version timed
    (20 calls in one CUDA graph) beside the bound (4 bytes read and 6
    written an element, the padding's zeros too); their sums over a step's
    7 layers. Returns the largest shape's row with the step's sums beside it."""
    from dlrm_flexflow_tpu_torch.ops.kernels.bf16_split import split_bf16x3, split_bf16x3_reference
    from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import padded_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    rows, err = {}, 0.0
    for n in sorted(set(KAGGLE_DENSE_NS), reverse=True):
        g = torch.randn((TRAIN_BATCH, n), generator=gen, device="cuda")
        np_ = padded_k(n)
        got, want = split_bf16x3(g, np_), split_bf16x3_reference(g, np_)
        parts = got.float().view(TRAIN_BATCH, 3, np_)[:, :, :n]
        exact = torch.equal((parts[:, 0] + parts[:, 1]) + parts[:, 2], g)
        err = max(err, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)) or not exact:
            raise AssertionError(f"bf16_split at [{TRAIN_BATCH}, {n}]: kernel differs from its plain version "
                                 f"or the parts do not sum to g ({exact})")
        rows[n] = {"ms": graph_ms(lambda: split_bf16x3(g, np_)),
                   "plain_ms": graph_ms(lambda: split_bf16x3_reference(g, np_)),
                   "bound_ms": TRAIN_BATCH * (4 * n + 6 * np_) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        del g, got, want, parts
    step = {key: sum(rows[n][key] for n in KAGGLE_DENSE_NS) for key in ("ms", "plain_ms", "bound_ms")}
    res = {"shapes": {f"{TRAIN_BATCH}x{n}": r for n, r in rows.items()},
           "step": step, "max_abs_err": err, "bit_identical_to_plain": True}
    log(f"[kernels] bf16_split: {json.dumps(res)}")
    torch.cuda.empty_cache()
    return {**rows[max(KAGGLE_DENSE_NS)], "max_abs_err": err, "step": step}


def phase_gather_probe() -> int:
    """The forward-gather probe's port at its defaults with a few steps:
    every variant's launches (K7: 10 a step in each of its 8 variants, K4:
    10 a step in E, none elsewhere) and its sums. Returns K7's launches."""
    from dlrm_flexflow_tpu_torch.tools import bench_gather_probe as probe

    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    out = probe.run(steps=PROBE_STEPS, log=lambda m: log(f"[gather-probe] {m}" if m.strip() else m))
    launches = {name: fn.launches for name, fn in counts.items()}
    res = out["results"]
    for key, r in res.items():
        kernel = key.startswith("k7_") or key.startswith("k4_")
        if r["launches"] != (PROBE_TABLES * r["steps_issued"] if kernel else 0):
            raise AssertionError(f"gather-probe variant {key} launched {r['launches']} for "
                                 f"{r['steps_issued']} steps")
    k7 = [k for k in res if k.startswith("k7_")]
    issued = {k: res[k]["steps_issued"] for k in res}
    want = {**{name: 0 for name in counts},
            "row_gather": sum(PROBE_TABLES * issued[k] for k in k7),
            "embedding_bag": PROBE_TABLES * issued["k4_h1_f32"]}
    if launches != want or len(k7) != 8:
        raise AssertionError(f"the gather probe launched {launches}, not {want}")
    for dt, same in (("f32", ["packed_f32", "k4_h1_f32"] + [k for k in k7 if k.endswith("_f32")]),
                     ("bf16", ["packed_bf16"] + [k for k in k7 if k.endswith("_bf16")])):
        sums = {k: res[k]["sum"] for k in same}
        if len(set(sums.values())) != 1 or not all(math.isfinite(v) for v in sums.values()):
            raise AssertionError(f"gather-probe {dt} variants disagree: {sums}")
    summary = {k: {"us_per_step": r["us_per_step"], "device_us_per_step": r.get("device_us_per_step"),
                   "ns_per_row": r["ns_per_row"], "launches": r["launches"]} for k, r in res.items()}
    log(f"[gather-probe] {json.dumps({'shapes': out['shapes'], 'launches': launches, 'results': summary})}")
    return launches["row_gather"]


def phase_train_host(train_ms: float) -> None:
    """Phase 8's kaggle model compiled with host_routing=True. Runs of 20
    timed steps, each after 3 warm-up steps, on the one model: with the
    routes precomputed and staged with the batches as the bench does, and
    with host routing off (sorted on the card), in turn (off, on, on, off,
    twice);
    then with the routes computed inside train_batch, from the numpy
    batches and from batches on the card (a readback). Each host-routed run
    must launch the row update 10 times a step and sort nothing on the
    card."""
    import os

    from dlrm_flexflow_tpu_torch.data import native_batcher
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import sort_rows

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    t0 = time.perf_counter()
    model = kaggle_model(cfg, TRAIN_BATCH, SEED, host_routing=True)
    torch.cuda.synchronize()
    check_route(model, cfg)
    batches, staged = kaggle_batches(model, cfg)
    route_ops = [op for op in model._sparse_ops if op.kernel_route]
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_batcher.get_lib()  # on a fresh checkout, g++ builds native/ffdata here: set-up
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes = [model.compute_routes(f) for f, _ in batches]
    compute_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    keys = np.stack([np.asarray(batches[0][0][op.inputs[0].owner_op.name], np.int64).reshape(-1)
                     for op in route_ops])
    t0 = time.perf_counter()
    for _ in range(4):
        native_batcher.argsort_i64_batch(keys)
    sort_ms = (time.perf_counter() - t0) / 4 * 1e3
    t0 = time.perf_counter()
    routed = [({**f, **model.stage_routes(r)}, lbl) for (f, lbl), r in zip(staged, routes)]
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    setup = {"batch": TRAIN_BATCH, "route_tables": len(route_ops), "set_up_s": setup_s,
             "ffdata_build_or_load_s": lib_s, "compute_routes_ms_per_batch": compute_ms, "native_sort_ms_per_batch": sort_ms,
             "stage_routes_ms_per_batch": stage_ms, "cpu_count": os.cpu_count(),
             "cpus_usable": len(os.sched_getaffinity(0))}
    log(f"[train-host] kaggle, host_routing=True: {json.dumps(setup)}")
    counts = launch_counts()
    runs = {}
    abba = [("device-sorted", staged, False), ("routes-precomputed", routed, True),
            ("routes-precomputed", routed, True), ("device-sorted", staged, False)]
    for variant, feeds, host_routing in abba + abba + [
        ("routes-inside-numpy", batches, True), ("routes-inside-staged", staged, True),
    ]:
        model.config.host_routing = host_routing
        losses = [float(model.train_batch(*feeds[i % 4])) for i in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        for fn in counts.values():
            fn.launches = 0
        sort_rows.calls = 0
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            loss = model.train_batch(*feeds[i % 4])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counts.items()}
        losses.append(float(loss))
        res = {"variant": variant, "steps": TRAIN_STEPS, "ms_per_step": dt / TRAIN_STEPS * 1e3,
               "examples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt, "launches": launches,
               "sort_rows_calls": sort_rows.calls, "first_loss": losses[0], "last_loss": losses[-1]}
        log(f"[train-host] {json.dumps(res)}")
        runs.setdefault(variant, []).append(res["ms_per_step"])
        want = {**{name: 0 for name in counts}, "row_update": TRAIN_STEPS * KAGGLE_BIG_TABLES}
        want_sorts = 0 if host_routing else TRAIN_STEPS
        if launches != want or sort_rows.calls != want_sorts:
            raise AssertionError(f"the {variant} train path launched {launches} and sorted "
                                 f"{sort_rows.calls} times on the card")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{variant} train losses not finite: {losses}")
    log(f"[train-host] ms a step by variant (train: {train_ms}): {json.dumps(runs)}")
    model.config.host_routing = True
    feeds, labels = routed[0]
    step_routes = {op.name: (feeds[f"_route:{op.name}:rows"], feeds[f"_route:{op.name}:order"])
                   for op in route_ops}
    log(f"[train-host] device ms by phase, one step of {TRAIN_BATCH} with staged routes: "
        f"{json.dumps(train_breakdown(model, feeds, labels, step_routes))}")
    log(f"[train-host] device ms by phase, one step of {TRAIN_BATCH} sorted on the card: "
        f"{json.dumps(train_breakdown(model, *staged[0]))}")
    del model, staged, routed
    torch.cuda.empty_cache()


def phase_train_parity_host() -> None:
    """Kaggle widths with vocabs capped at 20000, 5 SGD steps on CUDA:
    host-routed against device-sorted, which must be bit-identical (both
    kernels read the same order; torch's deterministic algorithms keep the
    one-hot lookups' index_add_ in one order), and host-routed against the
    CPU within E2E_ATOL."""
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update, sort_rows

    bs, steps = 256, 5
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        host = kaggle_model(cfg, bs, SEED + 10, packed_tables="on", host_routing=True)
        dev = kaggle_model(cfg, bs, SEED + 10, packed_tables="on")
        cpu = kaggle_model(cfg, bs, SEED + 10, device="cpu", packed_tables="on", host_routing=True)
        cpu.set_parameters({name: host.get_weights(name) for name in host.get_parameters()})
        feeds, labels = random_batches(cfg, steps * bs, seed=SEED + 10)
        feeds["sparse_20"][:9] = -1  # padding, dropped from the update stream
        losses = {"host": [], "device": [], "cpu": []}
        launches, sorts = {"host": 0, "device": 0}, {"host": 0, "device": 0}
        for i in range(steps):
            sl = slice(i * bs, (i + 1) * bs)
            batch = {k: v[sl] for k, v in feeds.items()}
            for name, model in (("host", host), ("device", dev)):
                l0, s0 = row_update.launches, sort_rows.calls
                losses[name].append(float(model.train_batch(batch, labels[sl])))
                launches[name] += row_update.launches - l0
                sorts[name] += sort_rows.calls - s0
            losses["cpu"].append(float(cpu.train_batch(batch, labels[sl])))
    finally:
        torch.use_deterministic_algorithms(False)
    names = list(host.get_parameters())
    same_w = all(np.array_equal(w, dev.get_weights(n)[k]) for n in names
                 for k, w in host.get_weights(n).items())
    cpu_err = float(max(np.abs(w - cpu.get_weights(n)[k]).max() for n in names
                        for k, w in host.get_weights(n).items()))
    res = {"steps": steps, "batch": bs, "launches": launches, "sort_rows_calls": sorts,
           "losses_bit_identical": losses["host"] == losses["device"], "weights_bit_identical": same_w,
           "max_loss_err_vs_cpu": max(abs(a - b) for a, b in zip(losses["host"], losses["cpu"])),
           "max_weight_err_vs_cpu": cpu_err, "atol": E2E_ATOL}
    log(f"[train-parity-host] host-routed vs device-sorted on CUDA, and vs the CPU: {json.dumps(res)}")
    if launches != {"host": steps * KAGGLE_BIG_TABLES, "device": steps * KAGGLE_BIG_TABLES} \
            or sorts != {"host": 0, "device": steps}:
        raise AssertionError(f"train-parity-host launched {launches} and sorted {sorts}")
    if not (res["losses_bit_identical"] and same_w):
        raise AssertionError(f"host-routed and device-sorted training differ: {res}")
    if res["max_loss_err_vs_cpu"] > E2E_ATOL or cpu_err > E2E_ATOL or not all(np.isfinite(losses["host"])):
        raise AssertionError(f"host-routed CUDA and CPU training disagree: {res}")


# ------------------------------------------------------------------ slice 8: the multi-step call, serving, state


def chunk_stacks(staged) -> tuple:
    """The staged batches (and routes) as [4, B, ...] stacks on the card."""
    feeds = {k: torch.stack([f[k] for f, _ in staged]) for k in staged[0][0]}
    return feeds, torch.stack([lbl for _, lbl in staged])


def chunk_profile(model, stack, labels, ms_per_step: float) -> dict:
    """Kernel time a step of graph replays (torch.profiler over one chunk of
    4), against the unprofiled step time: the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(model.train_chunk(stack, labels))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]  # not the spans mirrored on the card
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / int(labels.shape[0])
    if busy == 0.0:
        return {"kernel_ms_per_step": "not measured (the profiler saw no device time in the replays)"}
    return {"kernel_ms_per_step": busy, "busy_share_of_unprofiled_step": busy / ms_per_step}


def graph_launches(model, replays: int) -> dict:
    """The kernels one captured train step holds (tools/graph_nodes.py) and
    the row-update wrapper launches `replays` replays make: the row-update
    kernel nodes over the kernels a wrapper launch runs (2; AdaGrad 4). The
    step's phase stamps are counted apart ("phase_stamp", 8)."""
    from dlrm_flexflow_tpu_torch import RowWiseAdagradOptimizer
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import node_counts, stamps_apart

    nodes = stamps_apart(node_counts(model._step_graph.graph, kernel_names=True))
    row = sum(n for name, n in nodes["kernels"].items() if "row_update" in name)
    per_launch = 4 if type(model.sparse_optimizer) is RowWiseAdagradOptimizer else 2
    split = sum(n for name, n in nodes["kernels"].items() if "split_bf16x3" in name)
    return {"nodes": {k: v for k, v in nodes.items() if k != "kernels"},
            "distinct_kernels": len(nodes["kernels"]), "row_update_kernel_nodes": row,
            "row_update_launches": row // per_launch * replays, "split_kernel_nodes": split}


def phase_train_chunk(rule: str = "sgd", host_routing: bool = False) -> dict:
    """The kaggle train path at full width as graph replays (FFModel.
    train_chunk, K = 4 over the 4 staged batches) against eager steps, from
    the same weights: 3 warm-up and 20 timed steps each way, the same
    batches in the same order; the row-update launches counted from the
    captured graph's nodes times the replays; then, under deterministic
    algorithms (the one-hot lookups' index_add_ sums with float atomics,
    in another order each run, eager or not), 20 eager steps against 5
    chunks on fresh models, which must leave every tensor of the state and
    every loss bit for bit the same."""
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors

    tag = f"[train-chunk{'-host' if host_routing else ''}] {rule}"
    cfg = kaggle_config(batch_size=TRAIN_BATCH)

    def pair():
        models = [kaggle_model(cfg, TRAIN_BATCH, SEED, rule=rule, host_routing=host_routing) for _ in range(2)]
        check_route(models[0], cfg)
        batches, staged = kaggle_batches(models[0], cfg)
        if host_routing:
            staged = [({**f, **models[0].stage_routes(models[0].compute_routes(b))}, lbl)
                      for (b, _), (f, lbl) in zip(batches, staged)]
        return models, staged

    (eager, chunk), staged = pair()
    stack, labels = chunk_stacks(staged)
    counts = launch_counts()
    for i in range(TRAIN_WARMUP):
        eager.train_batch(*staged[i % 4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss_e = eager.train_batch(*staged[i % 4])
    float(loss_e)
    eager_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    chunk.train_chunk({k: v[:TRAIN_WARMUP] for k, v in stack.items()}, labels[:TRAIN_WARMUP])  # captures
    torch.cuda.synchronize()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS // 4):
        loss_g = chunk.train_chunk(stack, labels)
    float(loss_g)
    graph_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    python_launches = {name: fn.launches for name, fn in counts.items() if fn.launches}
    nodes = graph_launches(chunk, TRAIN_STEPS)
    # the same 23 steps on each: default (atomic) index_add_ in both
    default_diff = state_diff(eager, chunk)
    res = {"rule": rule, "host_routing": host_routing, "steps": TRAIN_STEPS,
           "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
           "eager_examples_per_s": TRAIN_BATCH / eager_ms * 1e3,
           "graph_examples_per_s": TRAIN_BATCH / graph_ms * 1e3,
           "graph": nodes, "python_counted_launches_in_replays": python_launches,
           "eager_loss": float(loss_e), "graph_loss": float(loss_g),
           "default_mode_differing_tensors": len(default_diff),
           "default_mode_max_abs_diff": max(default_diff.values(), default=0.0),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{tag} {json.dumps(res)}")
    log(f"{tag} eager device kernels: {json.dumps(train_profile(eager, staged, eager_ms))}")
    log(f"{tag} graph device kernels: {json.dumps(chunk_profile(chunk, stack, labels, graph_ms))}")
    want_row = TRAIN_STEPS * KAGGLE_BIG_TABLES
    if nodes["split_kernel_nodes"] != len(KAGGLE_DENSE_NS):
        raise AssertionError(f"{tag}: the graph held {nodes['split_kernel_nodes']} cotangent-split nodes, "
                             f"not {len(KAGGLE_DENSE_NS)}")
    if nodes["row_update_launches"] != want_row or python_launches:
        raise AssertionError(f"{tag}: the graph held {nodes} row-update kernel nodes, "
                             f"{nodes['row_update_launches']} launches in {TRAIN_STEPS} replays, not "
                             f"{want_row}; Python-counted launches during replays {python_launches}")
    if not (math.isfinite(res["eager_loss"]) and math.isfinite(res["graph_loss"])):
        raise AssertionError(f"{tag}: losses not finite: {res}")
    del eager, chunk, staged, stack, labels
    torch.cuda.empty_cache()

    (eager, chunk), staged = pair()
    stack, labels = chunk_stacks(staged)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_e = [eager.train_batch(*staged[i % 4]) for i in range(TRAIN_STEPS)]
        losses_g = [chunk.train_chunk(stack, labels) for _ in range(TRAIN_STEPS // 4)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = state_diff(eager, chunk)
    same_losses = all(torch.equal(a, b) for a, b in zip(losses_e[3::4], losses_g))
    bits = {"deterministic_steps": TRAIN_STEPS, "chunks": TRAIN_STEPS // 4,
            "tensors": len(state_tensors(eager)), "differing_tensors": len(diff),
            "max_abs_diff": max(diff.values(), default=0.0), "losses_bit_identical": same_losses,
            "step_counts": [eager._step_count, chunk._step_count]}
    log(f"{tag} replays vs eager steps, deterministic: {json.dumps(bits)}")
    if diff or not same_losses or eager._step_count != chunk._step_count:
        raise AssertionError(f"{tag}: graph replays and eager steps differ: {bits} {diff}")
    del eager, chunk, staged, stack, labels
    torch.cuda.empty_cache()
    return res


def phase_fit_chunk() -> dict:
    """One epoch of FFModel.fit(steps_per_call=4) on the full-width kaggle
    model (4 batches of 65536 from numpy: one chunk, staged by one pinned
    copy)."""
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    model = kaggle_model(cfg, TRAIN_BATCH, SEED)
    feeds, labels = random_batches(cfg, 4 * TRAIN_BATCH, seed=SEED)
    hist = model.fit(feeds, labels, epochs=1, batch_size=TRAIN_BATCH, verbose=False, steps_per_call=4)
    log(f"[fit-chunk] kaggle, 1 epoch of 4 steps, steps_per_call=4: {json.dumps(hist)}")
    if not all(math.isfinite(v) for v in hist.values()) or hist["samples"] != 4 * TRAIN_BATCH \
            or model._step_graph is None:
        raise AssertionError(f"fit(steps_per_call=4) gave {hist}")
    del model
    torch.cuda.empty_cache()
    return hist


# the JAX package's own bounds against the f32 model: bf16 tables
# (tests/test_training.py:245), int8 rows (:279); f16 keeps 3 more mantissa
# bits than bf16, so its bound is bf16's over 8. Under "on" every layer also
# rounds its output to bf16 (E2E_ON_ATOL more).
SERVE_QUANT_ATOL = {"bfloat16": 0.05, "float16": 0.05 / 8, "int8": 0.08}


def table_bytes(model) -> int:
    from dlrm_flexflow_tpu_torch import OperatorType

    return sum(t.numel() * t.element_size() for op in model.graph.compute_ops
               if op.op_type is OperatorType.OP_EMBEDDING for t in model.get_parameters()[op.name].values())


def warm_predict(model, feeds) -> tuple:
    """(outputs, launches of one predict, warm examples/s: the median of 3)."""
    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    out = model.predict(feeds)
    launches = {name: fn.launches for name, fn in counts.items()}
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.predict(feeds)
        warm.append(time.perf_counter() - t0)
    return out, launches, out.shape[0] / float(np.median(warm))


def phase_serve_quant(device_name: str) -> dict:
    """mlperf-lite serving at full width (26 tables, D = 128, 6.7 GB of f32
    tables) at batch 16384 through predict (4 full requests and a ragged
    one): under "auto" in f32, then after quantize_embeddings to bf16, f16
    and int8 (each from the f32 tables again, by set_parameters); then under
    "on" (packed_tables="off") in f32, bf16, f16 and int8, launches counted.
    Each quantized model is held against the f32 model of its route."""
    from dlrm_flexflow_tpu_torch import FFConfig, LossType
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model, mlperf_lite_config

    cfg = mlperf_lite_config(batch_size=BATCH)
    n = 4 * BATCH + 1000
    chunks = -(-n // BATCH)
    feeds, _ = random_batches(cfg, n, seed=SEED + 20)
    out = {}
    f32_tables = None
    for use_pallas in ("auto", "on"):
        model = make_dlrm_model(cfg, FFConfig(batch_size=BATCH, seed=SEED, use_pallas=use_pallas,
                                              packed_tables="off"))
        model.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
        if f32_tables is None:  # the f32 weights, kept on the card for each dtype
            f32_tables = {op: {k: v.clone() for k, v in sub.items()} for op, sub in model.get_parameters().items()}
        y32, launches, eps = warm_predict(model, feeds)
        rows = {"float32": {"table_bytes": table_bytes(model), "memory_allocated": torch.cuda.memory_allocated(),
                            "launches": launches, "warm_examples_per_s": eps}}
        for dtype in ("bfloat16", "float16", "int8"):
            model.set_parameters(f32_tables)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            touched = model.quantize_embeddings(dtype)
            torch.cuda.empty_cache()
            y, launches, eps = warm_predict(model, feeds)
            atol = SERVE_QUANT_ATOL[dtype] + (E2E_ON_ATOL if use_pallas == "on" else 0.0)
            err = float(np.abs(y - y32).max())
            rows[dtype] = {"arrays": touched, "table_bytes": table_bytes(model),
                           "memory_allocated": torch.cuda.memory_allocated(), "launches": launches,
                           "warm_examples_per_s": eps, "max_abs_err_vs_f32": err, "atol": atol}
            if use_pallas == "on":
                want = forced_launches(chunks)
                if dtype == "int8":  # the quantized lookup, as the reference's _forward_device
                    want = {**want, "embedding_bag": 0, "onehot_embedding": 0}
            else:
                want = {**{name: 0 for name in launches}, "dot_interaction": chunks}
            if launches != want or y.shape != (n, 1) or not np.isfinite(y).all() or err > atol \
                    or touched != cfg.num_tables:
                raise AssertionError(f"[serve-quant] {use_pallas} {dtype}: {rows[dtype]}, launches not {want}?")
        log(f"[serve-quant] mlperf-lite under {use_pallas!r} at batch {BATCH}, {n} examples, {device_name}: "
            f"{json.dumps(rows)}")
        if use_pallas == "on":
            log("[serve-quant] int8 under 'on': 0 embedding_bag and 0 onehot_embedding launches, as in the "
                "reference, whose Embedding takes quantized_embedding_bag before any Pallas route")
        out[use_pallas] = rows
        del model
        torch.cuda.empty_cache()
    del f32_tables
    torch.cuda.empty_cache()
    return out


def phase_checkpoint() -> dict:
    """kaggle widths with vocabs capped at 20000 under Adam (dense and
    lazy sparse, the route tables in bf16): 3 steps, save_checkpoint,
    restore into a freshly compiled model, 2 more steps, against 5
    uninterrupted steps, bit for bit (deterministic algorithms, as in
    train-parity-host)."""
    import tempfile

    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors
    from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint

    bs, steps = 256, 5
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    feeds, labels = random_batches(cfg, steps * bs, seed=SEED + 21)
    batches = [({k: v[i * bs:(i + 1) * bs] for k, v in feeds.items()}, labels[i * bs:(i + 1) * bs])
               for i in range(steps)]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        whole = kaggle_model(cfg, bs, SEED + 21, rule="adam", packed_tables="on")
        want = [float(whole.train_batch(*b)) for b in batches]
        first = kaggle_model(cfg, bs, SEED + 21, rule="adam", packed_tables="on")
        got = [float(first.train_batch(*b)) for b in batches[:3]]
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            save_checkpoint(tmp, first)
            resumed = kaggle_model(cfg, bs, SEED + 21, rule="adam", packed_tables="on")
            manifest = restore_checkpoint(tmp, resumed)
        got += [float(resumed.train_batch(*b)) for b in batches[3:]]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = state_diff(whole, resumed)
    res = {"steps": steps, "saved_at": manifest["step"], "losses_bit_identical": got == want,
           "differing_tensors": len(diff), "tensors": len(state_tensors(whole)),
           "route_tables": sum(op.kernel_route for op in resumed._sparse_ops),
           "step_counts": [whole._step_count, resumed._step_count]}
    log(f"[checkpoint] kaggle capped, Adam, 3 steps + save + restore + 2 against 5: {json.dumps(res)}")
    if diff or got != want or manifest["step"] != 3 or resumed._step_count != steps:
        raise AssertionError(f"[checkpoint] the resumed model differs: {res} {diff}")
    return res


def phase_bench() -> dict:
    """The port's bench as a user runs it, in a subprocess with a time
    limit: kaggle training (its default: batch 65536, host-routed), the same
    on Zipf(1.05) indices (frequency-skewed ids, as Criteo's are), with
    Adam and with the mid-band tables, mlperf-full training under host-tail
    offload, and mlperf-lite serving, --quick. Each must print bench.py's keys with
    finite numbers; kaggle must take the row-update route."""
    out = {}
    for name, extra in (("kaggle-train", []), ("kaggle-train-zipf", ["--zipf", "1.05"]),
                        ("kaggle-train-adam", ["--optimizer", "adam"]),
                        ("kaggle-train-midband", ["--onehot-packed-threshold", "1048576"]),
                        ("mlperf-full-train", ["--config", "mlperf-full"]),
                        ("mlperf-lite-infer", ["--config", "mlperf-lite", "--mode", "infer"]),
                        ("mlperf-lite-infer-int8", ["--config", "mlperf-lite", "--mode", "infer",
                                                    "--table-dtype", "int8"])):
        cmd = [sys.executable, "-m", "dlrm_flexflow_tpu_torch.bench", "--quick", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"bench {name} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr[-4000:]}")
        notes = [line for line in proc.stderr.splitlines() if line.startswith("#")]
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"[bench] {name}: {' '.join(cmd[1:])} ({wall:.3f} s wall)")
        for line in notes:
            log(f"[bench] {line}")
        log(f"[bench] {json.dumps(res)}")
        keys = {"metric", "value", "unit", "examples_per_sec_per_chip", "devices", "table_dtype",
                "packed_engaged", "loss"}
        if name == "mlperf-full-train":  # bench.py's host-tail keys
            keys |= {"host_tail_tables", "host_tail_touched_rows", "host_tail_drop_fraction"}
            if res.get("host_tail_tables") != 6 or not res.get("host_tail_touched_rows"):
                raise AssertionError(f"bench {name} printed {res}")
        if set(res) != keys or not (math.isfinite(res["value"]) and res["value"] > 0
                                    and math.isfinite(res["loss"])):
            raise AssertionError(f"bench {name} printed {res}")
        if "-train" in name and not (res["packed_engaged"] and res["table_dtype"] == "bfloat16"):
            raise AssertionError(f"bench {name} did not take the bf16 row-update route: {res}")
        # a host-tail step cannot be one graph: the host works between steps
        timed = "steps=graph" if name.startswith("kaggle-train") else "steps=eager"
        if not any(timed in line for line in notes) or (name.endswith("int8") and not any(
                "# quantized 26 embedding arrays to int8" in line for line in notes)):
            raise AssertionError(f"bench {name} did not say {timed!r} (or what it quantized): {notes}")
        out[name] = res
    return out


# ------------------------------------------------------------------ slice 9: host tail, mid-band, scatter replays

HOST_TAIL_HOT = 1 << 20  # mlperf-full's hot prefix on the card (the JAX bench's)
MIDBAND_THRESHOLD = 1 << 20  # train-midband's onehot_packed_threshold
# train-midband's CUDA-vs-CPU bounds, those of the card test
# test_midband_replays_eager_steps_and_matches_the_cpu: the same f32 sums
# in another order, over 5 steps
MIDBAND_LOSS_RTOL, MIDBAND_LOSS_ATOL, MIDBAND_WEIGHT_ATOL = 1e-5, 1e-6, 1e-5
FULL_WARMUP, FULL_STEPS, FULL_PROFILED = 3, 10, 3
MLPERF_FULL_ROWS = 882_774_559


def host_rss_gb() -> dict:
    """The process's resident host memory now and at its peak (GB)."""
    import resource

    rss = next((int(line.split()[1]) * 1024 / 1e9 for line in Path("/proc/self/status").read_text().splitlines()
                if line.startswith("VmRSS:")), None)
    return {"host_rss_gb": rss, "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}


def full_kernel_checks(model, feeds, rule: str) -> dict:
    """The kernels train-full launches, against their plain versions at the
    shapes the path gives them: the rule's row-update mode (`check_row_update`
    for SGD, `check_rule` for row-wise AdaGrad) on the hot prefix of the
    largest host-tail table ([2^20, 128] bf16, its weights as initialized)
    with the stream this batch's Zipf(1.05) ids make, those at or above the
    hot prefix masked as the model masks them (`Embedding.hot_indices`,
    then `bag_row_src`: padding becomes row V, dropped), and the
    interaction on a [65536, 27, 128] bf16 input."""
    from dlrm_flexflow_tpu_torch.ops.embedding import bag_row_src

    op = max((o for o in model._sparse_ops if o.host_tail_vocab), key=lambda o: o.host_tail_vocab)
    idx = torch.as_tensor(feeds[op.inputs[0].owner_op.name], dtype=op.inputs[0].dtype.to_torch()).cuda()
    table = model.get_parameters()[op.name]["weight"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    src = torch.randn((idx.shape[0], table.shape[1]), generator=gen, device="cuda") * 1e-2
    rows, _, _ = bag_row_src(op.hot_indices(idx), src, op.aggr, op.num_entries)
    name = f"full-{op.name}-v{op.host_tail_vocab}-hot{op.num_entries}"
    if rule == "sgd":
        rows_res = check_row_update(name, table, rows, src, torch.bfloat16, timed=False)
    else:
        rows_res = check_rule(f"adagrad:{name}", table, rows, src, timed=False, gen=gen)
    inter = next(o for o in model.graph.compute_ops if hasattr(o, "self_interaction"))
    x = torch.randn((TRAIN_BATCH, len(inter.inputs), inter.inputs[0].shape[1]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k3 = check_dot_interaction(x, inter.self_interaction)
    del x, src, rows
    torch.cuda.empty_cache()
    return {"row_update": rows_res, "dot_interaction": k3}


def phase_train_full(rule: str) -> dict:
    """mlperf-full (the unclipped Criteo Terabyte vocabs, 882,774,559 rows,
    D = 128) under host-tail offload at hot = 2^20: the 6 tables above it
    keep 2^20 rows on the card and their tail rows on the host; Zipf(1.05)
    ids, batch 65536, bf16 compute and route tables; SGD (lr 0.01), the
    tables' rows under SGD (`rule` "sgd") or row-wise AdaGrad at lr 0.01
    ("adagrad", a sparse optimizer: the hot rows on the card's row-update
    kernel and the tail rows in the store follow it): 3 warm-up and 10 timed train_batch
    steps (eager: the host works between steps), the row-update and
    interaction launches counted, then the time by phase, kernel time and
    busy share, touched tail rows, drop fraction, peak device memory and
    host RSS. Before the steps, the rule's row-update mode and the
    interaction are held against their plain versions at the shapes this
    path gives them (`full_kernel_checks`)."""
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, RowWiseAdagradOptimizer, SGDOptimizer
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model, mlperf_config

    tag = f"[train-full] {rule}"
    cfg = mlperf_config(batch_size=TRAIN_BATCH)
    if sum(cfg.embedding_size) != MLPERF_FULL_ROWS:
        raise AssertionError(f"mlperf-full holds {sum(cfg.embedding_size)} rows")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = make_dlrm_model(cfg, FFConfig(
        batch_size=TRAIN_BATCH, seed=SEED, compute_dtype="bfloat16", table_dtype="bfloat16",
        host_tail_threshold=HOST_TAIL_HOT, host_tail_cap_frac=0.25))
    model.compile(SGDOptimizer(lr=0.01), LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                  sparse_optimizer=None if rule == "sgd" else RowWiseAdagradOptimizer(lr=ADAGRAD_LR))
    torch.cuda.synchronize()
    ht = model._host_tail
    route = [op for op in model._sparse_ops if op.kernel_route]
    device_rows = sum(p["weight"].shape[0] for op, p in model.get_parameters().items() if op.startswith("table_"))
    feeds, labels = random_batches(cfg, 4 * TRAIN_BATCH, seed=SEED, learnable=False, zipf=1.05)
    batches = [({k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for k, v in feeds.items()},
                labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]) for i in range(4)]
    setup = {"tables": cfg.num_tables, "rows": sum(cfg.embedding_size), "device_rows": device_rows,
             "host_tail_tables": len(ht.entries), "k_cap": sorted({e[4] for e in ht.entries.values()}),
             "route_tables": len(route), "route_dtype": str(model.get_parameters()[route[0].name]["weight"].dtype),
             "rule": ht.rule, "set_up_s": time.perf_counter() - t0}
    log(f"{tag} mlperf-full: {json.dumps(setup)}")
    if len(ht.entries) != 6 or device_rows != 7_408_088 or len(route) != 13:
        raise AssertionError(f"{tag}: not the expected split: {setup}")
    checks = full_kernel_checks(model, batches[0][0], rule)
    losses = [float(model.train_batch(*batches[i % 4])) for i in range(FULL_WARMUP)]
    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(FULL_STEPS):
        loss = model.train_batch(*batches[i % 4])
    losses.append(float(loss))
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    wrapper = "row_update" if rule == "sgd" else "row_update_adagrad"
    want = {**{name: 0 for name in counts}, wrapper: FULL_STEPS * len(route), "dot_interaction": FULL_STEPS}
    ms = dt / FULL_STEPS * 1e3
    res = {"steps": FULL_STEPS, "ms_per_step": ms, "examples_per_s": TRAIN_BATCH / ms * 1e3, "launches": launches,
           "losses": losses, "touched_tail_rows": sum(e[0].touched_rows for e in ht.entries.values()),
           "tail_lookups": ht.total, "dropped": ht.dropped, "drop_fraction": model.host_tail_drop_fraction(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **host_rss_gb()}
    log(f"{tag} {json.dumps(res)}")
    if launches != want:
        raise AssertionError(f"{tag}: the path launched {launches}, not {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: losses not finite: {losses}")
    prof = train_profile(model, batches, ms, steps=FULL_PROFILED, route_tables=len(route))
    log(f"{tag} ms by phase, a step over {FULL_PROFILED} profiled steps (host clock; the span of "
        f"the device work each phase launched): {json.dumps(prof.pop('phases', None))}")
    log(f"{tag} device kernels over {FULL_PROFILED} profiled steps: {json.dumps(prof)}")
    del model, batches, feeds
    torch.cuda.empty_cache()
    return {**res, "profile": prof, "kernel_checks": checks}


def capped_kaggle(cap: int, bag: int = 1):
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    cfg = kaggle_config(batch_size=256)
    cfg.embedding_size = [min(v, cap) for v in cfg.embedding_size]
    cfg.embedding_bag_size = bag
    return cfg


def phase_host_tail_parity() -> dict:
    """A small host-tail model (kaggle widths, vocabs capped at 5000, bags
    of 2, hot prefix 1000: 15 tables offloaded; no one-hot tables) against the same model with
    its whole tables on the card, from the same effective tables and
    towers, and against the CPU port, 4 steps each under SGD and under SGD
    with row-wise AdaGrad on the tables (the usual DLRM split: dense
    AdaGrad's first step, about lr on every weight, saturates this model's
    loss within one step), f32 compute. Host tail vs the whole table: the same sums but
    for the host's duplicate rows, summed before their add (rtol 1e-5, atol
    1e-6 on the loss; AdaGrad's rsqrt in numpy against torch's: rtol 1e-4,
    atol 1e-5), the JAX package's bounds (tests/test_host_tail.py); CUDA vs
    CPU the same bounds."""
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, RowWiseAdagradOptimizer, SGDOptimizer
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model

    cfg, bs, hot, steps = capped_kaggle(5000, bag=2), 256, 1000, 4
    n_tail = sum(v > hot for v in cfg.embedding_size)
    out = {}
    for rule in ("sgd", "adagrad"):
        def make(device, thr):
            m = make_dlrm_model(cfg, FFConfig(batch_size=bs, seed=SEED + 30, compute_dtype="float32",
                                              onehot_embedding_threshold=0, host_tail_threshold=thr,
                                              host_tail_cap_frac=1.0), device=device)
            m.compile(SGDOptimizer(lr=0.05), LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                      sparse_optimizer=None if rule == "sgd" else RowWiseAdagradOptimizer(lr=0.05))
            return m

        full, tail, cpu = make("cuda", 0), make("cuda", hot), make("cpu", hot)
        for op, sub in full.get_parameters().items():
            w = full.get_weights(op)
            for m in (tail, cpu):
                if op in m._host_tail.entries:
                    m.set_weights(op, {"weight": w["weight"][:hot]})
                    m._host_tail.entries[op][0].load_state(np.arange(hot, w["weight"].shape[0]), w["weight"][hot:])
                else:
                    m.set_weights(op, w)
        feeds, labels = random_batches(cfg, steps * bs, seed=SEED + 30, zipf=1.05)
        losses = {"full": [], "tail": [], "cpu": []}
        for i in range(steps):
            b = ({k: v[i * bs:(i + 1) * bs] for k, v in feeds.items()}, labels[i * bs:(i + 1) * bs])
            for name, m in (("full", full), ("tail", tail), ("cpu", cpu)):
                losses[name].append(float(m.train_batch(*b)))
        rtol, atol = (1e-5, 1e-6) if rule == "sgd" else (1e-4, 1e-5)
        tail_err = max(abs(a - b) - rtol * abs(b) for a, b in zip(losses["tail"], losses["full"]))
        cpu_err = max(abs(a - b) - rtol * abs(b) for a, b in zip(losses["tail"], losses["cpu"]))
        row_err = 0.0
        for op, (store, *_) in tail._host_tail.entries.items():
            rows, vals, _ = store.state()
            row_err = max(row_err, float(np.abs(vals - full.get_weights(op)["weight"][rows]).max()))
            c_rows, c_vals, _ = cpu._host_tail.entries[op][0].state()
            if not np.array_equal(rows, c_rows):
                raise AssertionError(f"[host-tail-parity] {rule}: CUDA and CPU touched other tail rows")
            row_err = max(row_err, float(np.abs(vals - c_vals).max()))
        res = {"rule": rule, "tables_offloaded": len(tail._host_tail.entries), "steps": steps,
               "losses": losses, "loss_err_tail_vs_full_over_rtol": tail_err, "loss_err_cuda_vs_cpu_over_rtol": cpu_err,
               "max_tail_row_err": row_err, "rtol": rtol, "atol": atol, "tail_lookups": tail._host_tail.total,
               "dropped": tail.host_tail_dropped}
        log(f"[host-tail-parity] {json.dumps(res)}")
        if len(tail._host_tail.entries) != n_tail or tail_err > atol or cpu_err > atol or row_err > 10 * atol \
                or tail.host_tail_dropped:
            raise AssertionError(f"[host-tail-parity] {rule}: {res}")
        out[rule] = res
        del full, tail, cpu
    torch.cuda.empty_cache()
    return out


def replays_vs_eager(tag: str, make, cfg) -> dict:
    """Two models from `make()` (the same weights): 3 warm-up and 20 timed
    eager train_batch steps on the 4 staged batches against a warm-up chunk
    (the capture) and 5 chunks of 4 graph replays (train_chunk), ms a step
    both ways; then two fresh models under deterministic algorithms, 20
    eager steps against 5 chunks of 4, which must leave every loss and
    every tensor of the state bit for bit the same."""
    from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors

    eager, chunk = make(), make()
    batches, staged = kaggle_batches(eager, cfg)
    stack, labels = chunk_stacks(staged)
    for i in range(TRAIN_WARMUP):
        eager.train_batch(*staged[i % 4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss_e = eager.train_batch(*staged[i % 4])
    float(loss_e)
    eager_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    chunk.train_chunk({k: v[:TRAIN_WARMUP] for k, v in stack.items()}, labels[:TRAIN_WARMUP])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS // 4):
        loss_g = chunk.train_chunk(stack, labels)
    float(loss_g)
    graph_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    res = {"eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
           "eager_examples_per_s": TRAIN_BATCH / eager_ms * 1e3, "graph_examples_per_s": TRAIN_BATCH / graph_ms * 1e3,
           "eager_loss": float(loss_e), "graph_loss": float(loss_g),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{tag} {json.dumps(res)}")
    if not (math.isfinite(res["eager_loss"]) and math.isfinite(res["graph_loss"])):
        raise AssertionError(f"{tag}: losses not finite: {res}")
    del eager, chunk, staged, stack, labels
    torch.cuda.empty_cache()

    eager, chunk = make(), make()
    _, staged = kaggle_batches(eager, cfg)
    stack, labels = chunk_stacks(staged)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_e = [eager.train_batch(*staged[i % 4]) for i in range(TRAIN_STEPS)]
        losses_g = [chunk.train_chunk(stack, labels) for _ in range(TRAIN_STEPS // 4)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = state_diff(eager, chunk)
    same_losses = all(torch.equal(a, b) for a, b in zip(losses_e[3::4], losses_g))
    bits = {"deterministic_steps": TRAIN_STEPS, "chunks": TRAIN_STEPS // 4, "tensors": len(state_tensors(eager)),
            "differing_tensors": len(diff), "max_abs_diff": max(diff.values(), default=0.0),
            "losses_bit_identical": same_losses, "captured": chunk._step_graph is not None,
            "step_counts": [eager._step_count, chunk._step_count]}
    log(f"{tag} replays vs eager steps, deterministic: {json.dumps(bits)}")
    if diff or not same_losses or eager._step_count != chunk._step_count or chunk._step_graph is None:
        raise AssertionError(f"{tag}: graph replays and eager steps differ: {bits} {diff}")
    del eager, chunk, staged, stack, labels
    torch.cuda.empty_cache()
    return {**res, **bits}


def phase_train_midband() -> dict:
    """kaggle at full width with onehot_packed_threshold 2^20: the tables
    of 12517, 93145, 14992, 286181 and 142572 rows become mid-band (one-hot
    lookup, dense f32 gradients, the dense rule), the other five large ones
    stay on the row-update route in bf16; SGD and Adam, eager steps against
    graph replays. Then CUDA against the CPU at vocabs capped at 20000 (all
    10 large tables mid-band), 5 SGD steps."""
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    want_mid = sorted(v for v in cfg.embedding_size if 8192 < v <= MIDBAND_THRESHOLD)
    want_route = sum(v > MIDBAND_THRESHOLD for v in cfg.embedding_size)
    out = {}
    for rule in ("sgd", "adam"):
        def make():
            m = kaggle_model(cfg, TRAIN_BATCH, SEED, rule=rule, onehot_packed_threshold=MIDBAND_THRESHOLD)
            mid = sorted(op.num_entries for op in m.graph.compute_ops if getattr(op, "onehot_packed", False))
            routed = [op for op in m._sparse_ops if op.kernel_route]
            if mid != want_mid or len(routed) != want_route or any(
                    m.get_parameters()[op.name]["weight"].dtype != torch.bfloat16 for op in routed):
                raise AssertionError(f"[train-midband] mid-band {mid}, route {[op.name for op in routed]}")
            return m

        out[rule] = replays_vs_eager(f"[train-midband] {rule} (mid-band {want_mid})", make, cfg)
    pcfg = capped_kaggle(20_000)
    gpu = kaggle_model(pcfg, 256, SEED + 31, onehot_packed_threshold=MIDBAND_THRESHOLD)
    cpu = kaggle_model(pcfg, 256, SEED + 31, device="cpu", onehot_packed_threshold=MIDBAND_THRESHOLD)
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, labels = random_batches(pcfg, 5 * 256, seed=SEED + 31)
    errs = []
    for i in range(5):
        b = ({k: v[i * 256:(i + 1) * 256] for k, v in feeds.items()}, labels[i * 256:(i + 1) * 256])
        got, want = float(gpu.train_batch(*b)), float(cpu.train_batch(*b))
        errs.append(abs(got - want) - MIDBAND_LOSS_RTOL * abs(want))
    w_err = max(float(np.abs(w - cpu.get_weights(n)[k]).max())
                for n in gpu.get_parameters() for k, w in gpu.get_weights(n).items())
    res = {"mid_band_tables": sum(getattr(op, "onehot_packed", False) for op in gpu.graph.compute_ops),
           "steps": 5, "max_loss_err_over_rtol": max(errs), "max_weight_err": w_err,
           "loss_rtol": MIDBAND_LOSS_RTOL, "loss_atol": MIDBAND_LOSS_ATOL, "weight_atol": MIDBAND_WEIGHT_ATOL}
    log(f"[train-midband] CUDA vs CPU, vocabs capped at 20000: {json.dumps(res)}")
    if res["mid_band_tables"] != 10 or max(errs) > MIDBAND_LOSS_ATOL or w_err > MIDBAND_WEIGHT_ATOL:
        raise AssertionError(f"[train-midband] CUDA and CPU disagree: {res}")
    out["parity"] = res
    return out


def phase_train_chunk_scatter() -> dict:
    """kaggle at full width with packed_tables="off": all 10 large tables
    on the scatter route (the optimizer's fixed-size scatter rule), in f32;
    SGD and Adam, eager steps against graph replays."""
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    out = {}
    for rule in ("sgd", "adam"):
        def make():
            m = kaggle_model(cfg, TRAIN_BATCH, SEED, rule=rule, packed_tables="off")
            scatter = [op for op in m._sparse_ops if not op.kernel_route]
            if len(scatter) != KAGGLE_BIG_TABLES or len(m._sparse_ops) != KAGGLE_BIG_TABLES:
                raise AssertionError(f"[train-chunk-scatter] scatter route {[op.name for op in scatter]}")
            return m

        out[rule] = replays_vs_eager(f"[train-chunk-scatter] {rule}", make, cfg)
    return out


# ------------------------------------------------------------------ the hybrid-parallel path, one card

MESH_STEPS = 3


def mesh_one_model(mesh, cfg, rule: str, seed: int = SEED, batch: int = TRAIN_BATCH, **ffkw):
    """compile(mesh=, plan=dlrm_hybrid_plan()) of a kaggle-shaped model."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model
    from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan

    model = make_dlrm_model(cfg, FFConfig(batch_size=batch, seed=seed, compute_dtype="bfloat16",
                                          table_dtype="bfloat16", **ffkw), device="cuda")
    compile_for(model, rule, mesh=mesh, plan=dlrm_hybrid_plan())
    return model


def mesh_one_kaggle(mesh, rule: str) -> dict:
    """compile(mesh=, plan=dlrm_hybrid_plan()) on kaggle at full width in a
    world of one: the flat collection of the 10 large tables, on the flat
    scatter (no kernel launched), f32 pool; a warm-up and a few timed eager
    steps."""
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    model = mesh_one_model(mesh, cfg, rule)
    coll = model._op("embedding_collection")
    lay = coll.layout
    pool = model.get_parameters()[coll.name]["pool"]
    if (coll.shard is not None or lay.num_shards != 1 or lay.packed_pool or model.plan.packed_pool
            or len(coll.table_names) != KAGGLE_BIG_TABLES or pool.dtype != torch.float32):
        raise AssertionError(f"mesh-1 kaggle is not the flat f32 collection of the {KAGGLE_BIG_TABLES} "
                             f"large tables off the kernel route: {lay}")
    _, staged = kaggle_batches(model, cfg)
    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    losses = [float(model.train_batch(*staged[0]))]  # a warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [float(model.train_batch(*staged[(i + 1) % 4])) for i in range(MESH_STEPS)]
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items() if fn.launches}
    res = {"rule": rule, "tables": coll.table_names, "r_pad": lay.r_pad, "pool": list(pool.shape),
           "losses": losses, "ms_per_step": dt / MESH_STEPS * 1e3, "launches": launches}
    if launches or not all(np.isfinite(losses)):
        raise AssertionError(f"mesh-1 kaggle: {res}")
    return res


def mesh_one_parity(mesh, rule: str) -> dict:
    """Kaggle widths with vocabs capped at 20000, every table fused
    (onehot_embedding_threshold 0): 5 steps of the mesh-1 model on CUDA
    against FFConfig(fuse_embeddings=True) on the CPU (the same flat
    collection, no mesh) from the same weights."""
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config

    bs, steps = 256, 5
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    gpu = mesh_one_model(mesh, cfg, rule, seed=SEED + 5, batch=bs, onehot_embedding_threshold=0,
                         packed_tables="on")
    cpu = kaggle_model(cfg, bs, SEED + 5, device="cpu", rule=rule, onehot_embedding_threshold=0,
                       fuse_embeddings=True)
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    feeds, labels = random_batches(cfg, steps * bs, seed=SEED + 5)
    errs = []
    for i in range(steps):
        sl = slice(i * bs, (i + 1) * bs)
        batch = {k: v[sl] for k, v in feeds.items()}
        errs.append(abs(float(gpu.train_batch(batch, labels[sl])) - float(cpu.train_batch(batch, labels[sl]))))
    w_errs = np.concatenate([np.abs(w - cpu.get_weights(name)[k]).reshape(-1)
                             for name in gpu.get_parameters() for k, w in gpu.get_weights(name).items()])
    w_atol = ADAM_E2E_ATOL if rule == "adam" else E2E_ATOL
    res = {"rule": rule, "fused_tables": len(gpu._op("embedding_collection").table_names),
           "max_loss_err": max(errs), "max_weight_err": float(w_errs.max()),
           "share_within_e2e_atol": float(np.mean(w_errs <= E2E_ATOL)), "atol": E2E_ATOL, "weight_atol": w_atol}
    if (max(errs) > E2E_ATOL or res["max_weight_err"] > w_atol or res["share_within_e2e_atol"] < 0.999
            or res["fused_tables"] != cfg.num_tables):
        raise AssertionError(f"mesh-1 CUDA and CPU training disagree: {res}")
    return res


def mesh_one_layouts():
    """Kaggle's 10 large tables as one shard's kernel-route layout, dense
    and routed (exact mode), a [r_pad, 16] bf16 pool, 65536 lookups a
    table and their pooled gradients."""
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.parallel import embedding_collection as pec

    vocabs = [v for v in kaggle_config().embedding_size if v > 8192]
    dense = pec.ShardedEmbeddingLayout(vocabs, 16, 1, [0] * len(vocabs), packed_pool=True)
    routed = pec.ShardedEmbeddingLayout(vocabs, 16, 1, [0] * len(vocabs), packed_pool=True, exchange="routed",
                                        routed_cap_factor=0.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    pool = ((torch.rand((dense.r_pad, 16), generator=gen, device="cuda") - 0.5) * 0.02).to(torch.bfloat16)
    idx = torch.stack([torch.randint(0, v, (TRAIN_BATCH, 1), generator=gen, device="cuda") for v in vocabs], 1)
    g = torch.randn((TRAIN_BATCH, len(vocabs), 16), generator=gen, device="cuda") * 0.01
    return dense, routed, pool, idx, g


def mesh_one_exchange(mesh) -> dict:
    """`sharded_embedding_lookup` and `sharded_embedding_sparse_update`
    called directly at N = 1 over NCCL on a kernel-route layout of kaggle's
    10 large tables: the [r_pad, 16] bf16 shard pool, 65536 lookups a
    table. The lookup equals the flat gather bit for bit; the update (K1,
    SGD) is held against the row-update kernel's plain version on the flat
    rows, its launches counted."""
    from dlrm_flexflow_tpu_torch import AggrMode, SGDOptimizer
    from dlrm_flexflow_tpu_torch.ops.embedding import embedding_bag
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update, row_update_reference
    from dlrm_flexflow_tpu_torch.parallel import embedding_collection as pec

    lay, _, pool, idx, g = mesh_one_layouts()
    flat = (idx + torch.as_tensor(lay.table_bases(), device="cuda")[None, :, None]).reshape(-1, 1)
    got = pec.sharded_embedding_lookup(lay, pool, idx, mesh)
    want = embedding_bag(pool, flat, AggrMode.AGGR_MODE_SUM).reshape(got.shape)
    opt = SGDOptimizer(lr=0.01)
    upd = pool.clone()
    row_update.launches = 0
    pec.sharded_embedding_sparse_update(lay, upd, None, idx, g, mesh, opt)
    launches = row_update.launches
    scale = torch.tensor(-0.01, device="cuda")
    ref = pool.clone()
    rows, src = flat.reshape(-1), g.reshape(-1, 16).contiguous()
    row_update_reference(ref, rows, (src, 1), scale)
    tol = row_update_tolerance(pool, rows, src, 1, scale)
    err = (upd.float() - ref.float()).abs()
    res = {"r_pad": lay.r_pad, "t_max": lay.t_max, "pool": list(pool.shape), "pool_dtype": "bfloat16",
           "lookup_bit_equal": bool(torch.equal(got, want)), "row_update_launches": launches,
           "max_abs_err": err.max().item(),
           "max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item(),
           "touched_rows": int(torch.unique(rows).numel()),
           "lookup_ms": cuda_ms(lambda: pec.sharded_embedding_lookup(lay, pool, idx, mesh)),
           "flat_lookup_ms": cuda_ms(lambda: embedding_bag(pool, flat, AggrMode.AGGR_MODE_SUM)),
           "update_ms": cuda_ms(lambda: pec.sharded_embedding_sparse_update(lay, upd, None, idx, g, mesh, opt))}
    if not res["lookup_bit_equal"] or launches != 1 or res["max_err_over_tol"] > 1.0:
        raise AssertionError(f"mesh-1 exchange: {res}")
    return res


def mesh_one_chunk(mesh, rule: str) -> dict:
    """`train_chunk` under compile(mesh=, plan=) in the world of one, kaggle
    at full width (the flat collection on the scatter route): eager steps
    against graph replays, timed (3 warm-up and 20 timed steps each way,
    the captured step's nodes), then under deterministic algorithms 8
    eager steps against 2 chunks of 4 on fresh models, which must leave
    every tensor of the state and every loss bit for bit the same."""
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import node_counts, stamps_apart
    from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    eager, chunk = (mesh_one_model(mesh, cfg, rule) for _ in range(2))
    _, staged = kaggle_batches(eager, cfg)
    stack, labels = chunk_stacks(staged)
    for i in range(TRAIN_WARMUP):
        eager.train_batch(*staged[i % 4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss_e = eager.train_batch(*staged[i % 4])
    float(loss_e)
    eager_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    chunk.train_chunk({k: v[:TRAIN_WARMUP] for k, v in stack.items()}, labels[:TRAIN_WARMUP])  # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS // 4):
        loss_g = chunk.train_chunk(stack, labels)
    float(loss_g)
    graph_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    nodes = stamps_apart(node_counts(chunk._step_graph.graph, kernel_names=True))
    nodes.pop("kernels")
    res = {"rule": rule, "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
           "graph_examples_per_s": TRAIN_BATCH / graph_ms * 1e3, "graph_nodes": nodes,
           "eager_loss": float(loss_e), "graph_loss": float(loss_g)}
    del eager, chunk
    torch.cuda.empty_cache()
    eager, chunk = (mesh_one_model(mesh, cfg, rule) for _ in range(2))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_e = [eager.train_batch(*staged[i % 4]) for i in range(8)]
        losses_g = [chunk.train_chunk(stack, labels) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = state_diff(eager, chunk)
    res.update({"deterministic_steps": 8, "differing_tensors": len(diff),
                "losses_bit_identical": all(torch.equal(a, b) for a, b in zip(losses_e[3::4], losses_g)),
                "step_counts": [eager._step_count, chunk._step_count]})
    if (diff or not res["losses_bit_identical"] or eager._step_count != chunk._step_count
            or not all(math.isfinite(res[k]) for k in ("eager_loss", "graph_loss"))):
        raise AssertionError(f"mesh-1 train_chunk: replays and eager steps differ: {res} {diff}")
    del eager, chunk, staged, stack, labels
    torch.cuda.empty_cache()
    return res


def mesh_one_routed(mesh) -> dict:
    """The routed exchange called directly at N = 1 over NCCL in exact mode
    (cap_factor 0) on mesh_one_layouts: the lookup bit for bit against the
    dense exchange's; the update's K1 launch (SGD, one, at the owner) held
    against the row-update kernel's plain version on the same routed
    stream (its unique rows, their gradients summed) within the row-update
    tolerance; and the routed update against the dense exchange's within
    twice that tolerance (`row_update_tolerance` on the dense stream): the
    dense stream sums a row's bf16-rounded deltas and rounds the sum to
    bf16, the routed one rounds the sum of the f32 gradients once, so the
    two row deltas part by up to one bf16 step of the row's delta
    magnitude, 2^-7 sum |delta|, and the bf16 results by one more step,
    2^-7 |t|: within 2^-7 (|t| + sum |delta|) of each other twice over."""
    from dlrm_flexflow_tpu_torch import SGDOptimizer
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update, row_update_reference
    from dlrm_flexflow_tpu_torch.parallel import embedding_collection as pec
    from dlrm_flexflow_tpu_torch.parallel import routed_exchange as prx

    dense, routed, pool, idx, g = mesh_one_layouts()
    opt = SGDOptimizer(lr=0.01)
    scale = torch.tensor(-0.01, device="cuda")
    got = prx.routed_embedding_lookup(routed, pool, idx, mesh)
    want = pec.sharded_embedding_lookup(dense, pool, idx, mesh)
    upd_d, upd_r = pool.clone(), pool.clone()
    pec.sharded_embedding_sparse_update(dense, upd_d, None, idx, g, mesh, opt)
    stream = {}
    update = prx.local_pool_row_update

    def seen(layout, table, sstate, rows, payload, optimizer, lr=None):  # the owner's routed stream
        stream.update(rows=rows.clone(), src=payload[0].clone())
        return update(layout, table, sstate, rows, payload, optimizer, lr=lr)

    row_update.launches = 0
    prx.local_pool_row_update = seen
    try:
        prx.routed_embedding_sparse_update(routed, upd_r, None, idx, g, mesh, opt)
    finally:
        prx.local_pool_row_update = update
    launches = row_update.launches
    ref = pool.clone()
    row_update_reference(ref, stream["rows"], (stream["src"], 1), scale)
    k1_tol = row_update_tolerance(pool, stream["rows"], stream["src"], 1, scale)
    k1_err = (upd_r.float() - ref.float()).abs()
    rows = (idx + torch.as_tensor(dense.table_bases(), device="cuda")[None, :, None]).reshape(-1)
    tol = 2.0 * row_update_tolerance(pool, rows, g.reshape(-1, 16).contiguous(), 1, scale)
    err = (upd_r.float() - upd_d.float()).abs()
    res = {"lookup_bit_equal_to_dense": bool(torch.equal(got, want)), "row_update_launches": launches,
           "routed_stream": int(stream["rows"].numel()),
           "unique_rows": int((stream["rows"] < routed.r_pad).sum().item()),
           "max_abs_err": k1_err.max().item(), "max_err_over_tol": (k1_err / k1_tol.clamp_min(1e-30)).max().item(),
           "vs_dense_max_abs_err": err.max().item(),
           "vs_dense_max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item(),
           "c_max": prx.routed_plan(routed, TRAIN_BATCH, 1, 0.0).c_max,
           "lookup_ms": cuda_ms(lambda: prx.routed_embedding_lookup(routed, pool, idx, mesh)),
           "update_ms": cuda_ms(lambda: prx.routed_embedding_sparse_update(routed, upd_r, None, idx, g, mesh, opt))}
    if (not res["lookup_bit_equal_to_dense"] or launches != 1 or res["max_err_over_tol"] > 1.0
            or res["vs_dense_max_err_over_tol"] > 1.0):
        raise AssertionError(f"mesh-1 routed exchange: {res}")
    return res


def mesh_one_captured(mesh) -> dict:
    """The step's collectives captured in a CUDA graph over NCCL, as
    `train_chunk` captures them under a data axis > 1: the dense and the
    routed lookup and update (K1 at the owner) of mesh_one_layouts and an
    all-reduce of one flat bucket (`_all_reduce_flat`), captured in the
    process group's thread-local capture mode after one eager warm-up
    call, then replayed once: every output and both updated pools against
    the same calls made eagerly, bit for bit; the graph's nodes by type
    and its K1 kernel nodes."""
    from dlrm_flexflow_tpu_torch import SGDOptimizer
    from dlrm_flexflow_tpu_torch.core.ffmodel import _all_reduce_flat
    from dlrm_flexflow_tpu_torch.parallel import embedding_collection as pec
    from dlrm_flexflow_tpu_torch.parallel import routed_exchange as prx
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import node_counts

    dense, routed, pool, idx, g = mesh_one_layouts()
    opt = SGDOptimizer(lr=0.01)
    bucket = torch.randn(100_000, device="cuda")

    def body(pool_d, pool_r):
        outs = [pec.sharded_embedding_lookup(dense, pool_d, idx, mesh),
                prx.routed_embedding_lookup(routed, pool_r, idx, mesh)]
        pec.sharded_embedding_sparse_update(dense, pool_d, None, idx, g, mesh, opt)
        prx.routed_embedding_sparse_update(routed, pool_r, None, idx, g, mesh, opt)
        return outs + _all_reduce_flat([bucket.clone()])

    eager_pools = (pool.clone(), pool.clone())
    want = body(*eager_pools)
    warm = (pool.clone(), pool.clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(*warm)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    pools = (pool.clone(), pool.clone())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        got = body(*pools)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    nodes = node_counts(graph, kernel_names=True)
    res = {"outputs_bit_equal": [bool(torch.equal(a, b)) for a, b in zip(got, want)],
           "pools_bit_equal": [bool(torch.equal(a, b)) for a, b in zip(pools, eager_pools)],
           "nodes": {k: v for k, v in nodes.items() if k != "kernels"},
           "k1_kernel_nodes": sum(n for name, n in nodes["kernels"].items() if "row_update" in name),
           "nccl_kernel_nodes": sum(n for name, n in nodes["kernels"].items() if "nccl" in name.lower())}
    if not (all(res["outputs_bit_equal"]) and all(res["pools_bit_equal"])) or res["k1_kernel_nodes"] < 2:
        raise AssertionError(f"mesh-1 captured exchange: {res}")
    return res


def mesh_one_state(mesh) -> dict:
    """Kaggle widths with vocabs capped at 20000, every table fused, SGD, in
    the world of one: the checkpoint round trip of tests/test_sharding.py
    (one step, save, restore into a model built from another seed, the
    next step's loss within rtol 1e-5, atol 1e-6 of the saved model's, and
    the state bit for bit); then int8 serving of the fused collection
    (`quantize_embeddings("int8")`: its flat pool to pool_q and
    pool_scale): within the JAX test's atol 0.08 of the f32 output, and
    within E2E_ATOL of the CPU port's int8 output from the same weights."""
    import tempfile

    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.tools.state import state_diff
    from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint

    bs = 256
    cfg = kaggle_config(batch_size=bs)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    kw = dict(batch=bs, onehot_embedding_threshold=0, packed_tables="on")
    feeds, labels = random_batches(cfg, 2 * bs, seed=SEED + 22)
    batch = ({k: v[:bs] for k, v in feeds.items()}, labels[:bs])
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    first = mesh_one_model(mesh, cfg, "sgd", seed=SEED + 22, **kw)
    first.train_batch(*batch)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        save_checkpoint(tmp, first)
        resumed = mesh_one_model(mesh, cfg, "sgd", seed=SEED + 23, **kw)
        differed = bool(state_diff(first, resumed))
        manifest = restore_checkpoint(tmp, resumed)
    restored = state_diff(first, resumed)
    l1, l2 = float(first.train_batch(*batch)), float(resumed.train_batch(*batch))
    res = {"saved_at": manifest["step"], "differed_before_restore": differed,
           "differing_tensors_after_restore": len(restored), "loss_saved_model": l1, "loss_restored": l2}
    if restored or not differed or abs(l2 - l1) > 1e-6 + 1e-5 * abs(l1):
        raise AssertionError(f"mesh-1 checkpoint: {res} {restored}")
    cpu = kaggle_model(cfg, bs, SEED + 22, device="cpu", onehot_embedding_threshold=0, fuse_embeddings=True)
    cpu.set_parameters({name: first.get_weights(name) for name in first.get_parameters()})
    sample = {k: v[bs:] for k, v in feeds.items()}
    y32 = first.predict(sample)
    arrays = (first.quantize_embeddings("int8"), cpu.quantize_embeddings("int8"))
    y8, y8_cpu = first.predict(sample), cpu.predict(sample)
    sub = first.get_parameters()[first._op("embedding_collection").name]
    res.update({"int8_arrays": list(arrays), "int8_pool": list(sub["pool_q"].shape),
                "int8_vs_f32_max_err": float(np.abs(y8 - y32).max()),
                "int8_cuda_vs_cpu_max_err": float(np.abs(y8 - y8_cpu).max()), "atol": E2E_ATOL})
    if (arrays != (1, 1) or not np.all(np.isfinite(y8)) or res["int8_vs_f32_max_err"] > 0.08
            or res["int8_cuda_vs_cpu_max_err"] > E2E_ATOL):
        raise AssertionError(f"mesh-1 int8 serving: {res}")
    return res


def mesh_one_shards(mesh) -> dict:
    """The sharded checkpoint's two halves called directly in the world of
    one over NCCL (at a data axis of 1 `save_checkpoint` has no shards to
    gather): on mesh_one_layouts' [r_pad, 16] bf16 pool and an Adam m and v
    of its shape (f32), `_gather_shards` (rank 0's [1, r_pad, 16]; a bf16
    tensor travels as f16 bits), the host array the writer makes of it
    (`_host`), and `_own_shard` of that (what each rank keeps on restore),
    back on the card: each bit for bit with what was gathered; the gathers'
    and host copies' ms."""
    from types import SimpleNamespace

    from dlrm_flexflow_tpu_torch.training.checkpoint import _gather_shards, _host, _own_shard, _tensor

    _, _, pool, _, _ = mesh_one_layouts()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    state = {"pool": pool, "m": torch.randn(pool.shape, generator=gen, device="cuda") * 1e-3,
             "v": torch.rand(pool.shape, generator=gen, device="cuda") * 1e-6}
    coll = SimpleNamespace(name="embedding_collection", shard=mesh.rank)
    res = {}
    for key, t in state.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked = _gather_shards(t, mesh.rank, mesh.size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = _host(stacked)
        t2 = time.perf_counter()
        back = _tensor(_own_shard(host, coll, mesh.size)).to("cuda")
        res[key] = {"dtype": str(t.dtype), "stacked": list(stacked.shape), "host": str(host.dtype),
                    "bytes": t.numel() * t.element_size(), "gather_ms": (t1 - t0) * 1e3,
                    "to_host_ms": (t2 - t1) * 1e3, "bit_equal": bool(torch.equal(back, t))}
    if not all(r["bit_equal"] and r["stacked"] == [mesh.size, *pool.shape] for r in res.values()):
        raise AssertionError(f"mesh-1 checkpoint shards: {res}")
    return res


def mesh_one_replicated(mesh) -> dict:
    """The replicated tables' update (parallel/replicated_tables.py, which a
    sparse table outside the fused collection runs under a data axis > 1)
    called directly at N = 1 over NCCL on kaggle's 10 route tables ([V, 16]
    bf16 on K1) with the path's stream at batch 65536 (int64 ids, bf16
    pooled gradients): `replicated_sparse_update` all-gathers the ids and
    the gradients (a copy at N = 1) and applies them; under SGD and Adam it
    is held against `apply_sparse_updates` on the same stream, tables and
    slot states bit for bit, its K1 launches counted (10 a call). Then the
    gather and update are captured in a CUDA graph (after an eager warm-up
    on a side stream) and replayed once, bit for bit against the same call
    made eagerly; the graph's K1 and NCCL kernel nodes, and the call's ms
    eager and replayed."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update, row_update_adam
    from dlrm_flexflow_tpu_torch.parallel.replicated_tables import replicated_sparse_update
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import node_counts
    from dlrm_flexflow_tpu_torch.training.sparse_engine import apply_sparse_updates

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    model = kaggle_model(cfg, TRAIN_BATCH, SEED + 30)
    ops = [op for op in model._sparse_ops if op.kernel_route]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    xs = {op.name: [torch.randint(0, op.num_entries, (TRAIN_BATCH, 1), generator=gen, device="cuda")] for op in ops}
    g = {op.name: [(torch.randn((TRAIN_BATCH, op.out_dim), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)]
         for op in ops}
    tables = {op.name: model.get_parameters()[op.name]["weight"] for op in ops}
    out = {"tables": len(ops), "table_dtype": str(tables[ops[0].name].dtype),
           "gathered_bytes": sum(x[0].numel() * x[0].element_size() + y[0].numel() * y[0].element_size()
                                 for x, y in zip(xs.values(), g.values()))}
    for rule, opt, wrapper in (("sgd", SGDOptimizer(lr=0.01), row_update),
                               ("adam", AdamOptimizer(alpha=ADAM_ALPHA), row_update_adam)):
        lr = torch.tensor(0.01 if rule == "sgd" else ADAM_ALPHA, device="cuda")

        def fresh():
            return ({op.name: {"weight": tables[op.name].clone()} for op in ops},
                    {op.name: op.sparse_state_init(opt, "cuda") for op in ops})

        def call(params, states):
            return replicated_sparse_update(ops, params, xs, g, opt, states, model._ctx, lr=lr)[0]

        (pa, sa), (pb, sb) = fresh(), fresh()
        wrapper.launches = 0
        sa = call(pa, sa)
        launches = wrapper.launches
        sb = apply_sparse_updates(ops, pb, xs, g, opt, sb, model._ctx, lr=lr)
        equal = all(torch.equal(pa[n]["weight"], pb[n]["weight"]) for n in pa) and all(
            torch.equal(a, b) for n in sa for a, b in zip(_leaves(sa[n]), _leaves(sb[n])))
        warm = fresh()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(*warm)
        torch.cuda.current_stream().wait_stream(side)
        (pc, sc) = fresh()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            call(pc, sc)
        graph.instantiate()
        graph.replay()
        torch.cuda.synchronize()
        replay_equal = all(torch.equal(pa[n]["weight"], pc[n]["weight"]) for n in pa) and all(
            torch.equal(a, b) for n in sa for a, b in zip(_leaves(sa[n]), _leaves(sc[n])))
        nodes = node_counts(graph, kernel_names=True)
        params, states = fresh()
        out[rule] = {"row_update_launches": launches, "bit_equal_to_apply_sparse_updates": equal,
                     "replay_bit_equal_to_eager": replay_equal,
                     "k1_kernel_nodes": sum(n for k, n in nodes["kernels"].items() if "row_update" in k),
                     "nccl_kernel_nodes": sum(n for k, n in nodes["kernels"].items() if "nccl" in k.lower()),
                     "nodes": {k: v for k, v in nodes.items() if k != "kernels"},
                     "eager_ms": cuda_ms(lambda: call(params, states)), "replay_ms": cuda_ms(graph.replay)}
        if not (equal and replay_equal) or launches != len(ops) or out[rule]["k1_kernel_nodes"] < len(ops):
            raise AssertionError(f"mesh-1 replicated tables: {out}")
        del graph, pa, pb, pc, sa, sb, sc, warm, params, states
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return out


def _leaves(state) -> list:
    """The tensors of a slot state (None, a tensor, or Adam's {"m", "v"})."""
    if state is None:
        return []
    return [state[k] for k in sorted(state)] if isinstance(state, dict) else [state]


def mesh_one_tensor_parallel(mesh) -> dict:
    """The column-parallel Dense's two autograd functions
    (parallel/tensor_parallel.py `copy_in`, `gather_out`) in a process
    group of one (a subgroup of the world of one, `Mesh.subgroup`) around
    the port's `dense` at kaggle's widest tensor-parallel layer a rank of a
    (2, 2) mesh sees (bot_mlp_1: [16384, 512] -> 256, bf16 compute, ReLU):
    the output and the gradients of the input, the kernel and the bias
    against plain `dense` without them, eagerly and as a CUDA-graph replay
    of the forward and backward (the gather and the backward's all-reduce
    captured after one eager warm-up), bit for bit; the graph's nodes."""
    from dlrm_flexflow_tpu_torch.ffconst import ActiMode
    from dlrm_flexflow_tpu_torch.ops.dense import dense
    from dlrm_flexflow_tpu_torch.parallel.tensor_parallel import copy_in, gather_out
    from dlrm_flexflow_tpu_torch.tools.graph_nodes import node_counts

    group = mesh.subgroup([[0]])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    x = torch.randn((TRAIN_BATCH // 4, 512), generator=gen, device="cuda")
    kernel = torch.randn((256, 512), generator=gen, device="cuda") * 0.05
    bias = torch.randn((256,), generator=gen, device="cuda") * 0.05
    w = torch.randn((TRAIN_BATCH // 4, 256), generator=gen, device="cuda")

    def step(tp: bool):
        leaves = [t.detach().requires_grad_(True) for t in (x, kernel, bias)]
        xi = copy_in(leaves[0], group) if tp else leaves[0]
        y = dense(xi, leaves[1], leaves[2], ActiMode.AC_MODE_RELU, torch.bfloat16)
        if tp:
            y = gather_out(y, 1, 0, group)
        return [y.detach()] + list(torch.autograd.grad((y * w).sum(), leaves))

    want = step(False)
    eager = step(True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(True)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        got = step(True)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    nodes = node_counts(graph, kernel_names=True)
    names = ("output", "input_grad", "kernel_grad", "bias_grad")
    res = {"shape": [TRAIN_BATCH // 4, 512, 256],
           "eager_bit_equal": {n: bool(torch.equal(a, b)) for n, a, b in zip(names, eager, want)},
           "replay_bit_equal": {n: bool(torch.equal(a, b)) for n, a, b in zip(names, got, want)},
           "max_abs_err": max(float((a.float() - b.float()).abs().max()) for a, b in zip(eager + got, want + want)),
           "nodes": {k: v for k, v in nodes.items() if k != "kernels"},
           "nccl_kernel_nodes": sum(n for name, n in nodes["kernels"].items() if "nccl" in name.lower())}
    if not (all(res["eager_bit_equal"].values()) and all(res["replay_bit_equal"].values())):
        raise AssertionError(f"mesh-1 tensor parallel: {res}")
    return res


def mesh_one_pair_alike(make, staged, mesh) -> dict:
    """Models from `make(mesh)` and `make(None)` (one seed: the same
    weights) in a world of one: 2 eager steps each, then fresh ones with a
    chunk of 4 `train_chunk` replays each, under deterministic algorithms;
    every loss and every tensor of the state bit for bit."""
    from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors

    out = {}
    stack, labels = chunk_stacks(staged)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for how in ("eager", "replayed"):
            pair, losses = [make(mesh), make(None)], []
            for m in pair:
                got = ([m.train_batch(*staged[i]) for i in range(2)] if how == "eager"
                       else [m.train_chunk(stack, labels)])
                losses.append(torch.stack(got).float().cpu())
            diff = state_diff(*pair)
            out[how] = {"tensors": len(state_tensors(pair[0])), "differing_tensors": len(diff),
                        "losses_bit_identical": bool(torch.equal(*losses)), "losses": losses[0].tolist(),
                        "captured": how == "eager" or pair[0]._step_graph is not None}
            if diff or not out[how]["losses_bit_identical"] or not out[how]["captured"]:
                raise AssertionError(f"mesh-1: compile(mesh=) against no mesh, {how}: {out} {diff}")
            del pair
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def mesh_one_zoo(mesh) -> dict:
    """compile(mesh=, plan=data_parallel_plan()) of the op library's graphs
    in a world of one, each against the same model compiled with no mesh
    (`mesh_one_pair_alike`): moe_mlp at its widths and batch ZOO_MOE_BATCH
    under Adam, ResNet-50 at batch 64 under SGD, and a BatchNorm + Dropout
    graph (conv 3 -> 32 on 32 x 32 images, BatchNorm, Dropout 0.3, Dense
    to 10, softmax) at batch 256 under SGD."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, LossType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models import zoo
    from dlrm_flexflow_tpu_torch.parallel.plan import data_parallel_plan

    def compiled(m, opt, msh):
        m.compile(opt, LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, mesh=msh,
                  plan=data_parallel_plan() if msh is not None else None)
        return m

    def bn_dropout(b):
        m = FFModel(FFConfig(batch_size=b, seed=SEED + 63))
        t = m.create_tensor([b, 3, 32, 32], name="image")
        t = m.dropout(m.batch_norm(m.conv2d(t, 32, 3, 3, 1, 1, 1, 1)), 0.3)
        m.softmax(m.dense(m.flat(t), 10))
        return m

    gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
    cases = {
        "moe_mlp": (ZOO_MOE_BATCH, lambda msh, b: compiled(zoo.moe_mlp(
            batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 63)), AdamOptimizer(alpha=ADAM_ALPHA), msh),
            lambda b: moe_clustered(b, gen), "input"),
        "resnet": (ZOO_CNN_BATCH["resnet"], lambda msh, b: compiled(zoo.resnet(
            batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 63)), SGDOptimizer(lr=ZOO_CNN_LR["resnet"]), msh),
            lambda b: class_images(b, (3, 224, 224), gen), "image"),
        "batch_norm_dropout": (256, lambda msh, b: compiled(bn_dropout(b), SGDOptimizer(lr=0.005), msh),
                               lambda b: class_images(b, (3, 32, 32), gen), "image"),
    }
    out = {}
    for name, (b, make, data, key) in cases.items():
        staged = [({key: x}, y) for x, y in (data(b) for _ in range(4))]
        out[name] = {"batch": b, **mesh_one_pair_alike(lambda msh: make(msh, b), staged, mesh)}
        del staged
        torch.cuda.empty_cache()
    return out


def mesh_one_global_paths(mesh) -> dict:
    """The op library's global-batch code in a group of one, called
    directly on the card (the models above take it only under a data axis
    above 1): BatchNorm's two all-reduces (parallel/global_batch.py
    `all_reduce_sum`, forward and backward) against the one-card formula
    within f32 rounding, and MoE's arrival order with the count all-gather
    (`preceding_counts`) equal to one card's; then `expert_parallel_ffn` at
    N = 1 (its two all-to-alls in a group of one) against
    `reference_moe_ffn` at moe_mlp's widths, 4 experts, 16384 tokens, f32:
    the forward and w1's gradient within tests/test_sharding.py's bounds."""
    from dlrm_flexflow_tpu_torch.ops.conv import batch_norm
    from dlrm_flexflow_tpu_torch.ops.moe import dispatch_slots, moe_capacity
    from dlrm_flexflow_tpu_torch.parallel.expert_parallel import expert_parallel_ffn, moe_gate, reference_moe_ffn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 64)
    x = torch.randn((256, 32, 32, 32), generator=gen, device="cuda") * 2.0 + 0.5
    scale = torch.rand((32,), generator=gen, device="cuda") + 0.5
    bias = torch.randn((32,), generator=gen, device="cuda")
    w = torch.randn(x.shape, generator=gen, device="cuda")
    res = {}
    outs = []
    for msh in (mesh, None):
        leaf = x.clone().requires_grad_(True)
        y = batch_norm(leaf, scale, bias, True, 1e-5, msh)
        (g,) = torch.autograd.grad((y * w).sum(), [leaf])
        outs.append((y.detach(), g))
    # f32: the two means sum 262144 terms a channel in other orders
    res["batch_norm"] = {"max_abs_err_y": float((outs[0][0] - outs[1][0]).abs().max()),
                         "max_abs_err_dx": float((outs[0][1] - outs[1][1]).abs().max()),
                         "atol": 1e-4}
    assign = torch.randint(0, 4, (ZOO_MOE_BATCH, 2), generator=gen, device="cuda", dtype=torch.int32)
    cap = moe_capacity(2, 4, ZOO_MOE_BATCH, 1.0)
    res["dispatch_equal"] = bool(torch.equal(dispatch_slots(assign, 4, cap, mesh), dispatch_slots(assign, 4, cap)))
    if max(res["batch_norm"]["max_abs_err_y"], res["batch_norm"]["max_abs_err_dx"]) > 1e-4 or not res["dispatch_equal"]:
        raise AssertionError(f"mesh-1 global paths: {res}")
    d, h, e, t = 784, 64, 4, ZOO_MOE_BATCH
    xs = torch.randn((t, d), generator=gen, device="cuda")
    gate_w = torch.randn((d, e), generator=gen, device="cuda") * 0.05
    w1, b1 = torch.randn((e, d, h), generator=gen, device="cuda") * d**-0.5, torch.zeros((e, h), device="cuda")
    w2, b2 = torch.randn((e, h, d), generator=gen, device="cuda") * h**-0.5, torch.zeros((e, d), device="cuda")
    gv, ids = moe_gate(xs, gate_w, 2)
    got = []
    for fn in (lambda w: expert_parallel_ffn(xs, gv, ids, w, b1, w2, b2, mesh),
               lambda w: reference_moe_ffn(xs, gv, ids, w, b1, w2, b2, shards=1)):
        leaf = w1.clone().requires_grad_(True)
        y = fn(leaf)
        got.append((y.detach(), torch.autograd.grad(y.pow(2).sum(), [leaf])[0]))
    over = [float(((a - b).abs() - rtol * b.abs()).max() / atol)
            for (a, b), (rtol, atol) in zip(((got[0][0], got[1][0]), (got[0][1], got[1][1])), ((1e-4, 1e-5), (1e-3, 1e-4)))]
    res["expert_parallel"] = {"experts": e, "tokens": t, "max_err_over_tol": {"out": over[0], "grad": over[1]},
                              "bit_equal": bool(torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1]))}
    if max(over) > 1.0:
        raise AssertionError(f"mesh-1 expert_parallel_ffn at N = 1: {res}")
    return res


AUTOTUNE_BUDGET = 1000  # the strategy search's budget in mesh-1 and phase 35
AUTOTUNE_STEPS = 8  # calibrate_step_residual's replays


def mesh_one_search(mesh) -> dict:
    """compile(mesh=, plan=dlrm_hybrid_plan()) of kaggle at full width with
    search_budget > 0 in a world of one: the h100 preset, calibrated on
    this card into the machine file beside the exported strategy (both in
    a temporary directory); the exported strategy holds the plan's
    placement; one step against a model compiled with no search under the
    plan the search chose: the same loss, bit for bit, and every state
    tensor within E2E_ATOL (the one-hot tables' gradients add by float
    atomics)."""
    import shutil
    import tempfile

    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.autotune.machine import MachineSpec, physical_limits
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config, make_dlrm_model
    from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan
    from dlrm_flexflow_tpu_torch.tools.state import state_diff

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_search_")
    try:
        strategy = f"{tmp}/strategy.json"
        t0 = time.perf_counter()
        searched = mesh_one_model(mesh, cfg, "sgd", search_budget=AUTOTUNE_BUDGET, export_strategy_file=strategy)
        compile_s = time.perf_counter() - t0
        plan, report = searched.plan, searched._search_report
        chosen = {k: getattr(plan, k) for k in ("table_assignment", "table_split", "replicated_tables",
                                                 "exchange", "chips_per_host")}
        exported = json.loads(Path(strategy).read_text())
        machine = MachineSpec.from_file(searched.config.machine_cache_path())
        bad = [r for r in physical_limits(machine, searched.graph) if not r["ok"]]
        if not plan.table_assignment or exported["table_assignment"] != plan.table_assignment or bad:
            raise AssertionError(f"mesh-1 search: plan {chosen}, exported {exported}, beyond the card: {bad}")
        given = dlrm_hybrid_plan()
        for k, v in chosen.items():
            setattr(given, k, v)
        plain = make_dlrm_model(cfg, FFConfig(batch_size=TRAIN_BATCH, seed=SEED, compute_dtype="bfloat16",
                                              table_dtype="bfloat16"), device="cuda")
        compile_for(plain, "sgd", mesh=mesh, plan=given)
        _, staged = kaggle_batches(searched, cfg)
        losses = [float(searched.train_batch(*staged[0])), float(plain.train_batch(*staged[0]))]
        diff = state_diff(searched, plain)
        res = {"plan": chosen, "best_us": report["best_us"], "round_robin_us": report["round_robin_us"],
               "tp_ops": report["tp_ops"], "compile_s": compile_s, "machine": {
                   k: getattr(machine, k) for k in ("gather_gbps", "scatter_gbps", "update_pass_gbps",
                                                    "update_ns_per_row", "update_us_per_table",
                                                    "step_overhead_us", "dense_costs")},
               "losses": losses, "max_state_diff": max(diff.values(), default=0.0)}
        if losses[0] != losses[1] or res["max_state_diff"] > E2E_ATOL:
            raise AssertionError(f"mesh-1 search: the searched step parts from the plain one: {res}")
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mesh_one() -> dict:
    """Phase 24: the hybrid-parallel path in an in-process NCCL world of one
    (destroyed at the end, so later phases run as before)."""
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        log(f"[mesh-1] {mesh!r} NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")
        for rule in ("sgd", "adam"):
            log(f"[mesh-1] kaggle {json.dumps(mesh_one_kaggle(mesh, rule))}")
            torch.cuda.empty_cache()
        for rule in ("sgd", "adam"):
            log(f"[mesh-1] train_chunk replays vs eager steps {json.dumps(mesh_one_chunk(mesh, rule))}")
        for rule in ("sgd", "adam"):
            log(f"[mesh-1-parity] {json.dumps(mesh_one_parity(mesh, rule))}")
        res = mesh_one_exchange(mesh)
        log(f"[mesh-1] exchange at N = 1 {json.dumps(res)}")
        res["routed"] = mesh_one_routed(mesh)
        log(f"[mesh-1] routed exchange at N = 1, exact mode {json.dumps(res['routed'])}")
        res["captured"] = mesh_one_captured(mesh)
        log(f"[mesh-1] the exchange and an all-reduce captured in a CUDA graph {json.dumps(res['captured'])}")
        res["replicated"] = mesh_one_replicated(mesh)
        log(f"[mesh-1] replicated tables: the global stream gathered and applied "
            f"{json.dumps(res['replicated'])}")
        log(f"[mesh-1] checkpoint shards gathered and kept {json.dumps(mesh_one_shards(mesh))}")
        log(f"[mesh-1] checkpoint and int8 serving {json.dumps(mesh_one_state(mesh))}")
        log(f"[mesh-1] tensor-parallel Dense in a group of one {json.dumps(mesh_one_tensor_parallel(mesh))}")
        log(f"[mesh-1] the op library under compile(mesh=) against no mesh {json.dumps(mesh_one_zoo(mesh))}")
        log(f"[mesh-1] the global-batch paths and expert parallelism in a group of one "
            f"{json.dumps(mesh_one_global_paths(mesh))}")
        log(f"[mesh-1] the strategy search in a world of one {json.dumps(mesh_one_search(mesh))}")
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------ the zoo (phases 27-34)
ZOO_MOE_BATCH = 16384
ZOO_CANDLE_BATCH = 8192
ZOO_WARMUP, ZOO_MOE_STEPS, ZOO_STEPS = 3, 20, 10
ZOO_CHUNK = 4  # train_chunk's K in the zoo's replay checks (2 chunks against 8 eager steps)
# K6 launches of one request chunk under "on": every rank-2 Dense
ZOO_K6_A_CHUNK = {"mnist_mlp": 3, "moe_mlp": 10, "candle_uno": 19, "alexnet": 3}
# the zoo's rank-2 Dense layers at their chip-path M: (M, K, N, activation, layers)
ZOO_K6_SHAPES = [
    (16384, 784, 512, "relu", "mnist_mlp dense"), (16384, 512, 512, "relu", "mnist_mlp dense_1"),
    (16384, 512, 10, "none", "mnist_mlp dense_2"),
    (16384, 784, 64, "relu", "moe_mlp gate_h and expert{0..3}_h"), (16384, 64, 4, "none", "moe_mlp gate_out"),
    (16384, 64, 10, "none", "moe_mlp expert{0..3}_out"),
    (8192, 942, 1000, "relu", "candle_uno cell.rnaseq tower"),
    (8192, 5270, 1000, "relu", "candle_uno drug{1,2}.descriptors towers"),
    (8192, 2048, 1000, "relu", "candle_uno drug{1,2}.fingerprints towers"),
    (8192, 1000, 1000, "relu", "candle_uno towers' layers 2-3, head layers 2-3"),
    (8192, 5002, 1000, "relu", "candle_uno head layer 1"), (8192, 1000, 1, "none", "candle_uno output"),
    # the CNN heads after `flat`, at the serving batch of zoo-cnn-on
    (256, 9216, 4096, "relu", "alexnet dense"), (256, 4096, 4096, "relu", "alexnet dense_1"),
    (256, 4096, 10, "none", "alexnet dense_2"), (256, 2048, 10, "none", "resnet and inception_v3 dense"),
]


def zoo_inputs(model, n: int, gen, scale: float = 1.0) -> dict:
    """Normal inputs (std `scale`) of every graph input, n rows, on the card."""
    return {iop.name: torch.randn((n,) + tuple(iop.outputs[0].shape[1:]), generator=gen, device="cuda") * scale
            for iop in model.graph.inputs}


def moe_clustered(n: int, gen, in_dim: int = 784, classes: int = 10) -> tuple:
    """examples/moe.py's data on the card: a center a class in `in_dim`
    dims plus noise of 0.3; class ids as [n, 1]."""
    centers = torch.randn((classes, in_dim), generator=gen, device="cuda")
    y = torch.randint(0, classes, (n,), generator=gen, device="cuda")
    return centers[y] + 0.3 * torch.randn((n, in_dim), generator=gen, device="cuda"), y[:, None].float()


def zoo_train(tag: str, card: str, model, staged, steps: int, batch: int) -> dict:
    """ZOO_WARMUP warm-up and `steps` timed eager train_batch steps on the
    staged batches (the launch counts zeroed around the timed steps: "auto"
    reaches no kernel), then the kernel time and busy share."""
    for i in range(ZOO_WARMUP):
        model.train_batch(*staged[i % len(staged)])
    torch.cuda.synchronize()
    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [model.train_batch(*staged[i % len(staged)]) for i in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items() if fn.launches}
    losses = [float(v) for v in losses]
    res = {"card": card, "steps": steps, "batch": batch, "ms_per_step": dt / steps * 1e3,
           "examples_per_s": steps * batch / dt, "first_loss": losses[0], "last_loss": losses[-1],
           "launches": launches, "metrics": model.get_metrics(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{tag} {json.dumps(res)}")
    if not all(math.isfinite(v) for v in losses) or launches:
        raise AssertionError(f"{tag}: losses not finite, or a kernel launched under 'auto': {res}")
    log(f"{tag} device kernels over {PROFILED_STEPS} profiled steps: "
        f"{json.dumps({'card': card, **train_profile(model, staged, res['ms_per_step'], route_tables=1)})}")
    return {**res, "losses": losses}


def zoo_replays(tag: str, card: str, make, staged) -> dict:
    """Two models from `make()` (one seed: the same weights), 2 chunks of
    ZOO_CHUNK graph replays (train_chunk on the staged batches stacked)
    against as many eager steps under deterministic algorithms: every loss
    and every tensor of the state bit for bit. Then 2 more chunks timed
    against as many eager steps."""
    from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors

    eager, chunk = make(), make()
    stack, labels = chunk_stacks(staged)
    k = len(staged)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_e = [eager.train_batch(*staged[i % k]) for i in range(2 * k)]
        losses_g = [chunk.train_chunk(stack, labels) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = state_diff(eager, chunk)
    same = all(torch.equal(a, b) for a, b in zip(losses_e[k - 1::k], losses_g))
    t0 = time.perf_counter()
    for i in range(2 * k):
        loss_e = eager.train_batch(*staged[i % k])
    float(loss_e)
    eager_ms = (time.perf_counter() - t0) / (2 * k) * 1e3
    t0 = time.perf_counter()
    for _ in range(2):
        loss_g = chunk.train_chunk(stack, labels)
    float(loss_g)
    graph_ms = (time.perf_counter() - t0) / (2 * k) * 1e3
    res = {"card": card, "chunk_k": k, "deterministic_steps": 2 * k, "tensors": len(state_tensors(eager)),
           "differing_tensors": len(diff), "max_abs_diff": max(diff.values(), default=0.0),
           "losses_bit_identical": same, "captured": chunk._step_graph is not None,
           "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms}
    log(f"{tag} replays vs eager steps, deterministic: {json.dumps(res)}")
    if diff or not same or chunk._step_graph is None or not math.isfinite(float(loss_g)):
        raise AssertionError(f"{tag}: graph replays and eager steps differ: {res} {diff}")
    return {"res": res, "chunk": chunk, "stack": (stack, labels)}


def zoo_serve(card: str, on, auto, feeds: dict, want_k6: int, relative: bool = False) -> tuple:
    """predict under "on" (K6 counted) against the same weights under
    "auto": (the numbers, both outputs, whether K6 launched `want_k6`
    times and nothing else did). The tolerance is E2E_ON_ATOL, times the
    larger of 1 and the outputs' largest magnitude if `relative`."""
    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    y_on = on.predict(feeds)
    on_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items() if fn.launches}
    t0 = time.perf_counter()
    y_auto = auto.predict(feeds)
    auto_s = time.perf_counter() - t0
    n = next(iter(feeds.values())).shape[0]
    res = {"card": card, "examples": n, "launches_on": launches, "on_predict_s": on_s, "auto_predict_s": auto_s,
           "max_abs_err": float(np.abs(y_on - y_auto).max()),
           "atol": E2E_ON_ATOL * (max(1.0, float(np.abs(y_auto).max())) if relative else 1.0),
           "finite": bool(np.isfinite(y_on).all() and np.isfinite(y_auto).all())}
    return res, y_on, y_auto, launches == {"fused_dense": want_k6}


def phase_zoo_moe(card: str) -> dict:
    """moe_mlp at its default widths (784 in, 4 experts, k 2, alpha 2.0,
    64-wide gate and experts, 10 classes), batch 16384, on examples/moe.py's
    clustered data: Adam (alpha 0.001), sparse CE and accuracy, eager steps
    (the loss must fall), graph replays bit for bit, recompile, then serving
    under "on" (K6, 10 launches a chunk) against "auto"."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, FFConfig, LossType, MetricsType
    from dlrm_flexflow_tpu_torch.models import zoo
    from dlrm_flexflow_tpu_torch.tools.state import state_tensors

    tag, b = "[zoo-moe]", ZOO_MOE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)

    def make(use_pallas="auto"):
        m = zoo.moe_mlp(batch_size=b, num_experts=4, k=2, alpha=2.0, in_dim=784, num_classes=10,
                        config=FFConfig(batch_size=b, seed=SEED + 50, use_pallas=use_pallas))
        m.compile(AdamOptimizer(alpha=ADAM_ALPHA), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [MetricsType.METRICS_ACCURACY])
        return m

    t0 = time.perf_counter()
    model = make()
    x, y = moe_clustered(4 * b, gen)
    staged = [({"input": x[i * b:(i + 1) * b]}, y[i * b:(i + 1) * b]) for i in range(4)]
    cap = model.get_layer_by_name("group_by").capacity
    log(f"{tag} moe_mlp: 784 -> gate 64 -> 4 experts (top 2, capacity {cap}) of 784 -> 64 -> 10, batch {b}; "
        f"set-up {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    train = zoo_train(tag, card, model, staged, ZOO_MOE_STEPS, b)
    head, tail = np.mean(train["losses"][:5]), np.mean(train["losses"][-5:])
    if not tail < head:
        raise AssertionError(f"{tag}: the loss did not fall over the timed steps: {head} -> {tail}")
    rep = zoo_replays(tag, card, make, staged)
    replays, chunk, (stack, labels) = rep["res"], rep["chunk"], rep["stack"]
    before = {k: v.clone() for k, v in state_tensors(chunk).items()}
    old = chunk._step_graph
    chunk.recompile()
    dropped = chunk._step_graph is None
    kept = all(torch.equal(before[k], v) for k, v in state_tensors(chunk).items())
    loss = float(chunk.train_chunk(stack, labels))
    recap = {"card": card, "graph_dropped": dropped, "state_kept": kept, "step_count": chunk._step_count,
             "captured_again": chunk._step_graph is not None and chunk._step_graph is not old, "loss": loss}
    log(f"{tag} recompile: {json.dumps(recap)}")
    if not (dropped and kept and recap["captured_again"] and math.isfinite(loss)):
        raise AssertionError(f"{tag}: recompile: {recap}")
    del chunk, stack, labels, rep

    # serving: the trained weights under "on" and "auto"
    on, auto = make("on"), make()
    for m in (on, auto):
        m.set_parameters({name: model.get_weights(name) for name in model.get_parameters()})
    n = 4 * b + 1000
    xs, _ = moe_clustered(n, gen)
    feeds = {"input": xs.cpu().numpy()}
    chunks = -(-n // b)
    res, y_on, y_auto, k6_ok = zoo_serve(card, on, auto, feeds, ZOO_K6_A_CHUNK["moe_mlp"] * chunks)
    # the top 2 experts of each row under each route: a gate near-tie that
    # the bf16 rounding of K6's outputs flips sends a row to another expert
    same = np.ones(n, bool)
    topk = on.get_layer_by_name("topk")
    with torch.inference_mode():
        for i in range(0, n, b):
            part = xs[i:i + b]
            pad = torch.cat([part, part[-1:].expand(b - part.shape[0], -1)]) if part.shape[0] < b else part
            sets = [m.graph.execute(m.get_parameters(), {"input": pad}, m._ctx, fetch=[topk.outputs[1]])[0]
                    .sort(dim=1).values[:part.shape[0]] for m in (on, auto)]
            same[i:i + part.shape[0]] = (sets[0] == sets[1]).all(dim=1).cpu().numpy()
    res["rows_routed_alike"] = int(same.sum())
    res["max_abs_err_routed_alike"] = float(np.abs(y_on - y_auto)[same].max())
    res["mean_score"] = float(y_on.mean())
    log(f"{tag} predict under 'on' vs 'auto': {json.dumps(res)}")
    if not (k6_ok and res["finite"] and y_on.shape == (n, 10) and res["max_abs_err_routed_alike"] <= res["atol"]
            and n - res["rows_routed_alike"] <= 0.01 * n):
        raise AssertionError(f"{tag}: serving under 'on': {res}")
    out = {"train": train, "replays": replays, "k6_launches": res["launches_on"].get("fused_dense", 0),
           "max_abs_err": res["max_abs_err_routed_alike"]}
    del model, on, auto, staged, x, y, xs
    torch.cuda.empty_cache()
    return out


def phase_zoo_candle(card: str) -> dict:
    """candle_uno at its defaults (towers 942 / 5270 / 2048 ->
    1000 -> 1000 -> 1000, head 5002 -> 1000 -> 1000 -> 1000 -> 1), batch
    8192: SGD on MSE under "auto", eager steps, graph replays bit for bit,
    then serving under "on" (K6, 19 launches a chunk) against "auto"."""
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models import zoo

    tag, b = "[zoo-candle]", ZOO_CANDLE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)

    def make(use_pallas="auto"):
        m = zoo.candle_uno(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 51, use_pallas=use_pallas))
        m.compile(SGDOptimizer(lr=1e-3), LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                  [MetricsType.METRICS_MEAN_SQUARED_ERROR])
        return m

    t0 = time.perf_counter()
    model = make()
    staged = [(zoo_inputs(model, b, gen), torch.randn((b, 1), generator=gen, device="cuda")) for _ in range(4)]
    widths = {iop.name: iop.outputs[0].shape[1] for iop in model.graph.inputs}
    log(f"{tag} candle_uno: inputs {widths}, "
        f"{sum(p.numel() for sub in model.get_parameters().values() for p in sub.values())} parameters, batch {b}; "
        f"set-up {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    train = zoo_train(tag, card, model, staged, ZOO_STEPS, b)
    rep = zoo_replays(tag, card, make, staged)
    del rep, staged
    on, auto = make("on"), make()
    for m in (on, auto):
        m.set_parameters({name: model.get_weights(name) for name in model.get_parameters()})
    n = 2 * b + 1000
    feeds = {k: v.cpu().numpy() for k, v in zoo_inputs(model, n, gen).items()}
    chunks = -(-n // b)
    res, y_on, y_auto, k6_ok = zoo_serve(card, on, auto, feeds, ZOO_K6_A_CHUNK["candle_uno"] * chunks,
                                         relative=True)
    log(f"{tag} predict under 'on' vs 'auto' (atol E2E_ON_ATOL times the outputs' largest magnitude): "
        f"{json.dumps(res)}")
    if not (k6_ok and res["finite"] and y_on.shape == (n, 1) and res["max_abs_err"] <= res["atol"]
            and all(math.isfinite(v) for v in train["losses"])):
        raise AssertionError(f"{tag}: serving under 'on': {res}")
    out = {"train": train, "k6_launches": res["launches_on"]["fused_dense"], "max_abs_err": res["max_abs_err"]}
    del model, on, auto, feeds
    torch.cuda.empty_cache()
    return out


def phase_zoo_attention(card: str) -> dict:
    """transformer at its default widths (seq 64, hidden 128, 8 heads, 2
    layers) at batch 64, and bert_proxy at its widths (batch 8, seq 128,
    hidden 1024, 16 heads) cut to 2 layers (its 24 overflow f32 in the JAX
    package itself: no softmax, no normalization): Adam (alpha 1e-4) on MSE,
    eager steps, graph replays bit for bit, predict; a fresh bert_proxy
    (zero biases) at seq_length 64 gives zeros past row 64, and the
    seq_length drops a captured step. Then mnist_mlp served under "on"
    (K6, 3 launches)."""
    from dlrm_flexflow_tpu_torch import AdamOptimizer, FFConfig, LossType
    from dlrm_flexflow_tpu_torch.models import zoo

    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    out = {}
    for name, b, kw in (("transformer", 64, dict(seq_len=64, hidden=128, num_heads=8, num_layers=2)),
                        ("bert_proxy", 8, dict(seq_length=128, hidden=1024, num_heads=16, num_layers=2))):
        tag = f"[zoo-attention] {name}"

        def make(name=name, b=b, kw=kw):
            m = getattr(zoo, name)(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 52), **kw)
            m.compile(AdamOptimizer(alpha=1e-4), LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
            return m

        model = make()
        shape = tuple(model.graph.inputs[0].outputs[0].shape)
        staged = [(zoo_inputs(model, b, gen), torch.randn(shape, generator=gen, device="cuda")) for _ in range(4)]
        log(f"{tag}: input {shape}, {kw}")
        torch.cuda.reset_peak_memory_stats()
        train = zoo_train(tag, card, model, staged, ZOO_STEPS, b)
        rep = zoo_replays(tag, card, make, staged)
        y = model.predict({k: torch.cat([f[k] for f, _ in staged]).cpu().numpy() for k in staged[0][0]})
        res = {"card": card, "predict_shape": list(y.shape), "finite": bool(np.isfinite(y).all()),
               "max_abs_output": float(np.abs(y).max())}
        if name == "bert_proxy":
            chunk, (stack, labels) = rep["chunk"], rep["stack"]
            chunk.set_iteration_config_sequence_length(64)
            res["seq_length_drops_the_graph"] = chunk._step_graph is None
            res["seq_length_chunk_loss"] = float(chunk.train_chunk(stack, labels))
            fresh = make()
            fresh.set_iteration_config_sequence_length(64)
            z = fresh.forward(staged[0][0])
            res["fresh_rows_past_64_zero"] = bool((z[:, 64:] == 0).all())
            res["fresh_rows_to_64_nonzero"] = bool((z[:, :64] != 0).any())
            ok = (res["seq_length_drops_the_graph"] and math.isfinite(res["seq_length_chunk_loss"])
                  and res["fresh_rows_past_64_zero"] and res["fresh_rows_to_64_nonzero"])
            del chunk, stack, labels, fresh
        else:
            ok = True
        log(f"{tag} predict: {json.dumps(res)}")
        if not (ok and res["finite"] and tuple(y.shape) == (4 * b,) + shape[1:]):
            raise AssertionError(f"{tag}: {res}")
        out[name] = {"train": train, "replays": rep["res"]}
        del model, staged, rep
        torch.cuda.empty_cache()

    tag, b = "[zoo-attention] mnist_mlp", ZOO_MOE_BATCH
    on, auto = (zoo.mnist_mlp(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 53, use_pallas=up))
                for up in ("on", "auto"))
    on.compile()
    auto.compile()
    auto.set_parameters({name: on.get_weights(name) for name in on.get_parameters()})
    feeds = {"image": torch.randn((b, 784), generator=gen, device="cuda").cpu().numpy()}
    res, y_on, _, k6_ok = zoo_serve(card, on, auto, feeds, ZOO_K6_A_CHUNK["mnist_mlp"])
    log(f"{tag} predict under 'on' vs 'auto': {json.dumps(res)}")
    if not (k6_ok and res["finite"] and y_on.shape == (b, 10) and res["max_abs_err"] <= res["atol"]):
        raise AssertionError(f"{tag}: serving under 'on': {res}")
    out["mnist_mlp"] = {"k6_launches": res["launches_on"]["fused_dense"], "max_abs_err": res["max_abs_err"]}
    del on, auto
    torch.cuda.empty_cache()
    return out


ZOO_CNN_BATCH = {"resnet": 64, "alexnet": 64, "inception_v3": 32}
ZOO_CNN_FEW_STEPS = 4  # alexnet's and inception_v3's timed eager steps
ZOO_FALL_STEPS = 20  # resnet's and nmt's timed eager steps, over which the loss must fall
# SGD on the class-pattern images: ResNet-50's loss falls within 10 steps;
# inception_v3 (no BatchNorm either) overshoots at 0.005 within a few
ZOO_CNN_LR = {"resnet": 0.02, "alexnet": 0.02, "inception_v3": 0.001}
ZOO_NMT_BATCH = 64
ZOO_NMT_LR = 2.0  # SGD on the copy task (the loss starts at ln 20480 = 9.93)
ZOO_CNN_SERVE_BATCH = 256


def class_images(n: int, shape: tuple, gen, classes: int = 10) -> tuple:
    """Images that carry their class: a random pattern a class plus noise of
    0.5, on the card; class ids as [n, 1]."""
    centers = torch.randn((classes,) + shape, generator=gen, device="cuda")
    y = torch.randint(0, classes, (n,), generator=gen, device="cuda")
    return centers[y] + 0.5 * torch.randn((n,) + shape, generator=gen, device="cuda"), y[:, None].float()


def step_flop(model) -> float:
    """The forward's multiply-adds of the convolutions, the LSTMs and the
    Dense layers, times 2, times 3 for the backward: a train step's FLOP."""
    from dlrm_flexflow_tpu_torch.ops.conv import Conv2D
    from dlrm_flexflow_tpu_torch.ops.dense import Dense
    from dlrm_flexflow_tpu_torch.ops.rnn import LSTM

    fwd = 0.0
    for op in model.graph.compute_ops:
        if isinstance(op, (Conv2D, LSTM)):
            fwd += op.cost_stats()["flops"]
        elif isinstance(op, Dense):
            fwd += 2.0 * op.outputs[0].volume * op.in_dim
    return 3.0 * fwd


def replay_profile(tag: str, rep: dict, flop: float) -> dict:
    """The replays' kernel time a step and busy share (`chunk_profile`),
    and the TFLOP/s of the eager and the replayed step."""
    res, (stack, labels) = rep["res"], rep["stack"]
    prof = chunk_profile(rep["chunk"], stack, labels, res["graph_ms_per_step"])
    prof.update(eager_tflop_per_s=flop / res["eager_ms_per_step"] / 1e9,
                graph_tflop_per_s=flop / res["graph_ms_per_step"] / 1e9)
    log(f"{tag} replays: {json.dumps(prof)}")
    return prof


def loss_fell(tag: str, losses: list, cycle: int = 4) -> None:
    """The mean of the first `cycle` timed losses (one of each staged
    batch) above that of the last `cycle`."""
    head, tail = float(np.mean(losses[:cycle])), float(np.mean(losses[-cycle:]))
    log(f"{tag} loss over the timed steps: first {cycle} {head}, last {cycle} {tail}")
    if not tail < head:
        raise AssertionError(f"{tag}: the loss did not fall over the timed steps: {head} -> {tail}")


def phase_zoo_cnn(card: str) -> dict:
    """resnet (ResNet-50: 3-4-6-3 bottlenecks, no BatchNorm, as the
    reference builds it) at batch 64 on 224 x 224 images, SGD on sparse CE:
    eager steps (the loss must fall), graph replays bit for bit with eager
    steps; then alexnet (batch 64, 229 x 229) and inception_v3 (batch 32,
    299 x 299), a few eager steps each. bf16 compute: the convolutions
    run in cuDNN on bf16 operands (ops/conv.py)."""
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models import zoo

    gen = torch.Generator(device="cuda").manual_seed(SEED + 57)
    out = {}
    for name, b in ZOO_CNN_BATCH.items():
        tag = f"[zoo-cnn] {name}"

        def make(name=name, b=b):
            m = getattr(zoo, name)(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 57))
            m.compile(SGDOptimizer(lr=ZOO_CNN_LR[name]), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                      [MetricsType.METRICS_ACCURACY])
            return m

        t0 = time.perf_counter()
        model = make()
        shape = tuple(model.graph.inputs[0].outputs[0].shape[1:])
        staged = [({"image": x}, y) for x, y in (class_images(b, shape, gen) for _ in range(4))]
        flop = step_flop(model)
        convs = sum(type(op).__name__ == "Conv2D" for op in model.graph.compute_ops)
        log(f"{tag}: input {shape}, {convs} convolutions, "
            f"{sum(p.numel() for sub in model.get_parameters().values() for p in sub.values())} parameters, "
            f"batch {b}, {flop / 1e12:.4f} TFLOP a step; set-up {time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        steps = ZOO_FALL_STEPS if name == "resnet" else ZOO_CNN_FEW_STEPS
        train = zoo_train(tag, card, model, staged, steps, b)
        train["tflop_per_s"] = flop / train["ms_per_step"] / 1e9
        log(f"{tag} eager: {train['tflop_per_s']} TFLOP/s")
        out[name] = {"train": train}
        if name == "resnet":
            loss_fell(tag, train["losses"])
            del model
            rep = zoo_replays(tag, card, make, staged)
            out[name]["replays"] = rep["res"]
            out[name]["replay_profile"] = replay_profile(tag, rep, flop)
            del rep
        else:
            del model
        del staged
        torch.cuda.empty_cache()
    return out


def phase_zoo_nmt(card: str) -> dict:
    """nmt at the reference's defaults (batch 64, length 20, hidden and
    embed 2048, vocab 20480, 2 layers) on the copy task, SGD, sparse CE over
    [B, T] labels: both tables on the sparse path's scatter rule (D = 2048
    does not divide 128), eager steps (the loss must fall), graph replays
    bit for bit with eager steps."""
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models import zoo

    tag, b = "[zoo-nmt]", ZOO_NMT_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 58)

    def make():
        m = zoo.nmt(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 58))
        m.compile(SGDOptimizer(lr=ZOO_NMT_LR), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        return m

    t0 = time.perf_counter()
    model = make()
    routes = [(op.name, op.kernel_route) for op in model._sparse_ops]
    if routes != [("src_embed", False), ("dst_embed", False)]:
        raise AssertionError(f"{tag}: the tables' update path: {routes}")
    vocab = model.get_layer_by_name("src_embed").num_entries
    staged = []
    for _ in range(4):
        src, dst = (torch.randint(0, vocab, (b, 20), generator=gen, device="cuda", dtype=torch.int32)
                    for _ in range(2))
        staged.append(({"src_tokens": src, "dst_tokens": dst}, dst.float()))
    flop = step_flop(model)
    log(f"{tag}: {sum(p.numel() for sub in model.get_parameters().values() for p in sub.values())} parameters, "
        f"sparse tables {routes} (scatter rule), batch {b}, {flop / 1e12:.4f} TFLOP a step; "
        f"set-up {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    train = zoo_train(tag, card, model, staged, ZOO_FALL_STEPS, b)
    train["tflop_per_s"] = flop / train["ms_per_step"] / 1e9
    log(f"{tag} eager: {train['tflop_per_s']} TFLOP/s")
    loss_fell(tag, train["losses"])
    del model
    rep = zoo_replays(tag, card, make, staged)
    out = {"train": train, "replays": rep["res"], "replay_profile": replay_profile(tag, rep, flop)}
    del rep, staged
    torch.cuda.empty_cache()
    return out


def phase_zoo_cnn_on(card: str) -> dict:
    """alexnet served at a batch of 256 under use_pallas="on" against
    "auto" (the same weights): 4 x 256 + 100 images, K6 on the three Dense
    layers of the head, 3 launches a chunk; the convolutions are cuDNN's
    either way."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.models import zoo

    tag, b = "[zoo-cnn-on] alexnet", ZOO_CNN_SERVE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 59)
    on, auto = (zoo.alexnet(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 59, use_pallas=up))
                for up in ("on", "auto"))
    on.compile()
    auto.compile()
    auto.set_parameters({name: on.get_weights(name) for name in on.get_parameters()})
    n = 4 * b + 100
    x, _ = class_images(n, tuple(on.graph.inputs[0].outputs[0].shape[1:]), gen)
    feeds = {"image": x.cpu().numpy()}
    del x
    chunks = -(-n // b)
    res, y_on, _, k6_ok = zoo_serve(card, on, auto, feeds, ZOO_K6_A_CHUNK["alexnet"] * chunks)
    res["examples_per_s_on"] = n / res["on_predict_s"]
    res["examples_per_s_auto"] = n / res["auto_predict_s"]
    log(f"{tag} predict under 'on' vs 'auto': {json.dumps(res)}")
    if not (k6_ok and res["finite"] and y_on.shape == (n, 10) and res["max_abs_err"] <= res["atol"]):
        raise AssertionError(f"{tag}: serving under 'on': {res}")
    del on, auto, feeds
    torch.cuda.empty_cache()
    return {"k6_launches": res["launches_on"]["fused_dense"], "max_abs_err": res["max_abs_err"]}


ZOO_SMALL = {
    "mnist_mlp": dict(batch_size=64),
    "moe_mlp": dict(batch_size=64, in_dim=32, num_classes=10),
    "transformer": dict(batch_size=4, seq_len=16, hidden=32, num_heads=4, num_layers=2),
    "candle_uno": dict(batch_size=64, dense_layers=(64, 32), dense_feature_layers=(48, 24),
                       feature_shapes={"dose": 1, "cell.rnaseq": 94, "drug.descriptors": 527,
                                       "drug.fingerprints": 204}),
    "bert_proxy": dict(batch_size=2, seq_length=16, hidden=64, num_heads=4, num_layers=2),
}


def phase_zoo_parity(card: str) -> None:
    """Each zoo model at small widths, CUDA against the CPU port from the
    same weights (bf16 compute): predict under "auto" and, for the rank-2
    models, under "on" (K6 against its plain version), then 5 SGD steps
    under "auto" (losses and weights). Outputs and losses within E2E_ATOL
    ("on": E2E_ON_ATOL) times the larger of 1 and their magnitude (the
    attention models' outputs are unnormalized). Then a dropout model: its
    masks on the card and the CPU alike, and graph replays bit for bit with
    eager steps (the step count read from the captured step's buffer)."""
    from dlrm_flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models import zoo
    from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense
    from dlrm_flexflow_tpu_torch.tools.state import state_diff

    rank2 = ("mnist_mlp", "moe_mlp", "candle_uno")
    rng = np.random.default_rng(SEED + 54)
    for name, kw in ZOO_SMALL.items():
        b = kw["batch_size"]
        res = {"card": card}
        for up in ("auto", "on") if name in rank2 else ("auto",):
            gpu, cpu = (getattr(zoo, name)(config=FFConfig(batch_size=b, seed=SEED + 54, use_pallas=up), device=dev,
                                           **kw) for dev in ("cuda", "cpu"))
            for m in (gpu, cpu):
                m.compile(SGDOptimizer(lr=1e-3), LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
            cpu._ctx.use_pallas = gpu._ctx.use_pallas  # "auto" resolves to "off" on the CPU
            cpu.set_parameters({n: gpu.get_weights(n) for n in gpu.get_parameters()})
            n = 2 * b + 3
            # bert_proxy's layers are cubic in their input (no softmax, no
            # normalization): at 0.5 its steps at lr 1e-3 overflow
            scale = 0.2 if name in ("transformer", "bert_proxy") else 1.0
            feeds = {iop.name: (scale * rng.standard_normal((n,) + tuple(iop.outputs[0].shape[1:]))).astype(np.float32)
                     for iop in gpu.graph.inputs}
            before = fused_dense.launches
            y_gpu, y_cpu = gpu.predict(feeds), cpu.predict(feeds)
            k6 = fused_dense.launches - before
            mag = max(1.0, float(np.abs(y_cpu).max()))
            atol = (E2E_ON_ATOL if up == "on" else E2E_ATOL) * mag
            res[f"predict_{up}"] = {"max_abs_err": float(np.abs(y_gpu - y_cpu).max()), "atol": atol, "k6": k6}
            want_k6 = ZOO_K6_A_CHUNK.get(name, 0) * 3 if up == "on" else 0
            if name == "candle_uno" and up == "on":
                want_k6 = 13 * 3  # 5 towers of 2 and a head of 3 at these widths
            if not (np.isfinite(y_gpu).all() and res[f"predict_{up}"]["max_abs_err"] <= atol) or k6 != want_k6:
                raise AssertionError(f"[zoo-parity] {name} predict under {up!r}: {res}")
            if up != "auto":
                continue
            shape = tuple(gpu._out_spec.shape[1:])
            errs = []
            for i in range(5):
                bf = {k: scale * rng.standard_normal((b,) + v.shape[1:]).astype(np.float32) for k, v in feeds.items()}
                lbl = rng.standard_normal((b,) + shape).astype(np.float32)
                lg, lc = float(gpu.train_batch(bf, lbl)), float(cpu.train_batch(bf, lbl))
                errs.append(abs(lg - lc) / max(1.0, abs(lc)))
            w_err = max(float(np.abs(w - cpu.get_weights(op)[k]).max() / max(1.0, float(np.abs(w).max())))
                        for op in gpu.get_parameters() for k, w in gpu.get_weights(op).items())
            res["train"] = {"steps": 5, "max_loss_err": max(errs), "max_weight_err": w_err, "atol": E2E_ATOL}
            if not (max(errs) <= E2E_ATOL and w_err <= E2E_ATOL):  # NaN fails
                raise AssertionError(f"[zoo-parity] {name} training: {res}")
        log(f"[zoo-parity] {name} CUDA vs CPU {json.dumps(res)}")

    def dropout_model(dev):
        m = FFModel(FFConfig(batch_size=64, seed=SEED + 55), device=dev)
        m.dropout(m.dense(m.create_tensor([64, 32], name="x"), 64, name="h"), 0.5)
        m.compile(SGDOptimizer(lr=0.05))
        return m

    x = rng.standard_normal((4, 64, 32)).astype(np.float32)
    y = rng.standard_normal((4, 64, 64)).astype(np.float32)
    gpu, cpu = dropout_model("cuda"), dropout_model("cpu")
    cpu.set_parameters({n: gpu.get_weights(n) for n in gpu.get_parameters()})
    mask_gpu = gpu.forward({"x": x[0]}, training=True).cpu().numpy() != 0
    mask_cpu = cpu.forward({"x": x[0]}, training=True).numpy() != 0
    eager, chunk = dropout_model("cuda"), dropout_model("cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(8):
            eager.train_batch({"x": x[i % 4]}, y[i % 4])
        for _ in range(2):
            chunk.train_chunk({"x": x}, y)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = state_diff(eager, chunk)
    res = {"card": card, "masks_alike": bool(np.array_equal(mask_gpu, mask_cpu)), "kept_share": float(mask_gpu.mean()),
           "replays_differing_tensors": len(diff), "captured": chunk._step_graph is not None,
           "step_entry": "_step" in chunk._step_graph.views if chunk._step_graph is not None else False}
    log(f"[zoo-parity] dropout (rate 0.5 on a 32 -> 64 Dense's output): {json.dumps(res)}")
    if not (res["masks_alike"] and not diff and res["captured"] and res["step_entry"]):
        raise AssertionError(f"[zoo-parity] dropout: {res} {diff}")
    zoo_parity_cnn(card, rng)


def zoo_parity_cnn(card: str, rng) -> None:
    """The CNNs whole, a small nmt, a ResNet bottleneck at stride 2, each
    Inception block and a BatchNorm / Pool2D model, CUDA against the CPU
    port from the same weights (bf16 compute): predict, then 5 SGD steps on
    sparse CE (losses and every weight), within E2E_ATOL times the larger of
    1 and the value's magnitude. The blocks and the BatchNorm / Pool2D model
    end in flat, a Dense of 10 and a softmax."""
    from dlrm_flexflow_tpu_torch import FFConfig, FFModel, LossType, PoolType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models import zoo

    def head(call, shape):
        def build(cfg, dev):
            m = FFModel(cfg, device=dev)
            t = call(m, m.create_tensor([cfg.batch_size, *shape], name="image"))
            m.softmax(m.dense(m.flat(t), 10))
            return m
        return build

    def bn_pool(m, t):
        t = m.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
        t = m.batch_norm(t)
        t = m.pool2d(t, 3, 3, 2, 2, 1, 1)
        t = m.conv2d(t, 16, 3, 3, 1, 1, 1, 1)
        t = m.batch_norm(t, relu=False)
        return m.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type=PoolType.POOL_AVG)

    cases = {
        "mnist_cnn": (lambda cfg, dev: zoo.mnist_cnn(batch_size=16, config=cfg, device=dev), 16, 0.01),
        "cifar10_cnn": (lambda cfg, dev: zoo.cifar10_cnn(batch_size=16, config=cfg, device=dev), 16, 0.01),
        # vocab above the one-hot threshold: the tables on the sparse path
        "nmt": (lambda cfg, dev: zoo.nmt(batch_size=8, src_len=6, dst_len=5, hidden_size=64, embed_size=48,
                                         vocab_size=300, config=cfg, device=dev), 8, 0.5),
        "bottleneck-s2": (head(lambda m, t: zoo._bottleneck(m, t, 8, 2), (16, 9, 9)), 8, 0.01),
        "inception_a": (head(lambda m, t: zoo._inception_a(m, t, 16), (8, 7, 7)), 8, 0.01),
        "inception_b": (head(zoo._inception_b, (8, 9, 9)), 8, 0.01),
        "inception_c": (head(lambda m, t: zoo._inception_c(m, t, 16), (8, 7, 7)), 8, 0.01),
        "inception_d": (head(zoo._inception_d, (8, 9, 9)), 8, 0.01),
        "inception_e": (head(zoo._inception_e, (8, 5, 5)), 8, 0.01),
        "batch_norm-pool2d": (head(bn_pool, (3, 16, 16)), 8, 0.01),
    }
    for name, (build, b, lr) in cases.items():
        cfg = dict(batch_size=b, seed=SEED + 60, onehot_embedding_threshold=64)
        gpu, cpu = build(FFConfig(**cfg), "cuda"), build(FFConfig(**cfg), "cpu")
        for m in (gpu, cpu):
            m.compile(SGDOptimizer(lr=lr), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        cpu.set_parameters({n: gpu.get_weights(n) for n in gpu.get_parameters()})
        classes = gpu._out_spec.shape[-1]

        def batch(n):
            feeds = {}
            for iop in gpu.graph.inputs:
                shape = (n,) + tuple(iop.outputs[0].shape[1:])
                feeds[iop.name] = (rng.integers(0, classes, shape).astype(np.int32)
                                   if iop.outputs[0].dtype.name == "DT_INT32"
                                   else rng.standard_normal(shape).astype(np.float32))
            labels = (feeds["dst_tokens"] if "dst_tokens" in feeds
                      else rng.integers(0, classes, (n, 1)).astype(np.int32))
            return feeds, labels

        feeds, _ = batch(2 * b + 3)
        y_gpu, y_cpu = gpu.predict(feeds), cpu.predict(feeds)
        res = {"card": card, "sparse_tables": [op.name for op in gpu._sparse_ops],
               "predict": {"max_abs_err": float(np.abs(y_gpu - y_cpu).max()),
                           "atol": E2E_ATOL * max(1.0, float(np.abs(y_cpu).max()))}}
        if not (np.isfinite(y_gpu).all() and res["predict"]["max_abs_err"] <= res["predict"]["atol"]):
            raise AssertionError(f"[zoo-parity] {name} predict: {res}")
        errs = []
        for _ in range(5):
            bf, lbl = batch(b)
            lg, lc = float(gpu.train_batch(bf, lbl)), float(cpu.train_batch(bf, lbl))
            errs.append(abs(lg - lc) / max(1.0, abs(lc)))
        w_err = max(float(np.abs(w - cpu.get_weights(op)[k]).max() / max(1.0, float(np.abs(w).max())))
                    for op in gpu.get_parameters() for k, w in gpu.get_weights(op).items())
        res["train"] = {"steps": 5, "max_loss_err": max(errs), "max_weight_err": w_err, "atol": E2E_ATOL}
        log(f"[zoo-parity] {name} CUDA vs CPU {json.dumps(res)}")
        if not (max(errs) <= E2E_ATOL and w_err <= E2E_ATOL):  # NaN fails
            raise AssertionError(f"[zoo-parity] {name} training: {res}")
        if name == "nmt" and res["sparse_tables"] != ["src_embed", "dst_embed"]:
            raise AssertionError(f"[zoo-parity] nmt: the tables are not on the sparse path: {res}")


def phase_zoo_fused_dense(card: str) -> dict:
    """K6 at every zoo shape at its chip-path M (bf16 compute, f32 x):
    against its plain version (dense_tolerance), timed beside addmm of the
    operands cast to bf16 beforehand, with its bound; where x goes through
    the rounding pass (K = 942, 5270, 5002: a row is no whole number of
    16-byte units) the pass's share of the call from the profiler; and a
    moe bucket whose second half is zero rows."""
    from dlrm_flexflow_tpu_torch import ActiMode
    from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import fused_dense, fused_dense_reference, x_goes_direct

    acts = {"relu": ActiMode.AC_MODE_RELU, "none": ActiMode.AC_MODE_NONE}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 56)
    errs, rows = [], []
    for m, k, n, act, layers in ZOO_K6_SHAPES:
        x = randn((m, k), gen)
        w = randn((n, k), gen, scale=k**-0.5)
        b = randn((n,), gen, scale=0.1)
        errs.append(check_fused_dense(f"zoo {layers}", x, w, b, acts[act], torch.bfloat16))
        xb, wb, bb = x.to(torch.bfloat16), w.to(torch.bfloat16).t(), b.to(torch.bfloat16)
        lb = (m * k + n * k + n + m * n) * 4 / HBM_BYTES_PER_S * 1e3
        lo = 2.0 * m * n * k / BF16_FLOP_PER_S * 1e3
        row = {"card": card, "M": m, "K": k, "N": n, "layers": layers,
               "ms": graph_ms(lambda: fused_dense(x, w, b, acts[act], torch.bfloat16)),
               "plain_ms": graph_ms(lambda: fused_dense_reference(x, w, b, acts[act], torch.bfloat16)),
               "library_ms": graph_ms(lambda: torch.addmm(bb, xb, wb)),
               "bound_ms": max(lb, lo), "bound_by": "bytes" if lb >= lo else "operations",
               "x_direct": x_goes_direct(k, x.dtype, x.data_ptr())}
        if not row["x_direct"]:
            kernels = cuda_kernels_of(lambda: fused_dense(x, w, b, acts[act], torch.bfloat16))
            total = sum(v["a_call"] * v["us"] for v in kernels.values())
            rounds = {name: v for name, v in kernels.items() if "round_pad" in name}
            row["kernels_us"] = kernels
            row["round_pass_share"] = sum(v["a_call"] * v["us"] for v in rounds.values()) / total
        rows.append(row)
        log(f"[kernels] fused_dense zoo timing at M={m} K={k} N={n} bf16: {json.dumps(row)}")
        del x, w, b, xb, wb, bb
    m, k, n, _, _ = ZOO_K6_SHAPES[3]
    x = randn((m, k), gen)
    x[m // 2:] = 0.0  # a moe bucket: the slots past the arrivals are zero rows
    errs.append(check_fused_dense("zoo moe bucket, half zero rows", x, randn((n, k), gen, scale=k**-0.5),
                                  randn((n,), gen, scale=0.1), ActiMode.AC_MODE_RELU, torch.bfloat16))
    torch.cuda.empty_cache()
    return {"max_abs_err": max(e["max_abs_err"] for e in errs), "shapes": rows}


# ------------------------------------------------------------------ the strategy search and profiling (phase 35)
def autotune_graphs() -> dict:
    """The graphs whose conv, LSTM, attention and batch-matmul ops
    calibrate_graph_ops times, at the zoo phases' sizes: ResNet-50 at 64,
    nmt at its defaults, the transformer at its defaults, and one
    [64, 128, 256] x [64, 256, 128] batch-matmul."""
    from dlrm_flexflow_tpu_torch import FFConfig, FFModel
    from dlrm_flexflow_tpu_torch.models import zoo

    bmm = FFModel(FFConfig(batch_size=64), device="cuda")
    bmm.batch_matmul(bmm.create_tensor([64, 128, 256], name="a"), bmm.create_tensor([64, 256, 128], name="b"),
                     name="bmm")
    return {"resnet": zoo.resnet(batch_size=ZOO_CNN_BATCH["resnet"], device="cuda").graph,
            "nmt": zoo.nmt(batch_size=ZOO_NMT_BATCH, device="cuda").graph,
            "transformer": zoo.transformer(device="cuda").graph, "batch_matmul": bmm.graph}


def autotune_calibration(tmp: str) -> tuple:
    """The h100 machine model calibrated on this card, saved under `tmp`;
    each constant beside the limit the card sets on it (fails beyond it);
    the launches of the calibration (K1 must be among them)."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.autotune import machine as mm
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config, make_dlrm_model

    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    times = {}
    t0 = time.perf_counter()
    spec = mm.calibrate(mm.preset("h100"))
    times["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = mm.calibrate_packed(spec)
    times["calibrate_packed_s"] = time.perf_counter() - t0
    kaggle = make_dlrm_model(kaggle_config(TRAIN_BATCH), FFConfig(batch_size=TRAIN_BATCH), device="cuda").graph
    t0 = time.perf_counter()
    spec = mm.calibrate_dense(spec, mm.graph_dense_shapes(kaggle), batch=TRAIN_BATCH)
    times["calibrate_dense_s"] = time.perf_counter() - t0
    graphs = autotune_graphs()
    t0 = time.perf_counter()
    for g in graphs.values():
        spec = mm.calibrate_graph_ops(spec, g)
    times["calibrate_graph_ops_s"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items() if fn.launches}
    times["dispatch_latency_us"] = mm.measure_dispatch_latency() * 1e6
    spec.save(f"{tmp}/machine.json")
    rows = {r["name"]: r for g in [kaggle, *graphs.values()] for r in mm.physical_limits(spec, g)}
    for r in rows.values():
        log(f"[autotune] {r['name']} = {r['value']!r} ({'at most' if r['kind'] == 'max' else 'at least'} "
            f"{r['limit']!r} on the card) {'ok' if r['ok'] else 'BEYOND THE CARD'}")
    bad = [r for r in rows.values() if not r["ok"]]
    if bad or not launches.get("row_update") or len(spec.op_costs) < 4:
        raise AssertionError(f"autotune calibration: beyond the card {bad}, launches {launches}, "
                             f"op costs {sorted(spec.op_costs)}")
    log(f"[autotune] calibration {json.dumps({**times, 'launches': launches, 'constants': len(rows)})}")
    return spec, launches


def autotune_residual(spec) -> dict:
    """kaggle at 65536 (bf16 tables, SGD): calibrate_step_residual through
    train_chunk against the calibrated machine, every state tensor bit for
    bit before and after; then `fit` of 2 batches under config.profiling,
    one forward-time line an op before it trains."""
    import contextlib
    import io

    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from dlrm_flexflow_tpu_torch.tools.state import state_tensors

    cfg = kaggle_config(batch_size=TRAIN_BATCH)
    model = kaggle_model(cfg, TRAIN_BATCH, SEED)
    batches, _ = kaggle_batches(model, cfg)
    before = {k: v.clone() for k, v in state_tensors(model).items()}
    residual, measured, predicted = model.calibrate_step_residual(
        *batches[0], steps=AUTOTUNE_STEPS, machine=dataclasses.replace(spec.torus_for(1)), cache_path="")
    after = state_tensors(model)
    differing = sorted(k for k in before if not torch.equal(before[k], after[k]))
    res = {"steps": AUTOTUNE_STEPS, "measured_us": measured, "predicted_us": predicted, "residual": residual,
           "differing_tensors": differing, "step_count": model._step_count}
    log(f"[autotune] kaggle step residual {json.dumps(res)}")
    if differing or model._step_count != 0 or not (np.isfinite(residual) and residual > 0):
        raise AssertionError(f"calibrate_step_residual changed the model or gave no residual: {res}")
    model.config.profiling = True
    feeds = {k: np.concatenate([b[0][k] for b in batches[:2]]) for k in batches[0][0]}
    labels = np.concatenate([b[1] for b in batches[:2]])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = model.fit(feeds, labels, epochs=1, verbose=False)
    lines = [ln for ln in out.getvalue().splitlines() if " forward time = " in ln]
    for ln in lines:
        log(f"[autotune-fit] {ln}")
    want = [f"[{type(op).__name__}] {op.name}" for op in model.graph.compute_ops]
    if [ln.split(" forward time")[0] for ln in lines] != want or not np.isfinite(hist["accuracy"]):
        raise AssertionError(f"fit under profiling printed {len(lines)} lines for {len(want)} ops: {hist}")
    res["fit"] = {"ops": len(lines), "examples_per_s": hist["throughput"]}
    del model
    torch.cuda.empty_cache()
    return res


def autotune_on(tmp: str) -> dict:
    """mlperf-lite at 16384 under use_pallas="on" (serving only: the
    forced kernels have no backward), op by op: op_timing_report (10 timed
    calls after 2 an op) with K6, K5f, K4 and K3 launched; the rows'
    ms summed by kernel; export_task_graph, check_numerics (clean) and
    trace around a predict."""
    import contextlib
    import io
    import os

    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import mlperf_lite_config
    from dlrm_flexflow_tpu_torch.utils import (check_numerics, export_task_graph, op_timing_report,
                                               print_op_timings, trace)

    cfg = mlperf_lite_config(batch_size=BATCH)
    model = forced_model(cfg, BATCH, SEED)
    feeds, _ = random_batches(cfg, BATCH, seed=SEED)
    counts = launch_counts()
    for fn in counts.values():
        fn.launches = 0
    rows = op_timing_report(model, feeds, reps=10, warmup=2)
    launches = {name: fn.launches for name, fn in counts.items() if fn.launches}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_op_timings(rows)
    for ln in out.getvalue().splitlines():
        log(f"[autotune-on] {ln}")
    kernel_of = {"Dense": "fused_dense", "DotInteraction": "dot_interaction"}
    by_kernel = {}
    for op, r in zip(model.graph.compute_ops, rows):
        k = kernel_of.get(r["type"]) or ("onehot_embedding" if r["type"] == "Embedding"
                                         and op.num_entries <= model.config.onehot_embedding_threshold
                                         else "embedding_bag" if r["type"] == "Embedding" else r["type"])
        by_kernel.setdefault(k, []).append(r["ms"])
    export_task_graph(model, f"{tmp}/graph.dot")
    dot = Path(f"{tmp}/graph.dot").read_text()
    bad = check_numerics(model, feeds, None)
    with trace(f"{tmp}/trace"):
        model.predict(feeds)
    traces = [f for _, _, fs in os.walk(f"{tmp}/trace") for f in fs if f.endswith(".pt.trace.json")]
    res = {"ops": len(rows), "launches": launches,
           "ms_by_kernel": {k: {"ops": len(v), "ms_sum": sum(v), "ms_mean": sum(v) / len(v)}
                            for k, v in by_kernel.items()},
           "dot_bytes": len(dot), "numerics": bad, "trace_files": len(traces)}
    log(f"[autotune-on] mlperf-lite op by op under 'on' {json.dumps(res)}")
    need = ("fused_dense", "onehot_embedding", "embedding_bag", "dot_interaction")
    if (any(not launches.get(k) for k in need) or bad or len(traces) != 1 or not dot.startswith("digraph")
            or any(f'"{op.name}"' not in dot for op in model.graph.compute_ops)):
        raise AssertionError(f"autotune 'on' profiling: {res}")
    del model
    torch.cuda.empty_cache()
    return res


def phase_autotune() -> dict:
    """Phase 35 (see the module note), in a temporary directory."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    try:
        spec, launches = autotune_calibration(tmp)
        res = {"calibration_launches": launches, "residual": autotune_residual(spec), "on": autotune_on(tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


FRONTENDS_BATCH = 64  # Model.fit's batch, the zoo's default
FRONTENDS_SERVE = 16384  # the Keras models' serving batch
FRONTENDS_CHUNKS = 2  # full requests each Keras model serves under "on"
FRONTENDS_MNIST_N = 10000  # load_mnist's surrogate at its default size
FRONTENDS_CIFAR_N = 2048  # load_cifar10's surrogate: 32 batches an epoch
FRONTENDS_CIFAR_EPOCHS = 6
FRONTENDS_TABLES = (7424, 2_000_000)  # K5f's and K4's chip shapes, D = 128
# the f32 sums of a layer's outputs: C * kh * kw for a convolution, the
# input width for a Linear / Dense
ALEXNET_SUM_LENGTHS = (3 * 121, 64 * 25, 192 * 9, 384 * 9, 256 * 9, 9216, 4096, 4096)
TF_STAND_IN_SUM_LENGTHS = (9, 1568, 512, 512)


def f32_sum_atol(lengths) -> float:
    """Two f32 computations that sum a layer's n products in other orders
    (cuDNN's convolution against the port's, cuBLAS against a plain
    matmul) are each within n * 2^-24 of the exact sum, relative to the sum
    of the terms' magnitudes, so within 2 n 2^-24 of each other; to first
    order the layers' differences add. With inputs, activations and
    weights of unit order or less (the terms' magnitudes sum to about the
    output's scale), the outputs' tolerance is 2 * (sum of n) * 2^-24."""
    return 2.0 * sum(lengths) * F32_UNIT


def counted(fn) -> tuple:
    """fn()'s result and the kernel launches it made, the counts zeroed
    just before and read just after."""
    counts = launch_counts()
    for c in counts.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counts.items() if c.launches}


def timed_forward(ff, feeds: dict) -> tuple:
    """A warm forward of `feeds`: its output, examples/s by the host's clock
    to a synchronize, and the kernel launches it made."""
    ff.forward(feeds)
    t0 = time.perf_counter()
    out, launches = counted(lambda: ff.forward(feeds))
    return out, next(iter(feeds.values())).shape[0] / (time.perf_counter() - t0), launches


def keras_serve(tag: str, card: str, on, auto, chunks: list, want: dict) -> dict:
    """Keras `predict` of each full request under "on" (launches counted)
    and under "auto" with the same weights, each after a warm-up request:
    the launches under "on" exactly `want`, none under "auto", the outputs
    within E2E_ON_ATOL."""
    on.predict(chunks[0])
    auto.predict(chunks[0])
    t0 = time.perf_counter()
    y_on, launches = counted(lambda: [on.predict(c) for c in chunks])
    on_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y_auto, auto_launches = counted(lambda: [auto.predict(c) for c in chunks])
    auto_s = time.perf_counter() - t0
    y_on, y_auto = np.concatenate(y_on), np.concatenate(y_auto)
    n = y_on.shape[0]
    res = {"card": card, "examples": n, "launches_on": launches, "launches_auto": auto_launches,
           "examples_per_s_on": n / on_s, "examples_per_s_auto": n / auto_s,
           "max_abs_err": float(np.abs(y_on - y_auto).max()), "atol": E2E_ON_ATOL,
           "finite": bool(np.isfinite(y_on).all() and np.isfinite(y_auto).all())}
    log(f"{tag} served under 'on' vs 'auto': {json.dumps(res)}")
    if launches != want or auto_launches or not res["finite"] or not res["max_abs_err"] <= E2E_ON_ATOL:
        raise AssertionError(f"{tag}: serving under 'on', want launches {want}: {res}")
    return res


def frontends_mnist(card: str) -> dict:
    """The Keras Sequential mnist_mlp (the zoo's widths) trained by
    Model.fit past VerifyMetrics("accuracy", 0.9), bit for bit with
    zoo.mnist_mlp given its weights, then served under "on"."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.frontends import datasets, keras as K
    from dlrm_flexflow_tpu_torch.models import zoo
    from dlrm_flexflow_tpu_torch.training.callbacks import VerifyMetrics

    tag, b = "[frontends] keras mnist_mlp", FRONTENDS_BATCH

    def build(batch, **cfg):  # the zoo's op names, so its weights carry by name
        m = K.Sequential([K.Dense(512, activation="relu", name="dense"),
                          K.Dense(512, activation="relu", name="dense_1"),
                          K.Dense(10, name="dense_2"), K.Softmax(name="softmax")])
        m.compile(optimizer="sgd", loss="categorical_crossentropy", metrics=["accuracy"], input_shape=[784],
                  config=FFConfig(batch_size=batch, seed=SEED + 61, **cfg))
        return m

    (xtr, ytr), _ = datasets.load_mnist(synthetic_n=FRONTENDS_MNIST_N)
    x = xtr.reshape(len(xtr), 784).astype(np.float32) / 255.0
    y = datasets.to_categorical(ytr, 10)
    model = build(b)
    hist, launches = counted(lambda: model.fit(x, y, epochs=3, verbose=False,
                                               callbacks=[VerifyMetrics("accuracy", 0.9)]))
    ref = zoo.mnist_mlp(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 61))
    ref.compile()
    ref.set_parameters(model.ffmodel.get_parameters())
    got, want = model.predict(x[:b]), ref.forward({"image": x[:b]}).cpu().numpy()
    res = {"card": card, "epochs": 3, "batch": b, "examples_per_s": hist["throughput"],
           "first_epoch_time_s": hist["first_epoch_time_s"], "accuracy": hist["accuracy"], "launches": launches,
           "bit_identical_to_zoo": bool(np.array_equal(got, want)), "max_abs_err": float(np.abs(got - want).max())}
    log(f"{tag} fit {json.dumps(res)}")
    if launches or not res["bit_identical_to_zoo"]:
        raise AssertionError(f"{tag}: a kernel launched under 'auto', or the forward differs from the zoo's: {res}")
    on, auto = build(FRONTENDS_SERVE, use_pallas="on"), build(FRONTENDS_SERVE)
    for m in (on, auto):
        m.ffmodel.set_parameters(model.ffmodel.get_parameters())
    chunks = np.split(np.resize(x, (FRONTENDS_CHUNKS * FRONTENDS_SERVE, 784)), FRONTENDS_CHUNKS)
    res["serve"] = keras_serve(tag, card, on, auto, chunks,
                               {"fused_dense": ZOO_K6_A_CHUNK["mnist_mlp"] * FRONTENDS_CHUNKS})
    return res


def carry_by_order(model, ref) -> None:
    """ref's weights into `model`, op by op in graph order over the ops that
    have parameters, whose shapes must be equal."""
    mine, theirs = ([op.name for op in m.graph.compute_ops if op.name in m.get_parameters()] for m in (model, ref))
    shapes = [[{k: tuple(v.shape) for k, v in m.get_parameters()[n].items()} for n in ns]
              for m, ns in ((model, mine), (ref, theirs))]
    if shapes[0] != shapes[1]:
        raise AssertionError(f"parameter shapes {shapes[0]} differ from {shapes[1]}")
    model.set_parameters({n: ref.get_parameters()[t] for n, t in zip(mine, theirs)})


def frontends_cifar(card: str) -> dict:
    """The Keras functional cifar10_cnn (the zoo's widths): the zoo
    model's op types and parameter shapes, bit for bit with it given its
    weights; then Model.fit epochs at 64 on load_cifar10, the loss
    falling."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.frontends import datasets, keras as K
    from dlrm_flexflow_tpu_torch.models import zoo
    from dlrm_flexflow_tpu_torch.training.callbacks import Callback

    tag, b = "[frontends] keras cifar10_cnn", FRONTENDS_BATCH
    img = K.Input([3, 32, 32])
    t = img
    for i, filters in enumerate((32, 32, 0, 64, 64, 0)):
        layer = (K.Conv2D(filters, 3, padding="same", activation="relu", name=f"conv{i}") if filters
                 else K.MaxPooling2D(2, name=f"pool{i}"))
        t = layer(t)
    t = K.Dense(512, activation="relu", name="fc1")(K.Flatten(name="flat")(t))
    model = K.Model(img, K.Softmax(name="probs")(K.Dense(10, name="fc2")(t)))
    model.compile(optimizer="sgd", loss="categorical_crossentropy", metrics=["accuracy", "categorical_crossentropy"],
                  config=FFConfig(batch_size=b, seed=SEED + 62))
    ref = zoo.cifar10_cnn(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 62))
    ref.compile()
    kinds = [type(op).__name__ for op in model.ffmodel.graph.compute_ops]
    if kinds != [type(op).__name__ for op in ref.graph.compute_ops]:
        raise AssertionError(f"{tag}: op types {kinds} differ from zoo.cifar10_cnn's")
    carry_by_order(model.ffmodel, ref)
    (xtr, ytr), _ = datasets.load_cifar10(synthetic_n=FRONTENDS_CIFAR_N)
    x = xtr.astype(np.float32) / 255.0
    y = datasets.to_categorical(ytr, 10)
    got, want = model.predict(x[:b]), ref.forward({"image": x[:b]}).cpu().numpy()

    class EpochLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, m, epoch, metrics):
            self.losses.append(metrics["cce"])
            return False

    rec = EpochLosses()
    hist, launches = counted(lambda: model.fit(x, y, epochs=FRONTENDS_CIFAR_EPOCHS, verbose=False, callbacks=[rec]))
    res = {"card": card, "ops": kinds, "bit_identical_to_zoo": bool(np.array_equal(got, want)),
           "max_abs_err": float(np.abs(got - want).max()), "epochs": FRONTENDS_CIFAR_EPOCHS, "steps": FRONTENDS_CIFAR_EPOCHS * (FRONTENDS_CIFAR_N // b),
           "examples_per_s": hist["throughput"], "epoch_cce": rec.losses, "launches": launches}
    log(f"{tag} {json.dumps(res)}")
    if launches or not res["bit_identical_to_zoo"]:
        raise AssertionError(f"{tag}: a kernel launched under 'auto', or the forward differs from the zoo's: {res}")
    loss_fell(tag, rec.losses, cycle=2)
    return res


class AlexNet(torch.nn.Module):
    """zoo.alexnet's layers as a torch module (229 x 229 input, 10 classes)."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv1, self.conv2 = nn.Conv2d(3, 64, 11, 4, 2), nn.Conv2d(64, 192, 5, 1, 2)
        self.conv3, self.conv4 = nn.Conv2d(192, 384, 3, 1, 1), nn.Conv2d(384, 256, 3, 1, 1)
        self.conv5 = nn.Conv2d(256, 256, 3, 1, 1)
        self.pool, self.relu, self.flat = nn.MaxPool2d(3, 2), nn.ReLU(), nn.Flatten()
        self.fc1, self.fc2, self.fc3 = nn.Linear(9216, 4096), nn.Linear(4096, 4096), nn.Linear(4096, 10)
        self.softmax = nn.Softmax(dim=1)

    def forward(self, x):
        r = self.relu
        x = self.pool(r(self.conv2(self.pool(r(self.conv1(x))))))
        x = self.pool(r(self.conv5(r(self.conv4(r(self.conv3(x)))))))
        return self.softmax(self.fc3(r(self.fc2(r(self.fc1(self.flat(x)))))))


def no_tf32(fn):
    """fn() with TF32 off for cuBLAS and cuDNN, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def frontends_torch_fx(card: str) -> dict:
    """AlexNet traced by torch_to_ir, through save_ir and load_ir, applied
    on the card in f32 and held against the module's own forward with the
    imported weights; served at 256 under "on" (K6 on the three Linear
    layers) against "auto"; then the port's examples/import_models.py
    torch tour."""
    import tempfile

    from dlrm_flexflow_tpu_torch import FFConfig, FFModel
    from dlrm_flexflow_tpu_torch.examples import import_models
    from dlrm_flexflow_tpu_torch.frontends.torch_fx import PyTorchModel, load_ir, save_ir, torch_to_ir

    tag, b = "[frontends] torch.fx alexnet", ZOO_CNN_BATCH["alexnet"]
    module = AlexNet()
    ir = torch_to_ir(module)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fx_") as tmp:
        save_ir(ir, f"{tmp}/alexnet.ff")
        loaded = load_ir(f"{tmp}/alexnet.ff")
    if [n.to_line() for n in loaded] != [n.to_line() for n in ir]:
        raise AssertionError(f"{tag}: the IR file did not load back as written")

    def imported(batch, **cfg):
        ff = FFModel(FFConfig(batch_size=batch, seed=SEED + 63, **cfg))
        PyTorchModel(loaded).apply(ff, [ff.create_tensor([batch, 3, 229, 229], name="x")])
        ff.compile()
        return ff

    ff = imported(b, compute_dtype="float32")
    params = ff.get_parameters()
    module = module.cuda().eval()
    with torch.no_grad():
        for name, sub in params.items():
            getattr(module, name).weight.copy_(sub["kernel"])
            getattr(module, name).bias.copy_(sub["bias"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
    x = torch.randn((b, 3, 229, 229), generator=gen, device="cuda")
    got, rate, launches = timed_forward(ff, {"x": x})
    want = no_tf32(lambda: module(x))
    atol = f32_sum_atol(ALEXNET_SUM_LENGTHS)
    res = {"card": card, "nodes": len(ir), "batch": b, "examples_per_s_f32": rate, "launches": launches,
           "max_abs_err": float((got - want).abs().max()), "atol": atol, "finite": bool(torch.isfinite(got).all()),
           "out_range": [float(want.min()), float(want.max())]}
    log(f"{tag} f32 against the module's own forward: {json.dumps(res)}")
    if launches or not (res["finite"] and res["max_abs_err"] <= atol):
        raise AssertionError(f"{tag}: {res}")
    sb = ZOO_CNN_SERVE_BATCH
    on, auto = imported(sb, use_pallas="on"), imported(sb)
    for m in (on, auto):
        m.set_parameters(params)
    n = 4 * sb + 100
    feeds = {"x": torch.randn((n, 3, 229, 229), generator=gen, device="cuda").cpu().numpy()}
    serve, y_on, _, k6_ok = zoo_serve(card, on, auto, feeds, ZOO_K6_A_CHUNK["alexnet"] * -(-n // sb))
    serve["examples_per_s_on"] = n / serve["on_predict_s"]
    serve["examples_per_s_auto"] = n / serve["auto_predict_s"]
    log(f"{tag} served under 'on' vs 'auto': {json.dumps(serve)}")
    if not (k6_ok and serve["finite"] and y_on.shape == (n, 10) and serve["max_abs_err"] <= serve["atol"]):
        raise AssertionError(f"{tag}: serving under 'on': {serve}")
    res["serve"] = serve
    tour = import_models.main(["--tours", "torch"])["torch"]
    log(f"[frontends] examples/import_models.py torch tour: {json.dumps({'shape': tour['shape'], **tour['history']})}")
    if tour["shape"] != (8, 4) or not math.isfinite(tour["history"]["accuracy"]):
        raise AssertionError(f"[frontends] the torch tour: {tour}")
    return res


def onnx_cifar10_cnn(rng):
    """A duck-typed ONNX ModelProto of cifar10_cnn: Conv and Relu pairs, two
    MaxPools, Flatten, a Split / Concat pair, a Reshape to [0, -1], Gemm
    (transB) and Relu, Gemm, Softmax; initializers drawn from `rng`."""
    from types import SimpleNamespace as NS

    def init(name, *shape):
        return NS(name=name, array=rng.standard_normal(shape).astype(np.float32))

    def node(op, ins, outs, **attrs):
        return NS(op_type=op, input=ins, output=outs,
                  attribute=[NS(name=k, ints=v) if isinstance(v, list) else NS(name=k, i=v)
                             for k, v in attrs.items()])

    inits, nodes, t = [], [], "image"
    for i, step in enumerate(((3, 32), (32, 32), None, (32, 64), (64, 64), None)):
        if step is None:
            nodes.append(node("MaxPool", [t], [f"p{i}"], kernel_shape=[2, 2], strides=[2, 2]))
            t = f"p{i}"
            continue
        cin, cout = step
        inits += [init(f"w{i}", cout, cin, 3, 3), init(f"b{i}", cout)]
        nodes += [node("Conv", [t, f"w{i}", f"b{i}"], [f"c{i}"], kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
                  node("Relu", [f"c{i}"], [f"r{i}"])]
        t = f"r{i}"
    inits += [NS(name="shape", array=np.array([0, -1], np.int64)), init("fw1", 512, 4096), init("fb1", 512),
              init("fw2", 10, 512), init("fb2", 10)]
    nodes += [node("Flatten", [t], ["f"]),
              node("Split", ["f"], ["s1", "s2"], axis=1, split=[2048, 2048]),
              node("Concat", ["s1", "s2"], ["cat"], axis=1),
              node("Reshape", ["cat", "shape"], ["rs"]),
              node("Gemm", ["rs", "fw1", "fb1"], ["fc1"], transB=1),
              node("Relu", ["fc1"], ["fc1r"]),
              node("Gemm", ["fc1r", "fw2", "fb2"], ["fc2"], transB=1),
              node("Softmax", ["fc2"], ["probs"])]
    return NS(graph=NS(node=nodes, initializer=inits, output=[NS(name="probs")]))


def frontends_onnx(card: str, rng) -> dict:
    """The ONNX stand-in of cifar10_cnn applied on the card: the zoo
    model's parameter shapes, and its forward bit for bit with the zoo's
    given its weights."""
    from dlrm_flexflow_tpu_torch import FFConfig, FFModel
    from dlrm_flexflow_tpu_torch.frontends.onnx import ONNXModel
    from dlrm_flexflow_tpu_torch.models import zoo

    tag, b = "[frontends] onnx cifar10_cnn", FRONTENDS_BATCH
    proto = onnx_cifar10_cnn(rng)
    ff = FFModel(FFConfig(batch_size=b, seed=SEED + 64))
    out = ONNXModel(proto).apply(ff, {"image": ff.create_tensor([b, 3, 32, 32], name="image")})
    ff.compile()
    ref = zoo.cifar10_cnn(batch_size=b, config=FFConfig(batch_size=b, seed=SEED + 64))
    ref.compile()
    carry_by_order(ff, ref)
    x = rng.random((b, 3, 32, 32), dtype=np.float32)
    got, rate, launches = timed_forward(ff, {"image": x})
    want = ref.forward({"image": x})
    res = {"card": card, "nodes": len(proto.graph.node), "op_types": sorted({n.op_type for n in proto.graph.node}),
           "out_shape": list(out.shape), "examples_per_s": rate, "launches": launches,
           "bit_identical_to_zoo": bool(torch.equal(got, want)), "max_abs_err": float((got - want).abs().max())}
    log(f"{tag} {json.dumps(res)}")
    if launches or not res["bit_identical_to_zoo"] or tuple(got.shape) != (b, 10):
        raise AssertionError(f"{tag}: {res}")
    return res


def tf_stand_in(rng):
    """A duck-typed tf.keras Sequential (what from_tf_keras reads: layers
    whose class names are tf's, `name`, get_config() and get_weights() in
    tf's layouts, HWIO and [in, out]): a channels-first conv stem, then
    mnist_mlp's widths."""
    from types import SimpleNamespace as NS

    def layer(kind, name, config, *shapes):
        weights = [(rng.standard_normal(s) / math.sqrt(np.prod(s[:-1]) if len(s) > 1 else 1)).astype(np.float32)
                   for s in shapes]
        return type(kind, (), {"name": name, "get_config": lambda self: dict(config),
                               "get_weights": lambda self: list(weights)})()

    layers = [
        layer("InputLayer", "input", {}),
        layer("Conv2D", "conv", {"filters": 8, "kernel_size": (3, 3), "strides": (1, 1), "padding": "same",
                                 "data_format": "channels_first", "activation": "relu", "use_bias": True},
              (3, 3, 1, 8), (8,)),
        layer("MaxPooling2D", "pool", {"pool_size": (2, 2), "strides": (2, 2), "padding": "valid"}),
        layer("Flatten", "flat", {}),
        layer("Dense", "dense", {"units": 512, "activation": "relu"}, (1568, 512), (512,)),
        layer("Dense", "dense_1", {"units": 512, "activation": "relu"}, (512, 512), (512,)),
        layer("Dense", "dense_2", {"units": 10, "activation": "softmax"}, (512, 10), (10,)),
    ]
    return NS(layers=layers, inputs=[NS(shape=(None, 1, 28, 28))])


def frontends_tf(card: str, rng) -> dict:
    """from_tf_keras and load_tf_weights of the stand-in on the card (f32),
    held against a plain f32 computation from its arrays (TF32 off)."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.frontends.tf_keras import from_tf_keras, load_tf_weights

    tag, b = "[frontends] tf.keras stand-in", FRONTENDS_BATCH
    model = tf_stand_in(rng)
    ff, in_name = from_tf_keras(model, batch_size=b, config=FFConfig(batch_size=b, compute_dtype="float32"))
    ff.compile()
    updated = load_tf_weights(ff, model, ff._tf_weight_transfer[1])
    x = rng.standard_normal((b, 1, 28, 28)).astype(np.float32)
    got, rate, launches = timed_forward(ff, {in_name: x})
    w = {lay.name: [torch.from_numpy(a).cuda() for a in lay.get_weights()] for lay in model.layers}
    F = torch.nn.functional

    def plain():
        t = torch.relu(F.conv2d(torch.from_numpy(x).cuda(), w["conv"][0].permute(3, 2, 0, 1), w["conv"][1], padding=1))
        t = F.max_pool2d(t, 2).flatten(1)
        t = torch.relu(torch.relu(t @ w["dense"][0] + w["dense"][1]) @ w["dense_1"][0] + w["dense_1"][1])
        return torch.softmax(t @ w["dense_2"][0] + w["dense_2"][1], dim=1)

    want = no_tf32(plain)
    atol = f32_sum_atol(TF_STAND_IN_SUM_LENGTHS)
    res = {"card": card, "ops_updated": updated, "examples_per_s": rate, "launches": launches,
           "max_abs_err": float((got - want).abs().max()), "atol": atol}
    log(f"{tag} against its arrays computed plainly: {json.dumps(res)}")
    if launches or updated != 4 or not res["max_abs_err"] <= atol:
        raise AssertionError(f"{tag}: {res}")
    return res


def frontends_embedding(card: str, rng) -> dict:
    """A Keras functional model of two Embedding tables (7424 and 2,000,000
    rows, D = 128, one id a row) and 13 dense features, concatenated into
    Dense 256 relu and Dense 1 sigmoid, served at 16384 under "on"
    (packed_tables="off": the large table off the row-update route):
    K5f, K4 and two K6 a request, against "auto"."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.ffconst import DataType
    from dlrm_flexflow_tpu_torch.frontends import keras as K

    tag, small, large = "[frontends] keras embedding model", *FRONTENDS_TABLES

    def build(**cfg):
        a, b, dense = K.Input([1], DataType.DT_INT64), K.Input([1], DataType.DT_INT64), K.Input([13])
        h = K.Concatenate(axis=1, name="cat")([K.Embedding(small, 128, aggr="sum", name="small")(a),
                                               K.Embedding(large, 128, aggr="sum", name="large")(b), dense])
        h = K.Dense(256, activation="relu", name="h")(h)
        m = K.Model([a, b, dense], K.Dense(1, activation="sigmoid", name="out")(h))
        m.compile(loss="binary_crossentropy", config=FFConfig(batch_size=FRONTENDS_SERVE, seed=SEED + 65,
                                                              packed_tables="off", **cfg))
        return m

    on = build(use_pallas="on")
    auto = build()
    auto.ffmodel.set_parameters(on.ffmodel.get_parameters())
    n = FRONTENDS_SERVE
    chunks = [[rng.integers(0, small, (n, 1)), rng.integers(0, large, (n, 1)),
               rng.standard_normal((n, 13)).astype(np.float32)] for _ in range(FRONTENDS_CHUNKS)]
    want = {"fused_dense": 2 * FRONTENDS_CHUNKS, "onehot_embedding": FRONTENDS_CHUNKS,
            "embedding_bag": FRONTENDS_CHUNKS}
    return keras_serve(tag, card, on, auto, chunks, want)


def phase_frontends(card: str) -> dict:
    """Phase 36 (see the module note): the model-import frontends on the
    card, through the entry points a user calls."""
    rng = np.random.default_rng(SEED + 60)
    out = {"mnist": frontends_mnist(card), "cifar": frontends_cifar(card), "torch_fx": frontends_torch_fx(card),
           "onnx": frontends_onnx(card, rng), "tf": frontends_tf(card, rng),
           "embedding": frontends_embedding(card, rng)}
    torch.cuda.empty_cache()
    out["launches_on"] = {"mnist_mlp": out["mnist"]["serve"]["launches_on"],
                          "alexnet": out["torch_fx"]["serve"]["launches_on"],
                          "embedding_model": out["embedding"]["launches_on"]}
    return out


def main() -> None:
    card = phase_device()
    phase_build()
    k3 = phase_kernels()
    rows = phase_row_update()
    launches = phase_path()
    phase_parity()
    on_launches = phase_path_on()
    phase_parity_on()
    train_launches, train_ms, split_launches = phase_train()
    phase_train_parity()
    adam_launches, _, _ = phase_train("adam")
    optim_launches = {"adam": adam_launches, **phase_train_optims()}
    for rule in ("momentum", "nesterov", "adam", "adam+adagrad"):
        phase_train_parity(rule)
    k5b_launches = phase_onehot_grad()
    k7_launches = phase_gather_probe()
    phase_train_host(train_ms)
    phase_train_parity_host()
    split_nodes = phase_train_chunk("sgd")["graph"]["split_kernel_nodes"]
    phase_train_chunk("adam")
    phase_train_chunk("sgd", host_routing=True)
    phase_fit_chunk()
    phase_serve_quant(card)
    phase_checkpoint()
    full = {rule: phase_train_full(rule)["kernel_checks"] for rule in ("sgd", "adagrad")}
    phase_host_tail_parity()
    phase_train_midband()
    phase_train_chunk_scatter()
    mesh = phase_mesh_one()
    phase_bench()
    zoo = {"moe_mlp": phase_zoo_moe(card), "candle_uno": phase_zoo_candle(card), **phase_zoo_attention(card)}
    zoo.update(phase_zoo_cnn(card))
    zoo["nmt"] = phase_zoo_nmt(card)
    zoo["alexnet"].update(phase_zoo_cnn_on(card))
    phase_zoo_parity(card)
    autotune = phase_autotune()
    frontends = phase_frontends(card)
    # after the paths: run before them, these cases left about 0.5 GB
    # allocated, which showed in the paths' peak memory
    k6 = phase_fused_dense()
    k6_zoo = phase_zoo_fused_dense(card)
    k4, k5f = phase_lookups()
    k5b = phase_onehot_backward()
    modes = phase_optim_kernels()
    k7 = phase_gather()
    split = phase_bf16_split()
    kernel = {
        "name": "dot_interaction",
        "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/dot_interaction.cu",
        "replaces": "dlrm_flexflow_tpu/ops/pallas/dot_interaction.py:42",
        "launches": launches,
        "max_abs_err": max([k3["max_abs_err"]] + [c["dot_interaction"]["max_abs_err"] for c in full.values()]),
        "ms": k3["ms"],
        "kernel_ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }
    row_err = max([c["max_abs_err"] for c in rows.values()] + [full["sgd"]["row_update"]["max_abs_err"]])
    entries = [kernel]
    for case, replaces in (("a-k1-bfloat16-table-bfloat16-stream", 487), ("c-k2", 750)):
        c = rows[case]
        entries.append({
            "name": f"row_update ({case})",
            "route": "cuda",
            "source": "dlrm_flexflow_tpu_torch/csrc/row_update.cu",
            "replaces": f"dlrm_flexflow_tpu/ops/pallas/packed_update.py:{replaces}",
            "launches": train_launches,
            # the direct sharded, routed and replicated (SGD) updates at
            # N = 1 over NCCL (phase 24), and K1's kernel nodes in the
            # exchanges' captured graph
            "mesh_launches": (mesh["row_update_launches"] + mesh["routed"]["row_update_launches"]
                              + mesh["replicated"]["sgd"]["row_update_launches"]),
            "mesh_captured_k1_nodes": mesh["captured"]["k1_kernel_nodes"],
            "max_abs_err": max(row_err, mesh["max_abs_err"], mesh["routed"]["max_abs_err"]),
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
        })
    for name, src, replaces, res in (
        ("fused_dense", "fused_mlp.cu", "fused_mlp.py:31", k6),
        ("embedding_bag", "embedding_bag.cu", "embedding_bag.py:38", k4),
        ("onehot_embedding", "onehot_embedding.cu", "onehot_embedding.py:55", k5f),
    ):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"dlrm_flexflow_tpu_torch/csrc/{src}",
            "replaces": f"dlrm_flexflow_tpu/ops/pallas/{replaces}",
            "launches": on_launches[name],
            **{key: res[key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
        if name == "fused_dense":
            # the zoo's serving paths under "on" (phases 27-29, 32): launches of
            # each model's predict, and the zoo shapes' check (phase 34)
            entries[-1]["zoo_launches"] = {m: zoo[m]["k6_launches"] for m in ZOO_K6_A_CHUNK}
            entries[-1]["max_abs_err"] = max(k6["max_abs_err"], k6_zoo["max_abs_err"])
        # the imported models served under "on" (phase 36), by model
        entries[-1]["frontends_launches"] = {m: n[name] for m, n in frontends["launches_on"].items() if name in n}
    entries.append({
        "name": "onehot_embedding_backward",
        "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/onehot_embedding.cu",
        "replaces": "dlrm_flexflow_tpu/ops/pallas/onehot_embedding.py:62",
        "launches": k5b_launches,
        **{key: k5b[key] for key in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    # the optimizer modes replace K1's decay mode (packed_update.py:551-556
    # in _update_kernel) and, for AdaGrad, its per-entry scale (:343-351)
    for case, rule, replaces in (("momentum", "momentum", 487), ("nesterov", "nesterov", 487),
                                 ("adam", "adam", 487), ("adagrad", "adagrad", 487)):
        c = modes[case]
        entries.append({
            "name": f"row_update_{case}" if case != "nesterov" else "row_update_momentum (nesterov)",
            "route": "cuda",
            "source": "dlrm_flexflow_tpu_torch/csrc/row_update.cu",
            "replaces": f"dlrm_flexflow_tpu/ops/pallas/packed_update.py:{replaces}",
            "launches": optim_launches[rule],
            # the replicated tables' direct update under Adam (phase 24)
            **({"mesh_launches": mesh["replicated"]["adam"]["row_update_launches"]} if case == "adam" else {}),
            "max_abs_err": max([m["max_abs_err"] for k, m in modes.items()
                                if k.split(":")[0].split("-")[0] == case]
                               + ([full["adagrad"]["row_update"]["max_abs_err"]] if case == "adagrad" else [])),
            **{key: c[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    entries.append({
        "name": "split_bf16x3",
        "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/bf16_split.cu",
        "replaces": "none: no TPU counterpart (the Dense backward's cotangent split)",
        # the 7 kaggle Dense backwards of phase 8's 20 eager steps, counted
        # by the wrapper, and the split's kernel nodes in phase 17's
        # captured step
        "launches": split_launches,
        "graph_kernel_nodes": split_nodes,
        # at kaggle's largest cotangent [65536, 512]; "step" sums the 7
        "max_abs_err": split["max_abs_err"],
        **{key: split[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,  # no one PyTorch call splits an f32 into three bf16 parts
        "step": split["step"],
    })
    entries.append({
        "name": "row_gather",
        "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/row_gather.cu",
        "replaces": "scripts/bench_gather_probe.py:78",
        "launches": k7_launches,
        # f32 at the probe's shape, the wrapper's default depth 4
        **{key: k7[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    # phase 35: K1 timed by calibrate_packed, the forced kernels served op by op
    on, cal = autotune["on"]["launches"], autotune["calibration_launches"]
    for e in entries:
        k1 = e["name"].startswith("row_update (a-k1")
        n = cal.get("row_update", 0) if k1 else on.get(e["name"], 0)
        if n:
            e["autotune_launches"] = n
    if len(entries) != 13:
        raise AssertionError(f"{len(entries)} kernel entries, not 13")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
