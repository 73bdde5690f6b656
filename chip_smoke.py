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
               compile -> train_batch: 3 warm-up and 20 timed steps; then
               5 steps under torch.profiler (kernel time per step, the
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
 17. bench   - python -m dlrm_flexflow_tpu_torch.bench --quick, as a
               subprocess: kaggle training (host-routed), the same with
               --zipf 1.05, and mlperf-lite serving.
 18. kernels, continued - as phase 3: the fused dense layer at the 8
               mlperf-lite layer shapes at M = 16384 (bf16), at M = 1000, in
               f32, without bias; the embedding bag at [16384, 1] into a
               2,000,000 x 128 table, with bags of 4 (AVG, padding, a fully
               padded bag), a bf16 table, indices past the table; the one-hot
               lookup at V = 7424, D = 128, B = 16384 (SUM, AVG, duplicates,
               indices >= V, f32 and bf16 compute) and its gradient (K5b) at
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
               and 6 chunks, with indices < 0 and >= P, twice.
 19. summary - a {"kernels": [...]} line, then the last line
               {"ok": true, "device": {...}}.
Around each path (4, 6, 8, 10, 11, 13, 14 and 15) the kernel launch counts
are zeroed just before and read just after, and must show every kernel of
that path.
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


def phase_device() -> None:
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
    if table.dtype == torch.bfloat16:
        tol = tol + 2.0 * BF16_UNIT * want.abs()
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
    ]
    bound, bound_by = lookup_bound(big, main)
    k4 = {
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "ms": graph_ms(lambda: embedding_bag(big, main, SUM)),
        "plain_ms": graph_ms(lambda: embedding_bag_reference(big, main, SUM)),
        "library_ms": graph_ms(lambda: F.embedding_bag(main, big, mode="sum")),
        "bound_ms": bound, "bound_by": bound_by,
    }
    log(f"[kernels] embedding_bag timing at [{BATCH}, 1] into {list(big.shape)} f32: {json.dumps(k4)}")
    del big, bags

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
    ]
    bound, bound_by = lookup_bound(small, one)
    small_c = small.to(torch.bfloat16)
    k5f = {
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "ms": graph_ms(lambda: onehot_embedding(small, one, SUM, torch.bfloat16)),
        "plain_ms": graph_ms(lambda: onehot_embedding_reference(small, one, SUM, torch.bfloat16)),
        # one library call on a table cast to bf16 beforehand (a bf16 result)
        "library_ms": graph_ms(lambda: F.embedding_bag(one, small_c, mode="sum")),
        "bound_ms": bound, "bound_by": bound_by,
    }
    log(f"[kernels] onehot_embedding timing at [{BATCH}, 1] into {list(small.shape)} f32, "
        f"bf16 compute: {json.dumps(k5f)}")
    del small, small_c
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


def compile_for(model, rule: str) -> None:
    from dlrm_flexflow_tpu_torch import LossType, MetricsType

    opt, sopt = optimizers(rule)
    model.compile(opt, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                  sparse_optimizer=sopt)


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
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss = model.train_batch(*staged[i % 4])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}

    losses.append(float(loss))
    # one launch per kernel-route table and step; kaggle's cat interaction
    # and "auto" reach no other kernel
    want = {**{name: 0 for name in counts}, RULE_WRAPPER[rule]: TRAIN_STEPS * KAGGLE_BIG_TABLES}
    if launches != want:
        raise AssertionError(f"the train path launched {launches}, not {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    res = {
        "steps": TRAIN_STEPS, "seconds": dt, "examples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
        "ms_per_step": dt / TRAIN_STEPS * 1e3, "launches": launches,
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
    return launches[RULE_WRAPPER[rule]], res["ms_per_step"]


def train_profile(model, staged, ms_per_step: float) -> dict:
    """Kernel time per step on the device, from torch.profiler (CUPTI) over
    a few steps, against the unprofiled step time: the device's busy share.
    Sums kernel rows only (op rows carry their kernels' time again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED_STEPS):
            model.train_batch(*staged[i % len(staged)])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_step = {e.key: e.self_device_time_total / 1e3 / PROFILED_STEPS for e in kernels}
    busy = sum(per_step.values())
    if busy == 0.0:
        return {"kernel_ms_per_step": "not measured (the profiler saw no device time)"}
    # a row-update wrapper launch runs 2 to 4 CUDA kernels, all named row_update_*
    row = [e for e in kernels if "row_update" in e.key]
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    return {
        "kernel_ms_per_step": busy,
        "busy_share_of_unprofiled_step": busy / ms_per_step,
        "row_update_kernel_ms_per_launch": (
            sum(e.self_device_time_total for e in row) / 1e3 / (PROFILED_STEPS * KAGGLE_BIG_TABLES)),
        "top_kernels_ms_per_step": {k[:60]: v for k, v in top},
    }


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
    dstate = model.optimizer.update(g_dense, st["dense"], {n: params[n] for n in g_dense})
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
        rate = model._sparse_rate(dstate)
        if rate is None:
            rate = torch.tensor(sopt.lr, device="cuda")
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
                                          table_dtype="bfloat16"))
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


def phase_bench() -> dict:
    """The port's bench as a user runs it, in a subprocess with a time
    limit: kaggle training (its default: batch 65536, host-routed), the same
    on Zipf(1.05) indices (frequency-skewed ids, as Criteo's are), and
    mlperf-lite serving, --quick. Each must print bench.py's keys with
    finite numbers; kaggle must take the row-update route."""
    out = {}
    for name, extra in (("kaggle-train", []), ("kaggle-train-zipf", ["--zipf", "1.05"]),
                        ("mlperf-lite-infer", ["--config", "mlperf-lite", "--mode", "infer"])):
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
        if set(res) != keys or not (math.isfinite(res["value"]) and res["value"] > 0
                                    and math.isfinite(res["loss"])):
            raise AssertionError(f"bench {name} printed {res}")
        if name.startswith("kaggle-train") and not (res["packed_engaged"] and res["table_dtype"] == "bfloat16"):
            raise AssertionError(f"bench kaggle did not take the bf16 row-update route: {res}")
        out[name] = res
    return out


def main() -> None:
    phase_device()
    phase_build()
    k3 = phase_kernels()
    rows = phase_row_update()
    launches = phase_path()
    phase_parity()
    on_launches = phase_path_on()
    phase_parity_on()
    train_launches, train_ms = phase_train()
    phase_train_parity()
    adam_launches, _ = phase_train("adam")
    optim_launches = {"adam": adam_launches, **phase_train_optims()}
    for rule in ("momentum", "nesterov", "adam", "adam+adagrad"):
        phase_train_parity(rule)
    k5b_launches = phase_onehot_grad()
    k7_launches = phase_gather_probe()
    phase_train_host(train_ms)
    phase_train_parity_host()
    phase_bench()
    # after the paths: run before them, these cases left about 0.5 GB
    # allocated, which showed in the paths' peak memory
    k6 = phase_fused_dense()
    k4, k5f = phase_lookups()
    k5b = phase_onehot_backward()
    modes = phase_optim_kernels()
    k7 = phase_gather()
    kernel = {
        "name": "dot_interaction",
        "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/dot_interaction.cu",
        "replaces": "dlrm_flexflow_tpu/ops/pallas/dot_interaction.py:42",
        "launches": launches,
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "kernel_ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }
    row_err = max(c["max_abs_err"] for c in rows.values())
    entries = [kernel]
    for case, replaces in (("a-k1-bfloat16-table-bfloat16-stream", 487), ("c-k2", 750)):
        c = rows[case]
        entries.append({
            "name": f"row_update ({case})",
            "route": "cuda",
            "source": "dlrm_flexflow_tpu_torch/csrc/row_update.cu",
            "replaces": f"dlrm_flexflow_tpu/ops/pallas/packed_update.py:{replaces}",
            "launches": train_launches,
            "max_abs_err": row_err,
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
            "max_abs_err": max(m["max_abs_err"] for k, m in modes.items()
                               if k.split(":")[0].split("-")[0] == case),
            **{key: c[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
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
    if len(entries) != 12:
        raise AssertionError(f"{len(entries)} kernel entries, not 12")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
