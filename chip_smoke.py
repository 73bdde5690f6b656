"""Smoke run of the PyTorch port (dlrm_flexflow_tpu_torch) on one CUDA card.

    python chip_smoke.py        # from the root of a checkout, on a machine with an H100

Phases, each of which ends the run with a non-zero exit if it fails:
  1. device  - needs CUDA (else exits 1 and prints no result); prints the
               card's name and power limit as nvidia-smi gives them.
  2. build   - builds every kernel under dlrm_flexflow_tpu_torch/csrc with nvcc.
  3. kernels - holds each kernel against its plain PyTorch version on the
               card, at the serving path's shapes and a ragged one, and
               times kernel, plain version, a library call, and the bound.
  4. path    - serves mlperf-lite DLRM at full width (26 tables, D=128,
               vocabs capped at 2M, batch 16384) through make_dlrm_model ->
               compile -> predict on 4 full requests and a ragged one; the
               kernel launch counts are zeroed just before and read just
               after, and must show every kernel of the path.
  5. parity  - a D=128 DLRM with small vocabs: predict on CUDA (kernel path)
               against the CPU with the same weights (plain f32 versions).
  6. summary - a {"kernels": [...]} line, then the last line
               {"ok": true, "device": {...}}.
The script imports nothing of JAX: it runs the port alone.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 16384
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# K3 sums D products in f32 in another order than cuBLAS's bmm. Each result
# is within gamma_D * sum_d |x_r,d * x_c,d| of the exact dot (gamma_D ~
# D * 2^-24), so the two differ by at most twice that: the tolerance of an
# element is 2 * D * 2^-24 times the same dot taken over |x|.
F32_UNIT = 2.0**-24
# CUDA-vs-CPU end to end: both round the MLP operands to bf16 and sum in f32;
# the f32 sums differ in order only, but a difference that flips the bf16
# rounding of an activation moves it by one bf16 step (2^-8 relative) and
# that carries through the next layers. Bound on the sigmoid output:
E2E_ATOL = 2e-3


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
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


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


def phase_path() -> int:
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType
    from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model, mlperf_lite_config
    from dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction import dot_interaction

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

    dot_interaction.launches = 0
    t0 = time.perf_counter()
    out = model.predict(feeds)
    first_s = time.perf_counter() - t0
    launches = {"dot_interaction": dot_interaction.launches}

    chunks = -(-n // BATCH)
    if out.shape != (n, 1):
        raise AssertionError(f"predict shape {out.shape} != {(n, 1)}")
    if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError("predict gave values outside [0, 1] or not finite")
    if launches["dot_interaction"] != chunks:
        raise AssertionError(f"dot_interaction launched {launches} times for {chunks} chunks")

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
    cpu = make_dlrm_model(
        cfg, FFConfig(batch_size=bs, seed=SEED + 1, use_pallas="on"), device="cpu"
    )
    for m in (gpu, cpu):
        m.compile(loss_type=LossType.LOSS_BINARY_CROSSENTROPY)
    cpu.set_parameters({name: gpu.get_weights(name) for name in gpu.get_parameters()})
    n = 2 * bs + 37
    feeds, _ = random_batches(cfg, n, seed=SEED + 1)
    before = dot_interaction.launches
    y_gpu = gpu.predict(feeds)
    gpu_launches = dot_interaction.launches - before
    y_cpu = cpu.predict(feeds)
    err = float(np.abs(y_gpu - y_cpu).max())
    res = {"examples": n, "gpu_launches": gpu_launches, "max_abs_err": err, "atol": E2E_ATOL}
    log(f"[parity] CUDA kernel path vs CPU plain f32: {json.dumps(res)}")
    if gpu_launches != 3:
        raise AssertionError(f"CUDA parity model launched the kernel {gpu_launches} times, not 3")
    if not np.isfinite(y_gpu).all() or err > E2E_ATOL:
        raise AssertionError(f"CUDA and CPU predictions disagree: {res}")


def main() -> None:
    phase_device()
    phase_build()
    k3 = phase_kernels()
    launches = phase_path()
    phase_parity()
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
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
