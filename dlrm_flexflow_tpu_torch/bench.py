"""The PyTorch port's benchmark: DLRM training or serving examples/s.

    python -m dlrm_flexflow_tpu_torch.bench                      # kaggle training, batch 65536, host-routed
    python -m dlrm_flexflow_tpu_torch.bench --config mlperf-lite --mode infer
    python -m dlrm_flexflow_tpu_torch.bench --device cpu --config tiny --batch-size 64 --quick
    python -m dlrm_flexflow_tpu_torch.bench --config mlperf-full --quick   # host-tail offload
    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m dlrm_flexflow_tpu_torch.bench --mesh
    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m dlrm_flexflow_tpu_torch.bench --mesh \
        --config mlperf-full --quick                             # host-tail offload on 4 cards

The port of the root `bench.py`, with its flags, defaults and protocol
(`bench.py:245-375`): 4 batches from `random_batches` (indices Zipf with
`--zipf`); under `--host-routing` (the default) each batch's routes are
computed by `FFModel.compute_routes` before any timing; batches and routes
are staged on the device and stacked [4, B, ...]; for `--mode infer` with a
`--table-dtype` other than float32 the tables are quantized
(`quantize_embeddings`) after staging; `--warmup` steps run first (at least
one when training: it captures the train step); the timed window runs from
`torch.cuda.synchronize()` through `--steps` steps on the staged batches,
round robin, to the host readback of the loss or of the summed outputs.
Training steps are `FFModel.train_chunk` calls on the stack: on CUDA each
step is a replay of one train step captured in a CUDA graph, as the JAX
bench scans its steps inside one compiled call, so the host's time to launch
a step's kernels is not in the number. Serving steps are eager `forward`
calls, one a batch. The `#` line says which was timed (`steps=graph` or
`steps=eager`). The entry runs on CUDA unless `--device cpu` is given (steps
there are eager); a CUDA run without a card fails.

Prints one JSON line with `bench.py`'s keys (metric, value, unit,
examples_per_sec_per_chip, devices, table_dtype, packed_engaged: an op took
the row-update kernel route, loss) and a `#` line on stderr that names the
card and its power limit. The TPU anchors (vs_baseline) are a TPU's
numbers and are not printed.

`--config mlperf-full` (the unclipped Criteo Terabyte vocabs, 882,774,559
rows) trains under host-tail offload, as the JAX bench does (`bench.py:
158-166`, `:254-300`): `--host-tail-threshold` defaults to 2^20 there, the
exchange's capacity is a quarter of a batch's lookups, the indices are
Zipf(1.05) unless `--zipf` says otherwise, and only `--mode train` runs. A
host-tail step cannot be one graph (the host serves and updates the tail
rows between steps), so those steps are eager `train_batch` calls on the
numpy batches (`steps=eager`), the host's work included; the `#` line and
the JSON add `host_tail_tables`, `host_tail_touched_rows` and
`host_tail_drop_fraction`. `--onehot-packed-threshold N` makes the tables
with a vocab in (`--onehot-threshold`, N] mid-band tables (one-hot lookup,
dense gradients), which graph replays capture. Under `--mesh` the
host-tail tables are replicated sparse tables beside the sharded collection
and every rank runs the global batch's host half (`FFModel` under a mesh);
the steps stay eager, rank 0 prints, and `devices` and
`examples_per_sec_per_chip` are the world's.

`--mesh` trains (or serves) hybrid-parallel over every rank of the
launcher's world (`bench.py:190-210`): `launch.initialize`, `make_mesh`,
`compile(mesh=, plan=dlrm_hybrid_plan())`; every rank is given the global
batch of `--batch-size` (staged on its device) and takes its slice.
Training steps are `train_chunk` calls on the [4, B, ...] stack, so on CUDA
each is a replay of one captured step that holds the exchange's
all-to-alls and the all-reduces (`steps=graph`), as the JAX bench times one
scanned dispatch (`bench.py:239-242`); serving steps are eager `forward`
calls (`steps=eager`), as are the steps on the CPU. Rank 0 prints the keys, with
`devices` the world size, `examples_per_sec_per_chip` the global rate over
it, and `all_to_all_gbps`, the layout's `step_exchange_bytes` at the
pool's element size (the JAX bench counts the compute dtype's; both are 2
bytes under the default bf16 tables) over the timed window. A world of one
is refused, as the JAX bench takes the mesh only with more than one
device. --packed-gather-mode, --packed-stream-mode and
--packed-selective choose among the JAX package's packed-layout variants;
the port keeps [V, D] tables with one gather and one update stream, so they
are taken and change nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from . import AdamOptimizer, FFConfig, LossType, MetricsType, SGDOptimizer
from .data.synthetic import random_batches
from .launch import initialize
from .models.dlrm import (
    kaggle_config,
    make_dlrm_model,
    mlperf_config,
    mlperf_lite_config,
    summit_config,
    summit_large_config,
    tiny_config,
)
from .parallel.mesh import make_mesh
from .parallel.plan import dlrm_hybrid_plan

CONFIGS = {
    "tiny": tiny_config,
    "kaggle": kaggle_config,
    "mlperf": lambda batch_size: mlperf_config(batch_size=batch_size, num_tables=8),
    "mlperf-lite": mlperf_lite_config,
    "mlperf-full": mlperf_config,
    "summit": summit_config,
    "summit-large": summit_large_config,
}
N_BATCHES = 4


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="kaggle", choices=list(CONFIGS))
    ap.add_argument("--host-tail-threshold", type=int, default=0,
                    help="host-tail offload: tables above it keep this many rows on the device, "
                         "the rest in host RAM (mlperf-full: 2^20 unless given)")
    ap.add_argument("--batch-size", type=int, default=65536)
    ap.add_argument("--packed-tables", default="auto", choices=["auto", "on", "off"],
                    help="the row-update kernel route (auto: on CUDA)")
    ap.add_argument("--packed-gather-mode", default="auto", choices=["auto", "pack", "subpack"],
                    help="the JAX package's packed gather variants; no effect in the port")
    ap.add_argument("--packed-stream-mode", default="auto", choices=["auto", "expanded", "compact"],
                    help="the JAX package's packed update-stream formats; no effect in the port")
    ap.add_argument("--host-routing", action=argparse.BooleanOptionalAction, default=True,
                    help="sort each batch's row-update streams on the host before timing and "
                         "stage them with the batch (--no-host-routing sorts on the device)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--quick", action="store_true", help="10 steps, 3 warm-up")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--zipf", type=float, default=0.0,
                    help="Zipf exponent of the synthetic indices (0 = uniform)")
    ap.add_argument("--packed-selective", default="on", choices=["on", "off"],
                    help="the JAX package's touched-chunk dispatch; no effect in the port")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--mesh", action="store_true",
                    help="hybrid-parallel over the launcher's ranks (run under "
                         "python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node N)")
    ap.add_argument("--mode", default="train", choices=["train", "infer"])
    ap.add_argument("--onehot-threshold", type=int, default=8192,
                    help="vocab bound of the one-hot lookup path")
    ap.add_argument("--onehot-packed-threshold", type=int, default=0,
                    help="vocab bound of the mid-band tables (one-hot lookup, dense gradients); "
                         "0 = off")
    ap.add_argument("--table-dtype", default="auto",
                    choices=["auto", "float32", "bfloat16", "float16", "int8"],
                    help="train: float32 or bfloat16 route tables (auto: bfloat16); infer: the "
                         "tables quantized after staging (auto: float32, none)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (plain versions, for tests)")
    return ap


def check_ported(ap: argparse.ArgumentParser, args) -> None:
    """Resolve --table-dtype and mlperf-full's host tail as bench.py does."""
    if args.config == "mlperf-full":
        if args.mode != "train":
            ap.error("mlperf-full supports --mode train only (host-tail offload)")
        if args.host_tail_threshold == 0:
            args.host_tail_threshold = 1 << 20
    if args.table_dtype == "auto":
        args.table_dtype = "bfloat16" if args.mode == "train" else "float32"
    if args.mode == "train" and args.table_dtype not in ("float32", "bfloat16"):
        ap.error("train supports --table-dtype float32|bfloat16")


def card(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        limit = smi.strip().splitlines()[index].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name(device)}, {limit}"


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    explicit_table_dtype = args.table_dtype != "auto"
    if args.quick:
        args.steps, args.warmup = 10, 3
    if args.steps < 1 or args.warmup < 0:
        ap.error("--steps must be at least 1 and --warmup at least 0")
    check_ported(ap, args)
    with _world(args) as mesh:
        return _run(ap, args, mesh, explicit_table_dtype)


@contextlib.contextmanager
def _world(args):
    """Under --mesh, the launcher's world as a mesh (the process group
    joined here is left at the end), else None."""
    if not args.mesh:
        yield None
        return
    joined = not dist.is_initialized()
    initialize(args.device)
    try:
        mesh = make_mesh(device=args.device)
        if mesh.size == 1:
            raise ValueError("--mesh needs a world of more than one rank: run it under python -m "
                             "dlrm_flexflow_tpu_torch.launch --nproc-per-node N")
        yield mesh
    finally:
        if joined:
            dist.destroy_process_group()


def _run(ap, args, mesh, explicit_table_dtype) -> dict:
    device = mesh.device if mesh is not None else torch.device(args.device)
    bs = args.batch_size
    cfg = CONFIGS[args.config](batch_size=bs)
    ffc = FFConfig(batch_size=bs, compute_dtype=args.compute_dtype, packed_tables=args.packed_tables,
                   packed_gather_mode=args.packed_gather_mode,
                   packed_stream_mode=args.packed_stream_mode,
                   packed_selective=args.packed_selective,
                   onehot_embedding_threshold=args.onehot_threshold,
                   onehot_packed_threshold=args.onehot_packed_threshold,
                   host_routing=args.host_routing)
    if args.host_tail_threshold > 0:
        # Zipf(1.05) ids at hot = 2^20 send about a fifth of the lookups to
        # the tail; a quarter of the batch's lookups leaves slack
        ffc.host_tail_threshold, ffc.host_tail_cap_frac = args.host_tail_threshold, 0.25
    if args.mode == "train" and args.table_dtype != "float32":
        ffc.table_dtype = args.table_dtype
    model = make_dlrm_model(cfg, ffc, device=device)
    optimizer = AdamOptimizer(alpha=0.001) if args.optimizer == "adam" else SGDOptimizer(lr=0.01)
    model.compile(optimizer, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                  mesh=mesh, plan=dlrm_hybrid_plan() if mesh is not None else None)

    # what engaged (bench.py:213-237): bf16 storage exists only on the route
    layout = model._embedding_layout
    packed_engaged = any(op.kernel_route for op in model._sparse_ops) or bool(layout and layout.packed_pool)
    effective_table_dtype = args.table_dtype
    if args.mode == "train" and args.table_dtype == "bfloat16" and not any(
            op.table_dtype is not None for op in model._sparse_ops):
        msg = ("--table-dtype bfloat16 requested but no op engaged bf16 table storage (the "
               "row-update route is off: device, --packed-tables, batch volume or optimizer); "
               "measuring f32 tables")
        if explicit_table_dtype:
            ap.error(msg)
        print(f"# WARNING: {msg}", file=sys.stderr)
        effective_table_dtype = "float32"

    zipf = args.zipf if args.zipf > 0 else (1.05 if args.host_tail_threshold > 0 else 0.0)
    feeds_np, labels_np = random_batches(cfg, bs * N_BATCHES, seed=0, learnable=False, zipf=zipf)
    if model._host_tail is not None:
        return host_tail_run(args, model, mesh, feeds_np, labels_np, device, effective_table_dtype,
                             packed_engaged)
    if mesh is not None:
        return mesh_run(args, model, mesh, feeds_np, labels_np, effective_table_dtype, packed_engaged)
    routed = args.mode == "train" and args.host_routing and packed_engaged
    batches = []
    for j in range(N_BATCHES):
        feeds = {k: v[j * bs:(j + 1) * bs] for k, v in feeds_np.items()}
        staged = model._stage(feeds)
        if routed:
            staged.update(model.stage_routes(model.compute_routes(feeds)))
        batches.append((staged, model._stage_labels(labels_np[j * bs:(j + 1) * bs])))
    if args.mode == "train":
        stacked = {k: torch.stack([f[k] for f, _ in batches]) for k in batches[0][0]}
        stacked_labels = torch.stack([lbl for _, lbl in batches])
    elif args.table_dtype != "float32":
        n_cast = model.quantize_embeddings(args.table_dtype)
        print(f"# quantized {n_cast} embedding arrays to {args.table_dtype}", file=sys.stderr)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run(n: int) -> torch.Tensor:
        """n steps over the staged batches, round robin: the last loss, or
        the summed outputs."""
        if args.mode == "infer":
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n):
                acc += model.forward(batches[i % N_BATCHES][0]).float().sum()
            return acc
        for i in range(0, n, N_BATCHES):
            k = min(N_BATCHES, n - i)
            loss = model.train_chunk({name: v[:k] for name, v in stacked.items()}, stacked_labels[:k])
        return loss

    if args.mode == "train" or args.warmup:
        run(max(args.warmup, 1 if args.mode == "train" else 0))
    sync()
    t0 = time.perf_counter()
    value = float(run(args.steps))
    dt = time.perf_counter() - t0
    examples_per_sec = args.steps * bs / dt
    loss = value if args.mode == "train" else 0.0  # infer: no loss, as bench.py
    timed = "graph" if args.mode == "train" and device.type == "cuda" else "eager"
    print(f"# config={args.config} mode={args.mode} bs={bs} n_steps={args.steps} dt={dt}s "
          f"steps={timed} device={card(device)} host_routing={'yes' if routed else 'no'} "
          f"table_dtype={effective_table_dtype} packed={'yes' if packed_engaged else 'no'} "
          f"examples/s={examples_per_sec} loss={loss}", file=sys.stderr)
    result = {
        "metric": f"dlrm_{args.config}_{args.mode}_examples_per_sec",
        "value": examples_per_sec,
        "unit": "examples/s",
        "examples_per_sec_per_chip": examples_per_sec,
        "devices": 1,
        "table_dtype": effective_table_dtype,
        "packed_engaged": packed_engaged,
        "loss": loss,
    }
    print(json.dumps(result))
    return result


def mesh_run(args, model, mesh, feeds_np, labels_np, table_dtype, packed_engaged) -> dict:
    """The hybrid-parallel bench: the global batches staged on this rank's
    device beforehand and stacked [4, B, ...]; training steps are
    `train_chunk` calls (graph replays on CUDA, each rank on its slice),
    serving steps eager `forward` calls, round robin; rank 0 prints."""
    bs, device = args.batch_size, mesh.device
    batches = [({k: torch.as_tensor(v[j * bs:(j + 1) * bs]).to(device) for k, v in feeds_np.items()},
                torch.as_tensor(labels_np[j * bs:(j + 1) * bs]).to(device)) for j in range(N_BATCHES)]
    stacked = {k: torch.stack([f[k] for f, _ in batches]) for k in batches[0][0]}
    stacked_labels = torch.stack([lbl for _, lbl in batches])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run(n: int) -> torch.Tensor:
        out = torch.zeros((), dtype=torch.float32, device=device)
        if args.mode == "train":
            for i in range(0, n, N_BATCHES):
                k = min(N_BATCHES, n - i)
                out = model.train_chunk({name: v[:k] for name, v in stacked.items()}, stacked_labels[:k])
            return out
        for i in range(n):
            out = out + model.forward(batches[i % N_BATCHES][0]).float().sum()
        return out

    run(max(args.warmup, 1))
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    value = float(run(args.steps))
    dt = time.perf_counter() - t0
    examples_per_sec = args.steps * bs / dt
    loss = value if args.mode == "train" else 0.0
    pool = next((sub["pool"] for sub in model.get_parameters().values() if "pool" in sub), None)
    a2a_gbps = 0.0 if pool is None else (model._embedding_layout.step_exchange_bytes(
        bs, dtype_bytes=pool.element_size()) * args.steps / dt / 1e9)
    result = {
        "metric": f"dlrm_{args.config}_{args.mode}_examples_per_sec",
        "value": examples_per_sec,
        "unit": "examples/s",
        "examples_per_sec_per_chip": examples_per_sec / mesh.size,
        "devices": mesh.size,
        "all_to_all_gbps": a2a_gbps,
        "table_dtype": table_dtype,
        "packed_engaged": packed_engaged,
        "loss": loss,
    }
    timed = "graph" if args.mode == "train" and device.type == "cuda" else "eager"
    if mesh.rank == 0:
        print(f"# config={args.config} mode={args.mode} bs={bs} n_steps={args.steps} dt={dt}s steps={timed} "
              f"devices={mesh.size} device={card(device)} mesh=yes table_dtype={table_dtype} "
              f"packed={'yes' if packed_engaged else 'no'} examples/s={examples_per_sec} "
              f"per-chip={examples_per_sec / mesh.size} all-to-all={a2a_gbps}GB/s loss={loss}",
              file=sys.stderr)
        print(json.dumps(result))
    return result


def host_tail_run(args, model, mesh, feeds_np, labels_np, device, table_dtype, packed_engaged) -> dict:
    """The host-tail bench (bench.py:254-300): eager train_batch steps on
    the numpy batches, round robin, the host's work inside the timing;
    under a mesh every rank steps on the global batches and rank 0
    prints."""
    bs = args.batch_size
    n = 1 if mesh is None else mesh.size
    batches = [({k: v[j * bs:(j + 1) * bs] for k, v in feeds_np.items()}, labels_np[j * bs:(j + 1) * bs])
               for j in range(N_BATCHES)]
    for i in range(max(args.warmup, 1)):
        loss = model.train_batch(*batches[i % N_BATCHES])
    float(loss)
    if mesh is not None:
        dist.barrier()
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = model.train_batch(*batches[i % N_BATCHES])
    loss_val = float(loss)
    dt = time.perf_counter() - t0
    examples_per_sec = args.steps * bs / dt
    entries = model._host_tail.entries
    touched = sum(e[0].touched_rows for e in entries.values())
    drop = model.host_tail_drop_fraction()
    result = {
        "metric": f"dlrm_{args.config}_train_examples_per_sec",
        "value": examples_per_sec,
        "unit": "examples/s",
        "examples_per_sec_per_chip": examples_per_sec / n,
        "host_tail_tables": len(entries),
        "host_tail_touched_rows": int(touched),
        "host_tail_drop_fraction": drop,
        "devices": n,
        "table_dtype": table_dtype,
        "packed_engaged": packed_engaged,
        "loss": loss_val,
    }
    if mesh is None or mesh.rank == 0:
        print(f"# config={args.config} mode=train bs={bs} n_steps={args.steps} dt={dt}s steps=eager "
              f"devices={n} device={card(device)} mesh={'yes' if mesh is not None else 'no'} "
              f"host-tail tables={len(entries)} touched_rows={touched} drop_frac={drop} "
              f"table_dtype={table_dtype} packed={'yes' if packed_engaged else 'no'} "
              f"examples/s={examples_per_sec} per-chip={examples_per_sec / n} loss={loss_val}", file=sys.stderr)
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
