"""Per-op profiling and observability.

PyTorch counterpart of `dlrm_flexflow_tpu/utils/profiling.py`:
  op_timing_report  each op's forward alone on its staged inputs (one pass
                    of the graph records every op's inputs, `OpContext.
                    taps`), timed by CUDA events around `reps` calls after
                    a warm-up on CUDA, by perf_counter on the CPU; rows of
                    {name, type, ms, flops, bytes};
  print_op_timings  the reference's "[Linear] name forward time = ...ms";
  trace             a torch.profiler timeline that TensorBoard loads;
  export_task_graph the compute graph as Graphviz DOT, each op with its
                    cost_stats: the JAX package's text byte for byte;
  log_shardings     one row a parameter: this rank's shape, device and the
                    plan's placement of it (the port keeps a rank's tensors,
                    where the JAX package prints a NamedSharding);
  check_numerics    the ops whose outputs hold a NaN or an Inf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import torch


def _tapped_pass(model, feeds) -> tuple:
    """(staged inputs, {"op:i": output}) of one forward of `feeds`."""
    model._require_compiled()
    ctx = dataclasses.replace(model._ctx, training=False, taps={})
    staged = model._stage(model._host_tail_feeds(feeds, train=False))
    with torch.inference_mode():
        model.graph.execute(model._params, staged, ctx)
    return staged, ctx.taps


def _op_ms(fn, device: torch.device, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def op_timing_report(model, feeds: Dict[str, object], reps: int = 10, warmup: int = 2) -> List[Dict[str, object]]:
    """Each op's forward alone (the reference's per-op brackets, the JAX
    package's `op_timing_report`): one pass records every op's inputs,
    then each op runs `warmup` and `reps` times on them. Returns [{name,
    type, ms, flops, bytes}] in graph order."""
    from ..core.graph import InputOp

    staged, taps = _tapped_pass(model, feeds)
    run_ctx = dataclasses.replace(model._ctx, training=False)
    rows: List[Dict[str, object]] = []
    for op in model.graph.compute_ops:
        xs = [staged[t.owner_op.name] if isinstance(t.owner_op, InputOp) else taps[f"{t.owner_op.name}:{t.owner_idx}"]
              for t in op.inputs]
        params = model._params.get(op.name, {})

        def fn(op=op, params=params, xs=xs):
            with torch.inference_mode():
                return op.forward(params, xs, run_ctx)

        ms = _op_ms(fn, model.device, reps, warmup)
        stats = op.cost_stats()
        rows.append({"name": op.name, "type": type(op).__name__, "ms": ms,
                     "flops": stats.get("flops", 0.0), "bytes": stats.get("bytes", 0.0)})
    return rows


def print_op_timings(rows: List[Dict[str, object]]) -> None:
    """The reference's print format: '[Linear] forward time = 0.123ms'."""
    for r in rows:
        gflops = r["flops"] / max(r["ms"], 1e-9) / 1e6
        print(f"[{r['type']}] {r['name']} forward time = {r['ms']:.4f}ms ({gflops:.1f} GFLOP/s)")


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler timeline of the block (CPU and, where there is one,
    CUDA activity), written under `logdir` as a `*.pt.trace.json` file that
    TensorBoard's profiler plugin loads."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def export_task_graph(model, path: str) -> None:
    """The compute graph as Graphviz DOT, each op labelled with its type and
    cost_stats (the reference's --export-strategy-task-graph-file)."""
    lines = ["digraph taskgraph {", '  rankdir="LR";']
    for op in model.graph.inputs:
        lines.append(f'  "{op.name}" [shape=box, style=dashed];')
    for op in model.graph.compute_ops:
        s = op.cost_stats()
        label = (f"{op.name}\\n{type(op).__name__}\\n"
                 f"{s.get('flops', 0) / 1e6:.1f}MF {s.get('bytes', 0) / 1e6:.1f}MB")
        lines.append(f'  "{op.name}" [label="{label}"];')
        for t in op.inputs:
            lines.append(f'  "{t.owner_op.name}" -> "{op.name}";')
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _placement(model, op_name: str, key: str) -> str:
    from ..ops.embedding_collection_op import EmbeddingCollection

    mesh = model.mesh
    if mesh is None:
        return "one device"
    if key in model._model_parallel.get(op_name, ()):
        return f"column block {mesh.model_index} of {mesh.model_size} over 'model'"
    op = model._op(op_name)
    if isinstance(op, EmbeddingCollection) and op.shard is not None:
        return f"shard {op.shard} of {op.layout.num_shards} over 'data'"
    return "replicated"


def log_shardings(model) -> List[str]:
    """One row a parameter of this rank: its shape, device and placement
    (the reference's --log-instance-creation)."""
    rows = []
    for name, sub in (model._params or {}).items():
        for pname, t in sub.items():
            rows.append(f"param {name}/{pname} shape={tuple(t.shape)} dtype={t.dtype} device={t.device} "
                        f"spec={_placement(model, name, pname)}")
    return rows


def check_numerics(model, feeds, labels) -> Dict[str, str]:
    """{op output: 'nan' | 'inf'} of every floating output of one forward
    that holds a NaN or an Inf."""
    _, taps = _tapped_pass(model, feeds)
    bad: Dict[str, str] = {}
    for k, v in taps.items():
        if not torch.is_floating_point(v):
            continue
        if torch.isnan(v).any():
            bad[k] = "nan"
        elif torch.isinf(v).any():
            bad[k] = "inf"
    return bad
