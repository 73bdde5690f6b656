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
  check_numerics    the ops whose outputs hold a NaN or an Inf;
  span              a named host span: its count, host and self seconds
                    added to a process-wide registry, always, and under a
                    running profiler also a `record_function` range;
  op_range          a range under a running profiler only, with no totals
                    (the op loop's `op:<name>`: a gap in the trace names its
                    op);
  step_phases       the train step's device phase stamps (`PHASES`, and the
                    `SUB_PHASES` that an op cuts out of one): a one-thread
                    kernel reads the card's %globaltimer at each phase
                    boundary and adds the time since the last stamp to a
                    device accumulator, in the step's stream order, so a
                    captured step's replays time their phases with no host
                    read; on the CPU the same boundaries read
                    `perf_counter_ns`;
  count             a named counter of the work a step hands a layer (the
                    row update's ids): added once a call, and once a replay
                    where the call was captured;
  span_totals       the registry, the counters and the phase totals as a
                    plain dict;
  reset_spans       empties them.

Names of the spans, ranges and phases are part of the interface (PERF.md,
section 3, lists each with its reader). Spans are opened from one thread at
a time. A span opened inside `capturing()` (the block in which the port
captures its train step in a CUDA graph) adds nothing to the totals: the
replays do that work, not the host. The block is the port's own flag, not a
query of the stream's capture state, which costs microseconds a call on the
card's host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler


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


# ------------------------------------------------------------------ spans and phases
_now = time.perf_counter_ns
_SPANS: Dict[str, "_Span"] = {}  # name -> its totals, one object a name
_TOP = None  # the innermost open span
_NO_RANGE = contextlib.nullcontext()
_COUNTERS: Dict[str, List[int]] = {}  # name -> [calls, total]
_CAPTURES: List[Dict[str, int]] = []  # the open `capturing()` blocks, each its counts


class _Span:
    """One span name's totals and its open call: `span(name)` hands out the
    same object each call, so a span makes no object. A name opened inside
    itself gets an object of its own that adds to the name's totals
    (`into`)."""

    __slots__ = ("name", "numbered", "into", "count", "ns", "self_ns", "parent", "first_ns", "t0", "up",
                 "range")

    def __init__(self, name: str, numbered: bool, into: "_Span" = None):
        self.name, self.numbered, self.into = name, numbered, into if into is not None else self
        self.count = self.ns = self.self_ns = self.first_ns = self.t0 = 0
        self.parent = None

    def __enter__(self) -> "_Span":
        global _TOP
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name,
                                                        str(self.into.count) if self.numbered else None)
            self.range.__enter__()
        else:
            self.range = None
        self.up, _TOP = _TOP, self
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        global _TOP
        dt = _now() - self.t0
        self.t0 = 0
        _TOP = up = self.up
        if self.range is not None:
            self.range.__exit__(*exc)
        if _CAPTURES:
            return False
        if up is not None:
            up.into.self_ns -= dt  # a parent's self time is its time less its children's
        e = self.into
        if not e.count:
            e.first_ns, e.parent = dt, (up.name if up is not None else None)
        e.count += 1
        e.ns += dt
        e.self_ns += dt
        return False


def span(name: str, numbered: bool = False) -> _Span:
    """A host span `name` around a block: its count, host seconds and self
    seconds (less its child spans') go to the registry, and its first call's
    host seconds apart (a process's one-time set-up, such as a kernel's
    build, lands there); while a profiler records (torch.profiler sets
    `_is_profiler_enabled`) it is also a `record_function` range on the
    trace's clock. With `numbered` (fixed by a name's first span), the
    range's args are the call's sequence number (the span's count before
    it), so the ranges of one call share an identifier. With no profiler it
    costs two clock reads and a few attribute updates."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name, numbered)
    elif s.t0:  # open: the name nests in itself
        s = _Span(name, s.numbered, into=s)
    return s


def op_range(name: str):
    """A `record_function` range `name` while a profiler records; otherwise
    nothing. Keeps no totals."""
    return torch.profiler.record_function(name) if _autograd_profiler._is_profiler_enabled else _NO_RANGE


@contextlib.contextmanager
def capturing():
    """The block in which the port captures a step in a CUDA graph: spans
    opened in it add nothing to the totals. Yields a dict that collects the
    block's `count` calls, which the graph's owner adds at each replay
    (`add_counts`)."""
    _CAPTURES.append({})
    try:
        yield _CAPTURES[-1]
    finally:
        _CAPTURES.pop()


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` (one call more); inside `capturing()` to
    the block's dict instead, for the replays to add."""
    if _CAPTURES:
        block = _CAPTURES[-1]
        block[name] = block.get(name, 0) + int(n)
        return
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = [0, 0]
    c[0] += 1
    c[1] += int(n)


def add_counts(counts: Dict[str, int]) -> None:
    """One replay of a captured block's counts (`capturing()`'s dict)."""
    for name, n in counts.items():
        count(name, n)


# the train step's phases, in order (FFModel._step)
PHASES = ("phase:lookup", "phase:forward", "phase:loss", "phase:backward", "phase:dense_reduce",
          "phase:dense_update", "phase:sparse_update")
# blocks that an op cuts out of the step's forward and backward
# (`_StepPhases.cut`): the time between the sub-phase's start and end is the
# sub-phase's, and the phase around it keeps the rest and one count a step
SUB_PHASES = ("phase:cross_forward", "phase:cross_backward")
_SLOTS = PHASES + SUB_PHASES


class _PhaseClock:
    """One device's phase totals, [ns of each phase, count of each phase,
    the last stamp's time] as int64: on CUDA a device tensor that the stamp
    kernel updates, on the CPU a list that `perf_counter_ns` updates."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        n = 2 * len(_SLOTS) + 1
        if self.cuda:
            from ..ops.kernels.phase_stamp import stamper

            self.acc = torch.zeros(n, dtype=torch.int64, device=device)
            self._launch = stamper(self.acc, len(_SLOTS))  # checked and bound once
        else:
            self.acc = [0] * n

    def stamp(self, slot: int, counted: bool = True) -> None:
        """The time since the last stamp added to phase `slot`, and one to
        its count unless `counted` is false; slot -1 (a step's first stamp)
        only sets the time."""
        if self.cuda:
            self._launch(slot, counted)
            return
        now, acc, n = _now(), self.acc, len(_SLOTS)
        if slot >= 0:
            acc[slot] += now - acc[-1]
            acc[n + slot] += int(counted)
        acc[-1] = now

    def read(self) -> List[int]:
        if not self.cuda:
            return list(self.acc)
        torch.cuda.synchronize(self.device)
        return self.acc.tolist()

    def reset(self) -> None:
        if self.cuda:
            self.acc.zero_()
        else:
            self.acc[:] = [0] * len(self.acc)


_CLOCKS: Dict[str, _PhaseClock] = {}


def _clock(device: torch.device) -> _PhaseClock:
    """The device's phase clock, made on first use (a model's first step,
    eager); it outlives every model."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in _CLOCKS:
        if _CAPTURES:  # a capture would record the fill and replay it
            raise RuntimeError("the phase clock is made outside a CUDA graph capture: run the step once first")
        _CLOCKS[key] = _PhaseClock(device)
    return _CLOCKS[key]


class _Phase:
    __slots__ = ("steps", "slot", "range")

    def __init__(self, steps: "_StepPhases", name: str):
        self.steps, self.slot = steps, PHASES.index(name)

    def __enter__(self):
        self.range = op_range(PHASES[self.slot])
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.range.__exit__(*exc)
        if self.steps.clock is not None:
            self.steps.clock.stamp(self.slot)
        return False


class _StampOnBackward(torch.autograd.Function):
    """The identity, whose backward stamps (`stamp()`) when the gradient of
    its output is whole, before passing it on."""

    @staticmethod
    def forward(ctx, x, stamp):
        ctx.stamp = stamp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.stamp()
        return g, None


class _StepPhases:
    def __init__(self, device: torch.device, timed: bool):
        clock = _clock(device)  # made by the first step, eager, whether it is timed or not
        self.clock = clock if timed else None
        if self.clock is not None:
            self.clock.stamp(-1)

    def __call__(self, name: str) -> _Phase:
        return _Phase(self, name)

    def cut(self, name: str, x, body):
        """`body(x)`, run inside `phase:forward`, as the sub-phase
        `phase:<name>_forward`: the forward's time up to here is stamped
        uncounted, and the sub-phase at its end. Its backward is
        `phase:<name>_backward`, cut out of `phase:backward` alike: autograd
        stamps the backward (uncounted) when the gradient of `body`'s output
        is whole, and the sub-phase when that of `x` is. `x` and the output
        are single tensors."""
        if self.clock is None:
            return body(x)
        clock, forward, backward = self.clock, _SLOTS.index("phase:forward"), _SLOTS.index("phase:backward")
        inner, inner_back = _SLOTS.index(f"phase:{name}_forward"), _SLOTS.index(f"phase:{name}_backward")
        clock.stamp(forward, counted=False)
        x = _StampOnBackward.apply(x, lambda: clock.stamp(inner_back))
        with op_range(_SLOTS[inner]):
            y = body(x)
        clock.stamp(inner)
        return _StampOnBackward.apply(y, lambda: clock.stamp(backward, counted=False))


def step_phases(device: torch.device, timed: bool = True) -> _StepPhases:
    """The phase boundaries of one train step on `device`: stamps the step's
    start; `phases(name)` is a block whose end stamps phase `name` (one of
    `PHASES`), and which under a running profiler is also a range;
    `phases.cut(...)` cuts a sub-phase (`SUB_PHASES`) out of one, forward
    and backward. With `timed` false nothing is stamped (a warm-up step,
    whose first kernel loads and library set-up are not the step's work)."""
    return _StepPhases(device, timed)


def span_totals() -> Dict[str, Dict[str, object]]:
    """The registry as a plain dict: each host span's {count, host_s,
    self_s, parent, first_s}, each counter's {count, total} (its calls and
    the sum of what they added), then each phase and sub-phase stamped since
    the last reset as {count, device_s}, summed over this process's devices
    (on CUDA after a synchronisation: a replay's stamps land when it has
    run)."""
    out: Dict[str, Dict[str, object]] = {
        name: {"count": s.count, "host_s": s.ns / 1e9, "self_s": s.self_ns / 1e9, "parent": s.parent,
               "first_s": s.first_ns / 1e9}
        for name, s in _SPANS.items() if s.count}
    out.update({name: {"count": c, "total": t} for name, (c, t) in _COUNTERS.items()})
    n = len(_SLOTS)
    for clock in _CLOCKS.values():
        acc = clock.read()
        for i, name in enumerate(_SLOTS):
            if acc[n + i]:
                entry = out.setdefault(name, {"count": 0, "device_s": 0.0})
                entry["count"] += acc[n + i]
                entry["device_s"] += acc[i] / 1e9
    return out


def reset_spans() -> None:
    """Empties the registry and the counters and zeroes every device's phase
    totals in place (a captured step keeps stamping into the same
    accumulator)."""
    _SPANS.clear()
    _COUNTERS.clear()
    for clock in _CLOCKS.values():
        clock.reset()
