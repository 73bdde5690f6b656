"""Machine models for the strategy search, and their calibration on the card.

PyTorch counterpart of `dlrm_flexflow_tpu/autotune/machine.py`.
`MachineSpec` has the JAX package's fields, defaults and file format, so a
machine file that either package saved loads in the other unchanged
(`from_file`, `save`); `preset` has the JAX package's presets and `"h100"`.

The calibrators time the port's own code on the device, each timed region
a CUDA graph of `repeats` calls replayed between CUDA events (no host
launch, no synchronize inside it; on the CPU, which only the tests use, a
loop under `time.perf_counter`):
  calibrate            the forward row gather (`ops/embedding.py`
                       `embedding_bag`) and the scatter rule's row add (the
                       SGD `sparse_row_update`), 8 tables at once
                       -> gather_gbps, scatter_gbps;
  calibrate_packed     the row-update kernel (K1, `ops/kernels/row_update.
                       py` `row_update`, its stream sort included) at the
                       JAX package's four (K, tables, V) points on [V, D]
                       tables of the table dtype -> update_pass_gbps,
                       update_ns_per_row, update_us_per_table and the
                       step's fixed term;
  calibrate_dense      `ops/dense.py` forward and backward at the graph's
                       Dense shapes -> dense_costs;
  calibrate_graph_ops  conv, batch-matmul, attention and LSTM forward and
                       backward through torch.autograd -> op_costs;
  measure_dispatch_latency  one launch and a synchronize.

The JAX package also measures two variants of its packed gather and of its
update stream and records the winners (`gather_mode`, `stream_mode` and
their `*_by_dim` maps). The port has one kernel for each: it keeps those
fields so that a machine file round-trips, and they select nothing.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..ffconst import AggrMode, OperatorType
from .bindings import FFSimMachine

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core and plain f32 peaks,
# HBM3 bandwidth, NVLink 4 (900 GB/s a card, both directions together)
H100_BF16_TFLOPS = 989.0
H100_F32_TFLOPS = 67.0
H100_HBM_GBPS = 3350.0
H100_NVLINK_GBPS = 450.0  # one direction


@dataclasses.dataclass
class MachineSpec:
    name: str = "tpu_v5e"
    num_chips: int = 1
    chips_per_host: int = 4
    mxu_tflops: float = 197.0  # the JAX package's TPU v5e figures
    hbm_gbps: float = 820.0
    hbm_capacity_gb: float = 14.0
    ici_gbps: float = 45.0
    ici_latency_us: float = 1.0
    dcn_gbps: float = 25.0
    dcn_latency_us: float = 10.0
    gather_gbps: float = 30.0
    scatter_gbps: float = 1.1
    step_overhead_us: float = 30.0
    segment_bytes: float = 16777216.0
    max_segments: float = 1.0
    overlap_backward_update: float = 0.0
    hierarchical_a2a: float = 1.0
    ici_axis_x: int = 0
    ici_axis_y: int = 0
    ici_domain: int = 0
    update_pass_gbps: float = 900.0
    update_ns_per_row: float = 2.0
    update_us_per_table: float = 100.0
    use_dag: int = 1
    routed_exchange: int = 0
    routed_cap: float = 2.0
    routing_ns_per_entry: float = 3.0
    model_axis: int = 1
    pcie_gbps: float = 10.0
    pcie_latency_us: float = 20.0
    host_row_ns: float = 60.0
    param_sync: int = 0
    ps_gbps: float = 0.0
    # measured / predicted step (FFModel.calibrate_step_residual); applied
    # to reported predictions, not part of the native struct
    step_residual: float = 1.0
    # the JAX package's packed-kernel variant winners: kept so a machine
    # file round-trips; the port has one kernel for each and reads none
    gather_mode: str = "pack"
    stream_mode: str = "expanded"
    gather_mode_by_dim: dict = dataclasses.field(default_factory=dict)
    stream_mode_by_dim: dict = dataclasses.field(default_factory=dict)
    # measured Dense costs {"<in>x<out>": us per example} and other ops'
    # {op_cost_sig: us per example}: (forward + backward) / 3, so the
    # model's backward = 2 x forward gives the measured total
    dense_costs: dict = dataclasses.field(default_factory=dict)
    op_costs: dict = dataclasses.field(default_factory=dict)

    def torus_for(self, n: int) -> "MachineSpec":
        """n chips as one near-square 2-D torus (8 -> 2 x 4, 16 -> 4 x 4)."""
        x = 1
        for cand in range(int(math.isqrt(n)), 0, -1):
            if n % cand == 0:
                x = cand
                break
        return dataclasses.replace(self, num_chips=n, ici_axis_x=x, ici_axis_y=n // x, ici_domain=n)

    def nvswitch_for(self, n: int) -> "MachineSpec":
        """n cards of one NVSwitch host, as the native model's 1-D ring over
        them (see `preset`)."""
        return dataclasses.replace(self, num_chips=n, ici_axis_x=n, ici_axis_y=1, ici_domain=n)

    def predict_step_us(self, raw_model_us: float) -> float:
        """The model's step times the measured step residual."""
        return raw_model_us * (self.step_residual or 1.0)

    def to_native(self) -> FFSimMachine:
        m = FFSimMachine()
        for f in FFSimMachine._fields_:
            setattr(m, f[0], getattr(self, f[0]))
        return m

    @staticmethod
    def from_file(path: str) -> "MachineSpec":
        with open(path) as f:
            return MachineSpec(**json.load(f))

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def preset(name: str, num_chips: int = 1, chips_per_host: Optional[int] = None) -> MachineSpec:
    """Built-in machine models: the JAX package's TPU presets and cpu_sim,
    with its figures, and "h100".

    "h100": NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s
    of HBM3, 80 GB, NVLink 4 at 900 GB/s a card (450 one way), 8 cards a
    host; 400 Gb/s (50 GB/s) of network a card across hosts; PCIe Gen5 x16,
    64 GB/s one way. The native model knows a 2-D torus or a ring
    (native/ffsim/ffsim.cc `a2a_slice_us`, `ar_slice_us`); an NVSwitch host
    is neither: every card reaches every other at its full NVLink rate. The
    search maps a host's n cards to the ring over them (`nvswitch_for`) at
    ici_gbps = 450, the rate a card sends (and receives) at: the ring is
    the layout whose terms come closest. Its all-to-all term, Bn/8 over 450
    GB/s, charges 4 cards B/2 where the switch moves the B(n - 1)/n = 3B/4
    that leaves a card, 2/3 of it; its all-reduce term, 2B(n - 1)/n over 2 x
    450 GB/s, is half a ring all-reduce's over the switch (2B(n - 1)/n sent
    and received a card at 450 GB/s each way). A 2-D torus (2 x 2) charges
    the same all-to-all and a quarter of the all-reduce. The measured step
    residual (`FFModel.calibrate_step_residual`) takes up what the mapping
    leaves out. The gather, scatter and row-update figures are placeholders
    until the calibrators measure them."""
    presets = {
        "tpu_v5e": MachineSpec(),
        "tpu_v5p": MachineSpec(name="tpu_v5p", mxu_tflops=459.0, hbm_gbps=2765.0, hbm_capacity_gb=90.0,
                               ici_gbps=100.0, chips_per_host=4),
        "tpu_v4": MachineSpec(name="tpu_v4", mxu_tflops=275.0, hbm_gbps=1200.0, hbm_capacity_gb=30.0,
                              ici_gbps=50.0, chips_per_host=4),
        "cpu_sim": MachineSpec(name="cpu_sim", mxu_tflops=0.2, hbm_gbps=20.0, hbm_capacity_gb=4.0,
                               ici_gbps=2.0, chips_per_host=8, gather_gbps=1.0, scatter_gbps=1.0),
        "h100": MachineSpec(name="h100", mxu_tflops=H100_BF16_TFLOPS, hbm_gbps=H100_HBM_GBPS,
                            hbm_capacity_gb=80.0, ici_gbps=H100_NVLINK_GBPS, chips_per_host=8,
                            dcn_gbps=50.0, pcie_gbps=64.0, gather_gbps=1000.0, scatter_gbps=500.0,
                            update_pass_gbps=3000.0, update_ns_per_row=0.5, update_us_per_table=10.0),
    }
    spec = dataclasses.replace(presets[name], num_chips=num_chips)
    if chips_per_host is not None:
        spec.chips_per_host = chips_per_host
    return spec


# ------------------------------------------------------------------ timing
def replay_ms(calls: Sequence[Callable[[], object]], device, warmup: int = 2) -> float:
    """Device ms a call of `calls`, run in order: on CUDA captured in one
    CUDA graph (after `warmup` of them eagerly on a side stream) and
    replayed once between CUDA events; on the CPU a loop under
    perf_counter after the warm-up."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for c in calls[:warmup]:
            c()
        t0 = time.perf_counter()
        for c in calls:
            c()
        return (time.perf_counter() - t0) * 1e3 / len(calls)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in calls[:warmup]:
                c()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for c in calls:
                c()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / len(calls)


def measure_dispatch_latency(repeats: int = 16, device="cuda") -> float:
    """Seconds of one launch of a trivial kernel and a synchronize."""
    dev = torch.device(device)
    x = torch.zeros((), device=dev)

    def once():
        x.add_(1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    once()
    t0 = time.perf_counter()
    for _ in range(repeats):
        once()
    return (time.perf_counter() - t0) / repeats


def _randint(gen, high: int, shape, device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int64).to(device)


# ------------------------------------------------------------------ calibrators
def calibrate(spec: MachineSpec, dim: int = 16, vocab: int = 1_000_000, batch: int = 8192,
              repeats: int = 20, device="cuda") -> MachineSpec:
    """Effective rates of the port's forward row gather and scatter-add,
    8 f32 [vocab, dim] tables at once (a step runs its tables' lookups
    together), other rows every repeat so the tables stay out of the L2."""
    from ..ops.embedding import embedding_bag
    from ..training.optimizer import SGDOptimizer

    streams = 8
    gen = torch.Generator().manual_seed(0)
    tables = [torch.zeros((vocab, dim), dtype=torch.float32, device=device) for _ in range(streams)]
    idx = _randint(gen, vocab, (repeats, streams, batch), device)
    g = torch.ones((batch, dim), dtype=torch.float32, device=device)
    sgd = SGDOptimizer(lr=0.01, weight_decay=0.0)
    lr = torch.full((), 0.01, dtype=torch.float32, device=device)  # on the device: no copy in a capture

    def gather(r):
        return lambda: [embedding_bag(t, idx[r, s, :, None], AggrMode.AGGR_MODE_SUM) for s, t in enumerate(tables)]

    def scatter(r):
        return lambda: [sgd.sparse_row_update(t, None, idx[r, s], g, lr=lr) for s, t in enumerate(tables)]

    g_ms = replay_ms([gather(r) for r in range(repeats)], device) / streams
    s_ms = replay_ms([scatter(r) for r in range(repeats)], device) / streams
    moved = batch * dim * 4
    return dataclasses.replace(spec, gather_gbps=max(moved / (g_ms * 1e-3) / 1e9, 0.1),
                               scatter_gbps=max(moved / (s_ms * 1e-3) / 1e9, 0.1))


def solve_update_model4(m1: float, m2: float, m3: float, m4: float, k1: int, k2: int, t1: int, t2: int,
                        tb_small: float, tb_big: float):
    """Fit t(K, T, V) = F + T * (2 tb / pass + per_table) + T K ns from four
    row-update measurements (s): (k1, t1, small), (k2, t1, small), (k2, t2,
    small), (k2, t1, big). Returns (pass_gbps, ns, per_table_us, fixed_us)."""
    ns = (m2 - m1) / max(t1 * (k2 - k1), 1) * 1e9
    ns = max(0.1, min(ns, 1000.0))
    pass_per_byte = max((m4 - m2) / max(t1 * 2.0 * (tb_big - tb_small), 1.0), 1e-13)
    pass_gbps = max(10.0, min(1.0 / pass_per_byte / 1e9, 3000.0))
    per_table = max((m3 - m2 - (t2 - t1) * k2 * ns * 1e-9) / max(t2 - t1, 1) - 2.0 * tb_small / (pass_gbps * 1e9),
                    0.0)
    fixed = m1 - t1 * (2.0 * tb_small / (pass_gbps * 1e9) + per_table) - t1 * k1 * ns * 1e-9
    return pass_gbps, ns, per_table * 1e6, max(0.0, fixed) * 1e6


# the JAX package's four (K, tables) points and its small and large vocab
PACKED_POINTS = (16384, 65536, 4, 8)


def calibrate_packed(spec: MachineSpec, dim: int = 16, vocab: int = 1_000_000, repeats: int = 32,
                     device="cuda", table_dtype: torch.dtype = torch.bfloat16,
                     points=PACKED_POINTS) -> MachineSpec:
    """The row-update kernel's constants from four timed (K, tables, V)
    points: K = 16384 and 65536 rows into 4 or 8 tables of V = vocab or 4 x
    vocab rows, the group's sort and one launch a table (the SGD rule, bf16
    stream), other rows every repeat. The table bytes of the fit are the
    port's [V, D] tables at `table_dtype` (the JAX package's are its packed
    f32 [P, 128] pools)."""
    from ..ops.kernels.row_update import row_update

    k1, k2, t1, t2 = points
    gen = torch.Generator().manual_seed(1)
    scale = torch.full((), -1e-3, dtype=torch.float32, device=device)

    def timed_at(k: int, tables: int, v: int) -> float:
        tabs = [torch.zeros((v, dim), dtype=table_dtype, device=device) for _ in range(tables)]
        idx = _randint(gen, v, (repeats, tables, k), device)
        g = torch.ones((tables, k, dim), dtype=torch.float32, device=device)

        def call(r):
            return lambda: row_update(tabs, [idx[r, t] for t in range(tables)], [g[t] for t in range(tables)],
                                      scale)

        ms = replay_ms([call(r) for r in range(repeats)], device)
        del tabs
        return ms * 1e-3

    big = vocab * 4
    m1, m2, m3 = timed_at(k1, t1, vocab), timed_at(k2, t1, vocab), timed_at(k2, t2, vocab)
    m4 = timed_at(k2, t1, big)
    item = torch.empty((), dtype=table_dtype).element_size()
    tb_small, tb_big = float(vocab * dim * item), float(big * dim * item)
    pass_gbps, ns, per_table_us, fixed_us = solve_update_model4(m1, m2, m3, m4, k1, k2, t1, t2, tb_small, tb_big)
    return dataclasses.replace(spec, update_pass_gbps=pass_gbps, update_ns_per_row=ns,
                               update_us_per_table=per_table_us, step_overhead_us=spec.step_overhead_us + fixed_us)


def calibrate_dense(spec: MachineSpec, shapes, batch: int = 16384, repeats: int = 20, device="cuda",
                    compute_dtype: torch.dtype = torch.bfloat16) -> MachineSpec:
    """Forward and backward of `ops/dense.py`'s product (ReLU; under a
    bf16 compute dtype on CUDA the tensor-core route) at each (in, out) of
    `shapes` not yet in dense_costs, stored as (t_fwd + t_bwd) / 3 us per
    example."""
    from ..ffconst import ActiMode
    from ..ops.dense import dense

    costs = dict(spec.dense_costs)
    todo = [(int(di), int(do)) for di, do in shapes if f"{int(di)}x{int(do)}" not in costs]
    gen = torch.Generator().manual_seed(0)
    for di, do in todo:
        x = torch.randn((batch, di), generator=gen).to(device).requires_grad_(True)
        w = (torch.randn((do, di), generator=gen) * 0.02).to(device).requires_grad_(True)
        b = torch.zeros((do,), device=device, requires_grad=True)

        def fwd_bwd():
            y = dense(x, w, b, ActiMode.AC_MODE_RELU, compute_dtype)
            return torch.autograd.grad(y.sum(), (w, x, b))

        t_fb = max(replay_ms([fwd_bwd] * repeats, device) * 1e-3, 1e-7)
        costs[f"{di}x{do}"] = t_fb / 3.0 / batch * 1e6
    return dataclasses.replace(spec, dense_costs=costs)


def op_cost_sig(op) -> str:
    """The key of an op's measured cost: its type, input, output and
    parameter shapes and its activation (the JAX package's string)."""
    ins = ",".join("x".join(map(str, t.shape)) for t in op.inputs)
    outs = ",".join("x".join(map(str, t.shape)) for t in op.outputs)
    prm = ",".join("x".join(map(str, p.shape)) for p in op.params)
    act = getattr(op, "activation", "")
    return f"{op.op_type.name}|{ins}|{outs}|{prm}|{act}"


MEASURED_KINDS = (OperatorType.OP_CONV2D, OperatorType.OP_BATCHMATMUL, OperatorType.OP_MULTIHEAD_ATTENTION,
                  OperatorType.OP_LSTM)


def measurable_graph_ops(graph) -> List:
    """The conv, batch-matmul, attention and LSTM ops of a graph (Dense
    rides calibrate_dense, the tables the row calibrations)."""
    return [op for op in graph.compute_ops if op.op_type in MEASURED_KINDS]


def calibrate_graph_ops(spec: MachineSpec, graph, repeats: int = 20, compute_dtype: torch.dtype = torch.bfloat16,
                        device="cuda") -> MachineSpec:
    """Forward and backward of each measurable op not yet in op_costs at
    its built shapes (once a signature), through its own `forward` and
    torch.autograd, stored as (t_fwd + t_bwd) / 3 us per example."""
    from ..core.graph import OpContext

    costs = dict(spec.op_costs)
    todo = list({op_cost_sig(op): op for op in measurable_graph_ops(graph) if op_cost_sig(op) not in costs}.values())
    dev = torch.device(device)
    for op in todo:
        gen = torch.Generator(device=dev).manual_seed(0)
        xs = [torch.randn(t.shape, generator=gen, device=dev).requires_grad_(True) for t in op.inputs]
        params = {k: v.requires_grad_(True) for k, v in op.init_params(gen, dev).items()}
        ctx = OpContext(training=True, compute_dtype=compute_dtype, device=dev,
                        rng=torch.zeros((), dtype=torch.int64, device=dev))
        leaves = list(params.values()) + xs

        def fwd_bwd(op=op, params=params, xs=xs, ctx=ctx, leaves=leaves):
            outs = op.forward(params, xs, ctx)
            return torch.autograd.grad(sum(o.float().sum() for o in outs), leaves)

        t_fb = max(replay_ms([fwd_bwd] * repeats, device) * 1e-3, 1e-7)
        batch = op.outputs[0].shape[0] if op.outputs else 1
        costs[op_cost_sig(op)] = t_fb / 3.0 / max(batch, 1) * 1e6
    return dataclasses.replace(spec, op_costs=costs)


def graph_dense_shapes(graph) -> list:
    """(in_dim, out_dim) of every Dense op of a graph."""
    out = []
    for op in graph.compute_ops:
        if hasattr(op, "in_dim") and hasattr(op, "out_dim") and hasattr(op, "activation"):
            out.append((op.in_dim, op.out_dim))
    return sorted(set(out))


def calibrate_or_cached(spec: MachineSpec, cache_path: str, device="cuda") -> MachineSpec:
    """The cached machine file if there is one (with `spec`'s chip count and
    topology), else `calibrate` and `calibrate_packed` on the device,
    written to `cache_path`."""
    if cache_path and os.path.exists(cache_path):
        cached = MachineSpec.from_file(cache_path)
        return dataclasses.replace(cached, num_chips=spec.num_chips, chips_per_host=spec.chips_per_host,
                                   ici_axis_x=spec.ici_axis_x, ici_axis_y=spec.ici_axis_y,
                                   ici_domain=spec.ici_domain, model_axis=spec.model_axis)
    spec = calibrate_packed(calibrate(spec, device=device), device=device)
    if cache_path:
        spec.save(cache_path)
    return spec


# ------------------------------------------------------------------ what a card can do
def physical_limits(spec: MachineSpec, graph=None, hbm_gbps: float = H100_HBM_GBPS,
                    bf16_tflops: float = H100_BF16_TFLOPS, f32_tflops: float = H100_F32_TFLOPS) -> List[dict]:
    """Each calibrated constant beside the limit that one card sets on it:
    no rate above the memory's, no measured cost below its shape's
    roofline (the larger of its flops over the peak of the type it runs in
    and its bytes over the memory rate). Conv2D and Dense (calibrated under
    a bf16 compute dtype, `ops/dense.py` `Bf16Product`) multiply bf16
    operands on the tensor cores; batch-matmul, attention and the LSTM
    multiply f32 (operands rounded to the compute dtype) on the CUDA cores,
    unless TF32 products are allowed, where the bf16 peak bounds them too.
    Rows of
    {"name", "value", "limit", "kind": "max" | "min", "ok"}."""
    rows = []

    def add(name, value, limit, kind):
        ok = value <= limit if kind == "max" else value >= limit
        rows.append({"name": name, "value": value, "limit": limit, "kind": kind, "ok": bool(ok)})

    for f in ("gather_gbps", "scatter_gbps", "update_pass_gbps"):
        add(f, getattr(spec, f), hbm_gbps, "max")
    # a stream entry reads its f32 gradient row and index and rewrites its
    # table row: D = 16, bf16, 64 + 4 + 2 x 32 bytes
    add("update_ns_per_row", spec.update_ns_per_row, (64 + 4 + 64) / (hbm_gbps * 1e9) * 1e9, "min")
    add("update_us_per_table", spec.update_us_per_table, 0.0, "min")
    add("step_overhead_us", spec.step_overhead_us, 0.0, "min")
    # a stored cost is (t_fwd + t_bwd) / 3 an example; the backward does
    # twice the forward's flops and at least moves the forward's bytes
    # again (it reads the output's gradient and writes the input's)
    f32_peak = bf16_tflops if torch.backends.cuda.matmul.allow_tf32 else f32_tflops
    for key, us in spec.dense_costs.items():
        di, do = (int(v) for v in key.split("x"))
        floor = max(3 * 2.0 * di * do / (bf16_tflops * 1e12), 2 * 4.0 * (di + do) / (hbm_gbps * 1e9)) / 3 * 1e6
        add(f"dense_costs[{key}]", us, floor, "min")
    ops = {op_cost_sig(op): op for op in measurable_graph_ops(graph)} if graph is not None else {}
    for sig, us in spec.op_costs.items():
        op = ops.get(sig)
        if op is None:
            continue
        st = op.cost_stats()
        batch = max(op.outputs[0].shape[0], 1)
        peak = bf16_tflops if op.op_type is OperatorType.OP_CONV2D else f32_peak
        floor = max(3 * st["flops"] / (peak * 1e12), 2 * st["bytes"] / (hbm_gbps * 1e9)) / 3 / batch * 1e6
        add(f"op_costs[{op.name}]", us, floor, "min")
    return rows
