"""ctypes binding to the native cost model and strategy search (native/ffsim).

PyTorch-side counterpart of `dlrm_flexflow_tpu/autotune/bindings.py`, with
the same functions over the same C entry points (`native/ffsim/ffsim.h`):
the staged step cost (`simulate`, `breakdown`), the placement annealer
(`mcmc_search`), the joint (owner, split, mode, tp) model and annealer
(`simulate2`, `breakdown2`, `search2`, on the graph-generic task DAG when
given op edges), the exchange's wire bytes (`wire_bytes`) and the DAG
scheduler (`schedule_dag`).

The port builds the shared source unchanged, with the flags of
`native/Makefile`, into its own directory `build/host/` beside the package
(listed in `.gitignore`; `native/build/` belongs to the JAX package), at
first use, under a name that carries a hash of the source, the header and
the flags, as `data/native_batcher.py` builds ffdata. Nothing falls back:
if the library cannot be built or loaded, every function raises
RuntimeError with the compiler's output.

`FFSimMachine` and `FFSimOp` list the fields of `ffsim.h`'s structs in the
header's order and types: a field out of place would shift every later one
and corrupt each cost without an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_NATIVE = Path(__file__).resolve().parents[2] / "native" / "ffsim"
SOURCE = _NATIVE / "ffsim.cc"
HEADER = _NATIVE / "ffsim.h"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]  # native/Makefile

_loaded: Dict[str, ctypes.CDLL] = {}


class FFSimMachine(ctypes.Structure):
    _fields_ = [
        ("num_chips", ctypes.c_int32),
        ("chips_per_host", ctypes.c_int32),
        ("mxu_tflops", ctypes.c_double),
        ("hbm_gbps", ctypes.c_double),
        ("hbm_capacity_gb", ctypes.c_double),
        ("ici_gbps", ctypes.c_double),
        ("ici_latency_us", ctypes.c_double),
        ("dcn_gbps", ctypes.c_double),
        ("dcn_latency_us", ctypes.c_double),
        ("gather_gbps", ctypes.c_double),
        ("scatter_gbps", ctypes.c_double),
        ("step_overhead_us", ctypes.c_double),
        ("segment_bytes", ctypes.c_double),
        ("max_segments", ctypes.c_double),
        ("overlap_backward_update", ctypes.c_double),
        ("hierarchical_a2a", ctypes.c_double),
        ("ici_axis_x", ctypes.c_int32),
        ("ici_axis_y", ctypes.c_int32),
        ("ici_domain", ctypes.c_int32),
        ("update_pass_gbps", ctypes.c_double),
        ("update_ns_per_row", ctypes.c_double),
        ("update_us_per_table", ctypes.c_double),
        ("use_dag", ctypes.c_int32),
        ("routed_exchange", ctypes.c_int32),
        ("routed_cap", ctypes.c_double),
        ("routing_ns_per_entry", ctypes.c_double),
        ("model_axis", ctypes.c_int32),
        ("pcie_gbps", ctypes.c_double),
        ("pcie_latency_us", ctypes.c_double),
        ("host_row_ns", ctypes.c_double),
        ("param_sync", ctypes.c_int32),
        ("ps_gbps", ctypes.c_double),
    ]


class FFSimOp(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("flops", ctypes.c_double),
        ("bytes", ctypes.c_double),
        ("param_bytes", ctypes.c_double),
        ("table_rows", ctypes.c_double),
        ("row_bytes", ctypes.c_double),
        ("lookups", ctypes.c_double),
        ("pooled_rows", ctypes.c_double),
        ("sub_count", ctypes.c_double),
        ("wire_row_bytes", ctypes.c_double),
        ("stage", ctypes.c_int32),
        ("act_bytes", ctypes.c_double),
        ("fwd_us", ctypes.c_double),
        ("tail_hot_rows", ctypes.c_double),
        ("tail_miss_frac", ctypes.c_double),
        ("table_row_bytes", ctypes.c_double),
        ("upd_touched_frac", ctypes.c_double),
    ]


KIND_DENSE, KIND_EMBED, KIND_OTHER = 0, 1, 2

# the FFSimOp fields a cost-spec dict may set, with their defaults
_OP_DEFAULTS = {name: 0.0 for name, _ in FFSimOp._fields_}
_OP_DEFAULTS.update(kind=KIND_OTHER, sub_count=1.0, stage=2)


def library_path() -> Path:
    for f in (SOURCE, HEADER):
        if not f.is_file():
            raise RuntimeError(f"ffsim: its source {f} is missing from this checkout")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(HEADER.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libffsim-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("ffsim: g++ not found on PATH; the port's cost model needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ffsim: g++ failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if need be; raises RuntimeError if it
    cannot be built or loaded."""
    path = library_path()
    if str(path) in _loaded:
        return _loaded[str(path)]
    if not path.exists():
        _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"ffsim: cannot load {path}: {e}") from e
    mp, op = ctypes.POINTER(FFSimMachine), ctypes.POINTER(FFSimOp)
    i32, i64, f64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double, ctypes.c_uint64
    i32p, f64p = ctypes.POINTER(i32), ctypes.POINTER(f64)
    sim = [mp, op, i32, i32p, i32, f64]
    lib.ffsim_simulate.restype = f64
    lib.ffsim_simulate.argtypes = sim
    lib.ffsim_breakdown.restype = None
    lib.ffsim_breakdown.argtypes = sim + [f64p]
    lib.ffsim_mcmc_search.restype = f64
    lib.ffsim_mcmc_search.argtypes = sim + [i64, f64, u64, i64, f64p, i64]
    lib.ffsim_schedule_dag.restype = f64
    lib.ffsim_schedule_dag.argtypes = [i32, f64p, i32p, i32, i32p, i32p, i32]
    sim2 = [mp, op, i32, i32p, i32p, i32p, i32, i32p, i32, f64]
    op_edges = [i32p, i32p, i32]
    search2 = [mp, op, i32, i32p, i32p, i32p, i32, i32p, i32, i32p, i32p, i32p, f64p, i32, f64, i32, i64,
               f64, u64]
    for name, res, args in (
        ("ffsim2_simulate", f64, sim2),
        ("ffsim2_breakdown", None, sim2 + [f64p]),
        ("ffsim2_search", f64, search2),
        ("ffsim2g_simulate", f64, sim2 + op_edges),
        ("ffsim2g_breakdown", None, sim2 + op_edges + [f64p]),
        ("ffsim2g_search", f64, search2 + op_edges),
        ("ffsim2_wire_bytes", None, [mp, op, i32, i32p, i32p, i32p, i32, f64p]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _loaded[str(path)] = lib
    return lib


def _i32(vals, min_len: int = 1):
    vals = list(vals)
    return (ctypes.c_int32 * max(min_len, len(vals)))(*(vals or [0]))


def _ops_array(ops: Sequence[dict]):
    arr = (FFSimOp * len(ops))()
    for i, o in enumerate(ops):
        for name, default in _OP_DEFAULTS.items():
            setattr(arr[i], name, o.get(name, default))
    return arr


def _edges(op_edges):
    return _i32([e[0] for e in op_edges]), _i32([e[1] for e in op_edges]), len(op_edges)


def simulate(machine: FFSimMachine, ops: Sequence[dict], owner: Sequence[int],
             opt_state_factor: float = 0.0) -> float:
    """The step's modeled time in us under the staged model, table i on chip owner[i]."""
    lib = get_lib()
    return lib.ffsim_simulate(ctypes.byref(machine), _ops_array(ops), len(ops), _i32(owner), len(owner),
                              opt_state_factor)


def breakdown(machine: FFSimMachine, ops: Sequence[dict], owner: Sequence[int],
              opt_state_factor: float = 0.0) -> dict:
    lib = get_lib()
    out = (ctypes.c_double * 7)()
    lib.ffsim_breakdown(ctypes.byref(machine), _ops_array(ops), len(ops), _i32(owner), len(owner),
                        opt_state_factor, out)
    keys = ["dense_us", "embed_max_us", "all2all_us", "allreduce_us", "update_us", "mem_penalty_us",
            "total_us"]
    return dict(zip(keys, list(out)))


def mcmc_search(machine: FFSimMachine, ops: Sequence[dict], owner: Sequence[int], budget: int = 10000,
                alpha: float = 0.05, seed: int = 0, opt_state_factor: float = 0.0):
    """The placement annealer from `owner`. Returns (best_owner, best_us)."""
    lib = get_lib()
    own = _i32(owner)
    cost = lib.ffsim_mcmc_search(ctypes.byref(machine), _ops_array(ops), len(ops), own, len(owner),
                                 opt_state_factor, budget, alpha, seed, 0, None, 0)
    return list(own[: len(owner)]), cost


def simulate2(machine: FFSimMachine, ops: Sequence[dict], owner, split, mode, tp,
              opt_state_factor: float = 0.0, op_edges=()) -> float:
    """The joint (owner, split, mode, tp) state's modeled step in us; with
    `op_edges` [(src, dst)] over the op indices, on the graph-generic task
    DAG instead of the staged one."""
    lib = get_lib()
    head = (ctypes.byref(machine), _ops_array(ops), len(ops), _i32(owner), _i32(split), _i32(mode),
            len(owner), _i32(tp), len(tp), opt_state_factor)
    if op_edges:
        return lib.ffsim2g_simulate(*head, *_edges(op_edges))
    return lib.ffsim2_simulate(*head)


def breakdown2(machine: FFSimMachine, ops: Sequence[dict], owner, split, mode, tp,
               opt_state_factor: float = 0.0, op_edges=()) -> dict:
    lib = get_lib()
    out = (ctypes.c_double * 9)()
    head = (ctypes.byref(machine), _ops_array(ops), len(ops), _i32(owner), _i32(split), _i32(mode),
            len(owner), _i32(tp), len(tp), opt_state_factor)
    if op_edges:
        lib.ffsim2g_breakdown(*head, *_edges(op_edges), out)
    else:
        lib.ffsim2_breakdown(*head, out)
    keys = ["dense_us", "embed_fwd_max_us", "embed_upd_max_us", "all2all_us", "allreduce_us", "update_us",
            "mem_penalty_us", "total_us", "closed_form_us"]
    return dict(zip(keys, list(out)))


def search2(machine: FFSimMachine, ops: Sequence[dict], owner, split, mode, tp, vocab_caps, edges=(),
            budget: int = 20000, alpha: float = 0.05, seed: int = 0, opt_state_factor: float = 0.0,
            split_cap: int = 0, op_edges=()):
    """The joint annealer. edges: [(src_dense, dst_dense, volume)] for the
    propagate moves; op_edges: [(src_op, dst_op)], scoring on the task DAG.
    Returns (owner, split, mode, tp, best_us)."""
    lib = get_lib()
    nt, nd = len(owner), len(tp)
    own, spl, mod, tpa = _i32(owner), _i32(split), _i32(mode), _i32(tp)
    ev = (ctypes.c_double * max(1, len(edges)))(*([float(e[2]) for e in edges] or [0.0]))
    args = (ctypes.byref(machine), _ops_array(ops), len(ops), own, spl, mod, nt, tpa, nd,
            _i32(vocab_caps, min_len=max(1, nt)), _i32([e[0] for e in edges]), _i32([e[1] for e in edges]),
            ev, len(edges), opt_state_factor, split_cap, budget, alpha, seed)
    if op_edges:
        cost = lib.ffsim2g_search(*args, *_edges(op_edges))
    else:
        cost = lib.ffsim2_search(*args)
    return list(own[:nt]), list(spl[:nt]), list(mod[:nt]), list(tpa[:nd]), cost


def wire_bytes(machine: FFSimMachine, ops: Sequence[dict], owner, split, mode) -> dict:
    """The modeled exchange volumes of a step (forward-direction bytes)."""
    lib = get_lib()
    out = (ctypes.c_double * 3)()
    lib.ffsim2_wire_bytes(ctypes.byref(machine), _ops_array(ops), len(ops), _i32(owner), _i32(split),
                          _i32(mode), len(owner), out)
    return {"slot_payload": out[0], "domain_payload": out[1], "routed_wire": out[2]}


def schedule_dag(num_devices: int, durations, device_of, edges) -> float:
    """The makespan of a task DAG on `num_devices` timelines."""
    lib = get_lib()
    n = len(durations)
    src, dst, ne = _edges(edges)
    return lib.ffsim_schedule_dag(num_devices, (ctypes.c_double * n)(*durations),
                                  (ctypes.c_int32 * n)(*device_of), n, src, dst, ne)
