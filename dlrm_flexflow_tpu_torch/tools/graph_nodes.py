"""The work one call puts on the card, counted from a CUDA graph of it.

    from dlrm_flexflow_tpu_torch.tools.graph_nodes import graph_nodes, node_counts
    graph_nodes(lambda: fn(x))  # -> {"kernel": 2}
    node_counts(model._step_graph.graph, kernel_names=True)  # a captured train step
    stamps_apart(node_counts(model._step_graph.graph, kernel_names=True))

A profiler's activity records can come back short of a call's launches; a
captured graph holds one node for each kernel, copy and memset the call
launched on the card, so their count is exact. `graph_nodes` runs the call
once before it captures it (a first call may build or set up what capture
refuses) and never replays it. `node_counts` reads a graph captured with
`keep_graph=True` (as `FFModel.train_chunk` captures its step); with
`kernel_names` it also counts the kernel nodes by function name (libcuda's
`cuGraphKernelNodeGetParams_v2` and `cuFuncGetName`). A captured train step
also holds the phase stamps (`utils/profiling.py` `step_phases`, one kernel
node a stamp, 8 a step), which `stamps_apart` counts apart by name.
"""
from __future__ import annotations

import ctypes
import functools

import torch

STAMP_KERNEL = "phase_stamp_kernel"  # csrc/phase_stamp.cu
# CUgraphNodeType, cuda.h
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 8: "ext_semas_signal", 9: "ext_semas_wait",
              10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h), with room to spare after it."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p),
                ("_spare", ctypes.c_byte * 64)]


@functools.lru_cache(maxsize=1)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
    lib.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    for fn in (lib.cuGraphGetNodes, lib.cuGraphNodeGetType, lib.cuGraphKernelNodeGetParams_v2,
               lib.cuFuncGetName):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def graph_nodes(fn) -> dict:
    """{node type: count} of one call of fn captured in a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return node_counts(graph)


def node_counts(graph: torch.cuda.CUDAGraph, kernel_names: bool = False) -> dict:
    """{node type: count} of a graph captured with keep_graph=True; with
    `kernel_names`, also {"kernels": {function name: count}}."""
    lib = _libcuda()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    _check(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: dict = {}
    names: dict = {}
    for node in nodes[: n.value]:
        kind = ctypes.c_int(-1)
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        name = NODE_TYPES.get(kind.value, str(kind.value))
        counts[name] = counts.get(name, 0) + 1
        if kernel_names and name == "kernel":
            fname = _kernel_name(lib, node)
            names[fname] = names.get(fname, 0) + 1
    if kernel_names:
        counts["kernels"] = names
    return counts


def stamps_apart(counts: dict) -> dict:
    """`node_counts(..., kernel_names=True)` with the phase stamps' kernel
    nodes counted apart: "kernel" and "kernels" without them, and
    "phase_stamp" their number."""
    names = counts["kernels"]
    n = sum(v for k, v in names.items() if STAMP_KERNEL in k)
    out = dict(counts, phase_stamp=n, kernels={k: v for k, v in names.items() if STAMP_KERNEL not in k})
    out["kernel"] = counts.get("kernel", 0) - n
    return out


def _kernel_name(lib, node) -> str:
    params = _KernelNodeParams()
    _check(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
           "cuGraphKernelNodeGetParams_v2")
    name = ctypes.c_char_p()
    _check(lib.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
    return name.value.decode()
