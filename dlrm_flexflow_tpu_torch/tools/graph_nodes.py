"""The work one call puts on the card, counted from a CUDA graph of it.

    from dlrm_flexflow_tpu_torch.tools.graph_nodes import graph_nodes
    graph_nodes(lambda: fn(x))  # -> {"kernel": 2}

A profiler's activity records can come back short of a call's launches; a
captured graph holds one node for each kernel, copy and memset the call
issued on the card, so their count is exact. The call runs once before it
is captured (a first call may build or set up what capture refuses) and is
never replayed.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# CUgraphNodeType, cuda.h
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 8: "ext_semas_signal", 9: "ext_semas_wait",
              10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


@functools.lru_cache(maxsize=1)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
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
    lib = _libcuda()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    _check(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: dict = {}
    for node in nodes[: n.value]:
        kind = ctypes.c_int(-1)
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        name = NODE_TYPES.get(kind.value, str(kind.value))
        counts[name] = counts.get(name, 0) + 1
    return counts
