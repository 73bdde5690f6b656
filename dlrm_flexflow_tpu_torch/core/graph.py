"""Op base class and graph container.

PyTorch counterpart of `dlrm_flexflow_tpu/core/graph.py`. An Op is metadata
(inputs, outputs, parameter specs) plus a `forward` over plain tensors; the
math lives in plain functions beside each op. Parameters are held outside
the ops as `{op_name: {key: tensor}}`, the layout the JAX package uses, so
weights carry between the packages one to one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..ffconst import DataType, OperatorType
from .tensor import ParameterSpec, TensorSpec


_M32 = 0xFFFFFFFF


def hash32(x: Union[int, torch.Tensor]) -> Union[int, torch.Tensor]:
    """An xorshift-multiply hash of the low 32 bits of x (a Python int or
    an int64 tensor, elementwise), in [0, 2^32). Each multiplier is below
    2^31, so no product leaves int64: the same bits on every device."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def step_key(seed: int, step: torch.Tensor) -> torch.Tensor:
    """The random key of train step `step` (an int64 tensor, the step count
    before the step) under config.seed `seed`."""
    return hash32(step ^ hash32(seed))


def keep_mask(key: torch.Tensor, shape, keep: float, offset: int = 0) -> torch.Tensor:
    """A bool mask of `shape`, each entry kept with probability `keep`: the
    hash of (key, the entry's row-major index plus `offset`) below keep *
    2^32. A function of the key alone; `key` lies on the device the mask
    is made on. A rank's block of a batch-sharded tensor passes its offset
    in the global tensor (`OpContext.row_offset`), so the blocks of N ranks
    draw one card's mask."""
    idx = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64, device=key.device)
    return (hash32(hash32(idx) ^ key) < int(keep * 2**32)).reshape(shape)


@dataclasses.dataclass
class OpContext:
    """Per-call execution context threaded through every Op.forward."""

    training: bool = True
    compute_dtype: torch.dtype = torch.float32
    # vocab size at or below which embedding ops take the one-hot path
    # (0 disables)
    onehot_threshold: int = 0
    # kernel routing, resolved from FFConfig.use_pallas at compile:
    # "auto", "on" or "off" (ops/kernels/__init__.py)
    use_pallas: str = "off"
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu")
    )
    # op name -> precomputed output list; execute() uses these instead of
    # calling op.forward (the train step looks the sparse tables up outside
    # autograd and injects their pooled outputs here)
    overrides: Optional[Dict[str, List[torch.Tensor]]] = None
    # the compiled mesh (parallel/mesh.py): a sharded embedding collection
    # exchanges over it, a column-parallel Dense gathers over its model axis
    mesh: Optional[object] = None
    # the Dense ops that hold a row block of their kernel over the mesh's
    # model axis (parallel/tensor_parallel.py)
    model_parallel: frozenset = frozenset()
    # the reference's FFIterationConfig.seq_length (BatchMatmul); -1: none
    seq_length: int = -1
    # the step's random key (`step_key`, a 0-d int64 tensor on the device)
    # while training, else None; the JAX package's per-step PRNG key
    rng: Optional[torch.Tensor] = None
    # under a data axis above 1, the ops that run on the rank's block of a
    # batch-sharded input (parallel/global_batch.py `batch_ops`)
    batch_ops: frozenset = frozenset()
    # results shared by the ops of one execution (GroupBy's and its
    # Aggregate's token slots); `Graph.execute` starts each with its own
    memo: Optional[dict] = None
    # when a dict, `Graph.execute` records every op's outputs in it under
    # "{op}:{i}" (the per-op report and the NaN sweep, utils/profiling.py)
    taps: Optional[Dict[str, torch.Tensor]] = None

    def block_mesh(self, op: "Op"):
        """The mesh when `op` runs on the rank's block of a batch sharded
        over a data axis above 1, else None."""
        return self.mesh if op.name in self.batch_ops else None

    def row_offset(self, op: "Op", volume: int) -> int:
        """The global row-major index of the first entry of `op`'s block of
        `volume` entries (0 on one device and for a whole tensor)."""
        mesh = self.block_mesh(op)
        return 0 if mesh is None else mesh.data_index * volume

    def op_rng(self, op: "Op") -> Optional[torch.Tensor]:
        """The key of `op` this step: the step's key with its guid folded
        in (the JAX package folds `op.guid` into its key the same way)."""
        return None if self.rng is None else hash32(self.rng ^ hash32(op.guid))


class Op:
    """A graph node. Subclasses build their outputs and params in __init__
    and implement `forward(params, inputs, ctx) -> list of tensors`."""

    op_type: OperatorType = OperatorType.OP_INPUT
    # whether forward reads `ctx.op_rng` while training (the train step then
    # stages the step count on the device)
    stochastic: bool = False

    def __init__(self, name: str, inputs: Sequence[TensorSpec]):
        self.name = name
        self.guid = -1  # assigned by Graph.add_op
        self.inputs: List[TensorSpec] = list(inputs)
        self.outputs: List[TensorSpec] = []
        self.params: List[ParameterSpec] = []

    def _out(
        self,
        shape: Tuple[int, ...],
        dtype: DataType = DataType.DT_FLOAT,
        idx: int = 0,
    ) -> TensorSpec:
        t = TensorSpec(tuple(int(d) for d in shape), dtype, f"{self.name}:{idx}")
        t.owner_op = self
        t.owner_idx = idx
        self.outputs.append(t)
        return t

    def _param(
        self,
        key: str,
        shape: Tuple[int, ...],
        initializer,
        dtype: DataType = DataType.DT_FLOAT,
    ) -> ParameterSpec:
        p = ParameterSpec(key, tuple(int(d) for d in shape), dtype, initializer, self)
        self.params.append(p)
        return p

    def forward(
        self,
        params: Dict[str, torch.Tensor],
        inputs: List[torch.Tensor],
        ctx: OpContext,
    ) -> List[torch.Tensor]:
        raise NotImplementedError

    def init_params(
        self, generator: torch.Generator, device: torch.device
    ) -> Dict[str, torch.Tensor]:
        return {
            p.key: p.initializer(generator, p.shape, p.dtype.to_torch(), device)
            for p in self.params
        }

    def cost_stats(self) -> Dict[str, float]:
        """Analytic cost of one forward at the built shapes: flops, bytes
        moved and parameter bytes, the inputs of the strategy search's cost
        model (autotune/search.py), the task-graph export and the per-op
        report (utils/profiling.py). This default is an elementwise pass over
        the outputs; ops with products override it. Every op gives the JAX
        package's floats, computed in the same order."""
        out_elems = sum(t.volume for t in self.outputs)
        in_elems = sum(t.volume for t in self.inputs)
        return {
            "flops": float(out_elems),
            "bytes": 4.0 * float(in_elems + out_elems),
            "param_bytes": 4.0 * sum(p.volume for p in self.params),
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.name})"


class InputOp(Op):
    """Graph source node (reference: FFModel::create_tensor, model.cc:831)."""

    op_type = OperatorType.OP_INPUT

    def __init__(self, name: str, shape: Tuple[int, ...], dtype: DataType):
        super().__init__(name, [])
        self._out(shape, dtype)

    def forward(self, params, inputs, ctx):  # pragma: no cover - never invoked
        raise RuntimeError("InputOp is fed externally")


class Graph:
    """Ordered op list; creation order is topological (builder API
    property, as in the JAX package)."""

    def __init__(self) -> None:
        self.ops: List[Op] = []
        self.inputs: List[InputOp] = []
        self._names: Dict[str, int] = {}
        self._next_guid = 1000  # the JAX package's guid base

    def unique_name(self, base: str) -> str:
        n = self._names.get(base, 0)
        self._names[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def add_op(self, op: Op) -> Op:
        op.guid = self._next_guid
        self._next_guid += 1
        self.ops.append(op)
        if isinstance(op, InputOp):
            self.inputs.append(op)
        return op

    @property
    def compute_ops(self) -> List[Op]:
        return [op for op in self.ops if not isinstance(op, InputOp)]

    def init_params(
        self, generator: torch.Generator, device: torch.device
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Draws every op's params from one generator, in graph order."""
        return {
            op.name: op.init_params(generator, device)
            for op in self.compute_ops
            if op.params
        }

    def execute(
        self,
        params: Dict[str, Dict[str, torch.Tensor]],
        feeds: Dict[str, torch.Tensor],
        ctx: OpContext,
        fetch: Optional[Sequence[TensorSpec]] = None,
    ) -> List[torch.Tensor]:
        """Topological interpretation of the graph. `feeds` maps input-op
        name -> tensor. Returns the `fetch` tensors (default: the outputs
        of the final op)."""
        env: Dict[Tuple[int, int], torch.Tensor] = {}
        ctx = dataclasses.replace(ctx, memo={})
        for iop in self.inputs:
            env[(iop.guid, 0)] = feeds[iop.name]
        for op in self.compute_ops:
            if ctx.overrides is not None and op.name in ctx.overrides:
                ys = list(ctx.overrides[op.name])
            else:
                xs = [env[(t.owner_op.guid, t.owner_idx)] for t in op.inputs]
                ys = op.forward(params.get(op.name, {}), xs, ctx)
            if ctx.taps is not None:
                for i, y in enumerate(ys):
                    ctx.taps[f"{op.name}:{i}"] = y
            for i, y in enumerate(ys):
                env[(op.guid, i)] = y
        if fetch is None:
            fetch = self.compute_ops[-1].outputs
        return [env[(t.owner_op.guid, t.owner_idx)] for t in fetch]
