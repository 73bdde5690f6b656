"""Op base class and graph container.

PyTorch counterpart of `dlrm_flexflow_tpu/core/graph.py`. An Op is metadata
(inputs, outputs, parameter specs) plus a `forward` over plain tensors; the
math lives in plain functions beside each op. Parameters are held outside
the ops as `{op_name: {key: tensor}}`, the layout the JAX package uses, so
weights carry between the packages one to one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ffconst import DataType, OperatorType
from .tensor import ParameterSpec, TensorSpec


@dataclasses.dataclass
class OpContext:
    """Per-call execution context threaded through every Op.forward."""

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


class Op:
    """A graph node. Subclasses build their outputs and params in __init__
    and implement `forward(params, inputs, ctx) -> list of tensors`."""

    op_type: OperatorType = OperatorType.OP_INPUT

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
        for iop in self.inputs:
            env[(iop.guid, 0)] = feeds[iop.name]
        for op in self.compute_ops:
            xs = [env[(t.owner_op.guid, t.owner_idx)] for t in op.inputs]
            ys = op.forward(params.get(op.name, {}), xs, ctx)
            for i, y in enumerate(ys):
                env[(op.guid, i)] = y
        if fetch is None:
            fetch = self.compute_ops[-1].outputs
        return [env[(t.owner_op.guid, t.owner_idx)] for t in fetch]
