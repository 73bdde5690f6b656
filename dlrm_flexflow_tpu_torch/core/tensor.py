"""Logical tensor handles for the graph-builder API.

PyTorch counterpart of `dlrm_flexflow_tpu/core/tensor.py`. A TensorSpec is
metadata only (shape, dtype, producer); storage is torch tensors held by
FFModel. Shapes are C-order with batch first.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..ffconst import DataType


@dataclasses.dataclass(eq=False)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: DataType = DataType.DT_FLOAT
    name: str = ""
    guid: int = -1
    owner_op: Optional[object] = None  # Op producing this tensor
    owner_idx: int = 0  # which output of the owner

    @property
    def num_dims(self) -> int:
        return len(self.shape)

    @property
    def volume(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TensorSpec({self.name or self.guid}, {self.shape}, {self.dtype.value})"


@dataclasses.dataclass(eq=False)
class ParameterSpec:
    """A trainable weight owned by an op (reference: include/tensor.h:65-73).

    `key` is the op-local name inside the params dict
    (params[op.name][key]). `initializer` is a core.initializers.Initializer.
    """

    key: str
    shape: Tuple[int, ...]
    dtype: DataType = DataType.DT_FLOAT
    initializer: Optional[object] = None
    owner_op: Optional[object] = None

    @property
    def volume(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1
