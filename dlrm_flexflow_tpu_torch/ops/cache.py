"""Cache op and recompile-on-condition support.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/cache.py` (the reference's
Cache op and RecompileState, used by MoE to freeze expert assignments).
The cache, its moving-average score and `update_cache` live on the host.
Switching to the cached value is static: `use_cached` takes effect when the
model is compiled again (`FFModel.recompile`, which `recompile_on_condition`
calls), as the JAX package's re-trace does; the cached value then goes to
the device once (`stage`), so the forward, and a CUDA graph of the step,
copy nothing from the host.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ffconst import OperatorType
from ..core.graph import Op
from ..core.tensor import TensorSpec


class Cache(Op):
    op_type = OperatorType.OP_CACHE

    def __init__(
        self,
        name: str,
        input: TensorSpec,
        num_batches: int,
        score_func: Optional[Callable] = None,
    ):
        super().__init__(name, [input])
        self.num_batches = num_batches
        self.score_func = score_func or default_cache_score
        self._out(input.shape, input.dtype)
        # host-side state (reference: cached batches in zero-copy memory)
        self.cached_value: Optional[np.ndarray] = None
        self.score: float = 0.0
        self.batch_ctr: int = 0
        self.use_cached: bool = False  # static: flip, then recompile
        self.cached_tensor: Optional[torch.Tensor] = None  # what forward serves, set by `stage`

    def stage(self, device, mesh=None) -> None:
        """Fix what forward serves until the next compile: the cached value
        on `device` if `use_cached` and a value is cached, else the input.
        With `mesh` (the op runs on a rank's block of a batch sharded over
        its data axis) the rank's block of the cached global batch."""
        self.cached_tensor = None
        if self.use_cached and self.cached_value is not None:
            value = np.asarray(self.cached_value)
            if mesh is not None:
                value = value[mesh.batch_slice(value.shape[0])]
            self.cached_tensor = torch.as_tensor(value, dtype=self.outputs[0].dtype.to_torch()).to(device)

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return [x if self.cached_tensor is None else self.cached_tensor]

    def update_cache(self, batch_value: np.ndarray) -> float:
        """Host-side CACHE_UPDATE_TASK: stash the batch, fold the moving
        average score comparing new vs cached (reference: cache.cu:306+)."""
        batch_value = np.asarray(batch_value)
        if self.cached_value is None:
            self.cached_value = batch_value.copy()
            self.score = 0.0
        else:
            s = float(self.score_func(self.cached_value, batch_value))
            self.batch_ctr += 1
            self.score = self.score + (s - self.score) / self.batch_ctr
            self.cached_value = batch_value.copy()
        return self.score


def default_cache_score(cached: np.ndarray, current: np.ndarray) -> float:
    """Fraction of entries unchanged (reference MoE: fraction of identical
    expert assignments, moe.cc score function)."""
    if cached.shape != current.shape:
        return 0.0
    return float(np.mean(cached == current))


class RecompileState:
    """reference: include/recompile.h:27 — user trigger_func + alter_func;
    FFModel.recompile_on_condition calls trigger each iteration and applies
    alter once, then recompiles."""

    def __init__(self, trigger_func: Callable[["RecompileState"], bool], alter_func: Callable, model=None):
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.model = model
        self.recompilations = 0

    def trigger(self) -> bool:
        return bool(self.trigger_func(self))

    def alter(self) -> None:
        self.alter_func(self)
        self.recompilations += 1
