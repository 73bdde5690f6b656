"""DLRM pairwise dot-product feature interaction.

PyTorch counterpart of `dlrm_flexflow_tpu/ops/interaction.py`. Stack the
(1 + num_tables) feature vectors to [B, F, D], take the pairwise dots of the
strict lower triangle (row-major, `np.tril_indices(F, -1)`).

The routing decides the numbers and mirrors the JAX package's (`:61`):
- kernel path, when use_pallas is "on", or "auto" with D >= 128 and
  B % 8 == 0: the dots in f32 (`ops/kernels/dot_interaction.py`; the CUDA
  kernel on the card, its plain f32 version on the CPU);
- otherwise the plain einsum, with the inputs rounded to the compute dtype
  and the products summed in f32.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ffconst import OperatorType
from ..core.graph import Op
from ..core.tensor import TensorSpec
from .kernels.dot_interaction import dot_interaction as dot_interaction_kernel
from .kernels.dot_interaction import dot_interaction_reference


def dot_interaction(
    vectors: torch.Tensor,
    self_interaction: bool = False,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """vectors: [B, F, D] -> [B, F*(F-1)/2] pairwise dots (F*(F+1)/2 with
    self interaction), inputs rounded to `compute_dtype`, summed in f32."""
    return dot_interaction_reference(vectors.to(compute_dtype), self_interaction)


class DotInteraction(Op):
    op_type = OperatorType.OP_DOT_INTERACTION

    def __init__(
        self,
        name: str,
        inputs: Sequence[TensorSpec],
        self_interaction: bool = False,
    ):
        """inputs: n tensors of identical [B, D]."""
        super().__init__(name, inputs)
        b, d = inputs[0].shape
        for t in inputs:
            if tuple(t.shape) != (b, d):
                raise ValueError("all interaction features need equal [B, D]")
        f = len(inputs)
        self.self_interaction = self_interaction
        n_pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
        self._out((b, n_pairs), inputs[0].dtype)

    def forward(self, params, inputs, ctx):
        stacked = torch.stack(inputs, dim=1)  # [B, F, D]
        b, _, d = stacked.shape
        up = ctx.use_pallas
        if up == "on" or (up == "auto" and d >= 128 and b % 8 == 0):
            out = dot_interaction_kernel(stacked, self.self_interaction)
        else:
            out = dot_interaction(stacked, self.self_interaction, ctx.compute_dtype)
        return [out.to(inputs[0].dtype)]

    def cost_stats(self):
        b, d = self.inputs[0].shape
        f = len(self.inputs)
        return {
            "flops": 2.0 * b * f * f * d,
            "bytes": 4.0 * (b * f * d + b * self.outputs[0].shape[1]),
            "param_bytes": 0.0,
        }
