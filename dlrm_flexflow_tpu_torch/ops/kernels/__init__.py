"""Hand-written Hopper kernels, the port of `dlrm_flexflow_tpu/ops/pallas/`.

Each kernel module holds the wrapper that launches the CUDA kernel (built
from `csrc/` on first CUDA use, `_build.py`), its plain PyTorch version, and
a launch count on the wrapper. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.

  - dot_interaction.py  : pairwise-dot feature interaction (K3, replaces
                          `_interaction_kernel`, ops/pallas/dot_interaction.py)
  - row_update.py       : sparse embedding row updates, SGD, lazy momentum
                          and Nesterov, lazy Adam, row-wise AdaGrad (K1 + K2
                          in every mode, replaces `_update_kernel` and
                          `_update_kernel_manual`, ops/pallas/packed_update.py)
  - fused_mlp.py        : fused dense layer (K6, replaces `_dense_kernel`,
                          ops/pallas/fused_mlp.py)
  - embedding_bag.py    : pooled embedding-bag lookup (K4, replaces
                          `_bag_kernel`, ops/pallas/embedding_bag.py)
  - onehot_embedding.py : small-vocabulary pooled lookup and its gradient
                          (K5f and K5b, replace `_fwd_kernel` and
                          `_bwd_kernel`, ops/pallas/onehot_embedding.py)
  - row_gather.py       : the forward-gather probe's row gather (K7,
                          replaces `_dma_gather_kernel`,
                          scripts/bench_gather_probe.py)
  - phase_stamp.py      : the train step's device phase stamp (no TPU
                          counterpart: utils/profiling.py `step_phases`)
  - bf16_split.py       : the exact three-way bf16 split of the Dense
                          backward's f32 cotangent (no TPU counterpart:
                          ops/dense.py `Bf16Product`)
  - cross_epilogue.py   : the DCN-V2 cross network's f32 epilogue, forward
                          and backward, one pass a layer each way (no TPU
                          counterpart: ops/cross.py `FusedCrossNet`)

Routing mirrors the JAX package: FFConfig.use_pallas ->
resolve_use_pallas() -> OpContext.use_pallas, read per op.
"""
from __future__ import annotations

import torch


def resolve_use_pallas(flag: str, device: torch.device) -> bool:
    """Map an FFConfig.use_pallas value ('auto'|'on'|'off') to a bool for a
    model on `device`. "auto" is true only on CUDA, where the kernels run,
    as the JAX package's "auto" is true only on a TPU."""
    if flag == "on":
        return True
    if flag == "off":
        return False
    if flag != "auto":
        raise ValueError(f"use_pallas must be 'auto', 'on' or 'off', got {flag!r}")
    return torch.device(device).type == "cuda"

