"""Hand-written Hopper kernels, the port of `dlrm_flexflow_tpu/ops/pallas/`.

Each kernel module holds the wrapper that launches the CUDA kernel (built
from `csrc/` on first CUDA use, `_build.py`), its plain PyTorch version, and
a launch count on the wrapper. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.

  - dot_interaction.py : pairwise-dot feature interaction (replaces
                         `_interaction_kernel`, ops/pallas/dot_interaction.py)

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

