"""Carry weights from the JAX package into this one.

Both packages keep parameters as `{op_name: {key: array}}` with the same op
names, keys, shapes and layouts (Dense `kernel` [out, in] and `bias` [out];
Embedding `weight` [V, D]). `params_from_jax` takes what the JAX package's
`FFModel.get_weights(op_name)` returns for each op (host numpy in logical
shapes; packed tables come back unpacked) and gives torch tensors for
`FFModel.set_parameters`:

    port.set_parameters(params_from_jax(
        {name: ref.get_weights(name) for name in ref.get_parameters()}))
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # JAX hands out bf16 as an ml_dtypes array, which torch cannot read
        # directly: reinterpret the 16-bit payload
        return torch.from_numpy(np.array(arr, copy=True).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(
    np_params: Dict[str, Dict[str, np.ndarray]],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """{op_name: {key: numpy}} from the JAX package -> {op_name: {key: tensor}}."""
    return {
        op_name: {key: _to_torch(arr) for key, arr in sub.items()}
        for op_name, sub in np_params.items()
    }
