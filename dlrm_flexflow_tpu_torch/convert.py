"""Carry weights from the JAX package into this one.

Both packages keep parameters as `{op_name: {key: array}}` with the same op
names, keys, shapes and layouts (Dense `kernel` [out, in] and `bias` [out];
Embedding `weight` [V, D]; MultiHeadAttention `wq`, `wk`, `wv`, `wo`
[embed, in] and `bq`..`bo` [embed]; Conv2D `kernel` [O, C / groups, kh, kw]
and `bias` [O]; BatchNorm `scale` and `bias` [C]; LSTM `wx` [4H, E], `wh`
[4H, H] and `bias` [4H]), but for the tables the JAX package keeps
packed [P, 128] (row r at line r // (128 / D), lanes (r % (128 / D)) * D
onward), which the port keeps [V, D]: `params_from_jax(..., like=)` unpacks
them as the JAX package's `unpack_table` does. `params_from_jax` takes what the JAX package's
`FFModel.get_weights(op_name)` returns for each op (host numpy in logical
shapes; packed tables come back unpacked, bf16 tables as bf16) and gives
torch tensors for `FFModel.set_parameters`, which rounds each to the
storage dtype of the port's parameter (bf16 for a table on the row-update
kernel route with `table_dtype="bfloat16"`, f32 otherwise):

    port.set_parameters(params_from_jax(
        {name: ref.get_weights(name) for name in ref.get_parameters()}))
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor of the same dtype (bf16 included)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # JAX hands out bf16 as an ml_dtypes array, which torch cannot read
        # directly: reinterpret the 16-bit payload
        return torch.from_numpy(np.array(arr, copy=True).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def unpack_like(arr: np.ndarray, shape: tuple) -> np.ndarray:
    """A packed array of the JAX package in the port's `shape`: [Pp, 128]
    -> [V, D], the first V * D elements of the row-major lines
    (`unpack_table`, ops/pallas/packed_update.py:78); a per-line vector
    [Pp] (dense AdaGrad's accumulator of a packed table) -> its first
    `shape[0]` lines. Anything else comes back as it is."""
    arr = np.asarray(arr)
    n = math.prod(shape)
    if tuple(arr.shape) == tuple(shape) or arr.size < n:
        return arr
    if arr.ndim == 2 and arr.shape[1] == 128 and len(shape) == 2:
        return arr.reshape(-1)[:n].reshape(shape)
    if arr.ndim == 1 and len(shape) == 1:
        return arr[:n]
    return arr


def params_from_jax(
    np_params: Dict[str, Dict[str, np.ndarray]],
    like: Optional[Dict[str, Dict[str, tuple]]] = None,
    shard: Optional[int] = None,
    model: Optional[int] = None,
    column_parallel: Optional[Dict[str, Iterable[str]]] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """{op_name: {key: numpy}} from the JAX package -> {op_name: {key: tensor}}.
    `like` ({op_name: {key: shape}}, e.g. from the port model's
    `get_parameters()`) unpacks each packed table to its shape there (for
    arrays from the JAX package's `get_parameters()`; its `get_weights`
    unpacks already).

    A fused embedding collection's "pool", [N, R_pad, D] or packed [N, P,
    128] in the JAX package (P * 128 = R_pad * D: the packed layout's
    r_pad is chunk-aligned), becomes shard `shard`'s rows [R_pad, D] (a
    rank of a mesh), or with `shard` None the flat [N * R_pad, D] of one
    device; D comes from `like`, else from an unpacked pool's shape.

    `model`, a rank's model index on a 2-D mesh, with `column_parallel`
    ({op_name: keys} of the column-parallel Dense ops, the port model's
    `_model_parallel`): each array named there (a kernel [out, in] or a
    bias [out], whole in the JAX package) becomes that index's row block,
    [out / M, in] or [out / M], with the rows `like` holds for it (`like`
    is then needed); an array whose shape does not split so raises
    ValueError."""
    if model is not None and (like is None or column_parallel is None):
        raise ValueError("params_from_jax(model=): pass like= (the port model's parameters, which give the "
                         "row blocks' shapes) and column_parallel= (the column-parallel ops' keys)")
    cut = {op: frozenset(keys) for op, keys in (column_parallel or {}).items()} if model is not None else {}

    def fit(op_name, key, arr):
        shape = (like or {}).get(op_name, {}).get(key)
        shape = None if shape is None else tuple(shape.shape) if isinstance(shape, torch.Tensor) else tuple(shape)
        if key == "pool" and np.ndim(arr) == 3:
            arr = np.asarray(arr)
            d = shape[-1] if shape is not None else arr.shape[-1]
            return (arr if shard is None else arr[shard]).reshape(-1, d)
        if shape is None:
            return arr
        if key in cut.get(op_name, ()):
            arr = np.asarray(arr)
            if arr.shape[1:] != shape[1:] or arr.shape[0] % shape[0] or arr.shape[0] // shape[0] <= model:
                raise ValueError(f"params_from_jax: {op_name}/{key} {arr.shape} has no row block {model} of "
                                 f"{shape}")
            return arr[model * shape[0]:(model + 1) * shape[0]]
        return unpack_like(arr, shape)

    return {
        op_name: {key: to_torch(fit(op_name, key, arr)) for key, arr in sub.items()}
        for op_name, sub in np_params.items()
    }
