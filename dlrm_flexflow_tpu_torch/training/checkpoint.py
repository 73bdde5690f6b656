"""Checkpoint / resume.

PyTorch counterpart of `dlrm_flexflow_tpu/training/checkpoint.py`, writing
the same on-disk format: a directory with `params.npz`, `opt_state.npz` and
`metrics.npz` (the model's parameters, optimizer state and metric totals,
flattened to "a/b/c" keys by `_flatten`, a None leaf as "<path>/__none__")
and `manifest.json` (`version`, `step`, `host_tail`, `extra`), and under
host-tail offload `host_tail.npz` (each store's touched rows, their values
and their AdaGrad accumulators, "<op>/rows|vals|acc", as the JAX package
writes them, training/checkpoint.py:71-86). No pickle. A
bf16 tensor is written as the JAX package writes a bf16 array, 2-byte void
records of its bits ("|V2"), and read back bit for bit. Adam's sparse state
is written in the layout the port keeps on each route: {"m", "v"} pools on
the row-update kernel route, one stacked [2, V, D] array on the scatter
route, as the JAX package keeps its packed and scatter tables.

Under a mesh of several ranks saving is collective and rank 0 writes
while every other rank waits at a barrier for the files. A model sharded
over the data axis holds one shard of the fused collection's pool and of
its sparse optimizer state a data index: the ranks of model index 0 send
their shard of each such tensor to rank 0 (`torch.distributed.gather`
over the data group), which writes them stacked shard-leading, [N, *shard
shape] (the pool as [N, R_pad, D], the shape `get_weights` gives it and
the JAX package's unpacked pool has), with the replicated rest as one
device would. A column-parallel Dense (a model axis above 1) holds a row
block of its kernel, its bias and their dense optimizer state: the ranks
of data index 0 gather the blocks over the model group to rank 0, which
writes them whole, in the JAX package's shapes ([out, in], [out]).
Host-tail stores are replicas, the same on every rank: `host_tail.npz`
holds rank 0's. Restoring is collective too: every rank reads the files,
keeps its own shard and its own row blocks (the JAX package leaves a
restored optimizer state unsharded, training/checkpoint.py:128; the
values are the same) and restores its store replicas.

`restore_checkpoint` writes into the compiled model's own tensors (in
place), so a train step captured in a CUDA graph (`FFModel.train_chunk`)
stays valid; it needs the same keys and shapes as the model has, and a
checkpoint the JAX package wrote of the same model and config restores
too: a table the JAX package keeps packed [P, 128] (a mid-band table, and
with it the dense optimizer's state of that table) is unpacked to the
port's [V, D] as `unpack_table` does (convert.py).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..convert import to_torch, unpack_like
from ..ops.embedding_collection_op import EmbeddingCollection


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is None:
        out[prefix + "__none__"] = np.zeros(0, np.int8)
    else:
        out[prefix.rstrip("/")] = _host(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    none_paths = []
    for key, val in flat.items():
        parts = key.split("/")
        if parts[-1] == "__none__":
            if len(parts) == 1:
                return None
            none_paths.append(parts[:-1])
            continue
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    for path in none_paths:
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = None
    return root


def _host(x) -> np.ndarray:
    """A tensor (or a host step count) as numpy; bf16 as |V2 records."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x, np.int32 if isinstance(x, int) else None)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return to_torch(arr)


def _sharded_collection(model) -> Optional[EmbeddingCollection]:
    """The fused collection when it is sharded over the model's mesh."""
    return next((op for op in model.graph.compute_ops if isinstance(op, EmbeddingCollection) and op.sharded),
                None)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _gather_shards(t: torch.Tensor, rank: int, size: int, group=None) -> Optional[torch.Tensor]:
    """[N, *t.shape] on the group's rank 0 (None elsewhere): the t of each
    of the `size` ranks of `group` (None: the world), `rank` this rank's
    place in it. A bf16 tensor travels as its bits viewed as f16, a type
    both NCCL and gloo move (a gather copies bytes, so no value changes)."""
    bits = t.detach().contiguous()
    wire = bits.view(torch.float16) if bits.dtype == torch.bfloat16 else bits
    parts = [torch.empty_like(wire) for _ in range(size)] if rank == 0 else None
    dist.gather(wire, parts, dst=0 if group is None else dist.get_global_rank(group, 0), group=group)
    if rank != 0:
        return None
    out = torch.stack(parts)
    return out.view(torch.bfloat16) if bits.dtype == torch.bfloat16 else out


def _map_model_parallel(fn, tree, tp, path=()):
    """`tree` with `fn` applied to each array of a column-parallel
    parameter: a leaf under .../<op>/<key> with key in tp[op] (the
    parameters and every dense optimizer state keyed by op and key)."""
    if isinstance(tree, dict):
        return {k: _map_model_parallel(fn, v, tp, path + (k,)) for k, v in tree.items()}
    if tree is not None and len(path) >= 2 and path[-1] in tp.get(path[-2], ()):
        return fn(tree)
    return tree


def _whole(t: torch.Tensor, mesh) -> Optional[torch.Tensor]:
    """A column-parallel tensor's row blocks gathered over the model group,
    whole on the group's first rank (None elsewhere)."""
    out = _gather_shards(t, mesh.model_index, mesh.model_size, mesh.model_group())
    return None if out is None else out.reshape((-1,) + tuple(t.shape[1:]))


def _own_rows(a: np.ndarray, mesh) -> np.ndarray:
    """This rank's row block of a column-parallel array saved whole."""
    if a.ndim == 0 or a.shape[0] % mesh.model_size:
        raise ValueError(f"restore_checkpoint: a column-parallel array of shape {a.shape} does not split "
                         f"over the model axis of {mesh.model_size}")
    n = a.shape[0] // mesh.model_size
    return a[mesh.model_index * n:(mesh.model_index + 1) * n]


def _own_shard(a: np.ndarray, coll: EmbeddingCollection, size: int) -> np.ndarray:
    """This rank's [*shard shape] of a stacked [N, *shard shape] array."""
    if a.ndim == 0 or a.shape[0] != size:
        raise ValueError(f"restore_checkpoint: {coll.name} holds an array of shape {a.shape}, not one "
                         f"shard for each of the mesh's {size} ranks")
    return a[coll.shard]


def save_checkpoint(path: str, model, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write train state: params, optimizer state, step counter, metrics.
    Under a mesh of several ranks every rank calls it (the shards and row
    blocks gather to rank 0, which writes) and it returns once the files
    are written."""
    params, opt = model.get_parameters(), model._opt_state
    mesh = model.mesh
    coll = _sharded_collection(model)
    if coll is not None and mesh.model_index == 0:
        rank, size, group = mesh.data_index, mesh.data_size, mesh.data_group()

        def gather(t):
            return _gather_shards(t, rank, size, group)

        params = {**params, coll.name: _map(gather, params[coll.name])}
        opt = {**opt, "sparse": {**opt["sparse"], coll.name: _map(gather, opt["sparse"][coll.name])}}
    tp = model._model_parallel
    if tp and mesh.data_index == 0:
        params, opt = (_map_model_parallel(lambda t: _whole(t, mesh), tree, tp) for tree in (params, opt))
    if mesh is None or mesh.rank == 0:
        _write(path, model, params, opt, extra)
    if mesh is not None and mesh.size > 1:
        dist.barrier()  # every rank returns once the files are there


def _write(path: str, model, params, opt, extra) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))
    np.savez(os.path.join(path, "opt_state.npz"), **_flatten(opt))
    np.savez(os.path.join(path, "metrics.npz"), **_flatten(model._metrics_total))
    ht = model._host_tail
    if ht is not None and ht.entries:
        blobs = {}
        for name, (store, *_rest) in ht.entries.items():
            blobs[f"{name}/rows"], blobs[f"{name}/vals"], blobs[f"{name}/acc"] = store.state()
        np.savez(os.path.join(path, "host_tail.npz"), **blobs)
    manifest = {
        "version": 1,
        "step": int(model._step_count),
        "host_tail": bool(ht is not None and ht.entries),
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def _check_tree(have, got, key: str = "") -> None:
    """The keys and shapes of the file's tree `got` against the model's
    `have` (tensors, shape tuples, host ints or None), before any write."""
    def fail(what):
        raise ValueError(f"restore_checkpoint: {key or 'the tree'} {what}. Shapes must match "
                         "(same model/config).")

    if isinstance(have, dict):
        if not isinstance(got, dict) or set(got) != set(have):
            fail(f"holds {sorted(got) if isinstance(got, dict) else type(got).__name__}, "
                 f"the model {sorted(have)}")
        for k, v in have.items():
            _check_tree(v, got[k], f"{key}/{k}".lstrip("/"))
    elif (have is None) != (got is None):
        fail("is None on one side only")
    elif isinstance(have, (torch.Tensor, tuple)):
        shape = tuple(have.shape) if isinstance(have, torch.Tensor) else have
        if tuple(np.shape(got)) != shape:
            fail(f"has shape {tuple(np.shape(got))}, the model {shape}")


def _copy_into(have, got):
    """Write the file's tree `got` into the model's tree `have`, in place;
    returns the tree to keep (a host step count stays an int)."""
    if isinstance(have, dict):
        return {k: _copy_into(v, got[k]) for k, v in have.items()}
    if have is None:
        return None
    if isinstance(have, int):
        return int(got)
    with torch.no_grad():
        have.copy_(_tensor(got))
    return have


def _unpack_midband(got, have, midband, under=False):
    """The file's tree `got` with each array under a mid-band op's name
    unpacked to the shape the model's tree `have` holds there."""
    if isinstance(got, dict) and isinstance(have, dict):
        return {k: _unpack_midband(v, have[k], midband, under or k in midband) if k in have else v
                for k, v in got.items()}
    if under and isinstance(got, np.ndarray) and isinstance(have, (torch.Tensor, tuple)):
        return unpack_like(got, tuple(have.shape) if isinstance(have, torch.Tensor) else have)
    return got


def restore_checkpoint(path: str, model) -> Dict[str, Any]:
    """Restore state saved by save_checkpoint (by either package) into a
    compiled model, in place, the host-tail stores included. Shapes must
    match (same model/config); ValueError otherwise, and for a checkpoint
    with host-tail stores into a model without them. Under a mesh every
    rank reads the files and keeps its shard of the sharded collection's
    arrays and its row block of each column-parallel array. Returns the
    manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    ht = model._host_tail
    if manifest.get("host_tail") and not (ht is not None and ht.entries):
        raise ValueError("restore_checkpoint: the checkpoint carries host-tail stores but the model "
                         "has none (compile with the same host_tail_threshold)")

    def load_npz(name):
        with np.load(os.path.join(path, name)) as z:
            return _unflatten({k: z[k] for k in z.files})

    params, opt, totals = (load_npz(n) for n in ("params.npz", "opt_state.npz", "metrics.npz"))
    coll = _sharded_collection(model)
    if coll is not None:
        size = model.mesh.data_size
        params[coll.name] = _map(lambda a: _own_shard(a, coll, size), params.get(coll.name, {}))
        if isinstance(opt, dict) and isinstance(opt.get("sparse"), dict) and coll.name in opt["sparse"]:
            opt["sparse"][coll.name] = _map(lambda a: _own_shard(a, coll, size), opt["sparse"][coll.name])
    tp = model._model_parallel
    if tp:
        params, opt = (_map_model_parallel(lambda a: _own_rows(a, model.mesh), tree, tp) for tree in (params, opt))
    midband = {op.name for op in model.graph.compute_ops if getattr(op, "onehot_packed", False)}
    layout = {op: {k: shape for k, (shape, _) in sub.items()} for op, sub in model._layout.items()}
    params = _unpack_midband(params, layout, midband)
    opt = _unpack_midband(opt, model._opt_state, midband)
    _check_tree(layout, params)
    _check_tree(model._opt_state, opt)
    _check_tree(model._metrics_total, totals)
    model.set_parameters({op: {k: _tensor(a) for k, a in sub.items()} for op, sub in params.items()})
    model._opt_state = _copy_into(model._opt_state, opt)
    _copy_into(model._metrics_total, totals)
    model._step_count = int(manifest["step"])
    if manifest.get("host_tail"):
        with np.load(os.path.join(path, "host_tail.npz")) as z:
            for name, (store, *_rest) in ht.entries.items():
                acc = f"{name}/acc"
                store.load_state(z[f"{name}/rows"], z[f"{name}/vals"], z[acc] if acc in z.files else None)
    return manifest
