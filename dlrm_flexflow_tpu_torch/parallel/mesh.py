"""The device mesh: one process a device over the default process group.

The port of `dlrm_flexflow_tpu/parallel/mesh.py`. JAX arranges every device
of every host in one `jax.sharding.Mesh` and shards arrays over it; the port
runs one process a device (`launch.py` starts them, `launch.initialize`
joins them into the default process group: NCCL on CUDA, gloo on the CPU)
and a `Mesh` is this process's view of that group: its shape and axis
names, its rank and size, and its device. The "data" axis is the batch
axis: rank r holds rows [r * B / N, (r + 1) * B / N) of each global batch
(`batch_slice`, which stands in for the JAX package's `data_sharding`).

The mesh never shares a card between two ranks and never changes the
backend: a CUDA mesh needs NCCL and one card a local rank, a CPU mesh gloo;
anything else raises. A 2-D (data x model) mesh is ROADMAP.md Queue 1 item
7, a later slice.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .plan import TWO_D_MESH


class Mesh:
    """This rank's view of the default process group as a 1-D "data" mesh."""

    def __init__(self, device=None):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh: no process group; call dlrm_flexflow_tpu_torch.launch."
                               "initialize() first (the launcher's processes do it through it)")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.shape: Tuple[int, ...] = (self.size,)
        self.axis_names: Tuple[str, ...] = ("data",)
        backend = dist.get_backend()
        want = torch.device(device if device is not None else ("cuda" if backend == "nccl" else "cpu"))
        if want.type == "cuda":
            if backend != "nccl":
                raise RuntimeError(f"a CUDA mesh needs the NCCL backend, the process group has {backend}")
            local_rank = int(os.environ.get("LOCAL_RANK", self.rank))
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", self.size))
            if torch.cuda.device_count() < local_world:
                raise RuntimeError(f"{local_world} ranks on this host but {torch.cuda.device_count()} "
                                   "visible CUDA devices: a rank never shares a card")
            self.device = torch.device("cuda", local_rank if want.index is None else want.index)
        elif want.type == "cpu":
            if backend != "gloo":
                raise RuntimeError(f"a CPU mesh needs the gloo backend, the process group has {backend}")
            self.device = want
        else:
            raise ValueError(f"make_mesh: device {want} is neither cuda nor cpu")
        self._groups: Dict[tuple, object] = {}

    def batch_slice(self, n: int) -> slice:
        """This rank's rows of a global batch of n (n divisible by the size)."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} does not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def subgroup(self, partition: Sequence[Sequence[int]]):
        """The process group of this rank's block of `partition` (blocks of
        ranks covering the world). Made once a partition, by
        `dist.new_group` for every block on every rank, in one order, which
        every rank must reach alike."""
        key = tuple(tuple(int(r) for r in block) for block in partition)
        if key not in self._groups:
            mine = None
            for block in key:
                group = dist.new_group(list(block))
                if self.rank in block:
                    mine = group
            if mine is None:
                raise ValueError(f"rank {self.rank} is in no block of {key}")
            self._groups[key] = mine
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, axis_names={self.axis_names}, rank={self.rank}, device={self.device})"


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = ("data",),
              device=None) -> Mesh:
    """A 1-D "data" mesh over every rank of the default process group, on
    `device` (default: this rank's card under NCCL, the CPU under gloo).
    `shape`, if given, must be (world size,)."""
    if shape is not None and len(tuple(shape)) != 1:
        raise NotImplementedError(f"make_mesh(shape={tuple(shape)}): {TWO_D_MESH}")
    if tuple(axis_names[:1]) != ("data",):
        raise NotImplementedError(f"make_mesh(axis_names={tuple(axis_names)}): {TWO_D_MESH}")
    mesh = Mesh(device)
    if shape is not None and int(shape[0]) != mesh.size:
        raise ValueError(f"make_mesh(shape={tuple(shape)}) over a world of {mesh.size} ranks")
    return mesh


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device: str = "cuda") -> None:
    """Join this process to the default process group (`launch.initialize`)."""
    from ..launch import initialize

    initialize(device, coordinator=coordinator_address, world_size=num_processes, rank=process_id)
