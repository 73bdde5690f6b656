"""The device mesh: one process a device over the default process group.

The port of `dlrm_flexflow_tpu/parallel/mesh.py`. JAX arranges every device
of every host in one `jax.sharding.Mesh` and shards arrays over it; the port
runs one process a device (`launch.py` starts them, `launch.initialize`
joins them into the default process group: NCCL on CUDA, gloo on the CPU)
and a `Mesh` is this process's view of that group: its shape and axis
names, its rank and size, and its device.

A mesh is 1-D, ("data",) over every rank, or 2-D, ("data", "model") of
shape (D, M) with D * M ranks. Ranks lie row-major, as `make_mesh` of the
JAX package reshapes its device list: rank r sits at data index r // M and
model index r % M. The "data" axis is the batch axis: data index d holds
rows [d * B / D, (d + 1) * B / D) of each global batch (`batch_slice`,
which stands in for the JAX package's `data_sharding`); the ranks of one
data index hold the same rows. The "model" axis shards the wide Dense
layers' output channels (parallel/tensor_parallel.py). `data_group()` is
the process group of the ranks with this rank's model index (the data
axis's collectives: the exchange, the gradient and metric all-reduces),
`model_group()` that of the ranks with this rank's data index (the tensor-
parallel collectives). An axis that spans the world uses the default group,
so a 1-D mesh and a (D, 1) one run every collective as before; a 2-D mesh
with both axes above 1 makes both partitions' groups when it is built
(`Mesh.subgroup`, every rank in one order), and raises if it cannot.

The mesh never shares a card between two ranks and never changes the
backend: a CUDA mesh needs NCCL and one card a local rank, a CPU mesh gloo;
anything else raises.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES_2D = ("data", "model")


class Mesh:
    """This rank's view of the default process group as a ("data",) mesh or
    a ("data", "model") one."""

    def __init__(self, device=None, shape: Optional[Tuple[int, ...]] = None,
                 axis_names: Sequence[str] = ("data",)):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh: no process group; call dlrm_flexflow_tpu_torch.launch."
                               "initialize() first (the launcher's processes do it through it)")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape) if shape is not None else (self.size,)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.data_size = self.shape[0]
        self.model_size = self.shape[1] if len(self.shape) == 2 else 1
        self.data_index, self.model_index = divmod(self.rank, self.model_size)
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
        self._data_group = self._model_group = None
        if self.data_size > 1 and self.model_size > 1:
            # both partitions, on every rank, in this order
            self._data_group = self.subgroup(
                [[d * self.model_size + m for d in range(self.data_size)] for m in range(self.model_size)])
            self._model_group = self.subgroup(
                [[d * self.model_size + m for m in range(self.model_size)] for d in range(self.data_size)])

    def batch_slice(self, n: int) -> slice:
        """This rank's rows of a global batch of n (n divisible by the data
        axis): its data index's block."""
        if n % self.data_size:
            raise ValueError(f"a global batch of {n} does not split over {self.data_size} data indices")
        b = n // self.data_size
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def data_group(self):
        """The process group of the data axis (the ranks of this model
        index): the default group where the model axis is 1."""
        if self.model_size == 1:
            return None
        if self.data_size == 1:
            raise ValueError(f"{self!r}: the data axis is 1, so it has no collective")
        return self._data_group

    def model_group(self):
        """The process group of the model axis (the ranks of this data
        index): the default group where the data axis is 1."""
        if self.data_size == 1:
            return None
        if self.model_size == 1:
            raise ValueError(f"{self!r}: the model axis is 1, so it has no collective")
        return self._model_group

    def data_peer(self, d: int) -> int:
        """The world rank at data index d and this rank's model index."""
        return int(d) * self.model_size + self.model_index

    def data_subgroup(self, partition: Sequence[Sequence[int]]):
        """The process group of this rank's block of `partition`, a
        partition of the data indices (the hierarchical exchange's host and
        cross-host groups): each block taken at every model index, so that
        the blocks cover the world (`subgroup`)."""
        return self.subgroup([[d * self.model_size + m for d in block]
                              for m in range(self.model_size) for block in partition])

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
    """A mesh over every rank of the default process group, on `device`
    (default: this rank's card under NCCL, the CPU under gloo): with
    `shape` None or (world size,) the 1-D "data" mesh; with (D, M) and
    axis_names ("data", "model"), D * M the world size, the 2-D mesh."""
    shape = None if shape is None else tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if shape is None or len(shape) == 1:
        if names[:1] != ("data",):
            raise ValueError(f"make_mesh(axis_names={names}): a 1-D mesh's axis is 'data'")
        mesh = Mesh(device)
        if shape is not None and shape[0] != mesh.size:
            raise ValueError(f"make_mesh(shape={shape}) over a world of {mesh.size} ranks")
        return mesh
    if len(shape) != 2 or names != AXES_2D:
        raise ValueError(f"make_mesh(shape={shape}, axis_names={names}): a 2-D mesh is (D, M) over "
                         f"{AXES_2D}")
    world = dist.get_world_size() if dist.is_initialized() else None
    if world is not None and shape[0] * shape[1] != world:
        raise ValueError(f"make_mesh(shape={shape}) over a world of {world} ranks")
    return Mesh(device, shape, names)


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device: str = "cuda") -> None:
    """Join this process to the default process group (`launch.initialize`)."""
    from ..launch import initialize

    initialize(device, coordinator=coordinator_address, world_size=num_processes, rank=process_id)
