"""The program under test for the DLRM family: `dlrm_flexflow_tpu_torch`,
driven through its user entry points.

The port is imported inside these functions only, so the yardstick's
modules (the reference, the counts, the generator) load without it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..weights import draw


def _port_config(cfg: dict, batch: int):
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig

    return DLRMConfig(
        sparse_feature_size=cfg["sparse_feature_size"],
        embedding_size=list(cfg["vocab_sizes"]),
        embedding_bag_size=cfg["embedding_bag_size"],
        mlp_bot=list(cfg["mlp_bot"]),
        mlp_top=list(cfg["mlp_top"]),
        arch_interaction_op=cfg["arch_interaction_op"],
        batch_size=batch,
    )


def build(cfg: dict, mix: dict, device, mesh=None):
    """`make_dlrm_model` and `FFModel.compile` as the configuration and
    the mix state them: SGD at the mix's rate for training (none for
    serving), BCE, the hybrid plan where the mix names it."""
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model
    from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan

    batch = mix["batch_size"]
    ffc = FFConfig(batch_size=batch, compute_dtype=cfg["compute_dtype"],
                   onehot_embedding_threshold=cfg["onehot_embedding_threshold"],
                   use_pallas=mix["use_pallas"], packed_tables=mix["packed_tables"],
                   host_routing=bool(mix.get("host_routing", False)), table_dtype=cfg["table_dtype"])
    model = make_dlrm_model(_port_config(cfg, batch), ffc, device=device)
    opt = None
    if mix["mode"] == "train":
        if mix["optimizer"]["name"] != "sgd":
            raise ValueError(f"unknown optimizer {mix['optimizer']['name']!r}")
        opt = SGDOptimizer(lr=float(mix["optimizer"]["lr"]))
    plan = dlrm_hybrid_plan() if mix.get("plan") == "dlrm_hybrid" else None
    model.compile(opt, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                  mesh=None if mesh is None else mesh.port, plan=plan if mesh is not None else None)
    return model


def storage_dtypes(model, leaves) -> Dict[str, str]:
    """Each table leaf whose storage dtype in the model is not the one the
    configuration states (empty when the program follows it). A table
    fused into a sharded collection is read from the collection's pool."""
    params = model.get_parameters()
    wrong = {}
    for leaf in leaves:
        if leaf.key != "weight":
            continue
        if leaf.op in params:
            got = params[leaf.op]["weight"].dtype
        else:
            fused = model._fused_table(leaf.op)
            got = params[fused[0].name]["pool"].dtype
        want = {"float32": torch.float32, "bfloat16": torch.bfloat16}[leaf.dtype]
        if got != want:
            wrong[leaf.op] = f"{got} (the configuration states {leaf.dtype})"
    return wrong


def load_weights(model, leaves, seed: int, device) -> None:
    """Every leaf drawn from the seed on the device, one op at a time, and
    handed to the model with `set_weights`."""
    ops: Dict[str, List] = {}
    for i, leaf in enumerate(leaves):
        ops.setdefault(leaf.op, []).append((i, leaf))
    for op, items in ops.items():
        model.set_weights(op, {leaf.key: draw(leaf, i, seed, device) for i, leaf in items})


def routes(model, sparse: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The host routes of each batch of the stacks (`compute_routes` on the
    host copy of its ids, then `stage_routes`), stacked [K, n]."""
    host = {k: v.cpu().numpy() for k, v in sparse.items()}
    k = next(iter(host.values())).shape[0]
    per = [model.stage_routes(model.compute_routes({n: np.ascontiguousarray(a[i]) for n, a in host.items()}))
           for i in range(k)]
    return {key: torch.stack([r[key] for r in per]) for key in per[0]}


def state_reader(model, mesh=None):
    """leaf -> the model's current value of that parameter, on the device,
    in its storage dtype (read it before the next step). A table fused into
    the sharded collection is gathered whole from the ranks that hold its
    rows (`FFModel._table_weight`, a collective: every rank reads the same
    leaves in the same order)."""
    params = model.get_parameters()

    def read(leaf):
        if leaf.op in params:
            return params[leaf.op][leaf.key]
        return model._table_weight(*model._fused_table(leaf.op))

    return read


class Ranks:
    """This process's place among a cell's ranks: the port's launcher's
    world joined over NCCL (`launch.initialize`), its 1-D mesh, and a gloo
    group for the host's own decisions (when the window ends) and for
    gathering the ranks' readings."""

    def __init__(self, device: str = "cuda"):
        import torch.distributed as dist
        from dlrm_flexflow_tpu_torch.launch import initialize
        from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh

        initialize(device)
        self.port = make_mesh(device=device)
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.control = dist.new_group(backend="gloo")


def join_mesh(device: str = "cuda") -> Ranks:
    return Ranks(device)


def leave_mesh(ranks: Ranks) -> None:
    import torch.distributed as dist

    dist.destroy_process_group()


def gather(ranks: Ranks, summaries, peak: int):
    """Every rank's trace summaries (rank 0 gets the list, in rank order)
    and the largest peak memory over the ranks."""
    import torch.distributed as dist

    box = [None] * ranks.size
    dist.all_gather_object(box, (summaries, int(peak)), group=ranks.control)
    return [s for got, _ in box for s in got], max(p for _, p in box)
