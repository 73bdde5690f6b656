"""The program under test for the DLRM-DCNv2 family: `dlrm_flexflow_tpu_torch`,
driven through its user entry points (`make_dlrm_model` with the "dcn"
interaction and a bag size a table, `FFModel.compile`, `train_chunk`).

Everything but the model's configuration is the DLRM family's
(`programs/dlrm.py`). A program whose `DLRMConfig` has no cross network
raises ValueError in `build`, before anything is made.
"""
from __future__ import annotations

import dataclasses

from .dlrm import gather, join_mesh, leave_mesh, load_weights, routes, state_reader, storage_dtypes  # noqa: F401


def _port_config(cfg: dict, batch: int):
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig

    if "dcn_num_layers" not in {f.name for f in dataclasses.fields(DLRMConfig)}:
        raise ValueError("the program's DLRMConfig has no 'dcn' interaction (no dcn_num_layers): "
                         "it cannot build DLRM-DCNv2")
    return DLRMConfig(
        sparse_feature_size=cfg["sparse_feature_size"],
        embedding_size=list(cfg["vocab_sizes"]),
        embedding_bag_size=list(cfg["embedding_bag_size"]),
        mlp_bot=list(cfg["mlp_bot"]),
        mlp_top=list(cfg["mlp_top"]),
        arch_interaction_op=cfg["arch_interaction_op"],
        batch_size=batch,
        dcn_num_layers=cfg["dcn_num_layers"],
        dcn_low_rank_dim=cfg["dcn_low_rank_dim"],
    )


def build(cfg: dict, mix: dict, device, mesh=None):
    """`make_dlrm_model` and `FFModel.compile` as the configuration and the
    mix state them: SGD at the mix's rate, BCE, one card."""
    if mesh is not None or mix.get("plan"):
        raise ValueError("the DLRM-DCNv2 cells run on one card")
    port_cfg = _port_config(cfg, mix["batch_size"])
    from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
    from dlrm_flexflow_tpu_torch.models.dlrm import make_dlrm_model

    if mix["optimizer"]["name"] != "sgd":
        raise ValueError(f"unknown optimizer {mix['optimizer']['name']!r}")
    ffc = FFConfig(batch_size=mix["batch_size"], compute_dtype=cfg["compute_dtype"],
                   onehot_embedding_threshold=cfg["onehot_embedding_threshold"],
                   use_pallas=mix["use_pallas"], packed_tables=mix["packed_tables"],
                   host_routing=bool(mix.get("host_routing", False)), table_dtype=cfg["table_dtype"])
    model = make_dlrm_model(port_cfg, ffc, device=device)
    model.compile(SGDOptimizer(lr=float(mix["optimizer"]["lr"])), LossType.LOSS_BINARY_CROSSENTROPY,
                  [MetricsType.METRICS_ACCURACY])
    return model
