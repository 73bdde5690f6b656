"""DLRM model builder.

PyTorch counterpart of `dlrm_flexflow_tpu/models/dlrm.py`: the same config
dataclass, flag parser, graph (op names, order and parameter shapes) and the
six configs. Bottom MLP over the dense features -> one pooled embedding per
table -> feature interaction ("cat", or "dot" whose output is [pairs, x]) ->
top MLP -> sigmoid score (reference: examples/cpp/DLRM/dlrm.cc:49-195).

Beyond the JAX package: a bag size for each table (`embedding_bag_size` a
list; one int still means every table), and the interaction "dcn", DCN-V2's
low-rank cross network over [x, pooled embeddings] (`ops/cross.py`), whose
MLPerf Training shape `dcnv2_config` gives.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from ..config import FFConfig
from ..core.ffmodel import FFModel
from ..core.initializers import GlorotUniform
from ..core.tensor import TensorSpec
from ..ffconst import ActiMode, AggrMode, DataType


@dataclasses.dataclass
class DLRMConfig:
    """reference: app flags at dlrm.cc:197-260."""

    sparse_feature_size: int = 16
    embedding_size: List[int] = dataclasses.field(
        default_factory=lambda: [1000000, 1000000, 1000000, 1000000]
    )
    # ids a bag: one int for every table, or one a table
    embedding_bag_size: Union[int, List[int]] = 1
    mlp_bot: List[int] = dataclasses.field(default_factory=lambda: [13, 512, 256, 64, 16])
    mlp_top: List[int] = dataclasses.field(default_factory=lambda: [80, 256, 1])
    sigmoid_bot: int = -1  # index of bottom layer with sigmoid (reference semantics)
    sigmoid_top: int = -1  # defaulted to last top layer in __post_init__
    arch_interaction_op: str = "cat"  # "cat" | "dot" | "dcn"
    loss_threshold: float = 0.0
    data_size: int = -1
    batch_size: int = 64
    # "dcn": the cross network's layers and their rank
    dcn_num_layers: int = 3
    dcn_low_rank_dim: int = 512

    def __post_init__(self):
        if self.sigmoid_top < 0:
            self.sigmoid_top = len(self.mlp_top) - 2  # last layer sigmoid
        if self.arch_interaction_op not in ("cat", "dot", "dcn"):
            raise ValueError(f"unknown interaction op {self.arch_interaction_op!r}")
        # dot pairs the bottom output with each D-dim embedding, and dcn
        # crosses [x, embeddings] as (tables + 1) D-wide fields, so the
        # bottom MLP must end at D
        if self.arch_interaction_op in ("dot", "dcn") and self.mlp_bot[-1] != self.sparse_feature_size:
            raise ValueError(
                f"{self.arch_interaction_op} interaction: bottom MLP must end at "
                f"sparse_feature_size ({self.mlp_bot[-1]} != {self.sparse_feature_size})"
            )
        if not isinstance(self.embedding_bag_size, int) and len(self.embedding_bag_size) != self.num_tables:
            raise ValueError(f"{len(self.embedding_bag_size)} bag sizes for {self.num_tables} tables")

    @property
    def num_tables(self) -> int:
        return len(self.embedding_size)

    def bag_sizes(self) -> List[int]:
        """The bag size of each table."""
        b = self.embedding_bag_size
        return [int(b)] * self.num_tables if isinstance(b, int) else [int(x) for x in b]

    def top_in_dim(self) -> int:
        f = self.num_tables + 1
        d = self.sparse_feature_size
        if self.arch_interaction_op == "cat":
            return self.mlp_bot[-1] + self.num_tables * d
        if self.arch_interaction_op == "dot":
            return f * (f - 1) // 2 + d
        if self.arch_interaction_op == "dcn":
            return f * d
        raise ValueError(self.arch_interaction_op)

    @staticmethod
    def parse_args(argv) -> "DLRMConfig":
        """Consume reference-spelled DLRM flags (dlrm.cc:197-260)."""
        cfg = DLRMConfig()
        i = 0
        args = list(argv)

        def take():
            nonlocal i
            i += 1
            return args[i]

        while i < len(args):
            a = args[i]
            if a == "--arch-sparse-feature-size":
                cfg.sparse_feature_size = int(take())
            elif a == "--arch-embedding-size":
                cfg.embedding_size = [int(x) for x in take().split("-")]
            elif a == "--embedding-bag-size":
                bags = [int(x) for x in take().split("-")]
                cfg.embedding_bag_size = bags[0] if len(bags) == 1 else bags
            elif a == "--arch-mlp-bot":
                cfg.mlp_bot = [int(x) for x in take().split("-")]
            elif a == "--arch-mlp-top":
                cfg.mlp_top = [int(x) for x in take().split("-")]
            elif a == "--sigmoid-bot":
                cfg.sigmoid_bot = int(take())
            elif a == "--sigmoid-top":
                cfg.sigmoid_top = int(take())
            elif a == "--arch-interaction-op":
                cfg.arch_interaction_op = take()
            elif a == "--loss-threshold":
                cfg.loss_threshold = float(take())
            elif a == "--data-size":
                cfg.data_size = int(take())
            i += 1
        cfg.__post_init__()
        return cfg


def create_mlp(
    model: FFModel,
    input: TensorSpec,
    ln: Sequence[int],
    sigmoid_layer: int,
    prefix: str,
) -> TensorSpec:
    """reference: create_mlp at dlrm.cc:49-65 — chain of dense layers, relu
    everywhere except `sigmoid_layer` which gets sigmoid."""
    t = input
    for i in range(len(ln) - 1):
        activation = (
            ActiMode.AC_MODE_SIGMOID if i == sigmoid_layer else ActiMode.AC_MODE_RELU
        )
        t = model.dense(
            t,
            ln[i + 1],
            activation=activation,
            kernel_initializer=GlorotUniform(),
            name=f"{prefix}_{i}",
        )
    return t


def interact_features(
    model: FFModel,
    x: TensorSpec,
    ly: Sequence[TensorSpec],
    interaction: str,
    dcn_num_layers: int = 3,
    dcn_low_rank_dim: int = 512,
) -> TensorSpec:
    """reference: interact_features at dlrm.cc:67-75. "dot" stacks
    [x] + ly and concatenates [pairs, x], pairs first; "dcn" crosses
    x0 = [x] + ly, dense part first, through the low-rank cross network
    (TorchRec's `DLRM_DCN`)."""
    if interaction == "cat":
        return model.concat([x] + list(ly), axis=1, name="interaction_cat")
    if interaction == "dot":
        pairs = model.dot_interaction([x] + list(ly), name="interaction_dot")
        return model.concat([pairs, x], axis=1, name="interaction_cat")
    if interaction == "dcn":
        x0 = model.concat([x] + list(ly), axis=1, name="interaction_cat")
        return model.cross_network(x0, dcn_num_layers, dcn_low_rank_dim, name="cross")
    raise ValueError(f"unknown interaction op {interaction}")


def build_dlrm(
    model: FFModel, dlrm: DLRMConfig, batch_size: Optional[int] = None
) -> TensorSpec:
    """Build the DLRM graph onto `model`; returns the prediction tensor."""
    bs = batch_size or model.config.batch_size
    dense_in = model.create_tensor([bs, dlrm.mlp_bot[0]], name="dense_features")
    sparse_in = [
        model.create_tensor([bs, bag], DataType.DT_INT64, name=f"sparse_{i}")
        for i, bag in enumerate(dlrm.bag_sizes())
    ]
    x = create_mlp(model, dense_in, dlrm.mlp_bot, dlrm.sigmoid_bot, "bot_mlp")
    ly = [
        model.embedding(
            sparse_in[i],
            dlrm.embedding_size[i],
            dlrm.sparse_feature_size,
            AggrMode.AGGR_MODE_SUM,
            name=f"table_{i}",
        )
        for i in range(dlrm.num_tables)
    ]
    z = interact_features(model, x, ly, dlrm.arch_interaction_op, dlrm.dcn_num_layers, dlrm.dcn_low_rank_dim)
    if z.shape[1] != dlrm.mlp_top[0]:
        raise ValueError(
            f"top MLP input dim mismatch: interaction gives {z.shape[1]}, "
            f"mlp_top starts at {dlrm.mlp_top[0]}"
        )
    return create_mlp(model, z, dlrm.mlp_top, dlrm.sigmoid_top, "top_mlp")


def make_dlrm_model(
    dlrm: DLRMConfig, ff_config: Optional[FFConfig] = None, device="cuda"
) -> FFModel:
    cfg = ff_config or FFConfig(batch_size=dlrm.batch_size)
    model = FFModel(cfg, device=device)
    build_dlrm(model, dlrm, cfg.batch_size)
    return model


def tiny_config(batch_size: int = 64) -> DLRMConfig:
    """Tiny-DLRM: 8 tables x 100K x dim 16."""
    return DLRMConfig(
        sparse_feature_size=16,
        embedding_size=[100000] * 8,
        embedding_bag_size=1,
        mlp_bot=[13, 512, 256, 64, 16],
        mlp_top=[144, 512, 256, 1],
        arch_interaction_op="cat",
        batch_size=batch_size,
    )


def kaggle_config(batch_size: int = 256) -> DLRMConfig:
    """reference: run_criteo_kaggle.sh — 26 tables, dim 16,
    bot 13-512-256-64-16, top 432-512-256-1, cat interaction."""
    vocab = [
        1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
        8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
        15, 286181, 105, 142572,
    ]
    return DLRMConfig(
        sparse_feature_size=16,
        embedding_size=vocab,
        embedding_bag_size=1,
        mlp_bot=[13, 512, 256, 64, 16],
        mlp_top=[(26 + 1) * 16, 512, 256, 1],
        arch_interaction_op="cat",
        batch_size=batch_size,
    )


def mlperf_config(batch_size: int = 2048, num_tables: int = 26) -> DLRMConfig:
    """MLPerf-style Criteo Terabyte config: dim 128 tables, dot interaction."""
    vocab = [
        227605432, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 130229467,
        3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 292775614,
        40790948, 187188510, 590152, 12973, 108, 36,
    ][:num_tables]
    f = num_tables + 1
    return DLRMConfig(
        sparse_feature_size=128,
        embedding_size=vocab,
        embedding_bag_size=1,
        mlp_bot=[13, 512, 256, 128],
        mlp_top=[f * (f - 1) // 2 + 128, 1024, 1024, 512, 256, 1],
        arch_interaction_op="dot",
        batch_size=batch_size,
    )


def mlperf_lite_config(batch_size: int = 2048, vocab_cap: int = 2_000_000) -> DLRMConfig:
    """MLPerf Terabyte shapes (26 tables, D=128, dot interaction) with the
    vocabs clipped to `vocab_cap` rows so the model fits one device
    (13,116,632 rows, 6.7 GB of f32 tables at the default cap)."""
    cfg = mlperf_config(batch_size=batch_size)
    cfg.embedding_size = [min(v, vocab_cap) for v in cfg.embedding_size]
    return cfg


# MLPerf Training's recommendation model (mlcommons/training
# recommendation_v2/torchrec_dlrm, its README's run flags): the Criteo 1TB
# multi-hot tables capped at 40M rows, and the bag size of each
DCNV2_VOCAB = [
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000, 3067956, 405282, 10, 2209,
    11938, 155, 4, 976, 14, 40000000, 40000000, 40000000, 590152, 12973, 108, 36,
]
DCNV2_BAGS = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1]


def dcnv2_config(batch_size: int = 65536) -> DLRMConfig:
    """DLRM-DCNv2 of MLPerf Training: 26 multi-hot tables at D = 128
    (204,184,588 rows, 214 ids an example), bottom 13-512-256-128, three
    low-rank cross layers of rank 512 over the 27 x 128 = 3456-wide x0, top
    3456-1024-1024-512-256-1."""
    return DLRMConfig(
        sparse_feature_size=128,
        embedding_size=list(DCNV2_VOCAB),
        embedding_bag_size=list(DCNV2_BAGS),
        mlp_bot=[13, 512, 256, 128],
        mlp_top=[27 * 128, 1024, 1024, 512, 256, 1],
        arch_interaction_op="dcn",
        batch_size=batch_size,
        dcn_num_layers=3,
        dcn_low_rank_dim=512,
    )


def summit_large_config(batch_size: int = 512, num_tables: int = 6) -> DLRMConfig:
    """reference: examples/cpp/DLRM/run_summit_large.sh — 1M-row tables dim
    64 with multi-hot bags of 100, bot 2048-4096x5, top 4096x4-1."""
    return DLRMConfig(
        sparse_feature_size=64,
        embedding_size=[1_000_000] * num_tables,
        embedding_bag_size=100,
        mlp_bot=[2048, 4096, 4096, 4096, 4096, 4096],
        mlp_top=[4096 + num_tables * 64, 4096, 4096, 4096, 4096, 1],
        arch_interaction_op="cat",
        batch_size=batch_size,
    )


def summit_config(batch_size: int = 512) -> DLRMConfig:
    """reference: examples/cpp/DLRM/run_summit.sh — 8x1M-row tables dim 64,
    bot 64-512-512-64, top 576-1024-1024-1024-1."""
    return DLRMConfig(
        sparse_feature_size=64,
        embedding_size=[1_000_000] * 8,
        embedding_bag_size=1,
        mlp_bot=[64, 512, 512, 64],
        mlp_top=[576, 1024, 1024, 1024, 1],
        arch_interaction_op="cat",
        batch_size=batch_size,
    )
