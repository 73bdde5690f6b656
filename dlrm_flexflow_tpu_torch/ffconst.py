"""Framework-wide enums.

PyTorch counterpart of `dlrm_flexflow_tpu/ffconst.py`: the same names and the
same values, so a config or an enum value carries between the two packages
unchanged. `DataType.to_torch` takes the place of the JAX package's `to_jnp`.
"""
from __future__ import annotations

import enum

import torch


class ActiMode(enum.Enum):
    """Fused activation modes (reference: include/ffconst.h:4-10)."""

    AC_MODE_NONE = "none"
    AC_MODE_RELU = "relu"
    AC_MODE_SIGMOID = "sigmoid"
    AC_MODE_TANH = "tanh"
    AC_MODE_GELU = "gelu"


class AggrMode(enum.Enum):
    """Embedding-bag pooling modes (reference: include/ffconst.h:12-16)."""

    AGGR_MODE_NONE = "none"
    AGGR_MODE_SUM = "sum"
    AGGR_MODE_AVG = "avg"


class PoolType(enum.Enum):
    """Spatial pooling (reference: include/ffconst.h:18-21)."""

    POOL_MAX = "max"
    POOL_AVG = "avg"


_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


class DataType(enum.Enum):
    """Tensor element types (reference: include/ffconst.h:23-30)."""

    DT_FLOAT = "float32"
    DT_DOUBLE = "float64"
    DT_BFLOAT16 = "bfloat16"
    DT_INT32 = "int32"
    DT_INT64 = "int64"
    DT_BOOLEAN = "bool"
    DT_NONE = "none"

    def to_torch(self) -> torch.dtype:
        if self is DataType.DT_NONE:
            raise ValueError("DT_NONE has no torch dtype")
        return _TORCH_DTYPES[self.value]


class LossType(enum.Enum):
    """Loss functions (reference: include/ffconst.h:32-37)."""

    LOSS_CATEGORICAL_CROSSENTROPY = "cce"
    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = "scce"
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE = "mse_avg"
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE = "mse_sum"
    LOSS_BINARY_CROSSENTROPY = "bce"


class CompMode(enum.Enum):
    """(reference: include/ffconst.h:39-42)."""

    COMP_MODE_TRAINING = "training"
    COMP_MODE_INFERENCE = "inference"


class ParameterSyncType(enum.Enum):
    """Gradient sync flavor (reference: include/ffconst.h:44-48)."""

    NONE = "none"
    PS = "ps"
    NCCL = "allreduce"


class MetricsType(enum.Flag):
    """Metrics bitmask (reference: include/ffconst.h:50-57)."""

    METRICS_NONE = 0
    METRICS_ACCURACY = enum.auto()
    METRICS_CATEGORICAL_CROSSENTROPY = enum.auto()
    METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = enum.auto()
    METRICS_MEAN_SQUARED_ERROR = enum.auto()
    METRICS_ROOT_MEAN_SQUARED_ERROR = enum.auto()
    METRICS_MEAN_ABSOLUTE_ERROR = enum.auto()
    METRICS_AUC_ROC = enum.auto()


class OperatorType(enum.Enum):
    """Graph node kinds (reference: include/ffconst.h:59-138)."""

    OP_INPUT = enum.auto()
    OP_WEIGHT = enum.auto()
    OP_CONV2D = enum.auto()
    OP_DROPOUT = enum.auto()
    OP_LINEAR = enum.auto()
    OP_BATCHMATMUL = enum.auto()
    OP_POOL2D = enum.auto()
    OP_SCALAR_MULTIPLY = enum.auto()
    OP_SCALAR_ADD = enum.auto()
    OP_SCALAR_SUB = enum.auto()
    OP_SCALAR_TRUE_DIV = enum.auto()
    OP_RELU = enum.auto()
    OP_IDENTITY = enum.auto()
    OP_SIGMOID = enum.auto()
    OP_TANH = enum.auto()
    OP_ELU = enum.auto()
    OP_GELU = enum.auto()
    OP_EXP = enum.auto()
    OP_FLAT = enum.auto()
    OP_SOFTMAX = enum.auto()
    OP_BATCHNORM = enum.auto()
    OP_LAYERNORM = enum.auto()
    OP_CONCAT = enum.auto()
    OP_SPLIT = enum.auto()
    OP_EMBEDDING = enum.auto()
    OP_GROUP_BY = enum.auto()
    OP_CACHE = enum.auto()
    OP_AGGREGATE = enum.auto()
    OP_AGG_SPEC = enum.auto()
    OP_RESHAPE = enum.auto()
    OP_REVERSE = enum.auto()
    OP_TRANSPOSE = enum.auto()
    OP_EW_ADD = enum.auto()
    OP_EW_SUB = enum.auto()
    OP_EW_MUL = enum.auto()
    OP_EW_DIV = enum.auto()
    OP_TOPK = enum.auto()
    OP_MULTIHEAD_ATTENTION = enum.auto()
    OP_DOT_INTERACTION = enum.auto()
    OP_LSTM = enum.auto()
    OP_FUSED = enum.auto()


_ACTI_FROM_STR = {
    None: ActiMode.AC_MODE_NONE,
    "none": ActiMode.AC_MODE_NONE,
    "relu": ActiMode.AC_MODE_RELU,
    "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "tanh": ActiMode.AC_MODE_TANH,
    "gelu": ActiMode.AC_MODE_GELU,
}


def as_acti_mode(value) -> ActiMode:
    if isinstance(value, ActiMode):
        return value
    return _ACTI_FROM_STR[value]
