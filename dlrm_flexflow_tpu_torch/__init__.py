"""dlrm_flexflow_tpu_torch: the PyTorch and CUDA port of dlrm_flexflow_tpu.

The same graph-builder API, configs and parameter layout as the JAX package,
running on one NVIDIA H100 (or on the CPU when asked). Its kernels are
written by hand for Hopper (`csrc/`), each beside its plain PyTorch version
(`ops/kernels/`). This part of the port serves DLRM: build, compile,
predict, and carry weights over from the JAX package (`convert.py`).
"""

from .config import FFConfig, FFIterationConfig
from .ffconst import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
    ParameterSyncType,
    PoolType,
)
from .core.ffmodel import FFModel
from .core.initializers import (
    ConstantInitializer,
    GlorotUniform,
    NormInitializer,
    UniformInitializer,
    ZeroInitializer,
)
from .core.tensor import ParameterSpec, TensorSpec

__version__ = "0.1.0"

__all__ = [
    "FFConfig",
    "FFIterationConfig",
    "FFModel",
    "ActiMode",
    "AggrMode",
    "CompMode",
    "DataType",
    "LossType",
    "MetricsType",
    "OperatorType",
    "ParameterSyncType",
    "PoolType",
    "TensorSpec",
    "ParameterSpec",
    "GlorotUniform",
    "ZeroInitializer",
    "UniformInitializer",
    "NormInitializer",
    "ConstantInitializer",
]
