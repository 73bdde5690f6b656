"""dlrm_flexflow_tpu_torch: the PyTorch and CUDA port of dlrm_flexflow_tpu.

The same graph-builder API, configs and parameter layout as the JAX package,
running on one NVIDIA H100 (or on the CPU when asked). Its kernels are
written by hand for Hopper (`csrc/`), each beside its plain PyTorch version
(`ops/kernels/`). This part of the port serves DLRM (build, compile,
predict; the tables optionally quantized to bf16, f16 or int8), trains it
on one device (train_batch, train_chunk on a CUDA graph, fit, evaluate)
with SGD, momentum, Adam or row-wise AdaGrad, the tables optionally under a
sparse optimizer of their own, trains it hybrid-parallel on several cards
(`compile(mesh=, plan=)`, one process a card started by `launch.py`: the
large tables sharded and exchanged by NCCL all-to-all, the rest
data-parallel, the wide Dense layers column-parallel on a 2-D data x model
mesh), checkpoints it (`training/checkpoint.py`), and carries
weights over from the JAX package (`convert.py`). The op library's
elementwise, shape, attention, MoE, convolutional and recurrent ops build
every model of the zoo (`models/zoo.py`: the MLPs, MoE, attention models,
CNNs and the NMT LSTM), which train and serve on one device. The
model-import frontends (`frontends/`: the Keras facade, torch.fx, ONNX,
tf.keras and the Keras datasets) build models from other frameworks'
descriptions, importing none of tensorflow, keras or onnx.
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
from .training.optimizer import AdamOptimizer, RowWiseAdagradOptimizer, SGDOptimizer

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
    "SGDOptimizer",
    "AdamOptimizer",
    "RowWiseAdagradOptimizer",
]
