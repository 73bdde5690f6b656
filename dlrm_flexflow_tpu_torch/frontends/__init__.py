"""Model-import frontends (reference L9: python/flexflow/{keras,torch,onnx}).

Counterpart of `dlrm_flexflow_tpu/frontends/`, with the same exports:

- keras:    Sequential/functional Keras-clone facade over FFModel
            (reference: python/flexflow/keras/models/base_model.py)
- torch_fx: torch.fx symbolic trace -> IR text file -> FFModel replay
            (reference: python/flexflow/torch/fx.py, torch/model.py)
- onnx:     ONNX graph walker -> FFModel replay
            (reference: python/flexflow/onnx/model.py)
- tf_keras: a tf.keras Sequential model and its weights -> FFModel
            (reference: python/flexflow/keras_exp)
- datasets: the Keras datasets and preprocessing, numpy only

Importing this package imports none of tensorflow, keras or onnx.
"""
from . import keras  # noqa: F401
from . import datasets  # noqa: F401
from .onnx import ONNXModel  # noqa: F401
from .torch_fx import FXNode, PyTorchModel, load_ir, save_ir, torch_to_file, torch_to_ir  # noqa: F401
from .tf_keras import from_tf_keras, load_tf_weights  # noqa: F401
