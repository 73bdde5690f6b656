"""Keras-style frontend.

Counterpart of `dlrm_flexflow_tpu/frontends/keras.py` (reference:
python/flexflow/keras/ — Sequential + functional Model whose compile()
replays the recorded layer graph onto FFModel and whose fit() drives the
dataloader/train loop, python/flexflow/keras/models/base_model.py:127-424).
Layers are symbolic recorders: calling a layer on a `KTensor` appends a node;
`Model.compile` topologically replays nodes into a core FFModel on `device`
("cuda" unless the caller asks for the CPU), then fit/evaluate/predict
delegate to it (with the same string-name optimizer / loss / metrics
vocabulary as the reference's Keras surface). `predict` returns host numpy.

Layer names default to the class name and a per-class counter
(`dense_3`); the counters are this package's own, so a model built in
both packages has the same op names only where its layers are named.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..config import FFConfig
from ..ffconst import (
    ActiMode,
    AggrMode,
    DataType,
    LossType,
    MetricsType,
    PoolType,
    as_acti_mode,
)
from ..core.ffmodel import FFModel
from ..training.optimizer import AdamOptimizer, Optimizer, SGDOptimizer

_LOSSES = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "binary_crossentropy": LossType.LOSS_BINARY_CROSSENTROPY,
}

_METRICS = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "mse": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
    "auc": MetricsType.METRICS_AUC_ROC,
}


@dataclasses.dataclass
class KTensor:
    """Symbolic tensor produced by one layer CALL (node). Batch dim is
    position 0 and may be None until compile; node is None for Inputs."""

    shape: Tuple[Optional[int], ...]
    dtype: DataType = DataType.DT_FLOAT
    node: Optional["_CallNode"] = None

    @property
    def batch_shape(self):
        return self.shape


@dataclasses.dataclass
class _CallNode:
    """One invocation of a layer on specific inputs. A layer called twice
    (Keras weight sharing) yields two nodes, so both call sites wire
    correctly; note that parameters are NOT shared across calls here (each
    call builds its own FF op) — compile() warns when that happens."""

    layer: "Layer"
    inputs: List[KTensor]


class Layer:
    """Base symbolic layer. Subclasses implement output_shape(input_shapes)
    and build(ffmodel, input_handles) -> TensorSpec."""

    _counter = 0

    def __init__(self, name: Optional[str] = None):
        type(self)._counter += 1
        base = type(self).__name__.lower()
        self.name = name or f"{base}_{type(self)._counter}"

    def __call__(self, inputs: Union[KTensor, Sequence[KTensor]]) -> KTensor:
        ins = [inputs] if isinstance(inputs, KTensor) else list(inputs)
        out_shape = self.output_shape([t.shape for t in ins])
        return KTensor(tuple(out_shape), self.out_dtype(ins), _CallNode(self, ins))

    def out_dtype(self, ins: List[KTensor]) -> DataType:
        return ins[0].dtype if ins else DataType.DT_FLOAT

    def output_shape(self, input_shapes):  # pragma: no cover - abstract
        raise NotImplementedError

    def build(self, ff: FFModel, handles):  # pragma: no cover - abstract
        raise NotImplementedError


def Input(shape: Sequence[int], dtype: DataType = DataType.DT_FLOAT) -> KTensor:
    """reference: flexflow.keras Input — batch-unspecified symbolic input."""
    return KTensor((None,) + tuple(int(d) for d in shape), dtype, None)


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias: bool = True, name=None):
        super().__init__(name)
        self.units = int(units)
        self.activation = as_acti_mode(activation)
        self.use_bias = use_bias

    def output_shape(self, shapes):
        return shapes[0][:-1] + (self.units,)

    def build(self, ff, handles):
        return ff.dense(
            handles[0], self.units, activation=self.activation,
            use_bias=self.use_bias, name=self.name,
        )


class Activation(Layer):
    def __init__(self, activation, name=None):
        super().__init__(name)
        self.mode = as_acti_mode(activation) if activation != "softmax" else "softmax"

    def output_shape(self, shapes):
        return shapes[0]

    def build(self, ff, handles):
        x = handles[0]
        if self.mode == "softmax":
            return ff.softmax(x, name=self.name)
        if self.mode is ActiMode.AC_MODE_RELU:
            return ff.relu(x, name=self.name)
        if self.mode is ActiMode.AC_MODE_SIGMOID:
            return ff.sigmoid(x, name=self.name)
        if self.mode is ActiMode.AC_MODE_TANH:
            return ff.tanh(x, name=self.name)
        if self.mode is ActiMode.AC_MODE_GELU:
            return ff.gelu(x, name=self.name)
        return ff.identity(x, name=self.name)


class Softmax(Layer):
    def output_shape(self, shapes):
        return shapes[0]

    def build(self, ff, handles):
        return ff.softmax(handles[0], name=self.name)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(Layer):
    """NCHW, padding 'valid'|'same' (reference keras layer maps to the same
    FFModel.conv2d signature, python/flexflow/keras/layers/convolutional.py)."""

    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 activation=None, use_bias=True, groups=1, name=None):
        super().__init__(name)
        self.filters = int(filters)
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = as_acti_mode(activation)
        self.use_bias = use_bias
        self.groups = groups

    def _pads(self, h, w):
        if self.padding == "same":
            # reference semantics: pad so out = ceil(in/stride) for stride 1
            return self.kernel[0] // 2, self.kernel[1] // 2
        return 0, 0

    def output_shape(self, shapes):
        b, c, h, w = shapes[0]
        ph, pw = self._pads(h, w)
        oh = (h + 2 * ph - self.kernel[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.kernel[1]) // self.strides[1] + 1
        return (b, self.filters, oh, ow)

    def build(self, ff, handles):
        h, w = self.kernel
        shp = handles[0].shape  # TensorSpec: concrete at build time
        ph, pw = self._pads(shp[2], shp[3])
        return ff.conv2d(
            handles[0], self.filters, h, w, self.strides[0], self.strides[1],
            ph, pw, activation=self.activation, groups=self.groups,
            use_bias=self.use_bias, name=self.name,
        )


class _Pool2D(Layer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=2, strides=None, padding="valid", name=None):
        super().__init__(name)
        self.pool = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool
        self.padding = padding

    def _pads(self):
        if self.padding == "same":
            return self.pool[0] // 2, self.pool[1] // 2
        return 0, 0

    def output_shape(self, shapes):
        b, c, h, w = shapes[0]
        ph, pw = self._pads()
        oh = (h + 2 * ph - self.pool[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.pool[1]) // self.strides[1] + 1
        return (b, c, oh, ow)

    def build(self, ff, handles):
        ph, pw = self._pads()
        return ff.pool2d(
            handles[0], self.pool[0], self.pool[1], self.strides[0],
            self.strides[1], ph, pw, pool_type=self.pool_type, name=self.name,
        )


class MaxPooling2D(_Pool2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(_Pool2D):
    pool_type = PoolType.POOL_AVG


class Flatten(Layer):
    def output_shape(self, shapes):
        n = 1
        for d in shapes[0][1:]:
            n *= d
        return (shapes[0][0], n)

    def build(self, ff, handles):
        return ff.flat(handles[0], name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape, name=None):
        super().__init__(name)
        self.target = tuple(int(d) for d in target_shape)

    def output_shape(self, shapes):
        return (shapes[0][0],) + self.target

    def build(self, ff, handles):
        b = handles[0].shape[0]
        return ff.reshape(handles[0], (b,) + self.target, name=self.name)


class Dropout(Layer):
    def __init__(self, rate: float, name=None):
        super().__init__(name)
        self.rate = float(rate)

    def output_shape(self, shapes):
        return shapes[0]

    def build(self, ff, handles):
        return ff.dropout(handles[0], self.rate, name=self.name)


class Embedding(Layer):
    """reference keras Embedding -> FFModel.embedding with sum pooling over
    the bag dim (matching the reference's EmbeddingBag semantics)."""

    def __init__(self, input_dim: int, output_dim: int, aggr: str = "sum", name=None):
        super().__init__(name)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.aggr = {"sum": AggrMode.AGGR_MODE_SUM, "avg": AggrMode.AGGR_MODE_AVG,
                     "none": AggrMode.AGGR_MODE_NONE}[aggr]

    def out_dtype(self, ins):
        return DataType.DT_FLOAT

    def output_shape(self, shapes):
        return (shapes[0][0], self.output_dim)

    def build(self, ff, handles):
        return ff.embedding(
            handles[0], self.input_dim, self.output_dim, aggr=self.aggr,
            name=self.name,
        )


class Concatenate(Layer):
    def __init__(self, axis: int = 1, name=None):
        super().__init__(name)
        self.axis = axis

    def output_shape(self, shapes):
        out = list(shapes[0])
        out[self.axis] = sum(s[self.axis] for s in shapes)
        return tuple(out)

    def build(self, ff, handles):
        return ff.concat(list(handles), self.axis, name=self.name)


class _Merge(Layer):
    fn = "add"

    def output_shape(self, shapes):
        return shapes[0]

    def build(self, ff, handles):
        out = handles[0]
        for h in handles[1:]:
            out = getattr(ff, self.fn)(out, h, name=ff.graph.unique_name(self.name))
        return out


class Add(_Merge):
    fn = "add"


class Subtract(_Merge):
    fn = "subtract"


class Multiply(_Merge):
    fn = "multiply"


class BatchNormalization(Layer):
    def __init__(self, relu: bool = False, name=None):
        super().__init__(name)
        self.relu = relu

    def output_shape(self, shapes):
        return shapes[0]

    def build(self, ff, handles):
        return ff.batch_norm(handles[0], relu=self.relu, name=self.name)


def _as_optimizer(opt) -> Optimizer:
    if isinstance(opt, Optimizer):
        return opt
    if isinstance(opt, str):
        key = opt.lower()
        if key == "sgd":
            return SGDOptimizer(lr=0.01)
        if key == "adam":
            return AdamOptimizer(alpha=0.001)
    raise ValueError(f"unknown optimizer {opt!r}")


def _as_loss(loss) -> LossType:
    if isinstance(loss, LossType):
        return loss
    return _LOSSES[loss]


def _as_metrics(metrics) -> List[MetricsType]:
    out = []
    for m in metrics or ():
        out.append(m if isinstance(m, MetricsType) else _METRICS[m])
    return out


class Model:
    """Functional model (reference: python/flexflow/keras/models/model.py)."""

    def __init__(self, inputs, outputs, name: str = "model"):
        self.inputs: List[KTensor] = (
            [inputs] if isinstance(inputs, KTensor) else list(inputs)
        )
        assert isinstance(outputs, KTensor), "single-output models only"
        self.output = outputs
        self.name = name
        self.ffmodel: Optional[FFModel] = None
        self._nodes = self._topo_nodes()

    def _topo_nodes(self) -> List["_CallNode"]:
        seen: Dict[int, "_CallNode"] = {}
        order: List["_CallNode"] = []

        def visit(t: KTensor):
            node = t.node
            if node is None or id(node) in seen:
                return
            seen[id(node)] = node
            for src in node.inputs:
                visit(src)
            order.append(node)

        visit(self.output)
        return order

    @property
    def layers(self) -> List[Layer]:
        out, seen = [], set()
        for n in self._nodes:
            if id(n.layer) not in seen:
                seen.add(id(n.layer))
                out.append(n.layer)
        return out

    def summary(self) -> str:
        lines = [f'Model: "{self.name}"']
        for t in self.inputs:
            lines.append(f"  Input {t.shape} {t.dtype.name}")
        for node in self._nodes:
            out = node.layer.output_shape([s.shape for s in node.inputs])
            lines.append(f"  {type(node.layer).__name__} '{node.layer.name}' -> {out}")
        return "\n".join(lines)

    def compile(
        self,
        optimizer="sgd",
        loss="categorical_crossentropy",
        metrics=("accuracy",),
        batch_size: Optional[int] = None,
        config: Optional[FFConfig] = None,
        device="cuda",
        **kw,
    ) -> None:
        cfg = config or FFConfig()
        if batch_size is not None:
            cfg.batch_size = batch_size
        bs = cfg.batch_size
        ff = FFModel(cfg, device=device)
        handle: Dict[int, object] = {}
        self._input_names: List[str] = []
        for k, t in enumerate(self.inputs):
            shape = (bs,) + tuple(t.shape[1:])
            name = f"input_{k}"
            handle[id(t)] = ff.create_tensor(list(shape), dtype=t.dtype, name=name)
            self._input_names.append(name)

        # replay call nodes in topo order (a layer called N times builds N
        # FF ops — wiring is per call site; parameters are not shared)
        calls = collections.Counter(id(n.layer) for n in self._nodes)
        shared = [n.layer.name for n in self._nodes if calls[id(n.layer)] > 1]
        if shared:
            warnings.warn(
                f"layers called multiple times ({sorted(set(shared))}): each "
                "call builds its own parameters (no weight sharing)"
            )
        out_of: Dict[int, object] = dict(handle)
        node_out: Dict[int, object] = {}

        def resolve(t: KTensor):
            if id(t) in out_of:
                return out_of[id(t)]
            return node_out[id(t.node)]

        for node in self._nodes:
            hs = [resolve(src) for src in node.inputs]
            node_out[id(node)] = node.layer.build(ff, hs)

        ff.compile(
            optimizer=_as_optimizer(optimizer),
            loss_type=_as_loss(loss),
            metrics=_as_metrics(metrics),
            **kw,
        )
        self.ffmodel = ff

    # --- training interface (delegates to core FFModel) ----------------------
    def _feeds(self, x) -> Dict[str, np.ndarray]:
        xs = [x] if not isinstance(x, (list, tuple)) else list(x)
        assert len(xs) == len(self._input_names), (
            f"model has {len(self._input_names)} inputs, got {len(xs)} arrays"
        )
        return dict(zip(self._input_names, xs))

    def fit(self, x, y, epochs: int = 1, batch_size: Optional[int] = None,
            callbacks=(), verbose: bool = True, shuffle: bool = False,
            validation_data=None):
        assert self.ffmodel is not None, "call compile() first"
        if validation_data is not None:
            vx, vy = validation_data
            validation_data = (self._feeds(vx), vy)
        return self.ffmodel.fit(
            self._feeds(x), y, epochs=epochs, batch_size=batch_size,
            callbacks=callbacks, verbose=verbose, shuffle=shuffle,
            validation_data=validation_data,
        )

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        assert self.ffmodel is not None, "call compile() first"
        return self.ffmodel.evaluate(self._feeds(x), y, batch_size=batch_size)

    def predict(self, x):
        assert self.ffmodel is not None, "call compile() first"
        return self.ffmodel.forward(self._feeds(x), training=False).cpu().numpy()


class Sequential(Model):
    """reference: python/flexflow/keras/models/sequential.py."""

    def __init__(self, layers: Sequence[Layer] = (), name: str = "sequential"):
        self._pending: List[Layer] = list(layers)
        self._input_spec: Optional[KTensor] = None
        self.name = name
        self.ffmodel = None

    def add(self, layer: Layer) -> None:
        self._pending.append(layer)

    def _finalize(self, input_shape: Sequence[int], dtype=DataType.DT_FLOAT):
        t = Input(input_shape, dtype)
        first = t
        for lay in self._pending:
            t = lay(t)
        Model.__init__(self, [first], t, name=self.name)

    def compile(self, optimizer="sgd", loss="categorical_crossentropy",
                metrics=("accuracy",), input_shape: Optional[Sequence[int]] = None,
                input_dtype: DataType = DataType.DT_FLOAT, **kw):
        assert input_shape is not None or getattr(self, "inputs", None), (
            "Sequential.compile needs input_shape=[...] (sample shape, no batch)"
        )
        if input_shape is not None:
            self._finalize(input_shape, input_dtype)
        Model.compile(self, optimizer=optimizer, loss=loss, metrics=metrics, **kw)
