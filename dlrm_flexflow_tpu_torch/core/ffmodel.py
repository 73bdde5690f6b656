"""FFModel: graph-builder facade and the serving path.

PyTorch counterpart of `dlrm_flexflow_tpu/core/ffmodel.py`, for the verbs
serving needs: the builder verbs DLRM uses (`create_tensor`, `dense`,
`embedding`, `dot_interaction`, `concat`), `compile` (parameter init and
kernel routing), `forward`, `predict` and the weight IO. PyTorch runs
eagerly, so `compile` builds no step function: it makes the parameters on
the model's device and fixes the execution context.

A model lives on one device, given at construction and "cuda" by default.
It never moves to another: with no CUDA device a "cuda" model raises.
Training (`train_batch`, `fit`, `evaluate`) is the next part of the port
and raises NotImplementedError here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import FFConfig
from ..ffconst import ActiMode, AggrMode, DataType, LossType, MetricsType
from ..ops.dense import Dense
from ..ops.embedding import Embedding
from ..ops.interaction import DotInteraction
from ..ops.kernels import resolve_use_pallas
from ..ops.shape_ops import Concat
from .graph import Graph, InputOp, OpContext
from .tensor import TensorSpec

_TRAINING = "training is slice 2 of the port"


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None, device="cuda"):
        self.config = config or FFConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FFModel(device={str(self.device)!r}): no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        self.graph = Graph()
        self.loss_type: Optional[LossType] = None
        self.metrics_mask: MetricsType = MetricsType.METRICS_NONE
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._ctx: Optional[OpContext] = None
        self._out_spec: Optional[TensorSpec] = None
        self._compiled = False

    # ------------------------------------------------------------------ build
    def create_tensor(
        self,
        dims: Sequence[int],
        dtype: DataType = DataType.DT_FLOAT,
        name: Optional[str] = None,
    ) -> TensorSpec:
        """reference: FFModel::create_tensor (model.cc:831). dims are
        C-order, batch first."""
        name = self.graph.unique_name(name or "input")
        op = InputOp(name, tuple(int(d) for d in dims), dtype)
        self.graph.add_op(op)
        return op.outputs[0]

    def dense(
        self,
        input: TensorSpec,
        out_dim: int,
        activation=ActiMode.AC_MODE_NONE,
        use_bias: bool = True,
        kernel_initializer=None,
        bias_initializer=None,
        name: Optional[str] = None,
    ) -> TensorSpec:
        op = Dense(
            self.graph.unique_name(name or "dense"),
            input,
            out_dim,
            activation,
            use_bias,
            kernel_initializer,
            bias_initializer,
        )
        return self.graph.add_op(op).outputs[0]

    def embedding(
        self,
        input: TensorSpec,
        num_entries: int,
        out_dim: int,
        aggr: AggrMode = AggrMode.AGGR_MODE_SUM,
        kernel_initializer=None,
        name: Optional[str] = None,
    ) -> TensorSpec:
        op = Embedding(
            self.graph.unique_name(name or "embedding"),
            input,
            num_entries,
            out_dim,
            aggr,
            kernel_initializer,
        )
        return self.graph.add_op(op).outputs[0]

    def dot_interaction(
        self,
        inputs: Sequence[TensorSpec],
        self_interaction: bool = False,
        name: Optional[str] = None,
    ) -> TensorSpec:
        op = DotInteraction(
            self.graph.unique_name(name or "dot_interaction"), inputs, self_interaction
        )
        return self.graph.add_op(op).outputs[0]

    def concat(
        self, tensors: Sequence[TensorSpec], axis: int, name: Optional[str] = None
    ) -> TensorSpec:
        op = Concat(self.graph.unique_name(name or "concat"), tensors, axis)
        return self.graph.add_op(op).outputs[0]

    # ------------------------------------------------------------------ compile
    def compile(
        self,
        optimizer=None,
        loss_type: LossType = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
        metrics: Sequence[MetricsType] = (),
        seed: Optional[int] = None,
    ) -> None:
        """reference: FFModel::compile (model.cc:1567), forward-only: makes
        the parameters on the model's device from `seed` (default
        config.seed) and resolves the kernel routing. An optimizer belongs
        to training, which this package does not have yet."""
        if optimizer is not None:
            raise NotImplementedError(_TRAINING)
        self.loss_type = loss_type
        mask = MetricsType.METRICS_NONE
        for m in metrics:
            mask |= m
        self.metrics_mask = mask
        self._out_spec = self.graph.compute_ops[-1].outputs[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else seed)
        with torch.no_grad():
            self._params = self.graph.init_params(gen, self.device)
        use_pallas = self.config.use_pallas
        if not resolve_use_pallas(use_pallas, self.device):
            use_pallas = "off"
        self._ctx = OpContext(
            compute_dtype=DataType(self.config.compute_dtype).to_torch(),
            onehot_threshold=self.config.onehot_embedding_threshold,
            use_pallas=use_pallas,
            device=self.device,
        )
        self._compiled = True

    # ------------------------------------------------------------------ verbs
    def _require_compiled(self) -> None:
        if not self._compiled:
            raise RuntimeError("FFModel: call compile() first")

    def _stage(self, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host -> device batch staging; every graph input must be fed."""
        staged = {}
        for iop in self.graph.inputs:
            if iop.name not in feeds:
                raise KeyError(f"missing feed {iop.name!r}")
            staged[iop.name] = torch.as_tensor(
                feeds[iop.name], dtype=iop.outputs[0].dtype.to_torch()
            ).to(self.device)
        return staged

    def forward(self, feeds: Dict[str, Any], training: bool = False) -> torch.Tensor:
        """reference: FFModel::forward (model.cc:1416): the inference-style
        forward of one batch, as a tensor on the model's device."""
        self._require_compiled()
        if training:
            raise NotImplementedError(_TRAINING)
        with torch.inference_mode():
            (out,) = self.graph.execute(
                self._params, self._stage(feeds), self._ctx, fetch=[self._out_spec]
            )
        return out

    def train_batch(self, feeds, labels):
        raise NotImplementedError(_TRAINING)

    def fit(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    def predict(
        self,
        feeds: Dict[str, np.ndarray],
        batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Serving entry for any number of examples: inputs are cut into
        chunks of the compiled batch size; the last partial chunk is padded
        by repeating its final row, then trimmed."""
        self._require_compiled()
        bs = batch_size or self.config.batch_size
        n = next(iter(feeds.values())).shape[0]
        if n <= 0:
            raise ValueError("predict: empty input")
        outs = []
        for i in range(0, n, bs):
            chunk = {k: v[i : i + bs] for k, v in feeds.items()}
            m = next(iter(chunk.values())).shape[0]
            if m < bs:
                chunk = {
                    k: np.concatenate([v, np.repeat(v[-1:], bs - m, axis=0)], axis=0)
                    for k, v in chunk.items()
                }
            y = self.forward(chunk, training=False)
            outs.append(y[:m].float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------ state IO
    def get_parameters(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return self._params

    def set_parameters(self, params: Dict[str, Dict[str, Any]]) -> None:
        """Replace every parameter; `params` has the layout of
        get_parameters() (or of convert.params_from_jax)."""
        self._require_compiled()
        missing = set(self._params) - set(params)
        extra = set(params) - set(self._params)
        if missing or extra:
            raise KeyError(f"set_parameters: missing {sorted(missing)}, unknown {sorted(extra)}")
        for op_name, sub in params.items():
            if set(sub) != set(self._params[op_name]):
                raise KeyError(
                    f"set_parameters: {op_name} has {sorted(sub)}, "
                    f"expected {sorted(self._params[op_name])}"
                )
            self.set_weights(op_name, sub)

    def get_weights(self, op_name: str) -> Dict[str, np.ndarray]:
        """Per-op weight dict as host numpy, in the op's logical shapes."""
        self._require_compiled()
        return {k: v.cpu().numpy() for k, v in self._params[op_name].items()}

    def set_weights(self, op_name: str, weights: Dict[str, Any]) -> None:
        """Per-op weight update; each array keeps the dtype and shape of the
        parameter it replaces and lands on the model's device."""
        self._require_compiled()
        cur = self._params[op_name]
        new = dict(cur)
        for k, w in weights.items():
            if k not in cur:
                raise KeyError(f"{op_name} has no parameter {k!r}")
            arr = torch.as_tensor(w).to(device=self.device, dtype=cur[k].dtype)
            if tuple(arr.shape) != tuple(cur[k].shape):
                raise ValueError(
                    f"{op_name}/{k}: shape {tuple(arr.shape)} != {tuple(cur[k].shape)}"
                )
            new[k] = arr.contiguous()
        self._params[op_name] = new
