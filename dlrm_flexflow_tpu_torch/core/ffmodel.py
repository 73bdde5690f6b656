"""FFModel: graph-builder facade, single-device training and serving.

PyTorch counterpart of `dlrm_flexflow_tpu/core/ffmodel.py`: the graph
verbs (`create_tensor`, `create_constant`, `dense`, `embedding`,
`dot_interaction`, the shape, elementwise, softmax, dropout, batch_matmul,
attention and MoE verbs, `cache`, and `cross_network`, which the JAX
package lacks), the graph's introspection, `compile`
(parameters, optimizer state and kernel routing), `recompile`,
`train_batch`, `train_chunk`, `fit`, `eval_batch`, `evaluate`, `forward`,
`predict`, `quantize_embeddings`, the learning rate, the iteration
config's seq_length and the weight IO. PyTorch runs eagerly, so `compile`
builds no step function: it makes the parameters, the optimizer state and
the constants on the model's device and fixes the routing. The
convolutional and recurrent verbs (`conv2d`, `pool2d`, `batch_norm`,
`lstm`) build the ops of `ops/conv.py` and `ops/rnn.py`.

Static state that a captured train step cannot see (`set_iteration_config_
sequence_length`, a Cache's `use_cached` through `recompile`) drops the
captured step, so the next `train_chunk` captures again, as the JAX
package re-traces. Ops that draw random bits (dropout) read the step's key
(`_step_key`: config.seed and the step count), which a captured step reads
from its static buffer, so replays draw the eager steps' bits.

`train_chunk` runs K steps on [K, B, ...] stacks, the counterpart of the
JAX package's scanned multi-step call: on CUDA one train step is captured
in a CUDA graph on static device buffers and replayed once a step (below,
"The multi-step call"); on the CPU it is a loop of steps.

The train step is the JAX package's split step (`:926-1015`): embedding
ops whose indices come straight from the inputs and whose vocab is above
`onehot_embedding_threshold` are sparse. Their lookups run outside
autograd; their pooled outputs go into the graph as detached leaves that
require grad; the loss's gradient reaches the dense parameters and those
leaves; the dense optimizer runs in place; the leaves' gradients become row
updates under the sparse optimizer (training/sparse_engine.py), which is
the dense one unless `compile` is given its own. Tables on the row-update
kernel route may be stored in `table_dtype`. Under `config.host_routing`
the sort of each route table's update stream is taken off the device:
`compute_routes` sorts the batch's indices on the host (native/ffdata's
threaded radix sort) and `train_batch` hands the sorted streams to the
row-update kernel, as the JAX package's host routing does.

Mid-band tables (the JAX package's `onehot_packed_threshold`, :502-520):
an embedding op with its vocab in (onehot_embedding_threshold,
onehot_packed_threshold], D | 128, pooled, on one device and not a host-tail
op, takes the one-hot lookup with a dense [V, D] gradient and is updated
by the dense optimizer's rule (every row's Adam moments decay), never by a
row-update stream; its table stays f32 whatever `table_dtype` says.

Host-tail offload (config.host_tail_threshold; the JAX package's :1409-
1467, parallel/host_tail.py): a table above the threshold keeps its hot
prefix on the device and its tail rows in a host store. `train_batch`
builds the batch's tail partials on the host (`build_feeds`, after host
routing), stages them through pinned memory, runs the step (which also
gathers the pooled gradient at the partials' slots, `g_val`), reads `g_val`
and the step's row rate back in one copy, the step's one host sync, and
applies the tail rows' updates on the host at that rate. `forward`,
`eval_batch` and `predict` serve tail rows read-only. A host-tail step
cannot be one CUDA graph (the host works between steps): `train_chunk`
refuses such a model, as the JAX package's does.

Under use_pallas="on" every op takes its forced kernel (Dense, the pooled
lookups, the interaction), as in the JAX package; such a model serves
(`forward`, `predict`, `eval_batch`, `evaluate`) but does not train.

A model lives on one device, given at construction and "cuda" by default.
It never moves to another: with no CUDA device a "cuda" model raises.

Several devices (`compile(mesh=, plan=)`, the JAX package's hybrid
parallelism): one process a device, each with the same model on its own
card (parallel/mesh.py, launch.py). Under `dlrm_hybrid_plan()` the planner
pass fuses the tables above the one-hot threshold into one
EmbeddingCollection sharded over the ranks (ops/embedding_collection_op.py,
parallel/embedding_collection.py); the rest is replicated, and under
`data_parallel_plan()` everything is. Every rank is fed the global batch and
steps on its slice: the collection's lookup and update exchange over the
ranks; a sparse table outside the collection gathers every rank's index
feeds and pooled-output gradients and applies the global batch's stream to
its replica (parallel/replicated_tables.py); the local loss is the rank's
share of the global one, the dense gradients are summed over the ranks in
one all-reduce, the loss and metrics in another, so every rank holds the
same replicated parameters and returns the same loss
(`_loss_and_metrics`). Those collectives have static sizes (equal
all-to-all chunks, one flat bucket an all-reduce or all-gather), so
`train_chunk` captures the step with them on CUDA, as on one device. The
exchange is the dense one or, under `exchange="routed"`, the routed one
(parallel/routed_exchange.py). Host-tail offload runs under a mesh too:
every rank keeps a replica of each store and runs the global batch's host
half (`build_feeds`, `apply_grads`) as the JAX package's single controller
does, stages its own block of the partials (`host_tail.rank_block`), and
takes `g_val` from the gathered global gradient, so every replica makes
one card's update at the global batch.

The op library's graphs run under a data axis above 1 too
(parallel/global_batch.py): `compile` walks the graph once (`batch_ops`)
and raises NotImplementedError for what the port does not compute over the
global batch (an op that moves, reverses, concatenates, splits or
normalises along the batch axis, a reshape whose leading dimension the axis
does not divide, a non-row-wise op between a GroupBy and its Aggregate);
the ops that couple rows or read their built shape (Flat, Reshape, Dropout,
attention's dropout, BatchNorm, GroupBy, Aggregate) take the global batch's
meaning on the rank's block, a constant whose leading dimension is the
batch size is staged at the rank's block, and a Cache serves its block.

The strategy search (config.search_budget > 0 under `compile(mesh=,
plan=)`, the JAX package's `_run_strategy_search`, :1109-1316) runs before
the planner pass fuses the tables: rank 0 takes the machine model (the
"h100" preset on CUDA, "cpu_sim" on the CPU, or config.machine_model_file),
calibrates it on its card where no machine file is given (cached at
config.machine_cache_path()), runs the joint annealer
(autotune/search.py `autotune_plan_joint`) and broadcasts its decisions,
so every rank applies the same ones to its plan: the replicated tables,
host-tail rows, table placement and splits, column-parallel Dense ops, the
exchange and the host grouping. `compile` writes the task graph
(config.export_strategy_task_graph_file) from rank 0, `fit` under
config.profiling with no mesh prints each op's forward time before it
trains (utils/profiling.py), and `calibrate_step_residual` times the
multi-step call against the cost model's prediction.

On a 2-D ("data", "model") mesh the batch, the collection's shards and
every collective above belong to the data axis (its data group); the
ranks of one data index hold the same slice and the same replicas. The
Dense ops that the plan's specs make column-parallel
(`enable_parameter_parallel`, `_model_parallel`) hold a row block of
their kernel and bias a model index, drawn whole and cut so that the
model starts from one card's weights, and gather their outputs over the
model group (parallel/tensor_parallel.py); their gradients, shard-sized,
join the replicated towers' in the data group's one bucket, and their
optimizer state is shard-sized. The replicated gradients are then
broadcast from model index 0 over the model group in a bucket of their
own (`_reduce_dense_grads`), and the scatter rules that update replicated
tables add in one fixed order on the card (`ops.common.index_add_rows`), so
that the model peers' replicas stay equal bit for bit.

The multi-step call. A step reads everything that changes between steps
from device memory: the batch, its routes, and the step's scalars (Adam's
bias correction, `Optimizer.step_scalars`, computed on the host in f32 as
the eager step computes them); the host keeps the step count
(`_step_count`). Everything a step reads or writes stays where it is: the
parameters, the optimizer state and the metric totals are changed in place
(`set_weights`, `set_learning_rate`, `reset_metrics`, checkpoint restore),
so a captured step stays valid across them. `compile`, `quantize_embeddings`
and `set_parameters` after quantizing make new tensors and drop the graph.
For a chunk the stacks go to the device as one [K, bytes] buffer (one copy
from pinned memory for host arrays); each step is then one device copy of
row i into the static buffer and one replay, with no host sync. The first
chunk's first step runs eagerly on a side stream (it builds the kernels
and every lazy set-up, and is a real step), then one step is captured.
Capture and replay raise on failure: nothing falls back to eager steps.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import FFConfig, FFIterationConfig
from ..convert import to_torch
from ..data import native_batcher
from ..data.loader import DataLoader
from ..ffconst import ActiMode, AggrMode, DataType, LossType, MetricsType, OperatorType, PoolType
from ..ops.dense import Dense
from ..ops.embedding import Embedding, quantize_table_int8
from ..ops.embedding_collection_op import EmbeddingCollection
from ..ops.interaction import DotInteraction
from ..ops.kernels import resolve_use_pallas
from ..ops.attention import MultiHeadAttention
from ..ops.batch_matmul import BatchMatmul
from ..ops.cache import Cache
from ..ops.conv import BatchNorm, Conv2D, Pool2D
from ..ops.cross import LowRankCrossNet
from ..ops.elementwise import ElementBinary, ElementUnary
from ..ops.moe import Aggregate, AggregateSpec, GroupBy, TopK
from ..ops.regularizers import Dropout, Softmax
from ..ops.rnn import LSTM
from ..ops.shape_ops import Concat, Flat, Reshape, Reverse, Split, Transpose
from ..parallel.global_batch import batch_ops as batch_ops_of
from ..parallel.host_tail import HostTailRuntime, HostTailStore, rank_block
from ..parallel.passes import fuse_embedding_tables, offload_embedding_tails
from ..parallel.plan import ShardingPlan, dlrm_hybrid_plan, enable_parameter_parallel, tensor_parallel_ops
from ..parallel.replicated_tables import replicated_sparse_update
from ..parallel.tensor_parallel import row_block
from ..training import losses as losses_lib
from ..training import metrics as metrics_lib
from ..training.optimizer import (
    AdamOptimizer,
    Optimizer,
    RowWiseAdagradOptimizer,
    SGDOptimizer,
)
from ..training.sparse_engine import apply_sparse_updates
from ..utils.profiling import add_counts, capturing, span, step_phases
from .graph import Graph, InputOp, OpContext, step_key
from .tensor import TensorSpec

# the batch keys of host-computed routes, "_route:<op>:<field>" (the JAX
# package's reserved feed keys)
ROUTE_FIELDS = ("rows", "order")
# the feed keys of the host's tail partials, "_hosttail:<op>:pos|val"; under
# a data axis > 1 also "_hosttail:<op>:gpos", the global batch's pos staged
# beside the rank's block (no graph input)
HOST_TAIL_PREFIX = "_hosttail:"
# the eager train step's host phases, in order, as spans (utils/profiling.py:
# host totals, and torch.profiler ranges while a profiler records; the last
# two only under host-tail offload)
STEP_PHASES = ("step:build_feeds", "step:h2d_copy", "step:device_step", "step:g_val_readback",
               "step:apply_grads")
_FORCED_TRAINING = ("training under use_pallas='on' is a later slice of the port: the JAX "
                    "package's forced Dense kernel (dense_pallas) has no gradient; use "
                    "use_pallas='auto' or 'off' to train")
_QUANTIZED = ("the embedding tables were quantized for serving (quantize_embeddings); training "
              "needs the f32 master tables: compile again, or set_parameters to restore them")
_HOST_TAIL_CHUNK = ("train_chunk: host-tail offload steps one batch at a time (the host serves and "
                    "updates the tail rows between steps); use train_batch or fit(steps_per_call=1)")
QUANTIZED_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "int8": torch.int8}
_ALIGN = 16  # bytes: each entry of a chunk's packed step buffer starts on a 16-byte boundary


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
        self.iter_config = FFIterationConfig()
        self._constant_feeds: Dict[str, tuple] = {}  # input name -> (dims, value, DataType)
        self._constants: Dict[str, torch.Tensor] = {}  # made at compile
        self._stochastic = False  # an op reads the step's random key
        self._compile_args: Dict[str, Any] = {}
        self.loss_type: Optional[LossType] = None
        self.metrics_mask: MetricsType = MetricsType.METRICS_NONE
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._ctx: Optional[OpContext] = None
        self._out_spec: Optional[TensorSpec] = None
        self._compiled = False
        self.optimizer: Optional[Optimizer] = None
        self.sparse_optimizer: Optional[Optimizer] = None
        self._sparse_ops: List[Embedding] = []
        self._opt_state: Any = None
        self._metrics_total: Dict[str, torch.Tensor] = {}
        self._step_count = 0  # train steps taken (the checkpoint manifest's "step")
        self._tables_quantized = False
        self._layout: Dict[str, Dict[str, tuple]] = {}  # compiled (shape, dtype) of each parameter
        self._n_dense_scalars = 0
        self._sparse_base: Optional[torch.Tensor] = None
        self._step_graph: Optional[_StepGraph] = None
        self._host_tail: Optional[HostTailRuntime] = None
        self.mesh = None  # the compiled mesh (parallel/mesh.py), or None
        self.plan: Optional[ShardingPlan] = None
        self._embedding_layout = None  # the fused collection's layout, or None
        # column-parallel Dense ops over the mesh's model axis: {op: sharded keys}
        self._model_parallel: Dict[str, tuple] = {}
        self._search_report: Optional[dict] = None  # the strategy search's report, at compile

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

    def cross_network(self, input: TensorSpec, num_layers: int, rank: int,
                      name: Optional[str] = None) -> TensorSpec:
        """DCN-V2's low-rank cross network over input [B, d]
        (`ops/cross.py`): `num_layers` layers of rank `rank`."""
        op = LowRankCrossNet(self.graph.unique_name(name or "cross"), input, num_layers, rank)
        return self.graph.add_op(op).outputs[0]

    def concat(
        self, tensors: Sequence[TensorSpec], axis: int, name: Optional[str] = None
    ) -> TensorSpec:
        op = Concat(self.graph.unique_name(name or "concat"), tensors, axis)
        return self.graph.add_op(op).outputs[0]

    def create_constant(self, dims, value: float, dtype=DataType.DT_FLOAT,
                        name: Optional[str] = None) -> TensorSpec:
        """reference: FFModel.create_constant (flexflow_cffi.py): an input
        filled with `value` in `dtype`, made on the model's device at
        compile and fed to every call that is not given it."""
        t = self.create_tensor(dims, dtype=dtype, name=name or "constant")
        self._constant_feeds[t.owner_op.name] = (tuple(int(d) for d in dims), float(value), dtype)
        return t

    # --- introspection (reference: get_layers/print_layers, flexflow_cffi.py)
    def get_layers(self):
        return list(self.graph.compute_ops)

    def get_layer_by_name(self, name: str):
        op = self._op(name)
        if op is None:
            raise KeyError(name)
        return op

    def get_layer_by_id(self, guid: int):
        for op in self.graph.ops:
            if op.guid == guid:
                return op
        raise KeyError(guid)

    def print_layers(self) -> None:
        """reference: FFModel.print_layers."""
        for op in self.graph.compute_ops:
            ins = ", ".join(t.owner_op.name for t in op.inputs)
            outs = ", ".join(str(tuple(t.shape)) for t in op.outputs)
            print(f"[{op.guid}] {type(op).__name__} '{op.name}' ({ins}) -> {outs}")

    # --- shape ops (JAX package :218-261)
    def split(self, input: TensorSpec, sizes, axis: int, name: Optional[str] = None) -> List[TensorSpec]:
        """`sizes` a list of sizes, or a number of equal parts."""
        if isinstance(sizes, int):
            if input.shape[axis] % sizes:
                raise ValueError(f"split: {input.shape[axis]} does not split into {sizes} equal parts")
            sizes = [input.shape[axis] // sizes] * sizes
        op = Split(self.graph.unique_name(name or "split"), input, sizes, axis)
        return list(self.graph.add_op(op).outputs)

    def flat(self, input: TensorSpec, name: Optional[str] = None) -> TensorSpec:
        return self.graph.add_op(Flat(self.graph.unique_name(name or "flat"), input)).outputs[0]

    def reshape(self, input: TensorSpec, shape: Sequence[int], name: Optional[str] = None) -> TensorSpec:
        op = Reshape(self.graph.unique_name(name or "reshape"), input, shape)
        return self.graph.add_op(op).outputs[0]

    def transpose(self, input: TensorSpec, perm: Sequence[int], name: Optional[str] = None) -> TensorSpec:
        op = Transpose(self.graph.unique_name(name or "transpose"), input, perm)
        return self.graph.add_op(op).outputs[0]

    def reverse(self, input: TensorSpec, axis: int, name: Optional[str] = None) -> TensorSpec:
        op = Reverse(self.graph.unique_name(name or "reverse"), input, axis)
        return self.graph.add_op(op).outputs[0]

    # --- elementwise (JAX package :263-321)
    def _binary(self, t: OperatorType, x, y, name=None) -> TensorSpec:
        base = t.name.lower().replace("op_ew_", "")
        op = ElementBinary(self.graph.unique_name(name or base), t, x, y)
        return self.graph.add_op(op).outputs[0]

    def _unary(self, t: OperatorType, x, scalar=0.0, name=None) -> TensorSpec:
        base = t.name.lower().replace("op_", "")
        op = ElementUnary(self.graph.unique_name(name or base), t, x, scalar)
        return self.graph.add_op(op).outputs[0]

    def add(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_ADD, x, y, name)

    def subtract(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_SUB, x, y, name)

    def multiply(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_MUL, x, y, name)

    def divide(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_DIV, x, y, name)

    def exp(self, x, name=None):
        return self._unary(OperatorType.OP_EXP, x, name=name)

    def relu(self, x, name=None):
        return self._unary(OperatorType.OP_RELU, x, name=name)

    def sigmoid(self, x, name=None):
        return self._unary(OperatorType.OP_SIGMOID, x, name=name)

    def tanh(self, x, name=None):
        return self._unary(OperatorType.OP_TANH, x, name=name)

    def elu(self, x, name=None):
        return self._unary(OperatorType.OP_ELU, x, name=name)

    def gelu(self, x, name=None):
        return self._unary(OperatorType.OP_GELU, x, name=name)

    def identity(self, x, name=None):
        return self._unary(OperatorType.OP_IDENTITY, x, name=name)

    def scalar_multiply(self, x, scalar, name=None):
        return self._unary(OperatorType.OP_SCALAR_MULTIPLY, x, scalar, name)

    def scalar_add(self, x, scalar, name=None):
        return self._unary(OperatorType.OP_SCALAR_ADD, x, scalar, name)

    def scalar_sub(self, x, scalar, name=None):
        return self._unary(OperatorType.OP_SCALAR_SUB, x, scalar, name)

    def scalar_truediv(self, x, scalar, name=None):
        return self._unary(OperatorType.OP_SCALAR_TRUE_DIV, x, scalar, name)

    # --- regularizers (JAX package :323-337)
    def softmax(self, input: TensorSpec, name: Optional[str] = None) -> TensorSpec:
        return self.graph.add_op(Softmax(self.graph.unique_name(name or "softmax"), input)).outputs[0]

    def dropout(self, input: TensorSpec, rate: float, seed: int = 0, name=None) -> TensorSpec:
        op = Dropout(self.graph.unique_name(name or "dropout"), input, rate, seed)
        return self.graph.add_op(op).outputs[0]

    # --- linear algebra, attention (JAX package :339-436)
    def batch_matmul(self, A: TensorSpec, B: TensorSpec, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name: Optional[str] = None) -> TensorSpec:
        op = BatchMatmul(self.graph.unique_name(name or "batch_matmul"), A, B, a_seq_length_dim,
                         b_seq_length_dim)
        return self.graph.add_op(op).outputs[0]

    def multihead_attention(
        self,
        query: TensorSpec,
        key: TensorSpec,
        value: TensorSpec,
        embed_dim: int,
        num_heads: int,
        kdim: int = 0,
        vdim: int = 0,
        dropout: float = 0.0,
        bias: bool = True,
        add_bias_kv: bool = False,
        add_zero_attn: bool = False,
        kernel_initializer=None,
        name: Optional[str] = None,
    ) -> TensorSpec:
        op = MultiHeadAttention(
            self.graph.unique_name(name or "attention"),
            query, key, value, embed_dim, num_heads, kdim, vdim,
            dropout, bias, add_bias_kv, add_zero_attn, kernel_initializer,
        )
        return self.graph.add_op(op).outputs[0]

    # --- convolution, pooling, normalization, recurrence (JAX package :165-194, :355-410)
    def lstm(
        self,
        input: TensorSpec,
        hidden_size: int,
        initial_state=None,
        kernel_initializer=None,
        recurrent_initializer=None,
        bias_initializer=None,
        name: Optional[str] = None,
    ):
        """LSTM over [B, T, E] -> (sequence [B, T, H], h_T [B, H], c_T [B,
        H]). initial_state: an optional (h0, c0) pair of [B, H] tensors,
        e.g. an encoder's final state for a decoder layer."""
        h0, c0 = initial_state if initial_state is not None else (None, None)
        op = LSTM(self.graph.unique_name(name or "lstm"), input, hidden_size, h0=h0, c0=c0,
                  kernel_initializer=kernel_initializer, recurrent_initializer=recurrent_initializer,
                  bias_initializer=bias_initializer)
        self.graph.add_op(op)
        return op.outputs[0], op.outputs[1], op.outputs[2]

    def conv2d(
        self,
        input: TensorSpec,
        out_channels: int,
        kernel_h: int,
        kernel_w: int,
        stride_h: int = 1,
        stride_w: int = 1,
        padding_h: int = 0,
        padding_w: int = 0,
        activation=ActiMode.AC_MODE_NONE,
        groups: int = 1,
        use_bias: bool = True,
        kernel_initializer=None,
        bias_initializer=None,
        name: Optional[str] = None,
    ) -> TensorSpec:
        op = Conv2D(
            self.graph.unique_name(name or "conv2d"),
            input, out_channels, kernel_h, kernel_w, stride_h, stride_w,
            padding_h, padding_w, activation, groups, use_bias,
            kernel_initializer, bias_initializer,
        )
        return self.graph.add_op(op).outputs[0]

    def pool2d(
        self,
        input: TensorSpec,
        kernel_h: int,
        kernel_w: int,
        stride_h: int = 1,
        stride_w: int = 1,
        padding_h: int = 0,
        padding_w: int = 0,
        pool_type: PoolType = PoolType.POOL_MAX,
        activation=ActiMode.AC_MODE_NONE,
        name: Optional[str] = None,
    ) -> TensorSpec:
        op = Pool2D(
            self.graph.unique_name(name or "pool2d"),
            input, kernel_h, kernel_w, stride_h, stride_w,
            padding_h, padding_w, pool_type, activation,
        )
        return self.graph.add_op(op).outputs[0]

    def batch_norm(self, input: TensorSpec, relu: bool = True, name: Optional[str] = None) -> TensorSpec:
        op = BatchNorm(self.graph.unique_name(name or "batch_norm"), input, relu)
        return self.graph.add_op(op).outputs[0]

    # --- MoE (JAX package :438-490)
    def top_k(self, input: TensorSpec, k: int, sorted: bool = True, name: Optional[str] = None):
        op = self.graph.add_op(TopK(self.graph.unique_name(name or "topk"), input, k, sorted))
        return op.outputs[0], op.outputs[1]

    def group_by(self, data: TensorSpec, assign: TensorSpec, n: int, alpha: float,
                 name: Optional[str] = None) -> List[TensorSpec]:
        op = GroupBy(self.graph.unique_name(name or "group_by"), data, assign, n, alpha)
        return list(self.graph.add_op(op).outputs)

    def aggregate(self, inputs: Sequence[TensorSpec], n: int, lambda_bal: float = 0.0,
                  name: Optional[str] = None) -> TensorSpec:
        op = Aggregate(self.graph.unique_name(name or "aggregate"), inputs, n, lambda_bal)
        return self.graph.add_op(op).outputs[0]

    def aggregate_spec(self, inputs: Sequence[TensorSpec], n: int, lambda_bal: float = 0.0,
                       name: Optional[str] = None) -> TensorSpec:
        op = AggregateSpec(self.graph.unique_name(name or "aggregate_spec"), inputs, n, lambda_bal)
        return self.graph.add_op(op).outputs[0]

    def cache(self, input: TensorSpec, num_batches: int, score_func=None,
              name: Optional[str] = None) -> TensorSpec:
        op = Cache(self.graph.unique_name(name or "cache"), input, num_batches, score_func)
        return self.graph.add_op(op).outputs[0]

    def recompile_on_condition(self, recompile_state) -> bool:
        """reference: FFModel::recompile_on_condition (model.cc:1424-1428):
        call the user's trigger; if it fires, apply alter_func and
        recompile."""
        if recompile_state.trigger():
            recompile_state.alter()
            self.recompile()
            return True
        return False

    def recompile(self) -> None:
        """Compile again after a change to the graph's static state (a
        Cache's `use_cached`), keeping the parameters, the optimizer state,
        the step count and the metric totals; the captured train step is
        dropped, so the next `train_chunk` captures again (the JAX
        package's re-trace)."""
        self._require_compiled()
        kept = self._params, self._opt_state, self._step_count, self._metrics_total
        self.compile(**self._compile_args)
        self._params, self._opt_state, self._step_count, self._metrics_total = kept

    def set_iteration_config_sequence_length(self, seq_length: int) -> None:
        """reference: model.h:551. BatchMatmul reads it from the next call
        on; the captured train step is dropped (its shapes were fixed at
        capture), as the JAX package re-traces."""
        self.iter_config.seq_length = int(seq_length)
        if self._ctx is not None:
            self._ctx.seq_length = self.iter_config.seq_length
        self._step_graph = None

    # ------------------------------------------------------------------ compile
    def compile(
        self,
        optimizer: Optional[Optimizer] = None,
        loss_type: LossType = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
        metrics: Sequence[MetricsType] = (),
        seed: Optional[int] = None,
        sparse_optimizer: Optional[Optimizer] = None,
        mesh=None,
        plan: Optional[ShardingPlan] = None,
    ) -> None:
        """reference: FFModel::compile (model.cc:1567). Makes the parameters
        on the model's device from `seed` (default config.seed), selects
        the sparse embedding ops and their update route, and makes the
        optimizer state (default optimizer: SGD at config.learning_rate and
        config.weight_decay, as in the JAX package).

        sparse_optimizer: an optimizer of its own for the embedding rows
        (the JAX package's `compile(..., sparse_optimizer=)`, e.g. row-wise
        AdaGrad on the tables and Adam on the dense towers); default
        `optimizer`. Sparse Adam needs dense Adam: the bias correction's
        step count lives in the dense state (ValueError otherwise).

        Under config.host_tail_threshold the large tables are cut to their
        hot prefix before the parameters are made (`_setup_host_tail`);
        ValueError if the rows' optimizer is not plain SGD or row-wise
        AdaGrad.

        mesh, plan: the hybrid-parallel path (`parallel/mesh.py`
        `make_mesh`, `parallel/plan.py` `dlrm_hybrid_plan` or
        `data_parallel_plan`), the planner pass of `_plan_embeddings`.
        Every rank compiles the same model and makes the same replicated
        parameters (one seed, one order), host-tail stores included, and
        its own shard of the fused tables."""
        cfg = self.config
        self._compile_args = dict(optimizer=optimizer, loss_type=loss_type, metrics=tuple(metrics), seed=seed,
                                  sparse_optimizer=sparse_optimizer, mesh=mesh, plan=plan)
        n = mesh.data_size if mesh is not None else 1
        # under a data axis above 1: the inputs and ops on a rank's block,
        # after the refusals of what the port does not compute over the
        # global batch
        batch_ops = (batch_ops_of(self.graph, {k: v[0] for k, v in self._constant_feeds.items()},
                                  cfg.batch_size, n) if n > 1 else frozenset())
        self.optimizer = optimizer or SGDOptimizer(
            lr=cfg.learning_rate, weight_decay=cfg.weight_decay
        )
        self.sparse_optimizer = sparse_optimizer or self.optimizer
        opt, sopt = self.optimizer, self.sparse_optimizer
        for o in (opt, sopt):
            if not isinstance(o, Optimizer):
                raise TypeError(f"compile: optimizer must be an Optimizer, got {type(o).__name__}")
        if isinstance(sopt, AdamOptimizer) and not isinstance(opt, AdamOptimizer):
            raise ValueError("compile: sparse Adam requires dense Adam (the bias correction's "
                             "step count lives in the dense Adam state)")
        # the row-update kernel route (JAX package :798-841, whose "auto"
        # packs on a TPU; here "auto" takes the route on CUDA). The kernels
        # take exactly these sparse optimizers; any other (a custom
        # Optimizer subclass) keeps its scatter rule (:803-809).
        route_enable = (
            cfg.packed_tables == "on"
            or (cfg.packed_tables == "auto" and cfg.use_pallas != "off"
                and self.device.type == "cuda")
        ) and (isinstance(sopt, (SGDOptimizer, AdamOptimizer))
               or type(sopt) is RowWiseAdagradOptimizer)
        coll = self._plan_embeddings(mesh, plan, route_enable)
        if cfg.export_strategy_task_graph_file and (mesh is None or mesh.rank == 0):
            # the JAX package's :702-706, after the planner pass
            from ..utils.profiling import export_task_graph

            export_task_graph(self, cfg.export_strategy_task_graph_file)
        self.loss_type = loss_type
        mask = MetricsType.METRICS_NONE
        for m in metrics:
            mask |= m
        self.metrics_mask = mask
        self._out_spec = self.graph.compute_ops[-1].outputs[0]
        self._binary_acc = self._out_spec.shape[-1] == 1  # DLRM 0.5-threshold accuracy
        use_pallas = cfg.use_pallas
        if not resolve_use_pallas(use_pallas, self.device):
            use_pallas = "off"

        # sparse ops (JAX package :753-775): indices straight from the
        # inputs, vocab above the one-hot threshold (a host-tail op stays
        # sparse whatever its hot prefix: its backward exists only there),
        # not a mid-band table; the fused collection always
        sparse_ops: List[Embedding] = []
        if sopt.supports_sparse:
            for op in self.graph.compute_ops:
                if not (
                    hasattr(op, "sparse_update") and op.inputs
                    and all(isinstance(t.owner_op, InputOp) for t in op.inputs)
                ):
                    continue
                if isinstance(op, Embedding) and (
                    0 < op.num_entries <= cfg.onehot_embedding_threshold and not op.host_tail_vocab
                    or self._onehot_packed_eligible(op)
                ):
                    continue
                sparse_ops.append(op)
        if coll is not None and coll not in sparse_ops:
            raise ValueError(f"compile: the fused embedding collection needs a sparse optimizer "
                             f"(supports_sparse), got {type(sopt).__name__}")
        if self._host_tail is not None:
            missing = sorted(set(self._host_tail.entries) - {op.name for op in sparse_ops})
            if missing:
                raise ValueError(f"compile: host-tail tables {missing} need the sparse-update path "
                                 "(an optimizer with supports_sparse, indices fed from the inputs)")

        sparse_names = {op.name for op in sparse_ops}
        for op in self.graph.compute_ops:
            if isinstance(op, Embedding):
                op.kernel_route, op.table_dtype = False, None
                # mid-band (JAX package :843-864): f32, dense gradients
                op.onehot_packed = op.name not in sparse_names and self._onehot_packed_eligible(op)
        for op in sparse_ops:
            if (
                route_enable
                and type(op) is Embedding
                and 128 % op.out_dim == 0
                and (cfg.packed_tables == "on" or op.inputs[0].volume >= cfg.packed_min_rows)
            ):
                op.kernel_route = True
                if cfg.table_dtype != "float32":
                    op.table_dtype = DataType(cfg.table_dtype).to_torch()
        # bf16 pool storage (JAX package :871-893): on the kernel route
        # under a data axis > 1 only, where the row-update kernel adds each
        # step's f32 sums into it once; the flat collection's scatter would
        # round every duplicate add in bf16
        if coll is not None:
            coll.table_dtype = None
            if cfg.table_dtype == "bfloat16" and coll.sharded and coll.layout.packed_pool:
                coll.table_dtype = torch.bfloat16
        self._sparse_ops = sparse_ops
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed if seed is None else seed)
        with torch.no_grad():
            params = self.graph.init_params(gen, self.device, keep=self._kept_params)

        # the JAX package keeps a mid-band table packed [P, 128], and its
        # dense row-wise AdaGrad keeps one accumulator per 128-lane line of it
        line_rows = {op.name: 128 // op.out_dim for op in self.graph.compute_ops
                     if isinstance(op, Embedding) and op.onehot_packed}
        self._dense_kw = ({"line_rows": line_rows}
                          if line_rows and isinstance(opt, RowWiseAdagradOptimizer) else {})
        if sparse_ops:
            dense_init = {k: v for k, v in params.items() if k not in sparse_names}
            self._opt_state = {
                "dense": opt.init(dense_init, self.device, **self._dense_kw),
                "sparse": {op.name: op.sparse_state_init(sopt, self.device) for op in sparse_ops},
            }
        else:
            self._opt_state = opt.init(params, self.device, **self._dense_kw)
        self._params = params
        self._layout = {op: {k: (tuple(v.shape), v.dtype) for k, v in sub.items()}
                        for op, sub in params.items()}
        # per-step scalars: the dense optimizer's, then a distinct sparse
        # optimizer's; a distinct sparse optimizer's own rate lives on the
        # device from here on
        self._n_dense_scalars = len(opt.step_scalars(1))
        base = getattr(sopt, "alpha", getattr(sopt, "lr", None)) if sopt is not opt else None
        self._sparse_base = (None if base is None else
                             torch.full((), float(base), dtype=torch.float32, device=self.device))
        self._step_count = 0
        self._tables_quantized = False
        self._step_graph = None
        self._ctx = OpContext(
            training=False,
            compute_dtype=DataType(cfg.compute_dtype).to_torch(),
            onehot_threshold=cfg.onehot_embedding_threshold,
            use_pallas=use_pallas,
            device=self.device,
            mesh=self.mesh,
            model_parallel=frozenset(self._model_parallel),
            seq_length=self.iter_config.seq_length,
            batch_ops=batch_ops,
        )
        # constants (JAX package :707-719), each once, in its declared dtype;
        # under a data axis above 1 one whose leading dimension is the batch
        # size at the rank's block, as GSPMD slices it
        self._constants = {name: torch.full(((dims[0] // n,) + dims[1:]) if name in batch_ops else dims,
                                            value, dtype=dt.to_torch(), device=self.device)
                           for name, (dims, value, dt) in self._constant_feeds.items()}
        self._stochastic = any(op.stochastic for op in self.graph.compute_ops)
        for op in self.graph.compute_ops:
            if isinstance(op, Cache):
                op.stage(self.device, self.mesh if op.name in batch_ops else None)
        self._metrics_total = {}
        self.reset_metrics()
        self._compiled = True

    def _kept_params(self, op, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """An op's parameters as drawn (f32, whole) turned into what the
        model keeps, before the next op draws: a column-parallel Dense's
        row block (it draws its kernel and bias whole, so every later draw
        is one card's), a table or pool in its storage dtype."""
        for k in self._model_parallel.get(op.name, ()):
            params[k] = row_block(params[k], self.mesh.model_size, self.mesh.model_index)
        dtype = getattr(op, "table_dtype", None)
        if dtype is not None:
            key = "pool" if isinstance(op, EmbeddingCollection) else "weight"
            params[key] = params[key].to(dtype)
        return params

    def _onehot_packed_eligible(self, op) -> bool:
        """The JAX package's mid-band selection (`_onehot_packed_eligible`,
        :502-520): vocab in (onehot_embedding_threshold,
        onehot_packed_threshold], D | 128, pooled, not a host-tail op, no
        mesh."""
        thr = self.config.onehot_packed_threshold
        return (
            thr > 0
            and self.mesh is None
            and type(op) is Embedding
            and self.config.onehot_embedding_threshold < op.num_entries <= thr
            and 128 % op.out_dim == 0
            and op.aggr is not AggrMode.AGGR_MODE_NONE
            and not op.host_tail_vocab
        )

    # ------------------------------------------------------------------ the planner pass
    @property
    def _data_mesh(self):
        """The compiled mesh when its data axis is above 1, else None: the
        batch is then sliced, the dense gradients, losses and metrics
        reduced over the data group, and the fused tables sharded over the
        data indices."""
        return self.mesh if self.mesh is not None and self.mesh.data_size > 1 else None

    def _plan_embeddings(self, mesh, plan: Optional[ShardingPlan], route_enable: bool):
        """The planner pass of compile (the JAX package's :609-699), before
        the parameters are made; returns the fused collection or None.

        No mesh: host-tail offload, then, under config.fuse_embeddings,
        every table of one D and pooling fused on one device. A mesh: the
        plan's defaults from the config (a strategy file to import,
        `exchange`, `chips_per_host`), the kernel-route decision, host-tail
        offload (before fusion: a host-tail table is never fused), under a
        table-parallel plan the tables above onehot_embedding_threshold
        fused and sharded over the data axis, the strategy exported (by
        rank 0). At a data axis of 1 the collection is the flat one and
        stays off the kernel route whatever the plan says: the JAX package
        sets `packed_pool` there too and its flat fallback then asserts
        (`ops/embedding_collection_op.py:176-181`; ROADMAP.md Queue 3).

        A 2-D ("data", "model") mesh (the JAX package's :626-645, 670-674):
        config.chips_per_host is divided by the model axis (a data index
        spans M cards), config.enable_parameter_parallel adds the plan's
        column-parallel Dense specs (`enable_parameter_parallel`), the
        collection is sharded over the data axis and replicated along the
        model axis, and the plan's specs name the Dense ops that run
        column-parallel (`tensor_parallel_ops`, over a model axis above 1).

        config.search_budget > 0 with no table assignment in the plan runs
        the strategy search (`_run_strategy_search`) before the column-
        parallel specs and host-tail offload, as the JAX package does.
        Raises NotImplementedError for a parameter spec of another form
        than the column-parallel Dense one."""
        cfg = self.config
        existing = next((op for op in self.graph.compute_ops if isinstance(op, EmbeddingCollection)), None)
        self.mesh, self.plan = mesh, plan
        self._model_parallel = {}
        if mesh is None:
            self._setup_host_tail(plan)
            if existing is None and cfg.fuse_embeddings:
                existing = fuse_embedding_tables(self.graph, dlrm_hybrid_plan(), 1)
            return self._bind_collection(existing, 1, None)
        if self.device.type != mesh.device.type or (
                self.device.type == "cuda" and self.device.index not in (None, mesh.device.index)):
            raise ValueError(f"compile(mesh=): the model lives on {self.device}, the mesh's rank on "
                             f"{mesh.device}")
        if plan is None:
            raise ValueError("compile(mesh=) takes a plan: parallel.plan.dlrm_hybrid_plan() or "
                             "data_parallel_plan()")
        if cfg.import_strategy_file:
            plan = self.plan = ShardingPlan.load(cfg.import_strategy_file)
        if plan.exchange == "dense" and cfg.exchange != "dense":
            plan.exchange = cfg.exchange
        if plan.chips_per_host is None and cfg.chips_per_host:
            # a data index spans the model axis's cards of a host
            plan.chips_per_host = max(1, cfg.chips_per_host // mesh.model_size)
        if cfg.search_budget > 0 and plan.table_assignment is None:
            self._run_strategy_search(mesh, plan)
        if cfg.enable_parameter_parallel and "model" in mesh.axis_names:
            enable_parameter_parallel(plan, self.graph)
        tp = tensor_parallel_ops(plan, self.graph, mesh.axis_names)
        if mesh.model_size > 1:
            odd = [name for name in tp if self._op(name).out_dim % mesh.model_size]
            if odd:
                raise ValueError(f"compile(mesh=): the column-parallel Dense ops {odd} have an out_dim that "
                                 f"does not split over the model axis of {mesh.model_size}")
            self._model_parallel = tp
        if plan.exchange not in ("dense", "routed"):
            raise ValueError(f"compile(mesh=): exchange={plan.exchange!r}: 'dense' or 'routed'")
        n = mesh.data_size
        shard = mesh.data_index if n > 1 else None
        if plan.packed_pool is None or n == 1:
            plan.packed_pool = route_enable and n > 1
        self._setup_host_tail(plan)
        if existing is None and plan.embedding_mode == "table_parallel":
            existing = fuse_embedding_tables(self.graph, plan, n, min_vocab=cfg.onehot_embedding_threshold,
                                             shard=shard)
        if n > 1 and existing is not None and existing.layout.hierarchical:
            # the subgroups, made once on every rank (Mesh.subgroup)
            mesh.data_subgroup(existing.layout._host_groups())
            mesh.data_subgroup(existing.layout._cross_host_groups())
        if cfg.export_strategy_file and mesh.rank == 0:
            plan.save(cfg.export_strategy_file)
        return self._bind_collection(existing, n, shard)

    # ------------------------------------------------------------------ the strategy search
    def _search_machine(self, mesh):
        """The machine model of the search (the JAX package's :1113-1150):
        config.machine_model_file, else the "h100" preset on CUDA and
        "cpu_sim" on the CPU with config's simulator knobs; the mesh's
        cards as one NVSwitch host ("h100") or one torus; on CUDA with no
        machine file, calibrated on this card (cached at
        config.machine_cache_path())."""
        import os

        from ..autotune import machine as mm

        cfg, n = self.config, mesh.data_size
        if cfg.machine_model_file:
            machine = mm.MachineSpec.from_file(cfg.machine_model_file)
            machine.num_chips = n
        else:
            local = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.size))
            machine = mm.preset("h100" if self.device.type == "cuda" else "cpu_sim", num_chips=n,
                                chips_per_host=min(n, local))
            machine.segment_bytes = float(cfg.simulator_segment_size)
            machine.max_segments = float(cfg.simulator_max_num_segments)
        if cfg.search_overlap_backward_update:
            machine.overlap_backward_update = 1.0
        if machine.ici_axis_x <= 0 and machine.ici_domain <= 0:
            machine = machine.nvswitch_for(n) if machine.name == "h100" else machine.torus_for(n)
        if "model" in mesh.axis_names and machine.model_axis <= 1:
            machine.model_axis = int(mesh.model_size)
        if not cfg.machine_model_file and self.device.type == "cuda":
            cache = cfg.machine_cache_path()
            machine = mm.calibrate_or_cached(machine, cache, self.device)
            shapes = mm.graph_dense_shapes(self.graph)
            if any(f"{a}x{b}" not in machine.dense_costs for a, b in shapes):
                machine = mm.calibrate_dense(machine, shapes, device=self.device)
                machine.save(cache)
            if any(mm.op_cost_sig(o) not in machine.op_costs for o in mm.measurable_graph_ops(self.graph)):
                machine = mm.calibrate_graph_ops(machine, self.graph, device=self.device)
                machine.save(cache)
            print(f"[autotune] machine model calibrated (cache: {cache})")
        return machine

    def _run_strategy_search(self, mesh, plan: ShardingPlan) -> None:
        """The JAX package's `_run_strategy_search` (:1109-1316) in one
        process a card: rank 0 makes the machine model and runs
        `autotune_plan_joint`; its (owner, cost, report, machine) goes to
        every rank in one `broadcast_object_list`, so every rank applies
        the same decisions to its plan whatever its own card would have
        timed; only rank 0 calibrates and writes the machine file."""
        from ..autotune.search import autotune_plan_joint

        cfg = self.config
        found = None
        if mesh.rank == 0:
            machine = self._search_machine(mesh)
            sopt = self.sparse_optimizer or self.optimizer
            osf = 1.0 if sopt.sparse_init((2, 2), torch.device("cpu")) is not None else 0.0
            # row splits are exact only under SUM pooling (partial sums)
            sum_only = all(getattr(op, "aggr", AggrMode.AGGR_MODE_SUM) is AggrMode.AGGR_MODE_SUM
                           for op in self.graph.compute_ops if op.op_type is OperatorType.OP_EMBEDDING)
            half = cfg.compute_dtype in ("bfloat16", "float16")
            owner, cost_us, report = autotune_plan_joint(
                self.graph, machine, cfg.batch_size, budget=cfg.search_budget, alpha=cfg.search_alpha,
                seed=cfg.seed, opt_state_factor=osf, allow_splits=sum_only,
                min_vocab=cfg.onehot_embedding_threshold, exchange_dtype_bytes=2.0 if half else 4.0,
                enable_propagation=cfg.enable_propagation, host_tail_hot=cfg.host_tail_threshold or (1 << 20),
                table_dtype_bytes=2.0 if cfg.table_dtype == "bfloat16" else 4.0)
            found = (owner, cost_us, report, dataclasses.asdict(machine))
        if mesh.size > 1:
            box = [found]
            dist.broadcast_object_list(box, src=0)
            found = box[0]
        owner, cost_us, report, machine = found
        report = report or {}
        n = mesh.data_size
        if report.get("replicated_tables") is not None:
            plan.replicated_tables = report["replicated_tables"]
        tails = report.get("host_tail_rows")
        if tails and any(tails) and plan.host_tail_rows is None:
            # the search's table order is the graph's Embedding order only
            # before fusion
            if len(tails) == sum(1 for o in self.graph.compute_ops if isinstance(o, Embedding)):
                plan.host_tail_rows = tails
        if owner:
            plan.table_assignment = owner
            split = report.get("table_split")
            if split and any(s > 1 for s in split):
                plan.table_split = split
            tp_ops = set(report.get("tp_ops", []))
            if tp_ops and "model" in mesh.axis_names:
                enable_parameter_parallel(plan, self.graph, min_out_dim=2, only=tp_ops)
            if report.get("exchange") and plan.exchange == "dense":
                plan.exchange = report["exchange"]
            dom = machine["ici_domain"] or n
            if plan.chips_per_host is None and machine["hierarchical_a2a"] > 0 and 1 < dom < n:
                plan.chips_per_host = int(dom)
        self._search_report = report
        if report and mesh.rank == 0:
            print(f"[autotune] predicted step {cost_us * (machine['step_residual'] or 1.0):.1f}us "
                  f"(model {cost_us:.1f}us x residual {machine['step_residual']:.2f}; round-robin "
                  f"{report['round_robin_us']:.1f}us, {report['improvement']:.2f}x)")

    def _bind_collection(self, coll, num_shards: int, shard):
        if coll is not None and (coll.layout.num_shards != num_shards or coll.shard != shard):
            raise ValueError(f"compile: the graph's {coll.name} was fused for {coll.layout.num_shards} "
                             f"shards (shard {coll.shard}), not {num_shards} (shard {shard}); build the "
                             "model again for another mesh")
        self._embedding_layout = coll.layout if coll is not None else None
        return coll

    # ------------------------------------------------------------------ host-tail offload
    def _setup_host_tail(self, plan: Optional[ShardingPlan]) -> None:
        """The offload pass (parallel/passes.py, placed by the plan's
        `host_tail_rows` or config.host_tail_threshold) and the host
        stores, before the parameters are made (the JAX package's
        `_setup_host_tail`, :1409-1467). The tail rows follow the table's
        row rule: plain SGD or row-wise AdaGrad (a per-row accumulator in
        the store); any other rule would update the two halves of one
        table differently, so it raises ValueError. A second compile keeps
        the runtime it has. Under a mesh every rank makes the same stores
        (one seed): replicas."""
        entries = offload_embedding_tails(self.graph, plan, self.config)
        if not entries:
            return
        row_opt = self.sparse_optimizer or self.optimizer
        if isinstance(row_opt, RowWiseAdagradOptimizer):
            rule, eps, acc0 = "rowwise_adagrad", row_opt.epsilon, row_opt.initial_accumulator
        elif (isinstance(row_opt, SGDOptimizer) and row_opt.momentum == 0.0
              and row_opt.weight_decay == 0.0):
            rule, eps, acc0 = "sgd", 0.0, 0.0
        else:
            raise ValueError(
                "host-tail offload supports plain SGD (momentum 0, weight decay 0) or row-wise "
                f"AdaGrad row updates only, got {row_opt!r}; pass sparse_optimizer= one of those "
                "or set host_tail_threshold to 0")
        rt = HostTailRuntime(rule=rule, epsilon=eps)
        for j, (op, sfeed, full, hot, k_cap) in enumerate(entries):
            scale = float(getattr(op, "host_tail_init_scale", np.sqrt(6.0 / (full + op.out_dim))))
            rt.add(op.name, HostTailStore(op.out_dim, scale, seed=self.config.seed * 1000 + j,
                                          acc_init=acc0), sfeed, hot, full, k_cap)
        self._host_tail = rt

    @property
    def host_tail_dropped(self) -> int:
        """Tail lookups dropped by the exchange's capacity, over the
        model's training steps."""
        return self._host_tail.dropped if self._host_tail is not None else 0

    def host_tail_drop_fraction(self) -> float:
        return self._host_tail.drop_fraction if self._host_tail is not None else 0.0

    def routed_drop_fraction(self, feeds) -> float:
        """The share of a global batch's valid lookups that the routed
        exchange's capacity buckets drop (0.0 unless the fused collection's
        exchange is "routed" with cap_factor > 0), counted on the host
        (parallel/routed_exchange.routed_drop_stats; the JAX package's
        `routed_drop_fraction`, core/ffmodel.py:1894-1921)."""
        from ..parallel.routed_exchange import routed_drop_stats

        lay = self._embedding_layout
        if lay is None or lay.exchange != "routed" or lay.routed_cap_factor <= 0:
            return 0.0
        coll = next(op for op in self.graph.compute_ops if isinstance(op, EmbeddingCollection))

        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        idx = np.stack([host(feeds[t.owner_op.name]).reshape(len(feeds[t.owner_op.name]), -1)
                        for t in coll.inputs], axis=1)
        return float(routed_drop_stats(lay, idx)[2])

    def _index_arrays(self, feeds: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """The host-tail tables' index feeds as host arrays (a tensor on the
        device is copied back, which waits for the device)."""
        out = {}
        for _, sfeed, *_ in self._host_tail.entries.values():
            v = feeds[sfeed]
            out[sfeed] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return out

    def _host_tail_feeds(self, feeds: Dict[str, Any], train: bool) -> Dict[str, Any]:
        """`feeds` with the batch's tail partials (`HostTailRuntime.
        build_feeds`); `train=False` counts no drops and creates no rows."""
        if self._host_tail is None:
            return feeds
        return {**feeds, **self._host_tail.build_feeds(self._index_arrays(feeds), train=train)}

    def _host_tail_readback(self, g_host: Dict[str, torch.Tensor], scalars) -> tuple:
        """({op: g_val [K_cap, D] f32}, the step's row rate) on the host, in
        one copy into pinned memory: the host-tail step's one sync. The rate
        is the one the device step used (`_sparse_rate`)."""
        rate = self._sparse_rate(self._opt_state["dense"], scalars)
        names = list(g_host)
        flat = torch.cat([g_host[n].float().reshape(-1) for n in names] + [rate.float().reshape(1)])
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=flat.is_cuda).copy_(flat).numpy()
        out, off = {}, 0
        for n in names:
            k, d = g_host[n].shape
            out[n] = host[off:off + k * d].reshape(k, d)
            off += k * d
        return out, float(host[-1])

    # ------------------------------------------------------------------ verbs
    def _require_compiled(self) -> None:
        if not self._compiled:
            raise RuntimeError("FFModel: call compile() first")

    def _require_trainable(self) -> None:
        self._require_compiled()
        if self._tables_quantized:
            raise RuntimeError(_QUANTIZED)
        if self._ctx.use_pallas == "on":
            raise NotImplementedError(_FORCED_TRAINING)

    def _stage(self, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host -> device batch staging; every graph input must be fed, but
        a constant (`create_constant`), which is fed its compiled tensor
        unless given. Tensors already on the model's device pass through. The host's tail
        partials go through pinned memory, without waiting. Under a mesh
        each rank is fed the global batch and stages its slice
        (`Mesh.batch_slice`); of the global batch's tail partials it stages
        its block (`host_tail.rank_block`) and, as `_hosttail:<op>:gpos`,
        the global pos, at which `_step` gathers `g_val`."""
        staged = {}
        mesh = self._data_mesh
        if mesh is not None and self._host_tail is not None:
            feeds = dict(feeds)
            for name, (_, sfeed, *_rest) in self._host_tail.entries.items():
                pname, vname = self._host_tail.feed_names(name)
                feeds[f"{HOST_TAIL_PREFIX}{name}:gpos"] = feeds[pname]
                feeds[pname], feeds[vname] = rank_block(feeds[pname], feeds[vname], len(feeds[sfeed]),
                                                        mesh.data_index, mesh.data_size)
        for iop in self.graph.inputs:
            if iop.name not in feeds:
                if iop.name in self._constants:
                    staged[iop.name] = self._constants[iop.name]
                    continue
                raise KeyError(f"missing feed {iop.name!r}")
            x = feeds[iop.name]
            if iop.name in self._ctx.batch_ops and not iop.name.startswith(HOST_TAIL_PREFIX):
                x = x[mesh.batch_slice(x.shape[0])]
            staged[iop.name] = self._to_device(x, iop.outputs[0].dtype.to_torch(),
                                               iop.name.startswith(HOST_TAIL_PREFIX))
        if mesh is not None and self._host_tail is not None:
            for name in self._host_tail.entries:
                key = f"{HOST_TAIL_PREFIX}{name}:gpos"
                staged[key] = self._to_device(feeds[key], torch.int32, True)
        return staged

    def _to_device(self, x, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=dtype)
        if pinned and self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _stage_labels(self, labels) -> torch.Tensor:
        """Labels as f32 on the device. Sparse categorical CE reads class
        ids back from them, which is exact for ids below 2^24."""
        if self._data_mesh is not None:
            labels = labels[self._data_mesh.batch_slice(labels.shape[0])]
        return torch.as_tensor(labels, dtype=torch.float32).to(self.device)

    def forward(self, feeds: Dict[str, Any], training: bool = False) -> torch.Tensor:
        """reference: FFModel::forward (model.cc:1416): the forward of one
        batch, without gradients, as a tensor on the model's device; under
        a mesh, this rank's slice of it (`predict` puts the slices
        together)."""
        self._require_compiled()
        ctx = dataclasses.replace(self._ctx, training=training,
                                  rng=self._step_key(None) if training else None)
        feeds = self._host_tail_feeds(feeds, train=False)
        with torch.inference_mode():
            with span("forward:stage"):
                staged = self._stage(feeds)
            with span("forward:execute"):
                (out,) = self.graph.execute(self._params, staged, ctx, fetch=[self._out_spec])
        return out

    def train_batch(self, feeds: Dict[str, Any], labels) -> torch.Tensor:
        """One step: forward, loss and metrics, backward, the dense update
        in place, sparse row updates. Returns the loss as a 0-d tensor on the
        model's device (the JAX package returns a 0-d array). Raises
        NotImplementedError under use_pallas="on" and RuntimeError after
        `quantize_embeddings`.

        Under config.host_routing the row-update route's sorted streams come
        from the host (JAX package: ffmodel.py:1359-1360): feeds that carry
        every `_route:<op>:rows` and `_route:<op>:order` key (from
        `compute_routes` of this same batch, staged or not) are used as they
        are; otherwise `compute_routes(feeds)` makes them. Index feeds that
        already lie on the device then cost a device-to-host copy, which
        waits for the device, as the JAX package's `np.asarray` does; a
        caller that wants no such wait (bench.py) computes the routes from
        the host arrays beforehand and stages them with the batch.

        Under host-tail offload the step also builds the tail partials on
        the host, reads `g_val` back (one sync) and applies the tail rows'
        updates (see the module note)."""
        self._require_trainable()
        route_ops = self._route_ops()
        routes = self._routes_for(feeds, route_ops) if self.config.host_routing and route_ops else None
        return self._eager_step(feeds, labels, routes)

    def _eager_step(self, feeds, labels, routes) -> torch.Tensor:
        """Stage one batch and this step's scalars (one small copy), run the
        step, count it; under host-tail offload, the host's half around it.
        Each phase is a span named in `STEP_PHASES`."""
        with span("step:build_feeds"):
            feeds = self._host_tail_feeds(feeds, train=True)
        with span("step:h2d_copy"):
            scalars = self._step_scalars()
            staged, labels = self._stage(feeds), self._stage_labels(labels)
        with span("step:device_step"):
            loss, g_host = self._step(staged, labels, routes, scalars)
        if self._host_tail is not None:
            with span("step:g_val_readback"):
                g_val, rate = self._host_tail_readback(g_host, scalars)
            with span("step:apply_grads"):
                self._host_tail.apply_grads(g_val, rate)
        self._advance(1)
        return loss

    def _step_scalars(self) -> torch.Tensor:
        scalars = torch.from_numpy(self._scalar_table(self._step_count + 1, 1)[0])
        if self.device.type == "cuda":
            scalars = scalars.pin_memory().to(self.device, non_blocking=True)
        return scalars

    def _step_key(self, step: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The step's random key on the device (`core/graph.py` `step_key`
        of config.seed and the step count before the step, read from
        `step` where a captured step stages it, else from the host's
        count), or None when no op draws random bits."""
        if not self._stochastic:
            return None
        if step is None:
            step = torch.tensor(self._step_count, dtype=torch.int64, device=self.device)
        return step_key(self.config.seed, step)

    def _step(self, staged, labels, routes, scalars, grad_inputs: Sequence[str] = (), step=None,
              timed: bool = True) -> tuple:
        """The device work of one train step on staged tensors: `routes`
        None or {op: (rows_sorted, order)}, `scalars` this step's
        `_scalar_table` row on the device. Reads no host state that changes
        between steps and syncs nothing, so a CUDA graph can capture it.

        Under a data axis > 1 the sparse tables outside the fused
        collection are updated with the global batch's stream
        (`replicated_sparse_update`: two all-gathers, then the one-card
        update), after the dense gradients' all-reduce and before the
        collection's exchange, in that order on every rank.

        Returns (loss, aux): aux holds, under host-tail offload, each tail
        table's `g_val` [K_cap, D], its pooled-output gradient at the
        partials' slots (pos == B clipped to B - 1, as `jnp.take(mode=
        "clip")` does; the host reads only the filled slots; under a data
        axis > 1 the gathered global gradient at the global pos), and the
        gradient of each input named in `grad_inputs` (autograd on leaves
        that require grad; training/host_offload.py). `step`: the step count
        on the device where random ops need it (`_step_key`).

        Each phase of `utils/profiling.py` `PHASES` is a block whose end is
        stamped on the device (`step_phases`; a captured step stamps at
        every replay); `timed` false stamps nothing (the warm-up before a
        capture). The host tail's gather after the row updates is in no
        phase."""
        opt = self.optimizer
        sparse_ops = self._sparse_ops
        sparse_names = {op.name for op in sparse_ops}
        phase = step_phases(self.device, timed)
        ctx = dataclasses.replace(self._ctx, training=True, rng=self._step_key(step), phases=phase)

        sparse_xs: Dict[str, List[torch.Tensor]] = {}
        overrides: Dict[str, List[torch.Tensor]] = {}
        with phase("phase:lookup"), torch.no_grad():
            for op in sparse_ops:
                xs = [staged[t.owner_op.name] for t in op.inputs]
                sparse_xs[op.name] = xs
                overrides[op.name] = [
                    y.detach().requires_grad_(True)
                    for y in op.forward(self._params[op.name], xs, ctx)
                ]
        # dense leaves share storage with the parameters, which themselves
        # never require grad: no graph outlives the step
        leaves = {
            name: {k: p.detach().requires_grad_(True) for k, p in sub.items()}
            for name, sub in self._params.items()
            if name not in sparse_names
        }
        inputs = {name: staged[name].detach().requires_grad_(True) for name in grad_inputs}
        staged = {**staged, **inputs}
        ctx.overrides = overrides
        with phase("phase:forward"):
            (logits,) = self.graph.execute(leaves, staged, ctx, fetch=[self._out_spec])
        with phase("phase:loss"):
            loss, loss_out = self._loss_and_metrics(logits, labels)
        flat_leaves = [p for sub in leaves.values() for p in sub.values()]
        flat_over = [y for op in sparse_ops for y in overrides[op.name]]
        with phase("phase:backward"):
            grads = torch.autograd.grad(
                loss, flat_leaves + flat_over + list(inputs.values()), allow_unused=True,
                materialize_grads=True,
            )
        it = iter(grads)
        g_dense = {name: {k: next(it) for k in sub} for name, sub in leaves.items()}
        g_over = {op.name: [next(it) for _ in overrides[op.name]] for op in sparse_ops}
        aux = {name: next(it) for name in inputs}

        mesh = self._data_mesh
        with phase("phase:dense_reduce"):
            self._reduce_dense_grads(g_dense)
        dense_params = {name: self._params[name] for name in g_dense}
        st = self._opt_state
        with phase("phase:dense_update"):
            dstate = self._dense_update(g_dense, st["dense"] if sparse_ops else st, dense_params, scalars)
        with phase("phase:sparse_update"):
            if sparse_ops:
                lr = self._sparse_rate(dstate, scalars)
                sstates, rest = st["sparse"], sparse_ops
                replicated = [op for op in sparse_ops if not isinstance(op, EmbeddingCollection)]
                if mesh is not None and replicated:
                    sstates, g_global = replicated_sparse_update(
                        replicated, self._params, sparse_xs, g_over, self.sparse_optimizer, sstates, ctx,
                        lr=lr, routes=routes)
                    g_over = {**g_over, **g_global}
                    rest, routes = [op for op in sparse_ops if op not in replicated], None
                if rest:
                    sstates = apply_sparse_updates(rest, self._params, sparse_xs, g_over,
                                                   self.sparse_optimizer, sstates, ctx, lr=lr, routes=routes)
        self._opt_state = {"dense": dstate, "sparse": sstates} if sparse_ops else dstate
        if self._host_tail is not None:
            suffix = "gpos" if mesh is not None else "pos"
            for name in self._host_tail.entries:
                g = g_over[name][0]
                pos = staged[f"{HOST_TAIL_PREFIX}{name}:{suffix}"].long().clamp(0, g.shape[0] - 1)
                aux[name] = g[pos]
        return loss_out, aux

    def _reduce_dense_grads(self, g_dense) -> None:
        """The dense gradients, in place: under a data axis > 1 summed over
        the data group in one bucket. Under a model axis > 1 the replicated
        ones (all but the column-parallel blocks) are then broadcast from
        model index 0 over the model group in one bucket: the model peers
        of a data index compute them from the same inputs, and the
        broadcast keeps their replicas equal bit for bit whatever order a
        kernel of the backward sums in (the one-hot lookups' backward adds
        by float atomics)."""
        tp = self._model_parallel
        mesh = self.mesh
        if self._data_mesh is not None:
            _all_reduce_flat([g for sub in g_dense.values() for g in sub.values()], mesh.data_group())
        rep = [g for name, sub in g_dense.items() for k, g in sub.items() if k not in tp.get(name, ())]
        if tp and rep:
            _broadcast_flat(rep, mesh.data_index * mesh.model_size, mesh.model_group())

    def _loss_and_metrics(self, logits, labels) -> tuple:
        """(the loss to differentiate, the loss to return) of one batch,
        its metrics added to the totals. Under a data axis > 1 the first is
        this rank's share of the global batch's loss (a mean loss divided
        by the data axis), whose gradients sum over the data group to the
        global ones; the second, the global loss, and the metrics are
        reduced over the data group in one all-reduce, so every rank
        returns the same loss and keeps the same totals (the ranks of one
        data index compute the same ones: no sum along the model axis)."""
        loss = losses_lib.compute_loss(self.loss_type, logits, labels)
        with torch.no_grad():
            step = metrics_lib.compute_perf_metrics(self.metrics_mask, logits, labels, self._binary_acc)
        mesh = self._data_mesh
        if mesh is not None:
            if self.loss_type is not LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
                loss = loss / mesh.data_size
            with torch.no_grad():
                out, *values = _all_reduce_flat([loss.detach().clone()] + list(step.values()),
                                                mesh.data_group())
                step = dict(zip(step, values))
        else:
            out = loss.detach()
        with torch.no_grad():
            metrics_lib.accumulate(self._metrics_total, step)
        return loss, out

    def _dense_update(self, grads, state, params, scalars) -> dict:
        if self._n_dense_scalars:
            return self.optimizer.update(grads, state, params, scalars=scalars[: self._n_dense_scalars],
                                         **self._dense_kw)
        return self.optimizer.update(grads, state, params, **self._dense_kw)

    def _scalar_table(self, first_step: int, k: int) -> np.ndarray:
        """[k, S] f32: the step scalars of steps first_step .. first_step + k
        - 1, the dense optimizer's then a distinct sparse optimizer's."""
        opts = [self.optimizer] + ([self.sparse_optimizer]
                                   if self.sparse_optimizer is not self.optimizer else [])
        rows = [np.concatenate([o.step_scalars(t) for o in opts]) for t in range(first_step, first_step + k)]
        return np.stack(rows).astype(np.float32, copy=False)

    def _advance(self, steps: int) -> None:
        """The host's step count, mirrored into the dense state's "step" (a
        captured step leaves the host's Python state as its capture left it)."""
        self._step_count += steps
        st = self._opt_state
        (st["dense"] if "dense" in st else st)["step"] = self._step_count

    def _route_ops(self) -> List[Embedding]:
        return [op for op in self._sparse_ops if op.kernel_route]

    # ------------------------------------------------------------------ the multi-step call
    def train_chunk(self, stacked_feeds: Dict[str, Any], stacked_labels) -> torch.Tensor:
        """K train steps on [K, B, ...] stacks (the JAX package's
        `train_chunk`, core/ffmodel.py:1478-1520): every graph input is fed,
        and under `config.host_routing` a stack may carry each route table's
        `_route:<op>:rows` and `_route:<op>:order` ([K, n] int32, as
        `compute_routes` gives them for each batch), which the steps use;
        otherwise they sort on the device. Routes are never computed here.
        Returns the last step's loss as a 0-d tensor (a copy).

        On CUDA one step is captured in a CUDA graph and replayed (see the
        module note); a shorter stack replays the same graph fewer times.
        Tables on either update route and mid-band tables are captured.
        Raises whatever capture or replay raises: it never falls back to
        eager steps. On the CPU it is a loop of steps. Raises as
        `train_batch` does for a model that does not train, and
        RuntimeError under host-tail offload, as the JAX package does.

        Under a mesh every rank is given the global [K, B_global, ...]
        stacks and steps on its slice along axis 1 (`Mesh.batch_slice`; the
        JAX package shards them P(None, batch), :1498-1512). The captured
        step holds the step's collectives: the exchange's all-to-alls, the
        dense gradients' all-reduce and the loss-and-metrics all-reduce,
        each run once, in the same order on every rank, by the eager first
        step, which makes the NCCL communicators before the capture.

        Spans on CUDA (utils/profiling.py): `train_chunk:stage` (the stacks to
        the card, and each step's copy into the static buffer),
        `train_chunk:capture` (the warm-up step and the capture: its count
        is the captures made) and `train_chunk:replay` (the loop of steps)."""
        self._require_trainable()
        if self._host_tail is not None:
            raise RuntimeError(_HOST_TAIL_CHUNK)
        k = int(stacked_labels.shape[0])
        if k < 1:
            raise ValueError("train_chunk: the stacks hold no step")
        route_ops = self._route_ops()
        keys = ([f"_route:{op.name}:{f}" for op in route_ops for f in ROUTE_FIELDS]
                if self.config.host_routing else [])
        keys = keys if keys and all(key in stacked_feeds for key in keys) else []
        if self.device.type != "cuda":
            for i in range(k):
                feeds = {name: v[i] for name, v in stacked_feeds.items()}
                loss = self._eager_step(feeds, stacked_labels[i],
                                        self._routes_for(feeds, route_ops) if keys else None)
            return loss
        fed = [iop for iop in self.graph.inputs if iop.name in stacked_feeds or iop.name not in self._constants]
        missing = [iop.name for iop in fed if iop.name not in stacked_feeds]
        if missing:
            raise KeyError(f"train_chunk: missing feed {missing[0]!r}")
        mesh = self._data_mesh

        def local(stack, sharded=True):  # this rank's slice of a [K, B_global, ...] stack
            return stack if mesh is None or not sharded else stack[:, mesh.batch_slice(stack.shape[1])]

        entries = [(iop.name, local(stacked_feeds[iop.name], iop.name in self._ctx.batch_ops),
                    iop.outputs[0].dtype.to_torch()) for iop in fed]
        entries += [("_labels", local(stacked_labels), torch.float32)]
        entries += [(key, stacked_feeds[key], torch.int32) for key in keys]
        entries += [("_scalars", self._scalar_table(self._step_count + 1, k), torch.float32)]
        if self._stochastic:  # each step's count before the step: the eager steps' keys
            entries += [("_step", np.arange(self._step_count, self._step_count + k, dtype=np.int64),
                         torch.int64)]
        plan = _StepGraph.plan(entries, k)
        graph = self._step_graph
        if graph is None or graph.layout != plan:
            self._step_graph = None  # frees the old graph's memory first
            graph = self._step_graph = _StepGraph(self.device, plan, route_ops if keys else [],
                                                  {n: c for n, c in self._constants.items()
                                                   if n not in stacked_feeds})
        with span("train_chunk:stage"):
            stacks = graph.stage(entries, k)
        done = 0
        try:
            with span("train_chunk:replay"):
                for i in range(k):
                    with span("train_chunk:stage"):
                        graph.static.copy_(stacks[i])
                    if graph.graph is None:
                        with span("train_chunk:capture"):
                            loss = graph.warm_up(self)
                            done += 1
                            graph.capture(self)
                    else:
                        graph.graph.replay()
                        add_counts(graph.counts)
                        loss = graph.loss
                        done += 1
        finally:
            self._advance(done)
        return loss.clone()

    def calibrate_step_residual(self, feeds, labels, steps: int = 8, machine=None, cache_path: str = ""):
        """The measured step against the cost model's, over the whole step
        (the JAX package's `calibrate_step_residual`, :1807-1890): `steps`
        copies of one batch, staged on the device beforehand, go through
        `train_chunk` twice (the first builds and captures the step on
        CUDA), and the second is timed (CUDA events on CUDA, perf_counter
        on the CPU). The model is left as it was: its parameters, optimizer
        state, metric totals and step count are copied before and written
        back in place after (so a captured step stays valid). The
        prediction is `autotune_plan_joint`'s at budget 1 on `machine`
        (default: the machine file at `cache_path` or
        config.machine_cache_path(), else the "h100" preset on CUDA and
        "cpu_sim" on the CPU; one card). Stores measured / predicted as the
        machine's `step_residual` and saves the machine to the cache path.
        Returns (residual, measured_us, predicted_us)."""
        import os

        from ..autotune.machine import MachineSpec, preset
        from ..autotune.search import autotune_plan_joint
        from ..tools.state import state_tensors

        self._require_trainable()
        if self._host_tail is not None:
            raise RuntimeError(_HOST_TAIL_CHUNK)
        if machine is None:
            cache_path = cache_path or self.config.machine_cache_path()
            machine = (MachineSpec.from_file(cache_path) if os.path.exists(cache_path)
                       else preset("h100" if self.device.type == "cuda" else "cpu_sim"))
            machine = machine.torus_for(1)
        labels = np.asarray(labels)
        stacked = {}
        for iop in self.graph.inputs:
            if iop.name in feeds:
                v = np.asarray(feeds[iop.name])
                stacked[iop.name] = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(v, (steps,) + v.shape)),
                                                    dtype=iop.outputs[0].dtype.to_torch()).to(self.device)
        slabels = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(labels, (steps,) + labels.shape)),
                                  dtype=torch.float32).to(self.device)
        state = list(state_tensors(self).values())
        saved = [t.clone() for t in state]
        step_count = self._step_count
        try:
            self.train_chunk(stacked, slabels)
            if self.device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                self.train_chunk(stacked, slabels)
                end.record()
                torch.cuda.synchronize(self.device)
                measured_us = start.elapsed_time(end) * 1e3 / steps
            else:
                t0 = time.perf_counter()
                self.train_chunk(stacked, slabels)
                measured_us = (time.perf_counter() - t0) * 1e6 / steps
        finally:
            with torch.no_grad():
                for t, v in zip(state, saved):
                    t.copy_(v)
            self._advance(step_count - self._step_count)
        half = self.config.compute_dtype in ("bfloat16", "float16")
        _, pred_us, _ = autotune_plan_joint(
            self.graph, machine, self.config.batch_size, budget=1, min_vocab=self.config.onehot_embedding_threshold,
            exchange_dtype_bytes=2.0 if half else 4.0,
            table_dtype_bytes=2.0 if self.config.table_dtype == "bfloat16" else 4.0)
        residual = measured_us / max(pred_us, 1e-9)
        machine.step_residual = residual
        if cache_path:
            machine.save(cache_path)
        return residual, measured_us, pred_us

    # ------------------------------------------------------------------ host routing
    def compute_routes(self, feeds: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """The sorted update stream of each row-update-route table, computed
        on the host from the batch's indices (JAX package: `compute_routes`,
        ffmodel.py:1924-1946, and `host_pack_routes`, packed_update.py:
        1241-1269). Rows are keyed as `sort_rows` keys them (outside [0, V)
        -> V) and sorted stably by native/ffdata's radix sort, one thread a
        table; every dropped entry comes last. Returns numpy arrays under
        `_route:<op>:order` ([K] int32, the stable order: the JAX package's
        `order` and torch.sort(stable=True)'s) and `_route:<op>:rows` (the
        sorted keys, [K] int32), which the port's [V, D] kernel reads in
        place of the JAX package's pack fields (`enc`, `starts`).

        A device tensor among the index feeds is copied to the host first,
        which waits for the device. Each call is one `routes` span."""
        with span("routes"):
            return self._compute_routes(feeds)

    def _compute_routes(self, feeds: Dict[str, Any]) -> Dict[str, np.ndarray]:
        self._require_compiled()
        by_k: Dict[int, List] = {}
        for op in self._sparse_ops:
            if op.kernel_route:
                idx = feeds[op.inputs[0].owner_op.name]
                if isinstance(idx, torch.Tensor):
                    idx = idx.cpu().numpy()
                rows = np.asarray(idx, np.int64).reshape(-1)
                by_k.setdefault(rows.shape[0], []).append((op, rows))
        out: Dict[str, np.ndarray] = {}
        for k, group in by_k.items():
            keys = np.empty((len(group), k), np.int64)
            for i, (op, rows) in enumerate(group):
                # one pass: as unsigned, a row < 0 is above V too
                np.minimum(rows.view(np.uint64), np.uint64(op.num_entries), out=keys[i].view(np.uint64))
            order = native_batcher.argsort_i64_batch(keys)
            for i, (op, _) in enumerate(group):
                rows_sorted = np.empty(k, np.int32)
                np.take(keys[i], order[i], out=rows_sorted, mode="clip")
                out[f"_route:{op.name}:order"] = order[i]
                out[f"_route:{op.name}:rows"] = rows_sorted
        return out

    def stage_routes(self, routes: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Route arrays (`compute_routes`' output) as int32 tensors on the
        model's device. Host arrays go in one copy: on CUDA from pinned
        memory, without waiting (PyTorch's pinned-memory allocator keeps the
        buffer until the copy has run on the stream). Tensors already on the
        device pass through."""
        out = {k: v for k, v in routes.items()
               if isinstance(v, torch.Tensor) and self._on_device(v) and v.dtype == torch.int32}
        host = {k: np.ascontiguousarray(torch.as_tensor(v).cpu().numpy(), np.int32).reshape(-1)
                for k, v in routes.items() if k not in out}
        if host:
            flat = torch.from_numpy(np.concatenate(list(host.values())))
            if self.device.type == "cuda":
                flat = flat.pin_memory().to(self.device, non_blocking=True)
            out.update(zip(host, torch.split(flat, [a.size for a in host.values()])))
        return out

    def _on_device(self, t: torch.Tensor) -> bool:
        """Whether t lies on the model's device ("cuda" is the current card)."""
        dev = self.device
        if t.device.type != dev.type:
            return False
        if dev.type != "cuda" or t.device.index == dev.index:
            return True
        return dev.index is None and t.device.index == torch.cuda.current_device()

    def _routes_for(self, feeds: Dict[str, Any], route_ops) -> Dict[str, tuple]:
        """{op name: (rows_sorted, order)} on the device for this batch: the
        feeds' own `_route:` keys where all are there, else computed."""
        keys = [f"_route:{op.name}:{f}" for op in route_ops for f in ROUTE_FIELDS]
        given = {k: feeds[k] for k in keys if k in feeds}
        staged = self.stage_routes(given if len(given) == len(keys) else self.compute_routes(feeds))
        return {op.name: tuple(staged[f"_route:{op.name}:{f}"] for f in ROUTE_FIELDS)
                for op in route_ops}

    # ------------------------------------------------------------------ eval
    def eval_batch(self, feeds: Dict[str, Any], labels) -> torch.Tensor:
        """Forward, loss and metrics of one batch; returns the loss."""
        self._require_compiled()
        labels = self._stage_labels(labels)
        feeds = self._host_tail_feeds(feeds, train=False)
        with torch.no_grad():
            (logits,) = self.graph.execute(
                self._params, self._stage(feeds), self._ctx, fetch=[self._out_spec]
            )
            return self._loss_and_metrics(logits, labels)[1]

    def reset_metrics(self) -> None:
        """reference: FFModel::reset_metrics (model.h:508). Zeroes the
        totals in place (a captured step adds into them)."""
        fresh = metrics_lib.zero_perf_metrics(
            bool(self.metrics_mask & MetricsType.METRICS_AUC_ROC), self.device
        )
        if self._metrics_total.keys() == fresh.keys():
            for v in self._metrics_total.values():
                v.zero_()
        else:
            self._metrics_total = fresh

    def get_metrics(self) -> Dict[str, float]:
        """reference: FFModel::get_metrics (model.h:513) + PerfMetrics print."""
        return metrics_lib.summarize(self._metrics_total, self.metrics_mask)

    # ------------------------------------------------------------------ loops
    def fit(
        self,
        feeds: Dict[str, np.ndarray],
        labels: np.ndarray,
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        verbose: bool = True,
        callbacks: Sequence = (),
        steps_per_call: int = 1,
        shuffle: bool = False,
        validation_data=None,
    ) -> Dict[str, float]:
        """Keras-style loop (reference: base_model.py:195-424), with the JAX
        package's history keys: the metrics, `epoch_time_s`, `throughput`,
        `first_epoch_time_s` and `val_*`. `steps_per_call` K > 1 runs each
        epoch as `train_chunk` calls on the loader's [K, B, ...] stacks
        (`stacked_epoch`; the tail of an epoch is a shorter stack), as the
        JAX package does; K = 1 steps one batch per `train_batch` call."""
        self._require_trainable()
        epochs = epochs or self.config.epochs
        bs = batch_size or self.config.batch_size
        loader = DataLoader(feeds, labels, bs, shuffle=shuffle, seed=self.config.seed)
        steps = loader.steps_per_epoch
        print_every = max(self.config.print_freq, 1)
        history: Dict[str, float] = {}
        warm_time = None
        for cb in callbacks:
            cb.on_train_begin(self)
        if self.config.profiling and self.mesh is None:
            # the reference's per-op "[Linear] forward time = ..." lines (the
            # JAX package's :1575-1580), on the first batch
            from ..utils.profiling import op_timing_report, print_op_timings

            first, _ = next(iter(loader.epoch()))
            print_op_timings(op_timing_report(self, first, reps=3, warmup=1))
        stop = False
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(self, epoch)
            self.reset_metrics()
            t0 = time.time()
            if steps_per_call > 1:
                i = 0
                for sfeeds, slabels in loader.stacked_epoch(steps_per_call):
                    loss = self.train_chunk(sfeeds, slabels)
                    i += slabels.shape[0]
                    if verbose and (i // steps_per_call) % print_every == 0:
                        msg = " ".join(f"{k}={v:.6g}" for k, v in self.get_metrics().items())
                        print(f"epoch {epoch} step {i}/{steps} loss={float(loss):.6g} {msg}")
            else:
                for i, (batch, lbl) in enumerate(loader.epoch()):
                    loss = self.train_batch(batch, lbl)
                    if verbose and i % print_every == 0:
                        msg = " ".join(f"{k}={v:.6g}" for k, v in self.get_metrics().items())
                        print(f"epoch {epoch} step {i}/{steps} loss={float(loss):.6g} {msg}")
            int(self._metrics_total["train_all"])  # waits for the device
            dt = time.time() - t0
            if epoch == 0:
                warm_time = dt
            history = self.get_metrics()
            history["epoch_time_s"] = dt
            history["throughput"] = steps * bs / dt
            if validation_data is not None:
                vx, vy = validation_data
                if vy.shape[0] < bs:
                    raise ValueError(f"validation set ({vy.shape[0]}) smaller than one batch ({bs})")
                train_totals = {k: v.clone() for k, v in self._metrics_total.items()}
                val = self.evaluate(vx, vy, batch_size=bs)
                for k, v in train_totals.items():
                    self._metrics_total[k].copy_(v)
                history.update({f"val_{k}": v for k, v in val.items()})
            if verbose:
                print(f"epoch {epoch} done in {dt:.2f}s "
                      f"throughput={history['throughput']:.1f} samples/s")
            for cb in callbacks:
                stop = cb.on_epoch_end(self, epoch, history) or stop
            if stop:
                break
        if warm_time is not None:
            history["first_epoch_time_s"] = warm_time
        for cb in callbacks:
            cb.on_train_end(self, history)
        return history

    def evaluate(
        self,
        feeds: Dict[str, np.ndarray],
        labels: np.ndarray,
        batch_size: Optional[int] = None,
    ) -> Dict[str, float]:
        self._require_compiled()
        bs = batch_size or self.config.batch_size
        n = labels.shape[0]
        steps = n // bs
        if steps <= 0:
            raise ValueError(f"evaluate: dataset ({n}) smaller than one batch ({bs})")
        self.reset_metrics()
        for i in range(steps):
            sl = slice(i * bs, (i + 1) * bs)
            self.eval_batch({k: v[sl] for k, v in feeds.items()}, labels[sl])
        return self.get_metrics()

    def _sparse_rate(self, dstate: dict, scalars: torch.Tensor):
        """The rate of this step's row updates (JAX package :960-977), a 0-d
        tensor on the device: the dense state's rate, unless a distinct
        sparse optimizer keeps its own (made at compile); for sparse Adam,
        that base times the bias correction of this step (the dense state's
        step count after the dense update), read from this step's
        `scalars`. None only for a distinct sparse optimizer of a custom
        class with no `lr` of its own (its rule keeps its rate)."""
        sopt = self.sparse_optimizer
        if sopt is self.optimizer:
            lr, own = dstate["lr"], scalars[: self._n_dense_scalars]
        else:
            lr, own = self._sparse_base, scalars[self._n_dense_scalars:]
        if isinstance(sopt, AdamOptimizer):
            lr = sopt.alpha_t(lr, own, self.device)
        return lr

    def set_learning_rate(self, lr: float) -> None:
        """reference: Optimizer::set_learning_rate. The rate lives in the
        dense optimizer's state on the device; the next step reads it. The
        embedding rows follow it unless compile was given a distinct
        sparse optimizer, which keeps its own rate."""
        self._require_compiled()
        self._lr_tensor().fill_(float(lr))

    def get_learning_rate(self) -> float:
        self._require_compiled()
        return float(self._lr_tensor())

    def _lr_tensor(self) -> torch.Tensor:
        st = self._opt_state
        return st["dense"]["lr"] if "dense" in st else st["lr"]

    def predict(
        self,
        feeds: Dict[str, np.ndarray],
        batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Serving entry for any number of examples: inputs are cut into
        chunks of the compiled batch size; the last partial chunk is padded
        by repeating its final row, then trimmed. Under a mesh every rank
        is given all the examples, serves its slice of each chunk, and
        returns them all (an all-gather a chunk over the data group).

        Spans (utils/profiling.py): `predict` a call (numbered under a
        profiler), `forward:stage` and `forward:execute` a chunk (`forward`),
        `predict:readback` a chunk's copy to the host; the rest of the
        call's time, `predict`'s self time, is the chunking, padding and
        concatenation (and under a mesh the gather)."""
        with span("predict", numbered=True):
            return self._predict(feeds, batch_size)

    def _predict(self, feeds: Dict[str, np.ndarray], batch_size: Optional[int]) -> np.ndarray:
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
            mesh = self._data_mesh
            if mesh is not None:
                parts = torch.empty((mesh.data_size * y.shape[0],) + tuple(y.shape[1:]),
                                    dtype=y.dtype, device=y.device)
                dist.all_gather_into_tensor(parts, y.contiguous(), group=mesh.data_group())
                y = parts
            with span("predict:readback"):
                outs.append(y[:m].float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------ state IO
    def get_parameters(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return self._params

    def set_parameters(self, params: Dict[str, Dict[str, Any]]) -> None:
        """Set every parameter; `params` has the compiled layout of
        get_parameters() (or of convert.params_from_jax). After
        `quantize_embeddings` this restores the compiled tables (new
        tensors, so any captured train step is dropped) and the model
        trains again, as in the JAX package."""
        self._require_compiled()
        missing = set(self._layout) - set(params)
        extra = set(params) - set(self._layout)
        if missing or extra:
            raise KeyError(f"set_parameters: missing {sorted(missing)}, unknown {sorted(extra)}")
        for op_name, sub in params.items():
            if set(sub) != set(self._layout[op_name]):
                raise KeyError(
                    f"set_parameters: {op_name} has {sorted(sub)}, "
                    f"expected {sorted(self._layout[op_name])}"
                )
        if self._tables_quantized:
            self._params = {
                op: {k: torch.empty(shape, dtype=dt, device=self.device) for k, (shape, dt) in sub.items()}
                for op, sub in self._layout.items()
            }
            self._tables_quantized = False
            self._step_graph = None
        for op_name, sub in params.items():
            self.set_weights(op_name, sub)

    def get_weights(self, op_name: str) -> Dict[str, np.ndarray]:
        """Per-op weight dict as host numpy, in the op's logical shapes. A
        bf16 table comes back widened to f32, which is exact (numpy has no
        bf16 of its own).

        The fused embedding collection: its name gives {"pool": [N, R_pad,
        D]} (the JAX package's layout, unpacked), and the name of a table
        fused into it gives {"weight": [V, D]} in logical row order (the
        layout's `extract_table`). Under a mesh those come from the ranks
        that hold the rows (an all-gather, or a broadcast from each owner),
        so every rank must ask for them alike. So does a column-parallel
        Dense's name: its kernel and bias come whole, gathered over the
        model group."""
        self._require_compiled()
        fused = self._fused_table(op_name)
        if fused is not None:
            params = {"weight": self._table_weight(*fused)}
        elif isinstance(self._op(op_name), EmbeddingCollection):
            params = {"pool": self._global_pool(self._op(op_name))}
        elif op_name in self._model_parallel:
            params = {k: self._gather_model(v) if k in self._model_parallel[op_name] else v
                      for k, v in self._params[op_name].items()}
        else:
            params = self._params[op_name]
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
                for k, v in params.items()}

    def set_weights(self, op_name: str, weights: Dict[str, Any]) -> None:
        """Per-op weight update, in place: each array is rounded to the
        storage dtype of the parameter it sets (bf16 for a bf16 table) and
        keeps its shape. A fused table's name takes {"weight": [V, D]}; the
        collection's "pool" takes this rank's rows, or the global [N, R_pad,
        D] (or the JAX package's packed [N, P, 128]), of which each rank
        keeps its own (no collective: every rank is given the same
        arrays); so does a column-parallel Dense's kernel and bias, whole
        ([out, in] and [out]) or this rank's row block."""
        self._require_compiled()
        fused = self._fused_table(op_name)
        if fused is not None:
            self._set_table(*fused, weights)
            return
        cur = self._params[op_name]
        arrs = {}
        for k, w in weights.items():
            if k not in cur:
                raise KeyError(f"{op_name} has no parameter {k!r}")
            arrs[k] = w if isinstance(w, torch.Tensor) else to_torch(np.asarray(w))
            if k == "pool" and tuple(arrs[k].shape) != tuple(cur[k].shape):
                arrs[k] = self._local_pool(self._op(op_name), arrs[k])
            if k in self._model_parallel.get(op_name, ()) and tuple(arrs[k].shape) != tuple(cur[k].shape):
                arrs[k] = row_block(arrs[k], self.mesh.model_size, self.mesh.model_index)
            if tuple(arrs[k].shape) != tuple(cur[k].shape):
                raise ValueError(
                    f"{op_name}/{k}: shape {tuple(arrs[k].shape)} != {tuple(cur[k].shape)}"
                )
        with torch.no_grad():
            for k, arr in arrs.items():
                cur[k].copy_(arr)

    def _op(self, op_name: str):
        return next((op for op in self.graph.compute_ops if op.name == op_name), None)

    def _fused_table(self, name: str):
        """(collection, table id) of a table fused into the collection."""
        for op in self.graph.compute_ops:
            if isinstance(op, EmbeddingCollection) and name in op.table_names:
                return op, op.table_names.index(name)
        return None

    def _table_weight(self, coll: EmbeddingCollection, t: int) -> torch.Tensor:
        """Fused table t as [V, D] in logical row order, on this device;
        under a data axis > 1 each owner broadcasts its rows of it."""
        lay = coll.layout
        pool = self._params[coll.name]["pool"]
        if not coll.sharded:
            return lay.extract_table(pool, t)
        pieces = []  # (position start, rows)
        for shard in coll.owners(t):
            mine = coll.shard_rows(t, shard)
            if shard == coll.shard:
                buf = torch.cat([pool[off:off + length] for _, length, off in mine])
            else:
                buf = torch.empty((sum(length for _, length, _ in mine), lay.dim), dtype=pool.dtype,
                                  device=pool.device)
            dist.broadcast(buf, src=self.mesh.data_peer(shard), group=self.mesh.data_group())
            pieces += list(zip([start for start, _, _ in mine],
                               torch.split(buf, [length for _, length, _ in mine])))
        full = torch.cat([rows for _, rows in sorted(pieces, key=lambda p: p[0])])
        return full[torch.as_tensor(lay.perm_table_np(t), device=full.device)] if lay.hash_rows else full

    @torch.no_grad()
    def _set_table(self, coll: EmbeddingCollection, t: int, weights: Dict[str, Any]) -> None:
        """Fused table t's rows held here set from weights["weight"] ([V,
        D], logical row order), in place."""
        lay = coll.layout
        if set(weights) != {"weight"}:
            raise KeyError(f"{coll.table_names[t]} (fused into {coll.name}) takes 'weight' only")
        w = weights["weight"]
        w = (w if isinstance(w, torch.Tensor) else to_torch(np.asarray(w))).to(self.device)
        if tuple(w.shape) != (lay.vocab_sizes[t], lay.dim):
            raise ValueError(f"{coll.table_names[t]}/weight: shape {tuple(w.shape)} != "
                             f"{(lay.vocab_sizes[t], lay.dim)}")
        pool = self._params[coll.name]["pool"]
        for i, (tt, start, length) in enumerate(lay.subs):
            if tt == t and coll.shard in (None, lay.owner[i]):
                off = (0 if coll.sharded else lay.owner[i] * lay.r_pad) + int(lay.row_offset[i])
                rows = torch.as_tensor(lay._inv_positions(t, start, length), device=w.device)
                pool[off:off + length] = w[rows].to(pool.dtype)

    def _global_pool(self, coll: EmbeddingCollection) -> torch.Tensor:
        """[N, R_pad, D]: every shard's pool (an all-gather under a data
        axis > 1)."""
        lay = coll.layout
        pool = self._params[coll.name]["pool"]
        if coll.sharded:
            out = torch.empty((lay.num_shards * lay.r_pad, lay.dim), dtype=pool.dtype, device=pool.device)
            dist.all_gather_into_tensor(out, pool.contiguous(), group=self.mesh.data_group())
            pool = out
        return pool.reshape(lay.num_shards, lay.r_pad, lay.dim)

    def _gather_model(self, t: torch.Tensor) -> torch.Tensor:
        """A column-parallel parameter's row blocks gathered over the model
        group: the whole tensor."""
        mesh = self.mesh
        out = t.new_empty((mesh.model_size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.detach().contiguous(), group=mesh.model_group())
        return out

    @staticmethod
    def _local_pool(coll: EmbeddingCollection, arr: torch.Tensor) -> torch.Tensor:
        """The rows held here of a global pool [N, R_pad, D] or [N, P, 128]."""
        lay = coll.layout
        if arr.numel() != lay.num_shards * lay.r_pad * lay.dim:
            raise ValueError(f"{coll.name}/pool: shape {tuple(arr.shape)} holds no [N={lay.num_shards}, "
                             f"R_pad={lay.r_pad}, D={lay.dim}] pool")
        arr = arr.reshape(lay.num_shards, lay.r_pad, lay.dim)
        return arr[coll.shard] if coll.sharded else arr.reshape(-1, lay.dim)

    # ------------------------------------------------------------------ serving
    def quantize_embeddings(self, dtype: str = "bfloat16") -> int:
        """Serving-side table quantization (the JAX package's
        `quantize_embeddings`, core/ffmodel.py:1690-1757): "bfloat16" and
        "float16" cast every f32 array of each embedding op; "int8" replaces
        each op's `weight` by `weight_q` ([V, D] int8) and `weight_scale`
        ([V] f32, per row), which the lookup dequantizes
        (`ops/embedding.quantized_embedding_bag`) under every use_pallas; a
        fused collection at a data axis of 1 has its flat pool replaced by
        `pool_q` and `pool_scale` the same way (ValueError for a sharded
        one, as in the JAX package).
        Training refuses afterwards (RuntimeError) until compile or
        set_parameters restores the tables. Returns the number of arrays
        touched."""
        self._require_compiled()
        if dtype not in QUANTIZED_DTYPES:
            raise ValueError(f"quantize_embeddings takes {sorted(QUANTIZED_DTYPES)}, got {dtype!r}")
        coll = next((op for op in self.graph.compute_ops if isinstance(op, EmbeddingCollection)), None)
        if dtype == "int8" and coll is not None and coll.sharded:
            raise ValueError("int8 serving of a sharded embedding collection is not supported (as in "
                             "the JAX package); quantize a one-device model instead")
        self._step_graph = None
        n = 0
        with torch.no_grad():
            for op in self.graph.compute_ops:
                if op.op_type is not OperatorType.OP_EMBEDDING:
                    continue
                sub = self._params.get(op.name, {})
                if dtype == "int8":
                    # a fused collection (at a data axis of 1) quantizes its
                    # flat [N * R_pad, D] pool, as the JAX package does
                    key = "pool" if isinstance(op, EmbeddingCollection) else "weight"
                    if key not in sub:
                        continue
                    sub[f"{key}_q"], sub[f"{key}_scale"] = quantize_table_int8(sub.pop(key))
                    n += 1
                    continue
                for k, v in list(sub.items()):
                    if v.dtype == torch.float32:
                        sub[k] = v.to(QUANTIZED_DTYPES[dtype])
                        n += 1
        self._tables_quantized = self._tables_quantized or n > 0
        return n


class _StepGraph:
    """One train step captured in a CUDA graph, with its static buffer: the
    step's feeds, labels, routes and scalars packed into one byte buffer
    (`static`), each a view of its own 16-byte-aligned slice. `layout` is
    the plan the buffer was cut by; a stack of another shape, dtype or
    route set makes a new graph."""

    def __init__(self, device: torch.device, layout, route_ops, constants=None):
        self.layout = layout
        self.constants = constants or {}  # the model's constant inputs, fed as they lie
        _, off, shape, dt = layout[-1]
        self.static = torch.empty(off + _aligned(_nbytes(shape, dt)), dtype=torch.uint8, device=device)
        self.views = {key: _view(self.static, off, shape, dt) for key, off, shape, dt in layout}
        self.route_ops = route_ops
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.loss: Optional[torch.Tensor] = None
        self.counts: Dict[str, int] = {}

    @staticmethod
    def plan(entries, k: int) -> tuple:
        """((key, byte offset, shape of one step, dtype), ...) of the
        entries (key, [k, ...] stack, dtype)."""
        out, off = [], 0
        for key, stack, dt in entries:
            if int(stack.shape[0]) != k:
                raise ValueError(f"train_chunk: {key} stacks {stack.shape[0]} steps, the labels {k}")
            shape = tuple(int(d) for d in stack.shape[1:])
            out.append((key, off, shape, dt))
            off += _aligned(_nbytes(shape, dt))
        return tuple(out)

    def stage(self, entries, k: int) -> torch.Tensor:
        """The stacks as one [k, bytes] device buffer, row i the static
        buffer's bytes of step i: host arrays go over in one pinned,
        non-blocking copy each; tensors on the device are copied there."""
        dev = self.static.device
        stacks = torch.empty((k, self.static.numel()), dtype=torch.uint8, device=dev)
        for (key, stack, dt), (_, off, shape, _) in zip(entries, self.layout):
            t = torch.as_tensor(stack)
            if t.device != dev:
                t = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t.to(dev)
            n = _nbytes(shape, dt)
            if n:
                stacks[:, off:off + n].view(dt).copy_(t.reshape(k, -1))
        return stacks

    def warm_up(self, model: "FFModel") -> torch.Tensor:
        """One real step on the static buffer, eagerly on a side stream
        (PyTorch's capture protocol): kernels build and lazy set-up runs
        here, outside capture. Returns its loss."""
        dev = self.static.device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss, _ = model._step(*self._args(), step=self.views.get("_step"), timed=False)
        current.wait_stream(side)
        loss.record_stream(current)
        return loss

    def capture(self, model: "FFModel") -> None:
        """Capture one step (recorded, not run); its loss lands in
        `self.loss` at each replay. The graph's nodes stay readable
        (`keep_graph`; tools/graph_nodes.py counts them)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # thread_local: under a mesh the process group's watchdog thread
        # queries its work's events during the capture, which the default
        # global mode refuses; one mode on every device count
        with capturing() as counts, torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.loss, _ = model._step(*self._args(), step=self.views.get("_step"))
        self.counts = counts  # the step's counters, added at each replay
        graph.instantiate()
        self.graph = graph

    def _args(self) -> tuple:
        v = self.views
        feeds = {**self.constants, **{key: t for key, t in v.items() if not key.startswith("_")}}
        routes = ({op.name: tuple(v[f"_route:{op.name}:{f}"] for f in ROUTE_FIELDS)
                   for op in self.route_ops} or None)
        return feeds, v["_labels"], routes, v["_scalars"]


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _view(buf: torch.Tensor, off: int, shape, dtype) -> torch.Tensor:
    return buf[off:off + _nbytes(shape, dtype)].view(dtype).view(shape)


def _all_reduce_flat(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum `tensors` over the ranks of `group` (None: the world) in one
    all-reduce of an f32 bucket (one collective a step however many
    tensors), in place; returns them."""
    return _in_bucket(tensors, lambda flat: dist.all_reduce(flat, group=group))


def _broadcast_flat(tensors: List[torch.Tensor], src: int, group) -> List[torch.Tensor]:
    """`tensors` of world rank `src` on every rank of `group`, in one
    broadcast of an f32 bucket, in place; returns them."""
    return _in_bucket(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


def _in_bucket(tensors: List[torch.Tensor], collective) -> List[torch.Tensor]:
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    collective(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tensors
