"""Host-offloaded embedding tables: whole tables in host memory.

The port's counterpart of `dlrm_flexflow_tpu/training/host_offload.py`:
tables above a vocab threshold live in host RAM as numpy arrays, the
whole-table host placement (the host-tail offload of parallel/host_tail.py
keeps a hot prefix on the device instead):

  forward : the host gathers and pools each offloaded table's rows (the
            port's ffdata binding, `data/native_batcher.gather_batch`) and
            feeds the device a dense [B, D] input
  backward: the train step also returns d(loss)/d(that input), from
            autograd on the staged input as a leaf that requires grad; the
            host applies the SGD row update with the duplicate-safe native
            scatter-add (`scatter_add_f32`) at the device's current rate
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import FFConfig
from ..core.ffmodel import FFModel
from ..data.loader import DataLoader
from ..data.native_batcher import gather_batch, scatter_add_f32
from ..ffconst import AggrMode, DataType, LossType, MetricsType
from ..models.dlrm import DLRMConfig, create_mlp, interact_features
from ..training.optimizer import SGDOptimizer


class HostEmbeddingTable:
    """A [vocab, D] f32 table in host RAM with the native threaded lookup
    and SGD scatter update. SUM pooling over the bag (idx < 0 is padding).
    Rows are drawn as the JAX package draws them (numpy's generator from
    `seed`, in chunks of 2^24 values), so a table is the same in both."""

    def __init__(self, vocab: int, dim: int, seed: int = 0, scale: Optional[float] = None):
        rng = np.random.default_rng(seed)
        scale = np.float32(scale if scale is not None else 1.0 / np.sqrt(dim))
        self.table = np.empty((vocab, dim), np.float32)
        chunk = max(1, (1 << 24) // dim)
        for lo in range(0, vocab, chunk):
            hi = min(lo + chunk, vocab)
            block = rng.random((hi - lo, dim), dtype=np.float32)
            self.table[lo:hi] = (block * 2.0 - 1.0) * scale

    @property
    def vocab(self) -> int:
        return self.table.shape[0]

    @property
    def dim(self) -> int:
        return self.table.shape[1]

    def lookup(self, idx: np.ndarray) -> np.ndarray:
        """idx [B] or [B, H] -> pooled [B, D] f32 (native gather, then sum)."""
        idx = np.asarray(idx)
        if idx.ndim == 1:
            idx = idx[:, None]
        b, h = idx.shape
        flat = idx.reshape(b * h).astype(np.int64)
        (rows,) = gather_batch([self.table], np.where(flat >= 0, flat, 0))
        rows = rows.reshape(b, h, self.dim)
        rows[flat.reshape(b, h) < 0] = 0.0
        return rows.sum(axis=1)

    def apply_pooled_grads(self, idx: np.ndarray, g_pooled: np.ndarray, lr: float) -> None:
        """SGD on the touched rows: every bag member gets the pooled
        gradient (SUM pooling), added by the native duplicate-safe scatter."""
        idx = np.asarray(idx)
        if idx.ndim == 1:
            idx = idx[:, None]
        b, h = idx.shape
        g = np.asarray(g_pooled, np.float32)
        grads = np.broadcast_to(g[:, None, :], (b, h, self.dim)).reshape(b * h, self.dim)
        scatter_add_f32(self.table, idx.reshape(b * h), grads, scale=-lr)


def build_host_offload_dlrm(
    dlrm: DLRMConfig,
    config: Optional[FFConfig] = None,
    offload_threshold: int = 10_000_000,
    device="cuda",
) -> Tuple[FFModel, Dict[str, Tuple[HostEmbeddingTable, str]]]:
    """DLRM whose tables with vocab > offload_threshold live on the host.
    Returns (model, host_map), host_map: dense input name ->
    (HostEmbeddingTable, index feed name). The other tables keep their
    embedding ops on `device`."""
    cfg = config or FFConfig(batch_size=dlrm.batch_size)
    model = FFModel(cfg, device=device)
    bs = dlrm.batch_size
    dense_in = model.create_tensor([bs, dlrm.mlp_bot[0]], name="dense_features")
    x = create_mlp(model, dense_in, dlrm.mlp_bot, dlrm.sigmoid_bot, "bot_mlp")
    host_map: Dict[str, Tuple[HostEmbeddingTable, str]] = {}
    ly: List = []
    for i, (vocab, bag) in enumerate(zip(dlrm.embedding_size, dlrm.bag_sizes())):
        sparse_name = f"sparse_{i}"
        if vocab > offload_threshold:
            name = f"host_emb_{i}"
            ly.append(model.create_tensor([bs, dlrm.sparse_feature_size], name=name))
            host_map[name] = (HostEmbeddingTable(vocab, dlrm.sparse_feature_size, seed=1000 + i),
                              sparse_name)
        else:
            s = model.create_tensor([bs, bag], dtype=DataType.DT_INT64,
                                    name=sparse_name)
            ly.append(model.embedding(s, vocab, dlrm.sparse_feature_size,
                                      aggr=AggrMode.AGGR_MODE_SUM, name=f"emb_{i}"))
    z = interact_features(model, x, ly, dlrm.arch_interaction_op, dlrm.dcn_num_layers, dlrm.dcn_low_rank_dim)
    if z.shape[1] != dlrm.mlp_top[0]:
        raise ValueError(f"the interaction gives {z.shape[1]}, mlp_top starts at {dlrm.mlp_top[0]}")
    create_mlp(model, z, dlrm.mlp_top, dlrm.sigmoid_top, "top_mlp")
    return model, host_map


class HostOffloadTrainer:
    """The train loop around the model's step and the host tables' updates.
    A step: host gather -> device step (one backward, which also gives the
    host inputs' gradients) -> their copy to the host -> host scatter."""

    def __init__(self, model: FFModel, host_map, lr: float = 0.01):
        self.model = model
        self.host_map = host_map
        self.lr = lr

    def compile(self, optimizer=None, loss_type=LossType.LOSS_BINARY_CROSSENTROPY,
                metrics=(MetricsType.METRICS_ACCURACY,)):
        """Compile the model; the host tables step with plain SGD at the
        optimizer's rate (no momentum or Adam state for host rows)."""
        opt = optimizer or SGDOptimizer(lr=self.lr)
        if hasattr(opt, "lr"):
            self.lr = float(opt.lr)
        self.model.compile(opt, loss_type, list(metrics))
        return self

    def train_batch(self, feeds: Dict[str, np.ndarray], labels) -> float:
        m = self.model
        m._require_trainable()
        feeds = dict(feeds)
        for name, (table, sparse_name) in self.host_map.items():
            feeds[name] = table.lookup(feeds[sparse_name])
        scalars = m._step_scalars()
        loss, aux = m._step(m._stage(feeds), m._stage_labels(labels), None, scalars,
                            grad_inputs=tuple(self.host_map))
        m._advance(1)
        lr = self._current_lr()
        for name, (table, sparse_name) in self.host_map.items():
            table.apply_pooled_grads(feeds[sparse_name], aux[name].cpu().numpy(), lr)
        return float(loss)

    def _current_lr(self) -> float:
        """The device state's current rate (set_learning_rate and schedules
        change it after compile)."""
        return self.model.get_learning_rate()

    def fit(self, feeds, labels, epochs: int = 1, verbose: bool = False):
        loader = DataLoader(feeds, labels, self.model.config.batch_size)
        last = None
        for ep in range(epochs):
            self.model.reset_metrics()
            for batch, lbl in loader.epoch():
                last = self.train_batch(batch, lbl)
            if verbose:
                print(f"epoch {ep}: loss={last:.5f} {self.model.get_metrics()}")
        hist = self.model.get_metrics()
        hist["loss"] = last
        return hist
