"""Plain DLRM-DCNv2 in PyTorch: forward, binary cross-entropy, backward, SGD.

MLPerf Training's recommendation model (mlcommons/training
`recommendation_v2/torchrec_dlrm`, TorchRec's `DLRM_DCN`), written from a
configuration file's sizes: a bottom MLP over the dense features (ReLU after
every layer); one sum-pooled bag a table, each table with its own bag size
(`embedding_bag_size`, a list); x0 = [bottom output, pooled rows], the dense
part first, (tables + 1) x D wide; `dcn_num_layers` low-rank cross layers
(DCN-V2, Wang et al., arXiv:2008.13535, as TorchRec's `LowRankCrossNet`
computes them)

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l,

V_l [r, d] with no bias, W_l [d, r] with a bias, r = `dcn_low_rank_dim`;
a top MLP over x_L with ReLU and a sigmoid after its last layer; the mean
binary cross-entropy of that probability (clamped to [1e-7, 1 - 1e-7]).

Parameters are kept in the dtypes the configuration states: every kernel
and bias in float32; a table with more rows than
`onehot_embedding_threshold` in `table_dtype`, every other one in float32.
Only the gathered rows are widened, bag position by bag position, so no
[B, bag, D] block is made. Arithmetic is float32 with TF32 off
(`dlrm.plain_matmuls`). SGD updates a table row as its storage dtype holds
it: the f32 sum of its lookups' gradients times the rate, subtracted in f32
and rounded once into the storage dtype.

`compute` ("float32", or the control "float8": every product's operands
scaled per tensor to float8 e4m3 and rounded, a small table rounded whole
as a one-hot product's operand) and `fault` ("half_batch", "frozen",
"frozen_rows", "no_exchange_<n>") are those of `reference/dlrm.py`, whose
helpers this module uses.

Departures from TorchRec's `DLRM_DCN` and MLPerf's run: SGD in place of
Adagrad (the check reads a leaf's first gradient from an SGD step);
parameters drawn uniform from the seed (`benchmark/weights.py`: kernels and
tables Glorot, each bias in +-1/sqrt(fan_in)) in place of TorchRec's
initializers (xavier-normal cross kernels, zero cross biases); the sigmoid
inside the model with a clamped BCE in place of BCE on logits; large tables
stored in bfloat16 where the published run keeps float32.

No import of the program under test: this module is the yardstick.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

# plain_matmuls is read here by the training runner
from .dlrm import Leaf, _Linear, _mlp, bce, lower, plain_matmuls, table_dtype, tables  # noqa: F401


def width(cfg: dict) -> int:
    """x0's width: the bottom output and one pooled row a table."""
    return (len(tables(cfg)) + 1) * cfg["sparse_feature_size"]


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter, in a fixed order: the bottom MLP's kernels and
    biases, the tables, the cross layers' (op "cross": `v_kernel_<l>`,
    `w_kernel_<l>`, `bias_<l>`), the top MLP's. Kernels and tables are
    Glorot-uniform over their two dimensions; a bias is uniform in
    +-1/sqrt(fan_in)."""
    out: List[Leaf] = []

    def mlp(prefix: str, widths: Sequence[int]) -> None:
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            out.append(Leaf(f"{prefix}_{i}", "kernel", (n_out, n_in), "float32",
                            math.sqrt(6.0 / (n_in + n_out))))
            out.append(Leaf(f"{prefix}_{i}", "bias", (n_out,), "float32", 1.0 / math.sqrt(n_in)))

    d, w, r = cfg["sparse_feature_size"], width(cfg), cfg["dcn_low_rank_dim"]
    mlp("bot_mlp", cfg["mlp_bot"])
    for i, v in enumerate(tables(cfg)):
        out.append(Leaf(f"table_{i}", "weight", (v, d), table_dtype(cfg, v), math.sqrt(6.0 / (v + d))))
    glorot = math.sqrt(6.0 / (w + r))
    for layer in range(cfg["dcn_num_layers"]):
        out.append(Leaf("cross", f"v_kernel_{layer}", (r, w), "float32", glorot))
        out.append(Leaf("cross", f"w_kernel_{layer}", (w, r), "float32", glorot))
        out.append(Leaf("cross", f"bias_{layer}", (w,), "float32", 1.0 / math.sqrt(r)))
    mlp("top_mlp", cfg["mlp_top"])
    return out


def cross(cfg: dict, p: Dict[Tuple[str, str], torch.Tensor], x0: torch.Tensor, compute: str) -> torch.Tensor:
    x = x0
    for layer in range(cfg["dcn_num_layers"]):
        v = _Linear.apply(x, p[("cross", f"v_kernel_{layer}")], compute)
        y = _Linear.apply(v, p[("cross", f"w_kernel_{layer}")], compute) + p[("cross", f"bias_{layer}")]
        x = x0 * y + x
    return x


def forward(cfg: dict, p: Dict[Tuple[str, str], torch.Tensor], dense: torch.Tensor,
            emb: List[torch.Tensor], compute: str = "float32") -> torch.Tensor:
    """The click probability [B, 1] from dense features [B, 13] and the
    pooled embeddings (one [B, D] a table, as `lookup` gives them)."""
    bot, top = cfg["mlp_bot"], cfg["mlp_top"]
    x = _mlp(dense.float(), p, "bot_mlp", len(bot) - 1, -1, compute)
    z = cross(cfg, p, torch.cat([x] + emb, dim=1), compute)
    return _mlp(z, p, "top_mlp", len(top) - 1, len(top) - 2, compute)


def lookup(cfg: dict, table: torch.Tensor, idx: torch.Tensor, compute: str) -> torch.Tensor:
    """The bag sum of rows idx [B, bag] of one table, in float32, added in
    bag order. A small table's rows are a one-hot product's operands, so
    the table is rounded to the compute precision first; a large table's
    rows are read exactly as stored."""
    if table.shape[0] <= cfg["onehot_embedding_threshold"]:
        table = lower(table, compute)
    idx = idx.long()
    out = table[idx[:, 0]].float()
    for j in range(1, idx.shape[1]):
        out = out + table[idx[:, j]].float()
    return out


def sgd_step(cfg: dict, p: Dict[Tuple[str, str], torch.Tensor], dense: torch.Tensor,
             sparse: List[torch.Tensor], labels: torch.Tensor, lr: float, compute: str = "float32",
             fault: str = "", grad_norms: Dict[str, float] = None) -> float:
    """One training step on one batch, the parameters updated in place;
    returns the loss. Each pooled row is a leaf of the backward; a table's
    gradient stays sparse: each touched row gets the f32 sum of the pooled
    gradients of the bags that hold it, once an occurrence. `grad_norms`,
    if given, is filled with each leaf's gradient norm ("op/key"), as
    computed, before any storage rounds the step."""
    n_tab = len(tables(cfg))
    dense_keys = [k for k in p if not k[0].startswith("table_")]
    leaves_d = {k: p[k].detach().float().requires_grad_(True) for k in dense_keys}
    with torch.no_grad():
        pooled = [lookup(cfg, p[(f"table_{i}", "weight")], sparse[i], compute) for i in range(n_tab)]
    emb = [e.requires_grad_(True) for e in pooled]
    prob = forward(cfg, leaves_d, dense, emb, compute)
    if fault == "half_batch":
        half = prob.shape[0] // 2
        loss = bce(prob[:half], labels[:half])
    elif fault.startswith("no_exchange_"):
        n = int(fault.rsplit("_", 1)[1])
        part = prob.shape[0] // n
        loss = bce(prob[:part], labels[:part]) / n
    else:
        loss = bce(prob, labels)
    grads = torch.autograd.grad(loss, [leaves_d[k] for k in dense_keys] + emb)
    del prob, emb, pooled
    with torch.no_grad():
        rows_sum = []
        for i, g in enumerate(grads[len(dense_keys):]):
            w, idx = p[(f"table_{i}", "weight")], sparse[i].long()
            uniq, inv = torch.unique(idx.reshape(-1), return_inverse=True)
            inv = inv.reshape(idx.shape)
            acc = torch.zeros((uniq.shape[0], w.shape[1]), dtype=torch.float32, device=w.device)
            for j in range(idx.shape[1]):
                acc.index_add_(0, inv[:, j], g.float())
            rows_sum.append((uniq, acc))
        if grad_norms is not None:
            for k, g in zip(dense_keys, grads[:len(dense_keys)]):
                grad_norms[f"{k[0]}/{k[1]}"] = float(torch.linalg.vector_norm(g))
            for i, (_, acc) in enumerate(rows_sum):
                grad_norms[f"table_{i}/weight"] = float(torch.linalg.vector_norm(acc))
        if fault == "frozen":
            return float(loss.detach())
        for k, g in zip(dense_keys, grads[:len(dense_keys)]):
            p[k].sub_(lr * g)
        for i, (uniq, acc) in enumerate(rows_sum):
            w = p[(f"table_{i}", "weight")]
            if fault == "frozen_rows" and w.shape[0] > cfg["onehot_embedding_threshold"]:
                continue
            w[uniq] = (w[uniq].float() - lr * acc).to(w.dtype)
    return float(loss.detach())
