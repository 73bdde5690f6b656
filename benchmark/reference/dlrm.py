"""Plain DLRM in PyTorch: forward, binary cross-entropy, backward, SGD.

The model of DLRM-FlexFlow's `examples/cpp/DLRM/dlrm.cc` and of the
facebookresearch/dlrm reference, written from a configuration file's sizes:
a bottom MLP over the dense features (ReLU after every layer), one pooled
embedding (bag sum) per table, a feature interaction ("cat": the bottom
output and every embedding side by side; "dot": the pairwise dots of the
strict lower triangle of [bottom, embeddings], row-major, then the bottom
output), a top MLP with ReLU and a sigmoid after its last layer, and the
mean binary cross-entropy of that probability (clamped to [1e-7, 1 - 1e-7]).

Parameters are kept in the dtypes the configuration states: every Dense
kernel and bias in float32; a table with more rows than
`onehot_embedding_threshold` in `table_dtype`, every other one in float32.
Arithmetic is float32 with TF32 off (`plain_matmuls`). SGD updates a table
row as its storage dtype holds it: the f32 sum of its gradients times the
rate, subtracted in f32 and rounded once into the storage dtype.

`compute` lowers the precision of every product's operands, for the
control of the correctness check: "float32" (none) or "float8" (operands
scaled per tensor to float8 e4m3's range, rounded, and scaled back; the
rows of the small tables too). Nothing else changes.
`fault` plants one of the faults the check must catch: "half_batch" (the
loss is the mean over the first half of the batch), "frozen" (a step
leaves every parameter as it was), "frozen_rows" (a step leaves the
tables above `onehot_embedding_threshold` as they were: a row update that
writes nothing) or "no_exchange_<n>" (the gradient that
the first of n cards would have without the sum over the cards: its
block's share of the loss, the mean over the first 1/n of the batch over
n).

No import of the program under test: this module is the yardstick.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

EPS = 1e-7
F8_MAX = 448.0  # the largest finite float8 e4m3fn


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: op name, key, shape, storage dtype, and how it is
    drawn (`bound`: uniform in [-bound, bound])."""

    op: str
    key: str
    shape: Tuple[int, ...]
    dtype: str
    bound: float


def tables(cfg: dict) -> List[int]:
    return list(cfg["vocab_sizes"])


def table_dtype(cfg: dict, vocab: int) -> str:
    return cfg["table_dtype"] if vocab > cfg["onehot_embedding_threshold"] else "float32"


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter, in a fixed order: the bottom MLP's kernels and
    biases, the tables, the top MLP's. Kernels and tables are Glorot-uniform
    over their two dimensions; a bias is uniform in +-1/sqrt(fan_in)."""
    out: List[Leaf] = []

    def mlp(prefix: str, widths: Sequence[int]) -> None:
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            out.append(Leaf(f"{prefix}_{i}", "kernel", (n_out, n_in), "float32",
                            math.sqrt(6.0 / (n_in + n_out))))
            out.append(Leaf(f"{prefix}_{i}", "bias", (n_out,), "float32", 1.0 / math.sqrt(n_in)))

    d = cfg["sparse_feature_size"]
    mlp("bot_mlp", cfg["mlp_bot"])
    for i, v in enumerate(tables(cfg)):
        out.append(Leaf(f"table_{i}", "weight", (v, d), table_dtype(cfg, v), math.sqrt(6.0 / (v + d))))
    mlp("top_mlp", cfg["mlp_top"])
    return out


@contextlib.contextmanager
def plain_matmuls():
    """float32 products with TF32 off, whatever the process had set."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lower(x: torch.Tensor, compute: str) -> torch.Tensor:
    """x rounded to the `compute` precision, returned as float32."""
    x = x.float()
    if compute == "float32":
        return x
    if compute == "float8":
        scale = x.abs().amax().clamp_min(1e-30) / F8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown compute precision {compute!r}")


class _Linear(torch.autograd.Function):
    """x @ w.T with every operand, forward and backward, rounded to the
    compute precision and the sums in float32."""

    @staticmethod
    def forward(ctx, x, w, compute):
        xl, wl = lower(x, compute), lower(w, compute)
        ctx.save_for_backward(xl, wl)
        ctx.compute = compute
        return xl @ wl.t()

    @staticmethod
    def backward(ctx, g):
        xl, wl = ctx.saved_tensors
        gl = lower(g, ctx.compute)
        return gl @ wl, gl.t() @ xl, None


def _mlp(x: torch.Tensor, p: Dict[Tuple[str, str], torch.Tensor], prefix: str, n_layers: int,
         sigmoid_at: int, compute: str) -> torch.Tensor:
    for i in range(n_layers):
        x = _Linear.apply(x, p[(f"{prefix}_{i}", "kernel")], compute) + p[(f"{prefix}_{i}", "bias")]
        x = torch.sigmoid(x) if i == sigmoid_at else torch.relu(x)
    return x


def _pairs(f: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The strict lower triangle of an f x f matrix, row-major."""
    rows, cols = [], []
    for i in range(f):
        for j in range(i):
            rows.append(i)
            cols.append(j)
    return torch.tensor(rows), torch.tensor(cols)


def forward(cfg: dict, p: Dict[Tuple[str, str], torch.Tensor], dense: torch.Tensor,
            emb: List[torch.Tensor], compute: str = "float32") -> torch.Tensor:
    """The click probability [B, 1] from dense features [B, 13] and the
    pooled embeddings (one [B, D] a table, as `lookup` gives them)."""
    bot, top = cfg["mlp_bot"], cfg["mlp_top"]
    x = _mlp(dense.float(), p, "bot_mlp", len(bot) - 1, -1, compute)
    if cfg["arch_interaction_op"] == "cat":
        z = torch.cat([x] + emb, dim=1)
    elif cfg["arch_interaction_op"] == "dot":
        t = torch.stack([x] + emb, dim=1)  # [B, F, D]
        tl = lower(t, compute)
        gram = torch.bmm(tl, tl.transpose(1, 2))
        rows, cols = _pairs(t.shape[1])
        z = torch.cat([gram[:, rows.to(t.device), cols.to(t.device)], x], dim=1)
    else:
        raise ValueError(cfg["arch_interaction_op"])
    return _mlp(z, p, "top_mlp", len(top) - 1, len(top) - 2, compute)


def lookup(cfg: dict, table: torch.Tensor, idx: torch.Tensor, compute: str) -> torch.Tensor:
    """The bag sum of rows idx [B, bag] of one table, as float32. A small
    table's rows are products' operands (a one-hot product selects them), so
    they are rounded to the compute precision; a large table's are read
    exactly as stored."""
    rows = table[idx.long()].float()  # [B, bag, D]
    if table.shape[0] <= cfg["onehot_embedding_threshold"]:
        rows = lower(rows, compute)
    return rows.sum(dim=1)


def bce(prob: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    p = prob.float().clamp(EPS, 1.0 - EPS)
    y = labels.float().reshape(p.shape)
    return -torch.mean(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def sgd_step(cfg: dict, p: Dict[Tuple[str, str], torch.Tensor], dense: torch.Tensor,
             sparse: List[torch.Tensor], labels: torch.Tensor, lr: float, compute: str = "float32",
             fault: str = "", grad_norms: Dict[str, float] = None) -> float:
    """One training step on one batch, the parameters updated in place;
    returns the loss. Table gradients stay sparse: each touched row gets the
    f32 sum of its lookups' gradients. `grad_norms`, if given, is filled
    with each leaf's gradient norm ("op/key"), as computed, before any
    storage rounds the step."""
    n_tab = len(tables(cfg))
    dense_keys = [k for k in p if not k[0].startswith("table_")]
    leaves_d = {k: p[k].detach().float().requires_grad_(True) for k in dense_keys}
    rows = []
    for i in range(n_tab):
        w = p[(f"table_{i}", "weight")]
        r = w[sparse[i].long()].float().detach().requires_grad_(True)  # [B, bag, D]
        rows.append(r)
    emb = []
    for i, r in enumerate(rows):
        small = p[(f"table_{i}", "weight")].shape[0] <= cfg["onehot_embedding_threshold"]
        emb.append((lower(r, compute) if small else r).sum(dim=1))
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
    grads = torch.autograd.grad(loss, [leaves_d[k] for k in dense_keys] + rows)
    with torch.no_grad():
        rows_sum = []
        for i, g in enumerate(grads[len(dense_keys):]):
            w = p[(f"table_{i}", "weight")]
            uniq, inv = torch.unique(sparse[i].long().reshape(-1), return_inverse=True)
            acc = torch.zeros((uniq.shape[0], w.shape[1]), dtype=torch.float32, device=w.device)
            acc.index_add_(0, inv, g.reshape(-1, w.shape[1]).float())
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
