"""PyTorch frontend: torch.fx symbolic trace -> framework graph.

Counterpart of `dlrm_flexflow_tpu/frontends/torch_fx.py` (reference:
python/flexflow/torch/fx.py — symbolic-traces an nn.Module into a text `.ff`
node list; python/flexflow/torch/model.py:23 PyTorchModel.apply replays the
nodes onto FFModel). The same two stages, the same node lines and the same
file bytes as the JAX package:

  torch_to_ir(module)        -> List[FXNode]
  save_ir / load_ir          -> the `.ff`-style text round-trip
  PyTorchModel(ir).apply(ff, input_tensors) -> output TensorSpec

Topology only, like the reference: parameters are made by the framework at
compile, not copied from the torch module (reference fx.py writes no
weights).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.fx

from ..ffconst import AggrMode, PoolType
from ..core.ffmodel import FFModel
from ..core.tensor import TensorSpec


@dataclasses.dataclass
class FXNode:
    """One traced op (reference fx.py Node line format:
    name, input names, op string, params)."""

    name: str
    op: str  # linear|conv2d|pool2d|batchnorm|flat|relu|sigmoid|tanh|gelu|
    #          softmax|dropout|add|sub|mul|concat|embedding|identity|
    #          input|output
    inputs: List[str]
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_line(self) -> str:
        attrs = ",".join(f"{k}={v}" for k, v in sorted(self.attrs.items()))
        return f"{self.name};{self.op};{':'.join(self.inputs)};{attrs}"

    @staticmethod
    def from_line(line: str) -> "FXNode":
        name, op, ins, attrs = line.rstrip("\n").split(";")
        attr_d = {}
        if attrs:
            for kv in attrs.split(","):
                k, v = kv.split("=", 1)
                attr_d[k] = v
        return FXNode(name, op, [i for i in ins.split(":") if i], attr_d)


def save_ir(nodes: Sequence[FXNode], path: str) -> None:
    with open(path, "w") as f:
        for n in nodes:
            f.write(n.to_line() + "\n")


def load_ir(path: str) -> List[FXNode]:
    with open(path) as f:
        return [FXNode.from_line(l) for l in f if l.strip()]


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def torch_to_ir(module) -> List[FXNode]:
    """Symbolic-trace an nn.Module (reference: fx.py torch_to_flexflow)."""
    traced = torch.fx.symbolic_trace(module)
    mods = dict(traced.named_modules())
    nodes: List[FXNode] = []

    def attr_of_linear(m):
        return {"out": str(m.out_features), "bias": str(m.bias is not None)}

    for node in traced.graph.nodes:
        ins = [a.name for a in node.args if isinstance(a, torch.fx.Node)]
        if node.op == "placeholder":
            nodes.append(FXNode(node.name, "input", []))
        elif node.op == "output":
            nodes.append(FXNode(node.name, "output", ins))
        elif node.op == "call_module":
            m = mods[node.target]
            t = type(m).__name__
            if t == "Linear":
                nodes.append(FXNode(node.name, "linear", ins, attr_of_linear(m)))
            elif t == "Conv2d":
                kh, kw = _pair(m.kernel_size)
                sh, sw = _pair(m.stride)
                ph, pw = _pair(m.padding)
                nodes.append(FXNode(node.name, "conv2d", ins, {
                    "out": str(m.out_channels), "kh": str(kh), "kw": str(kw),
                    "sh": str(sh), "sw": str(sw), "ph": str(ph), "pw": str(pw),
                    "groups": str(m.groups), "bias": str(m.bias is not None),
                }))
            elif t in ("MaxPool2d", "AvgPool2d"):
                kh, kw = _pair(m.kernel_size)
                sh, sw = _pair(m.stride if m.stride is not None else m.kernel_size)
                ph, pw = _pair(m.padding)
                nodes.append(FXNode(node.name, "pool2d", ins, {
                    "kh": str(kh), "kw": str(kw), "sh": str(sh), "sw": str(sw),
                    "ph": str(ph), "pw": str(pw),
                    "type": "max" if t == "MaxPool2d" else "avg",
                }))
            elif t in ("BatchNorm2d", "BatchNorm1d"):
                nodes.append(FXNode(node.name, "batchnorm", ins))
            elif t == "Flatten":
                nodes.append(FXNode(node.name, "flat", ins))
            elif t == "Dropout":
                nodes.append(FXNode(node.name, "dropout", ins, {"rate": str(m.p)}))
            elif t in ("ReLU", "Sigmoid", "Tanh", "GELU", "Softmax", "Identity"):
                nodes.append(FXNode(node.name, t.lower(), ins))
            elif t == "Embedding":
                nodes.append(FXNode(node.name, "embedding", ins, {
                    "num": str(m.num_embeddings), "dim": str(m.embedding_dim),
                    "aggr": "none",
                }))
            elif t == "EmbeddingBag":
                nodes.append(FXNode(node.name, "embedding", ins, {
                    "num": str(m.num_embeddings), "dim": str(m.embedding_dim),
                    "aggr": m.mode,
                }))
            else:
                raise NotImplementedError(f"torch module {t} not supported")
        elif node.op == "call_function" or node.op == "call_method":
            fname = getattr(node.target, "__name__", str(node.target))
            if fname in ("add", "iadd"):
                nodes.append(FXNode(node.name, "add", ins))
            elif fname in ("sub",):
                nodes.append(FXNode(node.name, "sub", ins))
            elif fname in ("mul",):
                nodes.append(FXNode(node.name, "mul", ins))
            elif fname == "cat":
                cat_args = node.args[0]
                ins = [a.name for a in cat_args]
                axis = node.kwargs.get("dim", node.args[1] if len(node.args) > 1 else 1)
                nodes.append(FXNode(node.name, "concat", ins, {"axis": str(axis)}))
            elif fname in ("relu", "sigmoid", "tanh", "gelu"):
                nodes.append(FXNode(node.name, fname, ins))
            elif fname in ("flatten", "view", "reshape"):
                nodes.append(FXNode(node.name, "flat", ins[:1]))
            elif fname == "softmax":
                nodes.append(FXNode(node.name, "softmax", ins))
            else:
                raise NotImplementedError(f"torch function {fname} not supported")
        else:
            raise NotImplementedError(f"fx op {node.op} not supported")
    return nodes


class PyTorchModel:
    """Replayer (reference: python/flexflow/torch/model.py:23)."""

    def __init__(self, ir_or_path):
        if isinstance(ir_or_path, str):
            self.nodes = load_ir(ir_or_path)
        else:
            self.nodes = list(ir_or_path)

    def apply(self, ff: FFModel, input_tensors: Sequence[TensorSpec]) -> TensorSpec:
        env: Dict[str, TensorSpec] = {}
        it = iter(input_tensors)
        out: Optional[TensorSpec] = None
        act = {
            "relu": ff.relu, "sigmoid": ff.sigmoid, "tanh": ff.tanh,
            "gelu": ff.gelu, "identity": ff.identity, "softmax": ff.softmax,
        }
        for n in self.nodes:
            if n.op == "input":
                env[n.name] = next(it)
            elif n.op == "output":
                out = env[n.inputs[0]]
            elif n.op == "linear":
                env[n.name] = ff.dense(
                    env[n.inputs[0]], int(n.attrs["out"]),
                    use_bias=n.attrs.get("bias", "True") == "True", name=n.name,
                )
            elif n.op == "conv2d":
                a = n.attrs
                env[n.name] = ff.conv2d(
                    env[n.inputs[0]], int(a["out"]), int(a["kh"]), int(a["kw"]),
                    int(a["sh"]), int(a["sw"]), int(a["ph"]), int(a["pw"]),
                    groups=int(a.get("groups", 1)),
                    use_bias=a.get("bias", "True") == "True", name=n.name,
                )
            elif n.op == "pool2d":
                a = n.attrs
                env[n.name] = ff.pool2d(
                    env[n.inputs[0]], int(a["kh"]), int(a["kw"]), int(a["sh"]),
                    int(a["sw"]), int(a["ph"]), int(a["pw"]),
                    pool_type=PoolType.POOL_MAX if a.get("type", "max") == "max"
                    else PoolType.POOL_AVG,
                    name=n.name,
                )
            elif n.op == "batchnorm":
                env[n.name] = ff.batch_norm(env[n.inputs[0]], relu=False, name=n.name)
            elif n.op == "flat":
                env[n.name] = ff.flat(env[n.inputs[0]], name=n.name)
            elif n.op == "dropout":
                env[n.name] = ff.dropout(
                    env[n.inputs[0]], float(n.attrs["rate"]), name=n.name
                )
            elif n.op in act:
                env[n.name] = act[n.op](env[n.inputs[0]], name=n.name)
            elif n.op == "add":
                env[n.name] = ff.add(env[n.inputs[0]], env[n.inputs[1]], name=n.name)
            elif n.op == "sub":
                env[n.name] = ff.subtract(env[n.inputs[0]], env[n.inputs[1]], name=n.name)
            elif n.op == "mul":
                env[n.name] = ff.multiply(env[n.inputs[0]], env[n.inputs[1]], name=n.name)
            elif n.op == "concat":
                env[n.name] = ff.concat(
                    [env[i] for i in n.inputs], int(n.attrs.get("axis", 1)),
                    name=n.name,
                )
            elif n.op == "embedding":
                aggr = {"sum": AggrMode.AGGR_MODE_SUM, "mean": AggrMode.AGGR_MODE_AVG,
                        "avg": AggrMode.AGGR_MODE_AVG,
                        "none": AggrMode.AGGR_MODE_NONE}[n.attrs.get("aggr", "sum")]
                env[n.name] = ff.embedding(
                    env[n.inputs[0]], int(n.attrs["num"]), int(n.attrs["dim"]),
                    aggr=aggr, name=n.name,
                )
            else:
                raise NotImplementedError(f"ir op {n.op}")
        assert out is not None, "traced graph has no output node"
        return out


def torch_to_file(module, path: str) -> None:
    """reference: fx.py torch_to_flexflow(model, filename)."""
    save_ir(torch_to_ir(module), path)
