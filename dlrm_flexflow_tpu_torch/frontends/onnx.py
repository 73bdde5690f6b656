"""ONNX frontend: walk an ONNX graph and replay it onto FFModel.

Counterpart of `dlrm_flexflow_tpu/frontends/onnx.py` (reference:
python/flexflow/onnx/model.py:56 ONNXModel.apply — iterates graph.node,
dispatches on op_type to FFModel builders, uses initializers for
hyper-parameters). The `onnx` package is imported only to load a model from
a path or to convert a real TensorProto: ONNXModel accepts any object with
the ModelProto structure (`graph.node[*].{op_type,input,output,attribute}`,
`graph.initializer`, `graph.output`), so a duck-typed stand-in imports on a
machine that has no `onnx`, and real protos work unchanged where it is
installed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ffconst import PoolType
from ..core.ffmodel import FFModel
from ..core.tensor import TensorSpec


# onnx AttributeProto.type values (proto3 scalars are never "unset", so the
# type tag is the only reliable dispatch for real protos)
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_FLOATS, _ATTR_INTS = 1, 2, 3, 6, 7


def _attrs(node) -> Dict[str, object]:
    out = {}
    for a in getattr(node, "attribute", []):
        t = getattr(a, "type", None)
        if t:  # real onnx proto: dispatch on the type tag
            if t == _ATTR_INT:
                out[a.name] = a.i
            elif t == _ATTR_FLOAT:
                out[a.name] = a.f
            elif t == _ATTR_STRING:
                out[a.name] = a.s.decode() if isinstance(a.s, bytes) else a.s
            elif t == _ATTR_INTS:
                out[a.name] = list(a.ints)
            elif t == _ATTR_FLOATS:
                out[a.name] = list(a.floats)
            continue
        # duck-typed stand-ins: unset fields are None/empty
        for field in ("ints", "floats"):
            v = list(getattr(a, field, []) or [])
            if v:
                out[a.name] = v
                break
        else:
            for field in ("i", "f"):
                v = getattr(a, field, None)
                if v is not None:
                    out[a.name] = v
                    break
            else:
                sv = getattr(a, "s", None)
                if sv is not None:
                    out[a.name] = sv.decode() if isinstance(sv, bytes) else sv
    return out


class ONNXModel:
    """reference: python/flexflow/onnx/model.py:56."""

    def __init__(self, model):
        if isinstance(model, str):
            import onnx  # optional dependency

            model = onnx.load(model)
        self.graph = model.graph
        self.initializers: Dict[str, np.ndarray] = {}
        for ini in getattr(self.graph, "initializer", []):
            self.initializers[ini.name] = _to_numpy(ini)

    def apply(self, ff: FFModel, input_tensors: Dict[str, TensorSpec]) -> TensorSpec:
        env: Dict[str, TensorSpec] = dict(input_tensors)
        out: Optional[TensorSpec] = None
        for node in self.graph.node:
            op = node.op_type
            a = _attrs(node)
            ins = [i for i in node.input if i and i not in self.initializers]
            x = env.get(ins[0]) if ins else None
            name = node.output[0]
            if op == "Conv":
                w = self.initializers[node.input[1]]
                out_c, kh, kw = w.shape[0], int(a["kernel_shape"][0]), int(a["kernel_shape"][1])
                strides = a.get("strides", [1, 1])
                pads = a.get("pads", [0, 0, 0, 0])
                y = ff.conv2d(
                    x, out_c, kh, kw, int(strides[0]), int(strides[1]),
                    int(pads[0]), int(pads[1]),
                    groups=int(a.get("group", 1)),
                    use_bias=len(node.input) > 2, name=name,
                )
            elif op in ("Gemm", "MatMul"):
                w = self.initializers[node.input[1]]
                out_dim = w.shape[0] if int(a.get("transB", 0)) else w.shape[-1]
                y = ff.dense(x, int(out_dim), use_bias=len(node.input) > 2, name=name)
            elif op in ("MaxPool", "AveragePool"):
                ks = a["kernel_shape"]
                strides = a.get("strides", ks)
                pads = a.get("pads", [0, 0, 0, 0])
                y = ff.pool2d(
                    x, int(ks[0]), int(ks[1]), int(strides[0]), int(strides[1]),
                    int(pads[0]), int(pads[1]),
                    pool_type=PoolType.POOL_MAX if op == "MaxPool" else PoolType.POOL_AVG,
                    name=name,
                )
            elif op == "GlobalAveragePool":
                h, w_ = x.shape[2], x.shape[3]
                y = ff.pool2d(x, h, w_, 1, 1, 0, 0, pool_type=PoolType.POOL_AVG, name=name)
            elif op == "BatchNormalization":
                y = ff.batch_norm(x, relu=False, name=name)
            elif op == "Relu":
                y = ff.relu(x, name=name)
            elif op == "Sigmoid":
                y = ff.sigmoid(x, name=name)
            elif op == "Tanh":
                y = ff.tanh(x, name=name)
            elif op == "Softmax":
                y = ff.softmax(x, name=name)
            elif op == "Dropout":
                ratio = float(a.get("ratio", 0.5))
                y = ff.dropout(x, ratio, name=name)
            elif op == "Flatten":
                y = ff.flat(x, name=name)
            elif op == "Reshape":
                shape = self.initializers.get(node.input[1])
                assert shape is not None, "Reshape needs a constant shape initializer"
                dims = [int(d) for d in shape]
                b = x.shape[0]
                dims = [b if d in (0, -1) and i == 0 else int(d) for i, d in enumerate(dims)]
                if -1 in dims[1:]:
                    known = int(np.prod([d for d in dims[1:] if d != -1])) or 1
                    total = 1
                    for d in x.shape[1:]:
                        total *= d
                    dims = [dims[0]] + [d if d != -1 else total // known for d in dims[1:]]
                y = ff.reshape(x, dims, name=name)
            elif op == "Concat":
                y = ff.concat([env[i] for i in ins], int(a.get("axis", 1)), name=name)
            elif op == "Add":
                y = ff.add(env[ins[0]], env[ins[1]], name=name)
            elif op == "Sub":
                y = ff.subtract(env[ins[0]], env[ins[1]], name=name)
            elif op == "Mul":
                y = ff.multiply(env[ins[0]], env[ins[1]], name=name)
            elif op == "Split":
                sizes = a.get("split")
                axis = int(a.get("axis", 0))
                assert sizes, "Split needs explicit sizes"
                ys = ff.split(x, [int(s) for s in sizes], axis, name=name)
                for nm, t in zip(node.output, ys):
                    env[nm] = t
                out = ys[-1]
                continue
            elif op == "Identity":
                y = ff.identity(x, name=name)
            else:
                raise NotImplementedError(f"onnx op {op} not supported")
            env[name] = y
            out = y
        # prefer declared graph outputs
        outs = [o.name for o in getattr(self.graph, "output", [])]
        if outs and outs[0] in env:
            return env[outs[0]]
        assert out is not None, "empty onnx graph"
        return out


def _to_numpy(tensor) -> np.ndarray:
    if isinstance(tensor, np.ndarray):
        return tensor
    if hasattr(tensor, "detach"):  # torch tensor stand-in
        return tensor.detach().cpu().numpy()
    arr = getattr(tensor, "array", None)  # plain stand-in object
    if arr is not None:
        return np.asarray(arr)
    try:  # real onnx TensorProto
        from onnx import numpy_helper

        return numpy_helper.to_array(tensor)
    except Exception as e:  # pragma: no cover
        raise TypeError(f"cannot convert initializer {tensor!r}") from e
