"""Import a tf.keras model (reference: python/flexflow/keras_exp/ — the
reference traces tf.keras through keras2onnx into its ONNX importer,
python/flexflow/keras_exp/models/model.py:20-60).

Counterpart of `dlrm_flexflow_tpu/frontends/tf_keras.py`: it walks a Keras
Sequential layer stack directly, which also carries the trained weights
over (the keras2onnx path carried them as ONNX initializers). It never
imports tensorflow: the model is read through `layers`, `inputs[0].shape`,
each layer's class name, `name`, `get_config()` and `get_weights()`, so a
stand-in with those works where tensorflow is not installed.

Supports Sequential models over Dense / Conv2D(channels_first) / pooling /
Flatten / Dropout / BatchNormalization / Activation / ReLU / Softmax.
Functional tf.keras models can be exported to ONNX (tf2onnx) and imported
via frontends/onnx.py, matching the reference's route.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..config import FFConfig
from ..core.ffmodel import FFModel
from ..ffconst import ActiMode, PoolType, as_acti_mode


def _act(config_activation) -> ActiMode:
    if config_activation is None or config_activation == "linear":
        return ActiMode.AC_MODE_NONE
    if not isinstance(config_activation, str):
        raise NotImplementedError(
            f"non-string tf activation {config_activation!r} (layer/callable "
            "activations) is not supported — use a named activation"
        )
    return as_acti_mode(config_activation)


def from_tf_keras(
    tf_model,
    batch_size: int = 32,
    config: Optional[FFConfig] = None,
    transfer_weights: bool = True,
    device="cuda",
) -> Tuple[FFModel, str]:
    """Convert a tf.keras Sequential model into an (uncompiled) FFModel.
    Returns (ffmodel, input_name). Call .compile() then optionally
    load_tf_weights (done automatically when transfer_weights and the model
    is built). The FFModel is made on `device`."""
    layers = list(tf_model.layers)
    in_shape = tuple(int(d) for d in tf_model.inputs[0].shape[1:])
    ff = FFModel(config or FFConfig(batch_size=batch_size), device=device)
    x = ff.create_tensor([batch_size] + list(in_shape), name="input_0")
    t = x
    name_map: Dict[str, str] = {}  # tf layer name -> ff op name
    for lay in layers:
        kind = type(lay).__name__
        cfg = lay.get_config()
        if kind == "Dense":
            is_softmax = cfg.get("activation") == "softmax"
            act = ActiMode.AC_MODE_NONE if is_softmax else _act(cfg.get("activation"))
            t = ff.dense(t, int(cfg["units"]), activation=act,
                         use_bias=bool(cfg.get("use_bias", True)), name=lay.name)
            name_map[lay.name] = t.owner_op.name
            if is_softmax:
                t = ff.softmax(t)
        elif kind == "Conv2D":
            assert cfg.get("data_format") == "channels_first", (
                "convert tf conv models with data_format='channels_first' "
                "(TPU-native layout); channels_last needs transposes"
            )
            kh, kw = cfg["kernel_size"]
            sh, sw = cfg["strides"]
            pad = cfg.get("padding", "valid")
            if pad == "same":
                assert kh % 2 == 1 and kw % 2 == 1 and sh == sw == 1, (
                    "'same' conv import is exact only for odd kernels with "
                    "stride 1 (TF pads asymmetrically otherwise)"
                )
            ph, pw = (kh // 2, kw // 2) if pad == "same" else (0, 0)
            t = ff.conv2d(
                t, int(cfg["filters"]), kh, kw, sh, sw, ph, pw,
                activation=_act(cfg.get("activation")),
                use_bias=bool(cfg.get("use_bias", True)), name=lay.name,
            )
            name_map[lay.name] = t.owner_op.name
        elif kind in ("MaxPooling2D", "AveragePooling2D"):
            kh, kw = cfg["pool_size"]
            sh, sw = cfg.get("strides") or (kh, kw)
            assert cfg.get("padding", "valid") == "valid", (
                "'same' pooling import is not supported (TF pads "
                "asymmetrically); use valid pooling"
            )
            t = ff.pool2d(
                t, kh, kw, sh, sw, 0, 0,
                pool_type=PoolType.POOL_MAX if kind.startswith("Max") else PoolType.POOL_AVG,
                name=lay.name,
            )
        elif kind == "Flatten":
            t = ff.flat(t, name=lay.name)
        elif kind == "Dropout":
            t = ff.dropout(t, float(cfg["rate"]), name=lay.name)
        elif kind == "BatchNormalization":
            # NOTE: weights are NOT transferred for BN — our BatchNorm is
            # train-mode (batch statistics); tf's moving_mean/variance have
            # no slot here, so a transferred gamma/beta would still not
            # reproduce tf inference. Excluded from name_map on purpose.
            t = ff.batch_norm(t, relu=False, name=lay.name)
        elif kind in ("Activation", "ReLU", "Softmax"):
            act_name = cfg.get("activation", kind.lower())
            if act_name == "softmax" or kind == "Softmax":
                t = ff.softmax(t, name=lay.name)
            elif act_name in ("relu",) or kind == "ReLU":
                t = ff.relu(t, name=lay.name)
            elif act_name == "sigmoid":
                t = ff.sigmoid(t, name=lay.name)
            elif act_name == "tanh":
                t = ff.tanh(t, name=lay.name)
            else:
                raise NotImplementedError(f"tf activation {act_name}")
        elif kind == "InputLayer":
            continue
        else:
            raise NotImplementedError(f"tf.keras layer {kind} not supported")
    ff._tf_weight_transfer = (
        (tf_model, name_map) if transfer_weights else None
    )
    return ff, "input_0"


def load_tf_weights(ff: FFModel, tf_model, name_map: Dict[str, str]) -> int:
    """Copy trained tf weights into the compiled FFModel (layout conversion:
    tf Dense kernel [in,out] -> ours [out,in]; tf Conv2D HWIO -> OIHW).
    Returns the number of ops updated."""
    updated = 0
    for lay in tf_model.layers:
        ff_name = name_map.get(lay.name)
        if ff_name is None or not lay.get_weights():
            continue
        ws = lay.get_weights()
        kind = type(lay).__name__
        new: Dict[str, np.ndarray] = {}
        if kind == "Dense":
            new["kernel"] = np.ascontiguousarray(ws[0].T)
            if len(ws) > 1:
                new["bias"] = ws[1]
        elif kind == "Conv2D":
            new["kernel"] = np.ascontiguousarray(np.transpose(ws[0], (3, 2, 0, 1)))
            if len(ws) > 1:
                new["bias"] = ws[1]
        else:
            continue  # only Dense/Conv2D transfer (see BN note above)
        if new:
            ff.set_weights(ff_name, new)
            updated += 1
    return updated
