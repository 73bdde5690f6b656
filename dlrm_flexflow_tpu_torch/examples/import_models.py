"""Model-import frontends tour (the port's counterpart of
examples/import_models.py; reference: examples/python/{pytorch,onnx} +
keras_exp): bring a torch module or a trained tf.keras model into the
framework and train or serve it.

    python -m dlrm_flexflow_tpu_torch.examples.import_models [--device cpu] [--tours torch,tf]

Runs on the card unless `--device cpu` is given. The tf tour imports
tensorflow; `--tours torch` runs the torch tour alone, for a machine that has
no tensorflow.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
from dlrm_flexflow_tpu_torch.core.ffmodel import FFModel
from dlrm_flexflow_tpu_torch.frontends.tf_keras import from_tf_keras, load_tf_weights
from dlrm_flexflow_tpu_torch.frontends.torch_fx import PyTorchModel, torch_to_ir


def torch_example(device: str = "cuda") -> Dict[str, object]:
    """A torch.fx trace of a Linear-ReLU-Linear module, replayed onto an
    FFModel, compiled and trained one epoch of 4 batches of 8."""
    import torch.nn as nn

    net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    ir = torch_to_ir(net)
    ff = FFModel(FFConfig(batch_size=8), device=device)
    x = ff.create_tensor([8, 16], name="x")
    out = PyTorchModel(ir).apply(ff, [x])
    ff.compile(SGDOptimizer(lr=0.01), LossType.LOSS_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    rng = np.random.RandomState(0)
    hist = ff.fit({"x": rng.randn(32, 16).astype(np.float32)},
                  np.eye(4, dtype=np.float32)[rng.randint(0, 4, 32)], epochs=1, verbose=False)
    print("torch.fx import:", tuple(out.shape), "accuracy", hist["accuracy"])
    return {"shape": tuple(out.shape), "ops": [n.op for n in ir], "history": hist}


def tf_example(device: str = "cuda") -> Dict[str, object]:
    """A tf.keras MLP imported with its weights; its forward held against
    tf's own."""
    import tensorflow as tf

    tfm = tf.keras.Sequential([
        tf.keras.layers.Input(shape=(16,)),
        tf.keras.layers.Dense(32, activation="relu"),
        tf.keras.layers.Dense(4, activation="softmax"),
    ])
    ff, in_name = from_tf_keras(tfm, batch_size=8,
                                config=FFConfig(batch_size=8, compute_dtype="float32"), device=device)
    ff.compile(SGDOptimizer(lr=0.01), LossType.LOSS_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    load_tf_weights(ff, tfm, ff._tf_weight_transfer[1])
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    ours = ff.forward({in_name: x}).cpu().numpy()
    theirs = np.asarray(tfm(x))
    diff = float(np.abs(ours - theirs).max())
    print("tf.keras import: max |diff| =", diff)
    return {"max_abs_diff": diff}


TOURS = {"torch": torch_example, "tf": tf_example}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, object]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tours", default=",".join(TOURS),
                        help="comma-separated tours to run, of " + ", ".join(TOURS))
    args = parser.parse_args(argv)
    tours = [t for t in args.tours.split(",") if t]
    unknown = sorted(set(tours) - set(TOURS))
    if unknown:
        parser.error(f"unknown tours {unknown}; choose from {list(TOURS)}")
    return {t: TOURS[t](args.device) for t in tours}


if __name__ == "__main__":
    main()
