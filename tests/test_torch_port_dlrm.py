"""The PyTorch port's DLRM serving path against the JAX package.

Configs, graphs, synthetic data and `predict` on weights carried over from
the JAX package; plus the port's import boundary and its refusal to run
without CUDA unless asked for the CPU.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.data import synthetic as port_synthetic
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm

REPO = Path(__file__).resolve().parent.parent

ARGVS = [
    [],
    ["-b", "16384", "--compute-dtype", "float32", "--use-pallas", "on", "--seed", "7"],
    ["--epochs", "3", "--lr", "0.5", "--mesh", "2x4", "--table-dtype", "bfloat16",
     "--packed-tables", "off", "--host-routing", "--profiling", "--unknown", "x"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "serving", "training-flags"])
def test_ffconfig_parses_like_reference(argv):
    r = ref.FFConfig()
    p = port.FFConfig()
    assert p.update_from_args(argv) == r.update_from_args(argv)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)


DLRM_ARGVS = [
    ["--arch-sparse-feature-size", "128", "--arch-embedding-size", "100-2000-30",
     "--arch-mlp-bot", "13-64-128", "--arch-mlp-top", "131-64-1", "--arch-interaction-op", "dot"],
    ["--arch-embedding-size", "5-6", "--embedding-bag-size", "3", "--sigmoid-bot", "1",
     "--loss-threshold", "0.25", "--data-size", "100"],
]


@pytest.mark.parametrize("argv", DLRM_ARGVS, ids=["dot", "cat"])
def test_dlrm_config_parses_like_reference(argv):
    r = ref_dlrm.DLRMConfig.parse_args(argv)
    p = port_dlrm.DLRMConfig.parse_args(argv)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert p.top_in_dim() == r.top_in_dim()


CONFIGS = ["tiny_config", "kaggle_config", "mlperf_config", "mlperf_lite_config",
           "summit_large_config", "summit_config"]


def _graph_signature(model):
    return [
        (type(op).__name__, op.name, op.guid, [t.shape for t in op.outputs],
         [(p.key, p.shape) for p in op.params])
        for op in model.graph.compute_ops
    ]


@pytest.mark.parametrize("config", CONFIGS)
def test_graph_has_reference_names_and_shapes(config):
    """Built (not compiled: no weights are made), both packages give the same
    ops, guids, output shapes, parameter names and parameter shapes."""
    r = ref_dlrm.make_dlrm_model(getattr(ref_dlrm, config)(batch_size=32))
    p = port_dlrm.make_dlrm_model(getattr(port_dlrm, config)(batch_size=32), device="cpu")
    assert dataclasses.asdict(getattr(port_dlrm, config)()) == dataclasses.asdict(
        getattr(ref_dlrm, config)()
    )
    assert _graph_signature(p) == _graph_signature(r)


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(zipf=1.05), dict(learnable=False, seed=3)],
    ids=["uniform", "zipf", "noise"],
)
def test_random_batches_bit_identical(kwargs):
    cfg_r = ref_dlrm.kaggle_config()
    cfg_p = port_dlrm.kaggle_config()
    fr, lr = ref_synthetic.random_batches(cfg_r, 257, **kwargs)
    fp, lp = port_synthetic.random_batches(cfg_p, 257, **kwargs)
    assert fp.keys() == fr.keys()
    for k in fr:
        assert fp[k].dtype == fr[k].dtype
        np.testing.assert_array_equal(fp[k], fr[k])
    np.testing.assert_array_equal(lp, lr)


def _small_dot_config(pkg):
    # 2 tables take the one-hot path (<= 8192 rows), 2 the gather
    return pkg.DLRMConfig(
        sparse_feature_size=16,
        embedding_size=[50, 9000, 300, 10000],
        embedding_bag_size=2,
        mlp_bot=[13, 32, 16],
        mlp_top=[10 + 16, 32, 16, 1],
        arch_interaction_op="dot",
    )


# bf16 compute: both sides round the same operands to bf16 and sum in f32,
# but in another order; where that flips the bf16 rounding of an activation,
# the value moves by one bf16 step (2^-8 relative) into the next layer.
BF16_ATOL = 2e-3


@pytest.mark.parametrize(
    "compute_dtype, atol", [("float32", 1e-5), ("bfloat16", BF16_ATOL)]
)
def test_predict_matches_reference_on_carried_weights(compute_dtype, atol):
    bs, n = 32, 77  # 3 chunks, the last one ragged
    rm = ref_dlrm.make_dlrm_model(
        _small_dot_config(ref_dlrm), ref.FFConfig(batch_size=bs, compute_dtype=compute_dtype)
    )
    rm.compile(loss_type=ref.LossType.LOSS_BINARY_CROSSENTROPY)
    pm = port_dlrm.make_dlrm_model(
        _small_dot_config(port_dlrm),
        port.FFConfig(batch_size=bs, compute_dtype=compute_dtype),
        device="cpu",
    )
    pm.compile(loss_type=port.LossType.LOSS_BINARY_CROSSENTROPY)
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    feeds, _ = ref_synthetic.random_batches(_small_dot_config(ref_dlrm), n, seed=5)
    want = rm.predict(feeds)
    got = pm.predict(feeds)
    assert got.shape == want.shape == (n, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the carried weights round-trip unchanged
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            np.testing.assert_array_equal(pm.get_weights(op)[k], v)


def test_params_from_jax_reads_bf16_arrays():
    import jax.numpy as jnp

    w = np.asarray(jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16))
    t = params_from_jax({"emb": {"weight": w}})["emb"]["weight"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), w.astype(np.float32))


def test_set_parameters_rejects_wrong_shape_and_names():
    m = port_dlrm.make_dlrm_model(_small_dot_config(port_dlrm), port.FFConfig(batch_size=8), device="cpu")
    m.compile()
    params = {op: dict(sub) for op, sub in m.get_parameters().items()}
    with pytest.raises(ValueError):
        m.set_weights("table_0", {"weight": torch.zeros(51, 16)})
    with pytest.raises(KeyError):
        m.set_parameters({k: v for k, v in params.items() if k != "table_0"})
    m.set_parameters(params)


def test_training_verbs_raise_not_implemented():
    m = port_dlrm.make_dlrm_model(_small_dot_config(port_dlrm), port.FFConfig(batch_size=8), device="cpu")
    m.compile()
    for call in (lambda: m.train_batch({}, None), lambda: m.fit({}, None), lambda: m.evaluate({}, None)):
        with pytest.raises(NotImplementedError, match="slice 2"):
            call()
    with pytest.raises(NotImplementedError):
        port.FFModel(device="cpu").compile(optimizer=object())


def test_model_made_on_cpu_from_seed_is_deterministic():
    def weights(seed):
        m = port_dlrm.make_dlrm_model(
            _small_dot_config(port_dlrm), port.FFConfig(batch_size=8, seed=seed), device="cpu"
        )
        m.compile()
        return m.get_weights("top_mlp_0")["kernel"]

    np.testing.assert_array_equal(weights(1), weights(1))
    assert not np.array_equal(weights(1), weights(2))


def _run(code_or_args, cwd, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=240, **kw,
    )


def test_port_imports_no_jax_and_refuses_cuda_without_a_card():
    code = (
        "import sys, torch\n"
        "import dlrm_flexflow_tpu_torch as p\n"
        "import dlrm_flexflow_tpu_torch.convert, dlrm_flexflow_tpu_torch._build\n"
        "import dlrm_flexflow_tpu_torch.models.dlrm, dlrm_flexflow_tpu_torch.data.synthetic\n"
        "import dlrm_flexflow_tpu_torch.ops.kernels.dot_interaction\n"
        "import dlrm_flexflow_tpu_torch.tools.k3_staging_ab\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dlrm_flexflow_tpu')]\n"
        "assert not bad, bad\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        p.FFModel()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('FFModel() did not raise without CUDA')\n"
        "print('clean')\n"
    )
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: chip_smoke.py would run for real")
    res = _run(["chip_smoke.py"], REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package beside it, it fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
