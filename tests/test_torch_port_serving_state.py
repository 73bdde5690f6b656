"""Serving and state in the port, on the CPU: quantized tables, checkpoints,
callbacks and the Criteo files.

`quantize_embeddings` to bf16, f16 and int8 against the JAX package's on
the same weights (tests/test_training.py:209 and :252 mirrored), the int8
lookup against `quantized_embedding_bag`, K4's and K5f's plain versions on
f16 tables against the Pallas kernels in interpret mode; checkpoint round
trips (tests/test_services.py:40 and :60, tests/test_packed_update.py:773's
Adam part) and a checkpoint the JAX package wrote restored into the port;
the callbacks (tests/test_services.py:70-113) and the Criteo readers
(tests/test_data.py:53, :63 and :140) against the JAX package's. The f16
kernels and an int8 `predict` on the card are in tests/test_torch_port_cuda.py.
"""
import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data import criteo as ref_criteo
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm
from dlrm_flexflow_tpu.ops import embedding as ref_emb
from dlrm_flexflow_tpu.ops.pallas.embedding_bag import embedding_bag_pallas
from dlrm_flexflow_tpu.ops.pallas.onehot_embedding import onehot_embedding_pallas
from dlrm_flexflow_tpu.training import checkpoint as ref_checkpoint

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.data import criteo as port_criteo
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm
from dlrm_flexflow_tpu_torch.ops import embedding as port_emb
from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import embedding_bag
from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import onehot_embedding
from dlrm_flexflow_tpu_torch.training.callbacks import (
    CheckpointCallback,
    EarlyStopping,
    EpochVerifyMetrics,
    LearningRateScheduler,
    VerifyMetrics,
)
from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint

F32_UNIT = 2.0**-24
# the tolerances of the JAX package's own tests, on the same model: bf16
# tables (tests/test_training.py:245) and int8 rows (:279); f16 keeps 3
# more mantissa bits than bf16, so its bound is bf16's over 8
SERVE_ATOL = {"bfloat16": 0.05, "float16": 0.05 / 8, "int8": 0.08}
QUANT_DT = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
SUM, AVG, NONE = (port.AggrMode.AGGR_MODE_SUM, port.AggrMode.AGGR_MODE_AVG,
                  port.AggrMode.AGGR_MODE_NONE)


def _serve_cfg(pkg):
    """tests/test_training.py's quantization model."""
    return pkg.DLRMConfig(sparse_feature_size=16, embedding_size=[500, 300, 800], embedding_bag_size=2,
                          mlp_bot=[4, 16, 16], mlp_top=[64, 16, 1], batch_size=64)


def _serve_pair(packed="on", **ffkw):
    kw = dict(batch_size=64, compute_dtype="float32", onehot_embedding_threshold=0, packed_tables=packed,
              **ffkw)
    rm = ref_dlrm.make_dlrm_model(_serve_cfg(ref_dlrm), ref.FFConfig(**kw))
    rm.compile(ref.SGDOptimizer(lr=0.1), ref.LossType.LOSS_BINARY_CROSSENTROPY, [ref.MetricsType.METRICS_ACCURACY])
    pm = port_dlrm.make_dlrm_model(_serve_cfg(port_dlrm), port.FFConfig(**kw), device="cpu")
    pm.compile(port.SGDOptimizer(lr=0.1), port.LossType.LOSS_BINARY_CROSSENTROPY,
               [port.MetricsType.METRICS_ACCURACY])
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    return rm, pm


# ----------------------------------------------------------------- quantized serving


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_quantize_embeddings_serving_like_the_jax_package(dtype):
    """Every embedding array cast; outputs within the JAX test's bound of
    the f32 model (f16: stated above) and next to the JAX package's
    quantized model; training refused afterwards."""
    rm, pm = _serve_pair()
    feeds, labels = ref_synthetic.random_batches(_serve_cfg(ref_dlrm), 64, seed=5)
    y32 = pm.forward(feeds).numpy()
    n = pm.quantize_embeddings(dtype)
    assert n == rm.quantize_embeddings(dtype) == 3
    for op in pm.graph.compute_ops:
        if op.op_type is port.OperatorType.OP_EMBEDDING:
            assert all(v.dtype == QUANT_DT[dtype][0] for v in pm.get_parameters()[op.name].values())
    y = pm.forward(feeds).float().numpy()
    np.testing.assert_allclose(y, y32, atol=SERVE_ATOL[dtype])
    # the same rounded tables, gathered and summed over bags of 2 in each
    np.testing.assert_allclose(y, np.asarray(rm.forward(feeds), np.float32), rtol=0, atol=1e-3)
    with pytest.raises(RuntimeError, match="quantiz"):
        pm.train_batch(feeds, labels)


@pytest.mark.parametrize("packed", ["on", "off"])
def test_quantize_embeddings_int8_like_the_jax_package(packed):
    """int8 rows and per-row f32 scales (the JAX package's packed layout
    unpacked: the port keeps [V, D]): q and scale equal to the JAX
    package's `quantize_table_int8` on the same f32 tables, bit for bit;
    outputs within 0.08 of the f32 model and next to the JAX package's
    int8 model; training refused."""
    rm, pm = _serve_pair(packed)
    feeds, labels = ref_synthetic.random_batches(_serve_cfg(ref_dlrm), 64, seed=6)
    y32 = pm.forward(feeds).numpy()
    tables = {op: pm.get_weights(op)["weight"] for op in ("table_0", "table_1", "table_2")}
    assert pm.quantize_embeddings("int8") == rm.quantize_embeddings("int8") == 3
    for op, w in tables.items():
        sub = pm.get_parameters()[op]
        assert set(sub) == {"weight_q", "weight_scale"} and sub["weight_q"].dtype == torch.int8
        q, s = ref_emb.quantize_table_int8(jnp.asarray(w), False)
        np.testing.assert_array_equal(sub["weight_q"].numpy(), np.asarray(q))
        np.testing.assert_array_equal(sub["weight_scale"].numpy(), np.asarray(s))
    y8 = pm.forward(feeds).numpy()
    np.testing.assert_allclose(y8, y32, atol=SERVE_ATOL["int8"])
    np.testing.assert_allclose(y8, np.asarray(rm.forward(feeds)), rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="quantiz"):
        pm.train_batch(feeds, labels)


def test_int8_scale_of_a_bf16_route_table_is_computed_in_f32_by_design():
    """A bf16 table on the row-update route: the port widens it exactly and
    takes max|w| / 127 in f32; the JAX package takes the same division in
    the table's bf16 (one more rounding, at most 2^-8 relative, bf16's unit
    roundoff), and w / scale in bf16 too (its spacing is 0.25 to 0.5 above
    32). So the scales differ by that rounding, and an entry whose w / scale
    lies near a half may round to the next int8 value (about one in eight
    here): no entry more than one step away, the dequantized rows within
    1.5 steps of each other. ROADMAP.md Queue 3 lists this difference."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32) * 0.05)
    wb = w.to(torch.bfloat16)
    q, s = port_emb.quantize_table_int8(wb)
    want_s = torch.clamp_min(wb.float().abs().amax(dim=1), 1e-12) / 127.0
    assert s.dtype == torch.float32 and torch.equal(s, want_s)
    jq, js = ref_emb.quantize_table_int8(jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16), False)
    js = np.asarray(js, np.float32)
    rel = np.abs(s.numpy() - js) / js
    assert rel.max() <= 2.0**-8 and (rel > 0).any()
    jq = np.asarray(jq).astype(np.int32)
    assert np.abs(q.numpy().astype(np.int32) - jq).max() <= 1
    deq = np.abs(q.numpy() * s.numpy()[:, None] - jq * js[:, None])
    assert np.all(deq <= 1.5 * s.numpy()[:, None])


@pytest.mark.parametrize("aggr", [SUM, AVG, NONE], ids=["sum", "avg", "none"])
def test_quantized_lookup_matches_quantized_embedding_bag(aggr):
    """Padding, duplicates and indices >= V (clipped to V - 1, as the JAX
    function clips them), bags of 3; f32 out."""
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (40, 16)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, 40).astype(np.float32)
    idx = rng.integers(0, 40, (9, 3))
    idx[1, 2], idx[2] = -1, [-1, -1, -1]
    idx[3, 0], idx[4, 1] = 40, 45
    if aggr is NONE:
        idx = idx[:, :1]
    want = ref_emb.quantized_embedding_bag(jnp.asarray(q), jnp.asarray(s), jnp.asarray(idx),
                                           getattr(ref.AggrMode, aggr.name), 16, packed=False)
    got = port_emb.quantized_embedding_bag(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(idx), aggr)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 * F32_UNIT, atol=1e-8)


def test_int8_tables_take_the_quantized_lookup_under_use_pallas_on(monkeypatch):
    """Under "on" an int8 table reaches neither forced lookup (K4, K5f), as
    in the JAX package, whose `_forward_device` checks `weight_q` first."""
    cfg = port_dlrm.mlperf_lite_config(batch_size=16, vocab_cap=500)
    cfg.mlp_bot, cfg.mlp_top = [13, 128], [cfg.top_in_dim(), 16, 1]
    m = port_dlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=16, use_pallas="on", packed_tables="off"),
                                  device="cpu")
    m.compile(loss_type=port.LossType.LOSS_BINARY_CROSSENTROPY)
    feeds, _ = ref_synthetic.random_batches(cfg, 16, seed=2)
    assert m.quantize_embeddings("int8") == cfg.num_tables

    def refuse(*args, **kwargs):
        raise AssertionError("a forced lookup ran on an int8 table")

    monkeypatch.setattr(port_emb, "embedding_bag_kernel", refuse)
    monkeypatch.setattr(port_emb, "onehot_embedding", refuse)
    y = m.predict(feeds)
    assert y.shape == (16, 1) and np.isfinite(y).all()


def test_set_parameters_restores_training_after_quantizing():
    rm, pm = _serve_pair()
    feeds, labels = ref_synthetic.random_batches(_serve_cfg(ref_dlrm), 64, seed=7)
    f32 = {op: pm.get_weights(op) for op in pm.get_parameters()}
    pm.quantize_embeddings("int8")
    pm.set_parameters(f32)
    assert pm.get_parameters()["table_0"]["weight"].dtype == torch.float32
    assert np.isfinite(float(pm.train_batch(feeds, labels)))
    with pytest.raises(ValueError, match="quantize_embeddings takes"):
        pm.quantize_embeddings("int4")


@pytest.mark.parametrize("aggr", [SUM, AVG], ids=["sum", "avg"])
def test_forced_lookups_plain_versions_take_f16_tables_like_the_pallas_kernels(aggr):
    """K4's and K5f's plain versions on f16 tables (the kernels' new table
    dtype) against `embedding_bag_pallas` and `onehot_embedding_pallas`
    interpreted: rows summed in f32, one rounding to f16 at the end."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((40, 128)).astype(np.float16)
    idx = rng.integers(-1, 40, (13, 4))
    want = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(idx), getattr(ref.AggrMode, aggr.name), 8, True)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), aggr)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2.0**-10, atol=1e-4)
    small = rng.standard_normal((11, 16)).astype(np.float16)
    oidx = rng.integers(-1, 13, (9, 4))
    want = onehot_embedding_pallas(jnp.asarray(small), jnp.asarray(oidx), getattr(ref.AggrMode, aggr.name), 8,
                                   True, jnp.bfloat16)
    got = onehot_embedding(torch.from_numpy(small), torch.from_numpy(oidx), aggr, torch.bfloat16)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2.0**-10, atol=1e-4)


# ----------------------------------------------------------------- checkpoints


CKPT_CFG = dict(sparse_feature_size=8, embedding_size=[200, 300], embedding_bag_size=2, mlp_bot=[4, 8],
                mlp_top=[24, 8, 1], batch_size=32)


def _ckpt_model(opt=None, pkg=port, **ffkw):
    """tests/test_services.py's model."""
    dlrm = port_dlrm if pkg is port else ref_dlrm
    m = dlrm.make_dlrm_model(dlrm.DLRMConfig(**CKPT_CFG), pkg.FFConfig(batch_size=32, compute_dtype="float32",
                                                                        seed=7, **ffkw),
                             **({"device": "cpu"} if pkg is port else {}))
    m.compile(opt or pkg.SGDOptimizer(lr=0.05), pkg.LossType.LOSS_BINARY_CROSSENTROPY,
              [pkg.MetricsType.METRICS_ACCURACY])
    return m


def _batch(feeds, labels, i, bs=32):
    sl = slice(i * bs, (i + 1) * bs)
    return {k: v[sl] for k, v in feeds.items()}, labels[sl]


def test_checkpoint_roundtrip_resumes_identically(tmp_path):
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32 * 6, seed=1)
    m1 = _ckpt_model(onehot_embedding_threshold=0)
    for i in range(3):
        m1.train_batch(*_batch(feeds, labels, i))
    save_checkpoint(str(tmp_path / "ckpt"), m1, extra={"note": "three"})
    m2 = _ckpt_model(onehot_embedding_threshold=0)
    manifest = restore_checkpoint(str(tmp_path / "ckpt"), m2)
    assert manifest["step"] == 3 == m2._step_count and manifest["extra"] == {"note": "three"}
    assert set(json.loads((tmp_path / "ckpt" / "manifest.json").read_text())) == {
        "version", "step", "host_tail", "extra"}
    for i in range(3, 6):
        b = _batch(feeds, labels, i)
        assert torch.equal(m1.train_batch(*b), m2.train_batch(*b)), i
    assert m1.get_metrics() == m2.get_metrics()


def test_checkpoint_with_adam_state(tmp_path):
    m1 = _ckpt_model(port.AdamOptimizer(alpha=0.01))
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32, seed=2)
    m1.train_batch(feeds, labels)
    save_checkpoint(str(tmp_path / "c2"), m1)
    m2 = _ckpt_model(port.AdamOptimizer(alpha=0.01))
    restore_checkpoint(str(tmp_path / "c2"), m2)
    st1, st2 = (m._opt_state["dense"] if "dense" in m._opt_state else m._opt_state for m in (m1, m2))
    assert st2["step"] == 1
    assert torch.equal(st2["m"]["bot_mlp_0"]["kernel"], st1["m"]["bot_mlp_0"]["kernel"])


@pytest.mark.parametrize("route", ["kernel", "scatter"])
def test_adam_checkpoint_roundtrip_on_each_route(tmp_path, route):
    """tests/test_packed_update.py:773's Adam part: the sparse state in the
    layout of its route ({"m", "v"} on the kernel route, [2, V, D] on the
    scatter route) round-trips, a bf16 route table bit for bit, and the
    resumed model steps as the original does."""
    cfg = port_dlrm.DLRMConfig(sparse_feature_size=16, embedding_size=[500, 300, 800], embedding_bag_size=2,
                               mlp_bot=[4, 16, 16], mlp_top=[64, 16, 1], batch_size=32)
    ffkw = dict(batch_size=32, onehot_embedding_threshold=0,
                packed_tables="on" if route == "kernel" else "off",
                table_dtype="bfloat16" if route == "kernel" else "float32")

    def make():
        m = port_dlrm.make_dlrm_model(cfg, port.FFConfig(**ffkw), device="cpu")
        m.compile(port.AdamOptimizer(alpha=0.02), port.LossType.LOSS_BINARY_CROSSENTROPY, [])
        return m

    shared = {f.name for f in dataclasses.fields(ref_dlrm.DLRMConfig)}  # the port's adds the "dcn" fields
    feeds, labels = ref_synthetic.random_batches(
        ref_dlrm.DLRMConfig(**{k: v for k, v in vars(cfg).items() if k in shared}), 32 * 3, seed=13)
    model = make()
    st = model._opt_state["sparse"]["table_0"]
    assert (set(st) == {"m", "v"}) if route == "kernel" else tuple(st.shape) == (2, 500, 16)
    for i in range(2):
        model.train_batch(*_batch(feeds, labels, i))
    save_checkpoint(str(tmp_path / "ck"), model)
    model2 = make()
    restore_checkpoint(str(tmp_path / "ck"), model2)
    w = model2.get_parameters()["table_0"]["weight"]
    assert w.dtype == (torch.bfloat16 if route == "kernel" else torch.float32)
    assert torch.equal(w, model.get_parameters()["table_0"]["weight"])
    b = _batch(feeds, labels, 2)
    assert torch.equal(model.train_batch(*b), model2.train_batch(*b))


def test_checkpoint_written_by_the_jax_package_restores_into_the_port(tmp_path):
    """The JAX package trains 2 Adam steps and saves; the port restores
    that directory into its own model of the same config (both on the
    scatter route, as on the CPU), and its next step matches the JAX
    package's next step (f32: the same operations in another order)."""
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32 * 3, seed=4)
    rm = _ckpt_model(ref.AdamOptimizer(alpha=0.01), pkg=ref, onehot_embedding_threshold=0)
    for i in range(2):
        rm.train_batch(*_batch(feeds, labels, i))
    ref_checkpoint.save_checkpoint(str(tmp_path / "jax"), rm)
    pm = _ckpt_model(port.AdamOptimizer(alpha=0.01), onehot_embedding_threshold=0)
    assert restore_checkpoint(str(tmp_path / "jax"), pm)["step"] == 2 == pm._step_count
    assert pm._opt_state["dense"]["step"] == 2
    np.testing.assert_array_equal(pm.get_weights("table_0")["weight"], rm.get_weights("table_0")["weight"])
    b = _batch(feeds, labels, 2)
    np.testing.assert_allclose(float(pm.train_batch(*b)), float(rm.train_batch(*b)), rtol=1e-5, atol=1e-6)
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            np.testing.assert_allclose(pm.get_weights(op)[k], np.asarray(v), rtol=0, atol=1e-5)
    assert pm.get_metrics()["samples"] == rm.get_metrics()["samples"] == 96


def test_restore_refuses_other_shapes_and_host_tail_stores(tmp_path):
    m = _ckpt_model()
    save_checkpoint(str(tmp_path / "c"), m)
    other = port_dlrm.make_dlrm_model(port_dlrm.DLRMConfig(**{**CKPT_CFG, "embedding_size": [200, 301]}),
                                      port.FFConfig(batch_size=32, compute_dtype="float32"), device="cpu")
    other.compile(port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY,
                  [port.MetricsType.METRICS_ACCURACY])
    with pytest.raises(ValueError, match="table_1/weight has shape .*Shapes must match"):
        restore_checkpoint(str(tmp_path / "c"), other)
    adam = _ckpt_model(port.AdamOptimizer(alpha=0.01))
    with pytest.raises(ValueError, match="Shapes must match"):
        restore_checkpoint(str(tmp_path / "c"), adam)
    # host-tail stores go only into a model that has them (the round trip
    # is tests/test_torch_port_host_tail.py::test_host_tail_checkpoint_roundtrip)
    manifest = tmp_path / "c" / "manifest.json"
    manifest.write_text(json.dumps({**json.loads(manifest.read_text()), "host_tail": True}))
    with pytest.raises(ValueError, match="host-tail stores but the model has none"):
        restore_checkpoint(str(tmp_path / "c"), m)


# ----------------------------------------------------------------- callbacks


def test_lr_scheduler_changes_rate_without_recompile():
    m = _ckpt_model(port.SGDOptimizer(lr=0.1))
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32 * 2, seed=3)
    m.fit(feeds, labels, epochs=3, verbose=False,
          callbacks=[LearningRateScheduler(lambda epoch: 0.1 * (0.5 ** epoch))])
    assert m.get_learning_rate() == pytest.approx(0.1 * 0.25)


def test_set_learning_rate_zero_freezes_params():
    m = _ckpt_model(port.SGDOptimizer(lr=0.1))
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32, seed=4)
    m.set_learning_rate(0.0)
    before = {op: m.get_weights(op) for op in m.get_parameters()}
    m.train_batch(feeds, labels)
    for op, sub in before.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(v, m.get_weights(op)[k])


def test_verify_metrics_gates_raise():
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32 * 2, seed=5)
    with pytest.raises(AssertionError, match="VerifyMetrics failed"):
        _ckpt_model().fit(feeds, labels, epochs=1, verbose=False, callbacks=[VerifyMetrics("accuracy", 1.01)])
    with pytest.raises(AssertionError, match="EpochVerifyMetrics failed at epoch 1"):
        _ckpt_model().fit(feeds, labels, epochs=2, verbose=False,
                          callbacks=[EpochVerifyMetrics("accuracy", 1.01, start_epoch=1)])


def test_early_stopping_stops():
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32 * 2, seed=6)

    class CountingES(EarlyStopping):
        epochs_seen = 0

        def on_epoch_end(self, model, epoch, metrics):
            CountingES.epochs_seen = epoch + 1
            return super().on_epoch_end(model, epoch, metrics)

    # patience 1 on a constant metric stops after epoch 2
    _ckpt_model().fit(feeds, labels, epochs=10, verbose=False, callbacks=[CountingES(metric="samples", patience=1)])
    assert CountingES.epochs_seen == 2


def test_checkpoint_callback_saves_each_epoch(tmp_path):
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**CKPT_CFG), 32 * 2, seed=8)
    m = _ckpt_model()
    m.fit(feeds, labels, epochs=2, verbose=False, callbacks=[CheckpointCallback(str(tmp_path / "cb"))])
    manifest = restore_checkpoint(str(tmp_path / "cb"), _ckpt_model())
    assert manifest["step"] == 4 and manifest["extra"]["epoch"] == 1 and manifest["extra"]["samples"] == 64


# ----------------------------------------------------------------- Criteo files


def test_criteo_npz_roundtrip_like_the_jax_reader(tmp_path):
    path = str(tmp_path / "criteo.npz")
    port_criteo.save_synthetic_criteo(path, 128, [100, 200], num_dense=13, seed=0)
    feeds, labels, vocabs = port_criteo.load_criteo(path)
    assert feeds["dense_features"].shape == (128, 13) and feeds["sparse_0"].shape == (128, 1)
    assert labels.shape == (128, 1)
    assert len(vocabs) == 2 and vocabs[0] <= 100 and vocabs[1] <= 200
    ref_path = str(tmp_path / "ref.npz")
    ref_criteo.save_synthetic_criteo(ref_path, 128, [100, 200], num_dense=13, seed=0)
    want = ref_criteo.load_criteo(ref_path, max_samples=100)
    got = port_criteo.load_criteo(path, max_samples=100)
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_preprocess_raw_tsv_like_the_jax_package(tmp_path):
    raw = tmp_path / "day.tsv"
    rows = [
        "1\t" + "\t".join(str(i) for i in range(13)) + "\t" + "\t".join(["a1f"] * 26),
        "0\t" + "\t".join([""] * 13) + "\t" + "\t".join([""] * 26),
        "0\t-3\t7" + "\t" * 11 + "\tff\t10",
    ]
    raw.write_text("\n".join(rows) + "\n")
    n, vocabs = port_criteo.preprocess_raw_tsv(str(raw), str(tmp_path / "day.npz"), vocab_mod=1000)
    assert n == 3 and len(vocabs) == 26
    feeds, labels, _ = port_criteo.load_criteo(str(tmp_path / "day.npz"))
    assert feeds["dense_features"][0, 0] == 0.0
    assert feeds["dense_features"][0, 1] == pytest.approx(np.log(2.0))
    assert feeds["dense_features"][1].sum() == 0.0 and feeds["dense_features"][2, 0] == 0.0
    assert feeds["sparse_0"][1, 0] == 0 and feeds["sparse_0"][0, 0] == int("a1f", 16) % 1000
    assert ref_criteo.preprocess_raw_tsv(str(raw), str(tmp_path / "ref.npz"), vocab_mod=1000) == (n, vocabs)
    want = ref_criteo.load_criteo(str(tmp_path / "ref.npz"))
    for k in want[0]:
        np.testing.assert_array_equal(feeds[k], want[0][k])
    np.testing.assert_array_equal(labels, want[1])


def test_load_criteo_h5_fixture(tmp_path):
    """The reference's own dataset format (HDF5 X_int/X_cat/y,
    examples/cpp/DLRM/dlrm.cc:281-325), where h5py is installed."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(0)
    x_int = rng.rand(32, 13).astype(np.float32)
    x_cat = rng.randint(0, 50, (32, 4)).astype(np.int64)
    y = rng.randint(0, 2, 32).astype(np.float32)
    path = str(tmp_path / "criteo.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("X_int", data=x_int)
        f.create_dataset("X_cat", data=x_cat)
        f.create_dataset("y", data=y)
    feeds, labels, vocabs = port_criteo.load_criteo(path)
    np.testing.assert_allclose(feeds["dense_features"], x_int)
    np.testing.assert_array_equal(feeds["sparse_2"][:, 0], x_cat[:, 2])
    assert labels.shape == (32, 1)
    assert vocabs == [int(x_cat[:, i].max()) + 1 for i in range(4)]
