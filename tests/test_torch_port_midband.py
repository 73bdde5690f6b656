"""The mid-band tables in the port (`onehot_packed_threshold`) against the JAX
package, on the CPU.

A table with its vocab in (onehot_embedding_threshold,
onehot_packed_threshold] takes the JAX package's one-hot matmul over pack
lines (`packed_embedding_bag_onehot`) there and the port's one-hot lookup
on [V, D] here, with a dense gradient for the dense optimizer. The lookup
selects rows exactly, rounded to the compute dtype, and sums them in f32:
forward values agree to f32 rounding of the pooling sum (atol 1e-6 on
values of order 1). Gradients: both sum a row's contributions in f32 and
round the sum to the compute dtype once; the f32 sums run in another order
(n * 2^-24 relative for n terms), and at bf16 compute such a difference can
cross one bf16 rounding (2^-8 relative), where rounding every contribution
instead would miss by many steps on the rows looked up many times. Whole
models run f32 from carried weights: losses within rtol 1e-5 and atol 1e-6
and weights within 1e-6 under SGD and momentum, 1e-5 under Adam and
AdaGrad (their divisions and square roots an ulp apart in the two
packages, over 4 steps).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm
from dlrm_flexflow_tpu.ops import embedding as ref_emb
from dlrm_flexflow_tpu.ops.pallas import packed_update as pu
from dlrm_flexflow_tpu.training import checkpoint as ref_checkpoint

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax, unpack_like
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm
from dlrm_flexflow_tpu_torch.ops import embedding as port_emb
from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _lookup_case(d, bag, seed):
    rng = np.random.default_rng(seed)
    v, b = 1000, 64
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, bag)).astype(np.int32)
    idx[:20, 0] = 7  # a row looked up 20 times and more
    idx[5, 0] = -1  # padding
    idx[9, :] = -1  # a bag of padding only
    g = rng.standard_normal((b, d)).astype(np.float32)
    return table, idx, g


@pytest.mark.parametrize("d, bag, aggr, cdt", [(16, 1, "SUM", "float32"), (16, 3, "AVG", "bfloat16"),
                                              (32, 2, "SUM", "bfloat16"), (128, 2, "AVG", "float32"),
                                              (64, 1, "SUM", "bfloat16")])
def test_lookup_and_gradient_match_packed_embedding_bag_onehot(d, bag, aggr, cdt):
    """Forward against `packed_embedding_bag_onehot` on the packed table,
    gradient against its `jax.vjp`, unpacked."""
    table, idx, g = _lookup_case(d, bag, d + bag)
    aggr_p, aggr_r = getattr(port.AggrMode, f"AGGR_MODE_{aggr}"), getattr(ref.AggrMode, f"AGGR_MODE_{aggr}")
    jdt, tdt = DT[cdt]
    packed = pu.pack_table(jnp.asarray(table), 16)
    want, vjp = jax.vjp(lambda p: ref_emb.packed_embedding_bag_onehot(p, jnp.asarray(idx), aggr_r, d, jdt), packed)
    (g_packed,) = vjp(jnp.asarray(g))
    g_want = np.asarray(pu.unpack_table(g_packed, *table.shape))
    t = torch.from_numpy(table).requires_grad_(True)
    got = port_emb.embedding_bag_onehot(t, torch.from_numpy(idx), aggr_p, tdt)
    (g_got,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    g_got = g_got.numpy()
    if cdt == "float32":
        np.testing.assert_allclose(g_got, g_want, rtol=1e-6, atol=1e-6)
    else:
        # the values are bf16 numbers: at most one bf16 step apart, most equal
        np.testing.assert_allclose(g_got, g_want, rtol=2.0**-7, atol=1e-30)
        assert np.mean(g_got == g_want) > 0.99
        # rounding each of row 7's 20+ contributions before the sum misses
        rounded_each = torch.from_numpy(g[:20]).to(torch.bfloat16).float().sum(0)
        if aggr == "SUM" and bag == 1:
            assert not np.array_equal(rounded_each.numpy(), g_want[7])


def _cfg(pkg, sizes=(500, 12000, 40000, 9000), bs=64):
    """tests/test_packed_update.py::test_onehot_packed_midband_training_matches_baseline."""
    return pkg.DLRMConfig(sparse_feature_size=16, embedding_size=list(sizes), embedding_bag_size=1,
                          mlp_bot=[13, 64, 16], mlp_top=[(len(sizes) + 1) * 16, 64, 1],
                          arch_interaction_op="cat", batch_size=bs)


def _model(pkg, opt, pthr=16384, **ffkw):
    dlrm = port_dlrm if pkg is port else ref_dlrm
    kw = dict(batch_size=64, compute_dtype="float32", onehot_packed_threshold=pthr, packed_tables="off") | ffkw
    m = dlrm.make_dlrm_model(_cfg(dlrm), pkg.FFConfig(**kw), **({"device": "cpu"} if pkg is port else {}))
    m.compile(opt, pkg.LossType.LOSS_BINARY_CROSSENTROPY, [pkg.MetricsType.METRICS_ACCURACY])
    return m


def _flags(m):
    return {op.name: op.onehot_packed for op in m.graph.compute_ops if isinstance(op, port_emb.Embedding)}


def test_onehot_packed_midband_training_matches_baseline():
    """tests/test_packed_update.py:465 in the port: 12000 and 9000 are
    mid-band, 500 stays on the narrow one-hot path, 40000 on the sparse
    path; weight IO stays [V, D]; the losses equal the base model's, whose
    four tables start from the same weights."""
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), 64, seed=0)
    base = _model(port, port.SGDOptimizer(lr=0.05), pthr=0)
    mid = _model(port, port.SGDOptimizer(lr=0.05))
    assert not any(_flags(base).values())
    assert _flags(mid) == {"table_0": False, "table_1": True, "table_2": False, "table_3": True}
    assert [op.name for op in mid._sparse_ops] == ["table_2"]
    assert mid.get_weights("table_1")["weight"].shape == (12000, 16)
    mid.set_parameters({op: base.get_weights(op) for op in base.get_parameters()})
    losses = {m: [float(m.train_batch(feeds, labels)) for _ in range(4)] for m in (base, mid)}
    np.testing.assert_allclose(losses[mid], losses[base], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "adagrad"])
def test_midband_training_matches_the_jax_package(rule):
    """4 steps of both packages' mid-band models from carried weights (the
    JAX package's get_weights unpacks its [P, 128] tables): the dense rule
    updates every row of a mid-band table (Adam decays all moments;
    AdaGrad keeps one accumulator per 128-lane line, as the packed table's
    dense AdaGrad does)."""
    name, kw = {"sgd": ("SGDOptimizer", dict(lr=0.05)),
                "momentum": ("SGDOptimizer", dict(lr=0.05, momentum=0.9)),
                "adam": ("AdamOptimizer", dict(alpha=0.01)),
                "adagrad": ("RowWiseAdagradOptimizer", dict(lr=0.05))}[rule]
    rm, pm = _model(ref, getattr(ref, name)(**kw)), _model(port, getattr(port, name)(**kw))
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), 64 * 4, seed=2)
    loose = rule in ("adam", "adagrad")
    for i in range(4):
        sl = slice(64 * i, 64 * (i + 1))
        b = ({k: v[sl] for k, v in feeds.items()}, labels[sl])
        np.testing.assert_allclose(float(pm.train_batch(*b)), float(rm.train_batch(*b)), rtol=1e-5, atol=1e-6)
    if rule == "adagrad":
        acc = pm._opt_state["dense"]["acc"]["table_1"]["weight"]
        assert acc.shape == (12000 * 16 // 128,)
        np.testing.assert_allclose(acc.numpy(), np.asarray(rm._opt_state["dense"]["acc"]["table_1"]["weight"])[:1500],
                                   rtol=1e-5, atol=1e-7)
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            # Adam's and AdaGrad's divisions and square roots, an ulp
            # apart in the two packages, carried over 4 steps
            np.testing.assert_allclose(pm.get_weights(op)[k], v, rtol=0, atol=1e-5 if loose else 1e-6)


def test_rowwise_adagrad_keeps_per_line_accumulators_only_for_the_tables_it_is_told_of():
    """`init(line_rows=)` builds one accumulator per 128-lane line for the
    named tables and one per row elsewhere; `update` takes the per-line
    rule from the same map, so an accumulator of another shape raises
    instead of silently taking it."""
    opt = port.RowWiseAdagradOptimizer(lr=0.05)
    rng = np.random.default_rng(8)
    params = {t: {"weight": torch.from_numpy(rng.standard_normal((1000, 16)).astype(np.float32))}
              for t in ("mid", "row")}
    grads = {t: {"weight": torch.from_numpy(rng.standard_normal((1000, 16)).astype(np.float32))} for t in params}
    st = opt.init(params, "cpu", line_rows={"mid": 8})
    assert st["acc"]["mid"]["weight"].shape == (125,) and st["acc"]["row"]["weight"].shape == (1000,)
    st = opt.update(grads, st, params, line_rows={"mid": 8})
    lines = grads["mid"]["weight"].reshape(125, 128)
    torch.testing.assert_close(st["acc"]["mid"]["weight"], (lines * lines).mean(dim=1), rtol=1e-6, atol=0)
    with pytest.raises(RuntimeError):
        opt.update(grads, st, params)


def test_midband_train_chunk_matches_the_jax_train_chunk():
    rm, pm = _model(ref, ref.AdamOptimizer(alpha=0.01)), _model(port, port.AdamOptimizer(alpha=0.01))
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), 64 * 3, seed=4)
    stacked = {k: v.reshape((3, 64) + v.shape[1:]) for k, v in feeds.items()}
    r = float(rm.train_chunk(stacked, labels.reshape(3, 64, 1)))
    p = float(pm.train_chunk(stacked, labels.reshape(3, 64, 1)))
    np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)
    assert pm._step_count == 3


def test_midband_table_stays_f32_and_host_tail_tables_are_not_midband():
    """table_dtype bf16 touches only row-update route tables; a table over
    host_tail_threshold is a host-tail table, never mid-band."""
    m = _model(port, port.SGDOptimizer(lr=0.05), table_dtype="bfloat16", packed_tables="on", packed_min_rows=0)
    assert _flags(m)["table_1"] and m.get_parameters()["table_1"]["weight"].dtype == torch.float32
    assert m.get_parameters()["table_2"]["weight"].dtype == torch.bfloat16
    ht = _model(port, port.SGDOptimizer(lr=0.05), host_tail_threshold=10000, host_tail_cap_frac=1.0)
    assert _flags(ht) == {"table_0": False, "table_1": False, "table_2": False, "table_3": True}
    assert {op.name for op in ht._sparse_ops} == {"table_1", "table_2"}


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
def test_midband_checkpoint_written_by_the_jax_package_restores_into_the_port(tmp_path, rule):
    """The JAX package saves its mid-band tables packed [P, 128], and with
    them the dense optimizer's state of those tables (Adam's m and v
    [P, 128], AdaGrad's per-line accumulator [P]); the port unpacks them
    on restore, and its next step matches the JAX package's."""
    name, kw = ("AdamOptimizer", dict(alpha=0.01)) if rule == "adam" else ("RowWiseAdagradOptimizer", dict(lr=0.05))
    rm = _model(ref, getattr(ref, name)(**kw))
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), 64 * 3, seed=6)
    batches = [({k: v[64 * i:64 * (i + 1)] for k, v in feeds.items()}, labels[64 * i:64 * (i + 1)]) for i in range(3)]
    for b in batches[:2]:
        rm.train_batch(*b)
    ref_checkpoint.save_checkpoint(str(tmp_path / "jax"), rm)
    assert np.asarray(rm.get_parameters()["table_1"]["weight"]).shape[1] == 128
    pm = _model(port, getattr(port, name)(**kw))
    restore_checkpoint(str(tmp_path / "jax"), pm)
    np.testing.assert_array_equal(pm.get_weights("table_1")["weight"], rm.get_weights("table_1")["weight"])
    np.testing.assert_allclose(float(pm.train_batch(*batches[2])), float(rm.train_batch(*batches[2])),
                               rtol=1e-5, atol=1e-5)


def test_params_from_jax_unpacks_packed_tables():
    rm = _model(ref, ref.SGDOptimizer(lr=0.05))
    pm = _model(port, port.SGDOptimizer(lr=0.05))
    raw = {op: {k: np.asarray(v) for k, v in sub.items()} for op, sub in rm.get_parameters().items()}
    assert raw["table_1"]["weight"].shape[1] == 128
    pm.set_parameters(params_from_jax(raw, like=pm.get_parameters()))
    np.testing.assert_array_equal(pm.get_weights("table_1")["weight"], rm.get_weights("table_1")["weight"])
    assert unpack_like(np.arange(10.0), (4,)).tolist() == [0, 1, 2, 3]
    assert unpack_like(np.zeros((3, 5)), (2, 2)).shape == (3, 5)  # not a packed layout: as it is
