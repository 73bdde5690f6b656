"""Host-tail offload in the port (parallel/host_tail.py, parallel/passes.py,
`FFModel` under `host_tail_threshold`, training/host_offload.py) against
the JAX package, on the CPU.

The port's store is a copy of the JAX package's: from one seed it holds
the same rows bit for bit, and `build_feeds` gives the same (pos, val) and
drop counts. Whole models run from carried weights (the hot prefixes by
`convert.params_from_jax`; the stores from the seed), in f32: the same
operations but for the order of f32 sums, so losses agree within rtol 1e-5
and atol 1e-6 and weights within 1e-6 under SGD; row-wise AdaGrad's
reciprocal square roots (XLA's and torch's, an ulp apart) grow that to
rtol 1e-4 and atol 1e-5, the JAX package's own bound for its AdaGrad
host-tail test. Against the port's own full-device model the partition is
invisible: the same tolerances as tests/test_host_tail.py. The cases of
tests/test_host_tail.py follow, one port test each.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm
from dlrm_flexflow_tpu.parallel import host_tail as ref_ht
from dlrm_flexflow_tpu.training import checkpoint as ref_checkpoint

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm
from dlrm_flexflow_tpu_torch.ops import embedding as port_emb
from dlrm_flexflow_tpu_torch.parallel import host_tail as port_ht
from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from dlrm_flexflow_tpu_torch.training.host_offload import HostOffloadTrainer, build_host_offload_dlrm

VOCABS, HOT, BS = [50, 200, 120], 40, 16


def _cfg(pkg, vocabs=VOCABS, bs=BS, bag=2, dim=8):
    """tests/test_host_tail.py::_cfg."""
    return pkg.DLRMConfig(sparse_feature_size=dim, embedding_size=list(vocabs), embedding_bag_size=bag,
                          mlp_bot=[4, 16, dim], mlp_top=[(len(vocabs) + 1) * dim, 16, 1], batch_size=bs)


def _ffkw(hot=HOT, **kw):
    return dict(batch_size=BS, compute_dtype="float32", host_tail_threshold=hot, host_tail_cap_frac=1.0,
                onehot_embedding_threshold=0, packed_tables="off") | kw


def _model(pkg, opt, ffkw, vocabs=VOCABS, bag=2, sparse=None):
    dlrm = port_dlrm if pkg is port else ref_dlrm
    m = dlrm.make_dlrm_model(_cfg(dlrm, vocabs, ffkw["batch_size"], bag), pkg.FFConfig(**ffkw),
                             **({"device": "cpu"} if pkg is port else {}))
    m.compile(opt, pkg.LossType.LOSS_BINARY_CROSSENTROPY, [pkg.MetricsType.METRICS_ACCURACY],
              sparse_optimizer=sparse)
    return m


def _batches(steps, vocabs=VOCABS, bs=BS, bag=2, seed=3):
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm, vocabs, bs, bag), bs * steps, seed=seed)
    return [({k: v[bs * i:bs * (i + 1)] for k, v in feeds.items()}, labels[bs * i:bs * (i + 1)])
            for i in range(steps)]


def _embs(m):
    return [op for op in m.graph.compute_ops if isinstance(op, port_emb.Embedding)]


def _preseed(m, vocabs, tail, hot=HOT):
    """tests/test_host_tail.py::_train_models: every table from a shared
    seed; on a host-tail model the hot prefix on the device and the tail
    rows loaded into the store."""
    for t, op in enumerate(_embs(m)):
        full = np.random.RandomState(100 + t).randn(vocabs[t], 8).astype(np.float32) * 0.05
        if tail and op.host_tail_vocab:
            m.set_weights(op.name, {"weight": full[:hot]})
            m._host_tail.entries[op.name][0].load_state(np.arange(hot, vocabs[t]), full[hot:])
        else:
            m.set_weights(op.name, {"weight": full})


def _pair_with_full(opt_factory, vocabs=VOCABS, hot=HOT, cap=1.0, packed="off", sparse=None):
    """A full-device model and a host-tail model with the same effective
    tables and the same dense towers (the port draws every parameter from
    one generator in graph order, so the shrunk tables shift the towers'
    draws: they are copied over)."""
    models = {}
    for tail in (False, True):
        m = _model(port, opt_factory(), _ffkw(hot if tail else 0, packed_tables=packed, host_tail_cap_frac=cap),
                   vocabs, sparse=sparse() if sparse else None)
        _preseed(m, vocabs, tail, hot)
        models[tail] = m
    for op in models[False].get_parameters():
        if not op.startswith("table_"):
            models[True].set_weights(op, models[False].get_weights(op))
    return models


def _losses(m, batches):
    return [float(m.train_batch(*b)) for b in batches]


# ----------------------------------------------------------------- the store and the runtime


def test_store_rows_equal_the_jax_store_bit_for_bit():
    """One seed, the same touches: lookups (creating and not), scatter_add,
    row-wise AdaGrad steps and the checkpoint state agree bit for bit."""
    rng = np.random.default_rng(0)
    r, p = ref_ht.HostTailStore(16, 0.05, seed=1003, acc_init=0.1), port_ht.HostTailStore(16, 0.05, seed=1003,
                                                                                            acc_init=0.1)
    for step in range(4):
        rows = rng.integers(1000, 5_000_000_000, 300)
        rows[:40] = rows[0]  # duplicates
        np.testing.assert_array_equal(p.lookup(rows, create=step % 2 == 0), r.lookup(rows, create=step % 2 == 0))
        g = rng.standard_normal((300, 16)).astype(np.float32)
        r.scatter_add(rows, -0.01 * g)
        p.scatter_add(rows, -0.01 * g)
        r.rowwise_adagrad_step(rows[::2], g[::2], 0.05, 1e-10)
        p.rowwise_adagrad_step(rows[::2], g[::2], 0.05, 1e-10)
    assert p.touched_rows == r.touched_rows
    for a, b in zip(p.state(), r.state()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bag, cap", [(1, 64), (3, 16)], ids=["bag1-roomy", "bag3-overflow"])
def test_build_feeds_and_drop_counts_equal_the_jax_runtime(bag, cap):
    rng = np.random.default_rng(bag)
    rts = []
    for mod in (ref_ht, port_ht):
        rt = mod.HostTailRuntime(rule="sgd")
        rt.add("t", mod.HostTailStore(8, 0.1, seed=5), "sparse_0", 100, 1000, cap)
        rts.append(rt)
    for step in range(3):
        idx = rng.integers(-1, 1100, (32, bag))
        got = [rt.build_feeds({"sparse_0": idx}, train=step != 1) for rt in rts]
        assert got[0].keys() == got[1].keys() == {"_hosttail:t:pos", "_hosttail:t:val"}
        for k in got[0]:
            np.testing.assert_array_equal(got[1][k], got[0][k])
    assert (rts[1].dropped, rts[1].total) == (rts[0].dropped, rts[0].total)
    assert rts[1].drop_fraction == rts[0].drop_fraction
    assert (rts[1].dropped > 0) == (bag == 3)


def test_store_demand_allocation_deterministic():
    """tests/test_host_tail.py::test_store_demand_allocation_deterministic."""
    s1, s2 = port_ht.HostTailStore(8, scale=0.1, seed=7), port_ht.HostTailStore(8, scale=0.1, seed=7)
    rows = np.asarray([5, 900_000_000_000, 5, 31])
    a = s1.lookup(rows)
    assert s1.touched_rows == 3
    np.testing.assert_array_equal(a[0], a[2])
    np.testing.assert_array_equal(s2.lookup(rows[::-1])[::-1], a)
    assert np.all(np.abs(a) <= 0.1) and np.std(a) > 0
    s1.scatter_add(np.asarray([5, 5]), np.ones((2, 8), np.float32))
    np.testing.assert_allclose(s1.lookup(np.asarray([5]))[0], a[0] + 2.0)
    s3 = port_ht.HostTailStore(8, scale=0.1, seed=7)
    s3.load_state(*s1.state())
    np.testing.assert_array_equal(s3.lookup(rows), s1.lookup(rows))


@pytest.mark.parametrize("bag", [1, 3])
def test_tail_partials_add_as_the_jax_scatter_adds(bag):
    """`add_tail_partials` against `pooled.at[pos].add(val, mode="drop")`:
    with bags of 3 an example holds up to 3 partials, added in their order
    (pass by pass), bit for bit; pos == B drops."""
    rng = np.random.default_rng(bag)
    b, k, d = 8, 12, 4
    pooled = rng.standard_normal((b, d)).astype(np.float32)
    # at most `bag` partials an example, ascending as np.nonzero gives them
    pos = np.repeat(np.arange(b), rng.integers(0, bag + 1, b))[:k - 4]
    pos = np.concatenate([pos, np.full(k - pos.shape[0], b)]).astype(np.int32)
    val = (rng.standard_normal((k, d)) * 1e3).astype(np.float32)
    want = np.asarray(jnp.asarray(pooled).at[jnp.asarray(pos)].add(jnp.asarray(val), mode="drop"))
    got = port_emb.add_tail_partials(torch.from_numpy(pooled.copy()), torch.from_numpy(pos),
                                     torch.from_numpy(val), bag)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bag, cap", [(1, 64), (2, 48)], ids=["bag1", "bag2-overflow"])
def test_rank_blocks_of_the_partials_add_as_the_whole_batch(bag, cap):
    """A global batch's partials (`build_feeds` of 32 examples, hot 100 of
    1000 rows) split into the blocks of 4 ranks (`rank_block`): each
    block's pos lies in [0, 8], its filled slots come first and, shifted
    back by the slice start, concatenate to the global list in order, and
    every other slot is empty (pos 8, val 0). Each rank's
    `add_tail_partials` of its block on its slice of the pooled outputs
    adds what the whole batch's call adds there, bit for bit: with bags of
    2 an example holds up to 2 partials, and at K_cap 48 some drop."""
    rng = np.random.default_rng(bag)
    b, n, d = 32, 4, 4
    rt = port_ht.HostTailRuntime(rule="sgd")
    rt.add("t", port_ht.HostTailStore(d, 0.1, seed=7), "sparse_0", 100, 1000, cap)
    feeds = rt.build_feeds({"sparse_0": rng.integers(-1, 1000, (b, bag))})
    pos, val = feeds["_hosttail:t:pos"], feeds["_hosttail:t:val"]
    filled = int((pos < b).sum())
    assert filled == cap if bag == 2 else filled < cap
    pooled = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    whole = port_emb.add_tail_partials(pooled.clone(), torch.from_numpy(pos), torch.from_numpy(val), bag)
    parts = []
    for r in range(n):
        p, v = port_ht.rank_block(pos, val, b, r, n)
        assert p.shape == pos.shape and v.shape == val.shape and p.dtype == np.int32
        assert p.min() >= 0 and p.max() <= b // n
        k = int((p < b // n).sum())
        assert np.all(p[k:] == b // n) and not v[k:].any()
        parts.append((p[:k] + r * (b // n), v[:k]))
        sl = slice(r * (b // n), (r + 1) * (b // n))
        got = port_emb.add_tail_partials(pooled[sl].clone(), torch.from_numpy(p), torch.from_numpy(v), bag)
        assert torch.equal(got, whole[sl])
    np.testing.assert_array_equal(np.concatenate([p for p, _ in parts]), pos[:filled])
    np.testing.assert_array_equal(np.concatenate([v for _, v in parts]), val[:filled])


# ----------------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("rule", ["sgd", "adagrad"])
def test_host_tail_training_matches_the_jax_package(rule):
    """4 steps of both packages' host-tail models from carried hot prefixes
    and seeded stores (equal bit for bit at the start); losses, hot
    prefixes and every touched tail row compared."""
    def opts(pkg):
        return pkg.SGDOptimizer(lr=0.05) if rule == "sgd" else pkg.RowWiseAdagradOptimizer(lr=0.05)

    rm = _model(ref, opts(ref), _ffkw(fuse_embeddings=False))
    pm = _model(port, opts(port), _ffkw())
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    assert set(pm._host_tail.entries) == set(rm._host_tail.entries) == {"table_0", "table_1", "table_2"}
    assert pm._host_tail.rule == rm._host_tail.rule
    for name, (store, sfeed, hot, full, k_cap) in pm._host_tail.entries.items():
        rstore, *rest = rm._host_tail.entries[name]
        assert (sfeed, hot, full, k_cap) == tuple(rest) and store.scale == rstore.scale
    rtol, atol = (1e-5, 1e-6) if rule == "sgd" else (1e-4, 1e-5)
    for b in _batches(4):
        np.testing.assert_allclose(float(pm.train_batch(*b)), float(rm.train_batch(*b)), rtol=rtol, atol=atol)
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            np.testing.assert_allclose(pm.get_weights(op)[k], v, rtol=0, atol=atol)
    for name, (store, *_) in pm._host_tail.entries.items():
        rows, vals, acc = store.state()
        r_rows, r_vals, r_acc = rm._host_tail.entries[name][0].state()
        np.testing.assert_array_equal(rows, r_rows)
        np.testing.assert_allclose(vals, r_vals, rtol=0, atol=atol)
        np.testing.assert_allclose(acc, r_acc, rtol=rtol, atol=atol)
    assert (pm._host_tail.total, pm.host_tail_dropped) == (rm._host_tail.total, rm.host_tail_dropped)


def test_host_tail_checkpoint_written_by_the_jax_package_restores_into_the_port(tmp_path):
    """The JAX package trains 2 AdaGrad steps and saves (its stores in
    host_tail.npz); the port restores the directory and its next step
    matches the JAX package's."""
    rm = _model(ref, ref.RowWiseAdagradOptimizer(lr=0.05), _ffkw(fuse_embeddings=False))
    batches = _batches(3, seed=5)
    for b in batches[:2]:
        rm.train_batch(*b)
    ref_checkpoint.save_checkpoint(str(tmp_path / "jax"), rm)
    pm = _model(port, port.RowWiseAdagradOptimizer(lr=0.05), _ffkw())
    assert restore_checkpoint(str(tmp_path / "jax"), pm)["host_tail"] is True
    for name, (store, *_) in pm._host_tail.entries.items():
        for a, b in zip(store.state(), rm._host_tail.entries[name][0].state()):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(pm.train_batch(*batches[2])), float(rm.train_batch(*batches[2])),
                               rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- the cases of tests/test_host_tail.py


def test_host_tail_matches_full_device_model():
    models = _pair_with_full(lambda: port.SGDOptimizer(lr=0.05))
    batches = _batches(5)
    losses = {tail: _losses(m, batches) for tail, m in models.items()}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5, atol=1e-6)
    assert models[True].host_tail_dropped == 0
    for op_a, op_b in zip(_embs(models[False]), _embs(models[True])):
        wa = models[False].get_weights(op_a.name)["weight"]
        wb = models[True].get_weights(op_b.name)["weight"]
        np.testing.assert_allclose(wa[: wb.shape[0]], wb, rtol=1e-5, atol=1e-6)
        if op_b.host_tail_vocab:
            store = models[True]._host_tail.entries[op_b.name][0]
            np.testing.assert_allclose(store.lookup(np.arange(HOT, op_b.host_tail_vocab)), wa[HOT:],
                                       rtol=1e-5, atol=1e-6)


def test_host_tail_on_the_row_update_route_matches_full_device_model():
    """tests/test_host_tail.py::test_host_tail_packed_matches_full_device_model:
    the host-tail tables on the row-update kernel route (its plain version
    here), whose stream drops the rows >= the hot prefix."""
    models = _pair_with_full(lambda: port.SGDOptimizer(lr=0.05), packed="on")
    assert all(op.kernel_route for op in models[True]._sparse_ops)
    batches = _batches(3)
    losses = {tail: _losses(m, batches) for tail, m in models.items()}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4, atol=1e-5)
    assert models[True].host_tail_dropped == 0


def test_host_tail_capacity_overflow_counted():
    models = _pair_with_full(lambda: port.SGDOptimizer(lr=0.05), vocabs=[64, 1000], hot=8, cap=0.25)
    losses = _losses(models[True], _batches(3, vocabs=[64, 1000]))
    m = models[True]
    assert m.host_tail_dropped > 0 and 0.0 < m.host_tail_drop_fraction() < 1.0
    assert all(np.isfinite(losses))


def test_host_tail_memory_is_touched_rows_only():
    vocabs = [100_000_000, 50]
    m = _model(port, port.SGDOptimizer(lr=0.05), _ffkw(1000), vocabs, bag=1)
    rng = np.random.RandomState(0)
    feeds = {"dense_features": rng.rand(BS, 4).astype(np.float32),
             "sparse_0": rng.randint(0, 100_000_000, (BS, 1)), "sparse_1": rng.randint(0, 50, (BS, 1))}
    labels = rng.randint(0, 2, (BS, 1)).astype(np.float32)
    assert np.isfinite(float(m.train_batch(feeds, labels)))
    store = next(iter(m._host_tail.entries.values()))[0]
    assert 0 < store.touched_rows <= BS
    assert m.get_parameters()["table_0"]["weight"].shape == (1000, 8)
    assert np.isfinite(float(m.eval_batch(feeds, labels)))


def test_host_tail_under_onehot_threshold_stays_on_sparse_path():
    m = _model(port, port.SGDOptimizer(lr=0.05), _ffkw(onehot_embedding_threshold=8192))
    assert {op.name for op in m._sparse_ops} == {"table_0", "table_1", "table_2"}
    assert min(op.num_entries for op in m._sparse_ops) == HOT <= 8192
    assert np.isfinite(float(m.train_batch(*_batches(1, seed=4)[0])))


@pytest.mark.parametrize("opt", [port.AdamOptimizer(alpha=0.01), port.SGDOptimizer(lr=0.05, weight_decay=0.01),
                                 port.SGDOptimizer(lr=0.05, momentum=0.9)], ids=["adam", "sgd-wd", "momentum"])
def test_host_tail_refuses_stateful_optimizers(opt):
    """The JAX package asserts; the port raises ValueError naming the rule."""
    m = port_dlrm.make_dlrm_model(_cfg(port_dlrm), port.FFConfig(**_ffkw()), device="cpu")
    with pytest.raises(ValueError, match="plain SGD .* or row-wise AdaGrad"):
        m.compile(opt, port.LossType.LOSS_BINARY_CROSSENTROPY)


def test_host_tail_eval_does_not_pollute_drop_counters():
    m = _pair_with_full(lambda: port.SGDOptimizer(lr=0.05))[True]
    _losses(m, _batches(2))
    ht = m._host_tail
    before = (ht.total, ht.dropped, sum(e[0].touched_rows for e in ht.entries.values()))
    feeds, labels = _batches(1, seed=77)[0]
    m.eval_batch(feeds, labels)
    m.forward(feeds)
    assert np.isfinite(m.predict(feeds)).all()
    assert (ht.total, ht.dropped, sum(e[0].touched_rows for e in ht.entries.values())) == before


def test_host_tail_rowwise_adagrad_matches_full_device():
    models = _pair_with_full(lambda: port.RowWiseAdagradOptimizer(lr=0.05))
    batches = _batches(4)
    losses = {tail: _losses(m, batches) for tail, m in models.items()}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4, atol=1e-5)
    assert models[True]._host_tail.rule == "rowwise_adagrad"


def test_host_tail_lr_follows_distinct_sparse_optimizer():
    """Adam on the dense towers, SGD at 0.1 on the tables: the host half
    steps at the sparse rate, whatever the dense rate is set to."""
    models = _pair_with_full(lambda: port.AdamOptimizer(alpha=0.001), sparse=lambda: port.SGDOptimizer(lr=0.1))
    m = models[True]
    g, rate = m._host_tail_readback({}, m._step_scalars())
    assert g == {} and rate == pytest.approx(0.1)
    for mm in models.values():
        mm.set_learning_rate(0.5)  # the dense rate only
    batches = _batches(4)
    losses = {tail: _losses(mm, batches) for tail, mm in models.items()}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5, atol=1e-6)


def test_host_tail_follows_set_learning_rate():
    """Without a distinct sparse optimizer the tail rows step at the dense
    state's rate, read back with g_val after set_learning_rate."""
    models = _pair_with_full(lambda: port.SGDOptimizer(lr=0.05))
    for m in models.values():
        m.set_learning_rate(0.2)
    batches = _batches(3)
    losses = {tail: _losses(m, batches) for tail, m in models.items()}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5, atol=1e-6)
    assert models[True]._host_tail_readback({}, models[True]._step_scalars())[1] == np.float32(0.2)


def test_host_tail_hot_prefix_init_uses_full_table_fan():
    vocabs, dim = [10_000], 8
    m = port_dlrm.make_dlrm_model(_cfg(port_dlrm, vocabs, dim=dim),
                                  port.FFConfig(**_ffkw(64), ), device="cpu")
    m.compile(port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY)
    op = next(o for o in _embs(m) if o.host_tail_vocab)
    limit = np.sqrt(6.0 / (vocabs[0] + dim))
    w = m.get_weights(op.name)["weight"]
    assert w.shape == (64, dim) and np.abs(w).max() <= limit * (1 + 1e-6)
    assert m._host_tail.entries[op.name][0].scale == pytest.approx(limit, rel=1e-6)
    assert np.std(w) == pytest.approx(limit / np.sqrt(3.0), rel=0.2)


def test_host_tail_drops_out_of_vocab_indices():
    m = _model(port, port.SGDOptimizer(lr=0.05), _ffkw(batch_size=8), bag=2)
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm, bs=8), 8, seed=0)
    for name, (store, sfeed, h, full, _) in m._host_tail.entries.items():
        feeds[sfeed] = np.array(feeds[sfeed])
        feeds[sfeed][0] = full + 1000
    assert np.isfinite(float(m.train_batch(feeds, labels)))
    for name, (store, *_rest) in m._host_tail.entries.items():
        full = _rest[2]
        assert (np.fromiter(store._slot.keys(), np.int64, len(store._slot)) < full).all()


def test_host_tail_checkpoint_roundtrip(tmp_path):
    batches = _batches(3, seed=5)
    m1 = _model(port, port.RowWiseAdagradOptimizer(lr=0.05), _ffkw())
    for b in batches[:2]:
        m1.train_batch(*b)
    save_checkpoint(str(tmp_path / "ck"), m1)
    l1 = float(m1.train_batch(*batches[2]))
    m2 = _model(port, port.RowWiseAdagradOptimizer(lr=0.05), _ffkw())
    m2.set_parameters({op: {k: np.asarray(v) for k, v in m1.get_weights(op).items()}
                       for op in m1.get_parameters()})  # overwritten by the restore
    assert restore_checkpoint(str(tmp_path / "ck"), m2)["host_tail"] is True
    assert float(m2.train_batch(*batches[2])) == l1
    for name, (s1, *_r) in m1._host_tail.entries.items():
        for a, b in zip(s1.state(), m2._host_tail.entries[name][0].state()):
            np.testing.assert_array_equal(a, b)


def test_train_chunk_refuses_a_host_tail_model():
    m = _model(port, port.SGDOptimizer(lr=0.05), _ffkw())
    feeds, labels = _batches(1)[0]
    with pytest.raises(RuntimeError, match="host-tail offload steps one batch"):
        m.train_chunk({k: v[None] for k, v in feeds.items()}, labels[None])
    with pytest.raises(RuntimeError, match="host-tail"):
        m.fit(feeds, labels, verbose=False, steps_per_call=2, batch_size=8)


def test_fit_trains_a_host_tail_model():
    m = _model(port, port.SGDOptimizer(lr=0.05), _ffkw())
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), BS * 3, seed=8)
    hist = m.fit(feeds, labels, epochs=2, verbose=False)
    assert hist["samples"] == BS * 3 and m._step_count == 6 and m._host_tail.total > 0


def test_train_batch_marks_each_phase_of_the_step_for_the_profiler():
    """A host-tail step's five phases are torch.profiler ranges, in the
    order `_eager_step` runs them, one of each a step; a model without a
    host tail has the first three."""
    from torch.profiler import ProfilerActivity, profile

    from dlrm_flexflow_tpu_torch.core.ffmodel import STEP_PHASES

    for hot, want in ((HOT, STEP_PHASES), (0, STEP_PHASES[:3])):
        m = _model(port, port.SGDOptimizer(lr=0.05), _ffkw(hot))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for b in _batches(2):
                m.train_batch(*b)
        seen = [e for e in prof.events() if e.name.startswith("step:")]
        assert [e.name for e in sorted(seen, key=lambda e: e.time_range.start)] == list(want) * 2


# ----------------------------------------------------------------- the whole-table host placement


def test_host_offload_matches_device_training():
    """tests/test_services.py::test_host_offload_matches_device_training."""
    cfg = port_dlrm.DLRMConfig(sparse_feature_size=8, embedding_size=[500, 40, 900], embedding_bag_size=2,
                               mlp_bot=[4, 16, 8], mlp_top=[32, 16, 1], batch_size=16)
    ffc = port.FFConfig(batch_size=16, compute_dtype="float32", seed=2, onehot_embedding_threshold=0)
    model, host_map = build_host_offload_dlrm(cfg, ffc, offload_threshold=600, device="cpu")
    assert len(host_map) == 1
    trainer = HostOffloadTrainer(model, host_map, lr=0.05).compile(
        port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY, [port.MetricsType.METRICS_ACCURACY])
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm, [500, 40, 900]), 64, seed=3)
    losses = [trainer.fit(feeds, labels, epochs=1)["loss"] for _ in range(4)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses
    assert np.abs(next(iter(host_map.values()))[0].table).max() > 0


def test_host_offload_step_matches_the_jax_trainer():
    """One HostOffloadTrainer step in both packages from carried weights
    and the same host table (drawn alike from its seed): the host inputs'
    gradients from autograd on leaves match jax.grad's, so the updated
    host tables agree."""
    from dlrm_flexflow_tpu.training import host_offload as ref_ho

    kw = dict(sparse_feature_size=8, embedding_size=[500, 40, 900], embedding_bag_size=2,
              mlp_bot=[4, 16, 8], mlp_top=[32, 16, 1], batch_size=16)
    ffkw = dict(batch_size=16, compute_dtype="float32", seed=2, onehot_embedding_threshold=0)
    rmod, rmap = ref_ho.build_host_offload_dlrm(ref_dlrm.DLRMConfig(**kw), ref.FFConfig(**ffkw), 600)
    rt = ref_ho.HostOffloadTrainer(rmod, rmap, lr=0.05).compile(ref.SGDOptimizer(lr=0.05))
    pmod, pmap = build_host_offload_dlrm(port_dlrm.DLRMConfig(**kw), port.FFConfig(**ffkw), 600, device="cpu")
    pt = HostOffloadTrainer(pmod, pmap, lr=0.05).compile(port.SGDOptimizer(lr=0.05))
    pmod.set_parameters(params_from_jax({op: rmod.get_weights(op) for op in rmod.get_parameters()}))
    np.testing.assert_array_equal(pmap["host_emb_2"][0].table, rmap["host_emb_2"][0].table)
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**kw), 32, seed=3)
    for i in range(2):
        b = ({k: v[16 * i:16 * (i + 1)] for k, v in feeds.items()}, labels[16 * i:16 * (i + 1)])
        np.testing.assert_allclose(pt.train_batch(*b), rt.train_batch(*b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pmap["host_emb_2"][0].table, rmap["host_emb_2"][0].table, rtol=0, atol=1e-6)
