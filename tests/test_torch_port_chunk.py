"""The multi-step call (`FFModel.train_chunk`, `fit(steps_per_call)`) on the CPU.

`train_chunk` against K `train_batch` calls of the port, bit for bit (on
the CPU it is a loop of the same step), and against the JAX package's
`train_chunk` (its scanned multi-step call) on the same stacks from carried
weights, within the tolerances of the port's training parity tests; fit
with steps_per_call=4 against steps_per_call=1 as tests/test_data.py checks
the JAX package; the per-step scalars, the in-place state that a captured
step relies on, and the packing of a chunk's stacks into the static buffer
of the CUDA graph; the scatter route's rules, whose tensors are all sized by
the update stream so that a graph captures them, against the JAX rules. The
graph itself is held against eager steps on the card in
tests/test_torch_port_cuda.py and chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.core import ffmodel as port_ffmodel
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm

BS = 32
RULES = {
    "sgd": (("SGDOptimizer", dict(lr=0.05)), None),
    "momentum": (("SGDOptimizer", dict(lr=0.05, momentum=0.9)), None),
    "adam": (("AdamOptimizer", dict(alpha=0.01)), None),
    "adam+adagrad": (("AdamOptimizer", dict(alpha=0.01)), ("RowWiseAdagradOptimizer", dict(lr=0.05))),
}


def _cfg(pkg):
    """Three tables on the sparse path (two above packed_min_rows' reach
    once "on") and one of 60 rows on the one-hot path."""
    return pkg.DLRMConfig(sparse_feature_size=16, embedding_size=[500, 300, 800, 60],
                          embedding_bag_size=2, mlp_bot=[4, 16, 16], mlp_top=[80, 16, 1],
                          batch_size=BS)


FFKW = dict(batch_size=BS, compute_dtype="float32", onehot_embedding_threshold=100, packed_tables="on")


def _model(rule, pkg=port, **ffkw):
    (name, kw), sparse = RULES[rule]
    dlrm = port_dlrm if pkg is port else ref_dlrm
    m = dlrm.make_dlrm_model(_cfg(dlrm), pkg.FFConfig(**{**FFKW, **ffkw}),
                             **({"device": "cpu"} if pkg is port else {}))
    m.compile(getattr(pkg, name)(**kw), pkg.LossType.LOSS_BINARY_CROSSENTROPY,
              [pkg.MetricsType.METRICS_ACCURACY, pkg.MetricsType.METRICS_AUC_ROC],
              sparse_optimizer=None if sparse is None else getattr(pkg, sparse[0])(**sparse[1]))
    return m


def _data(steps, seed=3):
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), BS * steps, seed=seed)
    stacked = {k: v.reshape((steps, BS) + v.shape[1:]) for k, v in feeds.items()}
    return feeds, labels, stacked, labels.reshape(steps, BS, 1)


def _tensors(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensors(v, f"{path}/{k}"))
        return out
    return {path: tree} if isinstance(tree, torch.Tensor) else {}


def _assert_same_state(a, b):
    """Parameters, optimizer state, metric totals and step counts equal bit
    for bit."""
    for name, tree_a, tree_b in (("params", a.get_parameters(), b.get_parameters()),
                                 ("opt", a._opt_state, b._opt_state),
                                 ("metrics", a._metrics_total, b._metrics_total)):
        ta, tb = _tensors(tree_a), _tensors(tree_b)
        assert ta.keys() == tb.keys()
        for k in ta:
            assert torch.equal(ta[k], tb[k]), f"{name}{k}"
    assert a._step_count == b._step_count
    st_a, st_b = (m._opt_state.get("dense", m._opt_state) for m in (a, b))
    assert st_a["step"] == st_b["step"] == a._step_count


@pytest.mark.parametrize("rule", list(RULES))
def test_train_chunk_equals_k_train_batch_calls(rule):
    """A chunk of 4 and a tail chunk of 2 give the same bits as 6 steps,
    with the rate changed between the chunks; the loss is the last step's,
    a copy."""
    feeds, labels, stacked, slabels = _data(6)
    eager, chunk = _model(rule), _model(rule)
    losses = []
    for i in range(6):
        if i == 4:
            eager.set_learning_rate(0.02)
        sl = slice(BS * i, BS * (i + 1))
        losses.append(eager.train_batch({k: v[sl] for k, v in feeds.items()}, labels[sl]))
    first = chunk.train_chunk({k: v[:4] for k, v in stacked.items()}, slabels[:4])
    chunk.set_learning_rate(0.02)
    last = chunk.train_chunk({k: v[4:] for k, v in stacked.items()}, slabels[4:])
    assert first.dim() == 0 and torch.equal(first, losses[3]) and torch.equal(last, losses[5])
    _assert_same_state(eager, chunk)
    assert chunk.get_metrics() == eager.get_metrics()


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_train_chunk_matches_the_jax_train_chunk(rule):
    """Two chunks (4, then a tail of 2) in both packages from carried
    weights, on the scatter route (the kernel route's steps are held
    against the JAX package's in test_torch_port_training.py and
    test_torch_port_sparse_optim.py; here the scan is the point). f32
    compute: the same operations in another summation order, as in
    test_small_dlrm_trajectory_matches_reference."""
    _, _, stacked, slabels = _data(6, seed=4)
    rm, pm = _model(rule, ref, packed_tables="off"), _model(rule, packed_tables="off")
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    for sl in (slice(0, 4), slice(4, 6)):
        r = float(rm.train_chunk({k: v[sl] for k, v in stacked.items()}, slabels[sl]))
        p = float(pm.train_chunk({k: v[sl] for k, v in stacked.items()}, slabels[sl]))
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            np.testing.assert_allclose(pm.get_weights(op)[k], np.asarray(v, np.float32), rtol=0,
                                       atol=1e-5 if rule == "adam" else 1e-6)
    assert pm._step_count == int(rm._step_count) == 6
    assert pm.get_metrics()["samples"] == rm.get_metrics()["samples"]


def test_train_chunk_uses_stacked_routes_under_host_routing():
    """Stacks that carry each batch's `compute_routes` (the JAX package's
    `_route:` feed keys, [K, n]) train as host-routed steps do."""
    feeds, labels, stacked, slabels = _data(4, seed=5)
    eager, chunk = _model("sgd", host_routing=True), _model("sgd", host_routing=True)
    routes = [chunk.compute_routes({k: v[i] for k, v in stacked.items()}) for i in range(4)]
    assert routes[0] and all(k.startswith("_route:") for k in routes[0])
    stacked = {**stacked, **{k: np.stack([r[k] for r in routes]) for k in routes[0]}}
    for i in range(4):
        eager.train_batch({k: v[i] for k, v in stacked.items()}, slabels[i])
    chunk.train_chunk(stacked, slabels)
    _assert_same_state(eager, chunk)


def test_set_parameters_and_reset_metrics_between_chunks_work_in_place():
    """What a captured step reads stays where it is: set_parameters and
    reset_metrics write into the tensors they find, and the next chunk
    gives what eager steps give."""
    feeds, labels, stacked, slabels = _data(4, seed=6)
    eager, chunk = _model("adam"), _model("adam")
    new = {op: {k: np.asarray(v) * 0.5 for k, v in eager.get_weights(op).items()}
           for op in eager.get_parameters()}
    ids = {k: id(t) for k, t in _tensors(chunk.get_parameters()).items()}
    totals = {k: id(t) for k, t in chunk._metrics_total.items()}
    for m in (eager, chunk):
        m.train_batch({k: v[0] for k, v in stacked.items()}, slabels[0])
        m.set_parameters(new)
        m.reset_metrics()
    assert all(float(t.abs().sum()) == 0.0 for t in chunk._metrics_total.values())
    for i in range(1, 4):
        eager.train_batch({k: v[i] for k, v in stacked.items()}, slabels[i])
    chunk.train_chunk({k: v[1:] for k, v in stacked.items()}, slabels[1:])
    _assert_same_state(eager, chunk)
    assert ids == {k: id(t) for k, t in _tensors(chunk.get_parameters()).items()}
    assert totals == {k: id(t) for k, t in chunk._metrics_total.items()}


@pytest.mark.parametrize("steps_per_call, n", [(4, 8), (4, 7)], ids=["whole-chunks", "tail-chunk"])
def test_fit_steps_per_call_matches_per_step_fit(steps_per_call, n):
    """tests/test_data.py::test_scanned_fit_matches_per_step_fit: the same
    samples, parameters within rtol 1e-5 and atol 1e-6 (7 batches leave a
    tail stack of 3)."""
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), 16 * n, seed=3)

    def make():
        m = port_dlrm.make_dlrm_model(_cfg(port_dlrm), port.FFConfig(batch_size=16, compute_dtype="float32",
                                                                     seed=9), device="cpu")
        m.compile(port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY,
                  [port.MetricsType.METRICS_ACCURACY])
        return m

    m1, m2 = make(), make()
    h1 = m1.fit(feeds, labels, epochs=2, verbose=False, steps_per_call=1)
    h2 = m2.fit(feeds, labels, epochs=2, verbose=False, steps_per_call=steps_per_call)
    assert m1.get_metrics()["samples"] == m2.get_metrics()["samples"] == h2["samples"] == 16 * n
    assert np.isfinite(h2["accuracy"]) and h1["accuracy"] == pytest.approx(h2["accuracy"])
    for op in m1.get_parameters():
        for k, v in m1.get_weights(op).items():
            np.testing.assert_allclose(v, m2.get_weights(op)[k], rtol=1e-5, atol=1e-6)
    assert m2._step_count == 2 * n


def test_fit_with_validation_keeps_the_training_totals():
    feeds, labels = ref_synthetic.random_batches(_cfg(ref_dlrm), BS * 4, seed=7)
    m = _model("sgd")
    hist = m.fit(feeds, labels, epochs=1, verbose=False, steps_per_call=2,
                 validation_data=(feeds, labels))
    assert hist["samples"] == BS * 4 == hist["val_samples"]
    assert m.get_metrics()["samples"] == BS * 4


def test_train_chunk_refusals():
    _, _, stacked, slabels = _data(2)
    m = port_dlrm.make_dlrm_model(_cfg(port_dlrm), port.FFConfig(**FFKW), device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        m.train_chunk(stacked, slabels)
    m = _model("sgd")
    with pytest.raises(ValueError, match="no step"):
        m.train_chunk({k: v[:0] for k, v in stacked.items()}, slabels[:0])
    m.quantize_embeddings("bfloat16")
    with pytest.raises(RuntimeError, match="quantiz"):
        m.train_chunk(stacked, slabels)
    forced = port_dlrm.make_dlrm_model(_cfg(port_dlrm), port.FFConfig(**FFKW, use_pallas="on"), device="cpu")
    forced.compile(port.SGDOptimizer(lr=0.05))
    with pytest.raises(NotImplementedError, match="use_pallas='on'"):
        forced.train_chunk(stacked, slabels)


@pytest.mark.parametrize("rule", ["sgd", "adam", "adam+adagrad"])
def test_step_scalars_are_the_eager_bias_correction(rule):
    """The per-step scalars a step reads: none for SGD; Adam's f32
    sqrt(1 - beta2^t) and 1 - beta1^t (the dense optimizer's, then a
    distinct sparse optimizer's); the rate computed from them is the one
    `AdamOptimizer.alpha_t` gives for step t, bit for bit."""
    m = _model(rule)
    table = m._scalar_table(5, 3)
    assert table.dtype == np.float32 and table.shape == (3, 0 if rule == "sgd" else 2)
    if rule == "sgd":
        return
    opt = m.optimizer
    for i, t in enumerate(range(5, 8)):
        corr = np.sqrt(np.float32(1) - np.power(np.float32(opt.beta2), np.float32(t)))
        assert table[i, 0] == corr and table[i, 1] == np.float32(1) - np.power(np.float32(opt.beta1),
                                                                              np.float32(t))
        lr = torch.tensor(0.01)
        got = opt.alpha_t(lr, torch.from_numpy(table[i]), "cpu")
        want = lr * float(table[i, 0]) / float(table[i, 1])
        assert torch.equal(got, want)


def test_chunk_stacks_pack_into_the_static_buffer():
    """The static buffer's plan: each entry on a 16-byte boundary, its view
    the entry's bytes; a staged [k, bytes] row holds step i of every stack,
    whatever their dtype on the way in."""
    k = 3
    rng = np.random.default_rng(0)
    entries = [("dense_features", rng.standard_normal((k, 5, 3)).astype(np.float32), torch.float32),
               ("sparse_0", rng.integers(0, 9, (k, 5, 2)), torch.int64),
               ("_labels", torch.from_numpy(rng.integers(0, 2, (k, 5, 1)).astype(np.float32)), torch.float32),
               ("_route:t:rows", rng.integers(0, 9, (k, 7)).astype(np.int64), torch.int32),
               ("_scalars", np.zeros((k, 0), np.float32), torch.float32)]
    plan = port_ffmodel._StepGraph.plan(entries, k)
    assert [p[1] % 16 for p in plan] == [0] * 5
    assert [p[1] for p in plan] == [0, 64, 144, 176, 208]
    graph = port_ffmodel._StepGraph(torch.device("cpu"), plan, [])
    stacks = graph.stage(entries, k)
    assert stacks.shape == (k, graph.static.numel()) and graph.static.numel() == 208
    for i in range(k):
        graph.static.copy_(stacks[i])
        for key, stack, dt in entries:
            want = torch.as_tensor(stack)[i].to(dt)
            assert graph.views[key].dtype == dt and torch.equal(graph.views[key], want), key
    with pytest.raises(ValueError, match="stacks 2 steps"):
        port_ffmodel._StepGraph.plan(entries[:1] + [("x", np.zeros((2, 1)), torch.float32)], k)


# ----------------------------------------------------------------- the scatter route in a graph


SCATTER_RULES = {"sgd": ("SGDOptimizer", dict(lr=0.1)),
                 "sgd-wd": ("SGDOptimizer", dict(lr=0.1, weight_decay=0.01)),
                 "momentum": ("SGDOptimizer", dict(lr=0.1, momentum=0.9)),
                 "nesterov": ("SGDOptimizer", dict(lr=0.1, momentum=0.9, nesterov=True)),
                 "adam": ("AdamOptimizer", dict(alpha=0.01)),
                 "adagrad": ("RowWiseAdagradOptimizer", dict(lr=0.1))}


@pytest.mark.parametrize("stream", ["duplicates-and-dropped", "all-padding", "all-one-row"])
@pytest.mark.parametrize("rule", list(SCATTER_RULES))
def test_fixed_size_scatter_rules_match_the_jax_rules(rule, stream):
    """The scatter rules, every tensor sized by K (a CUDA graph captures
    them), against the JAX rules over 2 steps: duplicates (a run of 9),
    rows < 0 and >= V, a stream that is all padding (nothing moves), and
    one row K times. f32 sums of a row's duplicates in another order
    (rtol 1e-5, atol 1e-6, as test_scatter_rule_matches_jax_rule)."""
    name, kw = SCATTER_RULES[rule]
    r_opt, p_opt = getattr(ref, name)(**kw), getattr(port, name)(**kw)
    rng = np.random.default_rng(len(rule) + len(stream))
    v, d, k = 30, 4, 40
    table = rng.standard_normal((v, d)).astype(np.float32)
    r_t, r_s = jnp.asarray(table), r_opt.sparse_init((v, d))
    p_t = torch.from_numpy(table.copy())
    p_s = p_opt.sparse_init((v, d), "cpu")
    if p_s is not None and r_s is not None and rule != "adagrad":
        p_s.copy_(torch.from_numpy(np.abs(rng.standard_normal(tuple(p_s.shape))).astype(np.float32)))
        r_s = jnp.asarray(p_s.numpy())
    for step in range(2):
        rows = rng.integers(-3, v + 3, k).astype(np.int32)
        if stream == "duplicates-and-dropped":
            rows[:9] = 4
        elif stream == "all-padding":
            rows = np.where(np.arange(k) % 2 == 0, -1, v + 1).astype(np.int32)
        else:
            rows[:] = v - 1
        g = rng.standard_normal((k, d)).astype(np.float32)
        lr = 0.01 * (step + 1) if rule == "adam" else None
        # the JAX scatter (`.at[rows].add`) wraps a negative row around as
        # numpy indexing does, where its dedup drops it; the port drops it
        # on every rule (the model's streams mark padding V, never < 0)
        r_rows = np.where(rows < 0, v, rows) if rule in ("sgd", "sgd-wd", "adagrad") else rows
        r_t, r_s = r_opt.sparse_row_update(r_t, r_s, jnp.asarray(r_rows), jnp.asarray(g),
                                           lr=None if lr is None else jnp.float32(lr))
        p_s = p_opt.sparse_row_update(p_t, p_s, torch.from_numpy(rows), torch.from_numpy(g),
                                      lr=None if lr is None else torch.tensor(lr))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(r_t), rtol=1e-5, atol=1e-6)
    if r_s is not None:
        np.testing.assert_allclose(p_s.numpy(), np.asarray(r_s), rtol=1e-5, atol=1e-6)
    if stream == "all-padding":
        assert np.array_equal(p_t.numpy(), table)


def test_segments_are_sized_by_the_stream():
    """`_segments`: every output has K entries whatever the data; the
    padding slots point at slot 0 (one real row written twice with the same
    bits), and a stream that drops everything has no real segment."""
    from dlrm_flexflow_tpu_torch.training.optimizer import _segments

    g = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    for rows, want_rows, n in (([3, 1, 3, 9, -1, 1], [1, 3], 2), ([5, 5, 5, 5, 5, 5], [5], 1),
                               ([-1, 9, 7, -2, 8, 10], [], 0), ([0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 4, 5], 6)):
        row, valid, src, G, Sq = _segments(torch.tensor(rows), g, 6, squares=True)
        assert [t.shape[0] for t in (row, valid, src, G, Sq)] == [6] * 5
        assert row[valid].tolist() == want_rows and int(valid.sum()) == n
        assert src.tolist() == [i if i < n else 0 for i in range(6)]
        keep = [r for r in rows if 0 <= r < 6]
        for s, r in enumerate(want_rows):
            sel = [i for i, x in enumerate(rows) if x == r]
            assert torch.equal(G[s], g[sel].sum(0)) and torch.equal(Sq[s], (g[sel] ** 2).sum(0))
        assert int(row.max()) <= 5 and len(keep) >= n


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "adam+adagrad"])
def test_train_chunk_on_the_scatter_route_equals_k_train_batch_calls(rule):
    """A model whose tables take the scatter route (packed_tables="off")
    in chunks of 4 and 2 against 6 steps, bit for bit (on the card the
    chunk is one captured step replayed: tests/test_torch_port_cuda.py)."""
    feeds, labels, stacked, slabels = _data(6, seed=8)
    eager, chunk = _model(rule, packed_tables="off"), _model(rule, packed_tables="off")
    assert eager._sparse_ops and not any(op.kernel_route for op in eager._sparse_ops)
    for i in range(6):
        sl = slice(BS * i, BS * (i + 1))
        eager.train_batch({k: v[sl] for k, v in feeds.items()}, labels[sl])
    for sl in (slice(0, 4), slice(4, 6)):
        chunk.train_chunk({k: v[sl] for k, v in stacked.items()}, slabels[sl])
    _assert_same_state(eager, chunk)
