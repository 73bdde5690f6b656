"""The PyTorch port's training path against the JAX package, on the CPU.

Losses, metrics, the bag gradients, the row-update kernel's plain version,
the sparse engine and whole training runs take the same numpy inputs and
the same weights on both sides. The JAX side runs its Pallas update kernels
in interpret mode, as tests/test_packed_update.py runs them; the port's
wrapper takes its plain version, because the tensors lie on the CPU (the
CUDA kernel is held against that plain version on the card, in
tests/test_torch_port_cuda.py and chip_smoke.py).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.data.loader import DataLoader as RefLoader
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm
from dlrm_flexflow_tpu.ops import embedding as ref_emb
from dlrm_flexflow_tpu.ops.pallas import packed_update as pu
from dlrm_flexflow_tpu.training import losses as ref_losses
from dlrm_flexflow_tpu.training import metrics as ref_metrics
from dlrm_flexflow_tpu.training import sparse_engine as ref_engine

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.data.loader import DataLoader as PortLoader
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm
from dlrm_flexflow_tpu_torch.ops import embedding as port_emb
from dlrm_flexflow_tpu_torch.ops.kernels.row_update import row_update
from dlrm_flexflow_tpu_torch.training import losses as port_losses
from dlrm_flexflow_tpu_torch.training import metrics as port_metrics
from dlrm_flexflow_tpu_torch.training import sparse_engine as port_engine

F32_UNIT = 2.0**-24
BF16_UNIT = 2.0**-8


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


# ----------------------------------------------------------------- losses


def _loss_inputs(loss_type, rng):
    b, c = 64, 5
    if loss_type is ref.LossType.LOSS_BINARY_CROSSENTROPY:
        logits = rng.uniform(0, 1, (b, 1)).astype(np.float32)
        logits[:3, 0] = [0.0, 1.0, 1e-9]  # inside the clip
        return logits, rng.integers(0, 2, (b, 1)).astype(np.float32)
    probs = rng.uniform(0.01, 1, (b, c)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    if loss_type is ref.LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        return probs, np.eye(c, dtype=np.float32)[rng.integers(0, c, b)]
    if loss_type is ref.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        return probs, rng.integers(0, c, (b, 1)).astype(np.int32)
    return rng.standard_normal((b, c)).astype(np.float32), rng.standard_normal((b, c)).astype(np.float32)


@pytest.mark.parametrize("loss_name", [t.name for t in ref.LossType])
def test_loss_and_its_gradient_match_reference(loss_name):
    rl, pl = ref.LossType[loss_name], port.LossType[loss_name]
    logits, labels = _loss_inputs(rl, _rng(0))
    want, g_want = jax.value_and_grad(
        lambda x: ref_losses.compute_loss(rl, x, jnp.asarray(labels))
    )(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = port_losses.compute_loss(pl, x, torch.from_numpy(labels))
    got.backward()
    # the same f32 formula; means over 64 rows in another order
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize(
    "names, labels_kind",
    [(["METRICS_ACCURACY", "METRICS_AUC_ROC", "METRICS_MEAN_SQUARED_ERROR",
       "METRICS_ROOT_MEAN_SQUARED_ERROR", "METRICS_MEAN_ABSOLUTE_ERROR"], "binary"),
     (["METRICS_ACCURACY", "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY"], "class"),
     (["METRICS_ACCURACY", "METRICS_CATEGORICAL_CROSSENTROPY", "METRICS_MEAN_SQUARED_ERROR"],
      "one-hot")],
)
def test_metrics_accumulate_and_summarize_like_reference(names, labels_kind):
    rmask, pmask = ref.MetricsType.METRICS_NONE, port.MetricsType.METRICS_NONE
    for n in names:
        rmask |= ref.MetricsType[n]
        pmask |= port.MetricsType[n]
    rng = _rng(1)
    binary = labels_kind == "binary"
    r_total = ref_metrics.zero_perf_metrics(with_auc=bool(rmask & ref.MetricsType.METRICS_AUC_ROC))
    p_total = port_metrics.zero_perf_metrics(bool(pmask & port.MetricsType.METRICS_AUC_ROC))
    for step in range(3):
        if binary:
            logits = rng.uniform(0, 1, (50, 1)).astype(np.float32)
            logits[0, 0] = 1.0  # the top bin's clip
            labels = rng.integers(0, 2, (50, 1)).astype(np.float32)
        else:
            logits = rng.uniform(0.01, 1, (50, 4)).astype(np.float32)
            logits /= logits.sum(-1, keepdims=True)
            labels = rng.integers(0, 4, (50, 1)).astype(np.float32)
            if labels_kind == "one-hot":
                labels = np.eye(4, dtype=np.float32)[labels[:, 0].astype(int)]
        r_step = ref_metrics.compute_perf_metrics(rmask, jnp.asarray(logits), jnp.asarray(labels), binary)
        p_step = port_metrics.compute_perf_metrics(
            pmask, torch.from_numpy(logits), torch.from_numpy(labels), binary
        )
        assert set(p_step) == set(r_step)
        r_total = ref_metrics.accumulate(r_total, r_step)
        p_total = port_metrics.accumulate(p_total, p_step)
    for k in r_total:
        # counts and histograms exactly; f32 sums over 50 rows in another order
        np.testing.assert_allclose(p_total[k].numpy(), np.asarray(r_total[k]), rtol=1e-6, atol=1e-6)
    want = ref_metrics.summarize(r_total, rmask)
    got = port_metrics.summarize(p_total, pmask)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_auc_from_histograms_matches_reference():
    rng = _rng(2)
    pos, neg = rng.integers(0, 9, 8192).astype(np.float32), rng.integers(0, 9, 8192).astype(np.float32)
    assert port_metrics.auc_from_histograms(pos, neg) == ref_metrics.auc_from_histograms(pos, neg)
    assert port_metrics.auc_from_histograms(pos * 0, neg) == 0.5


# ----------------------------------------------------------------- bag gradients


@pytest.mark.parametrize("aggr", ["AGGR_MODE_SUM", "AGGR_MODE_AVG", "AGGR_MODE_NONE"])
def test_bag_row_grads_and_src_match_reference(aggr):
    rng = _rng(3)
    v, b, h, d = 40, 16, 3, 8
    idx = rng.integers(-2, v + 2, (b, h))  # padding (< 0) and rows >= V
    idx[0] = -1  # an all-padding bag: AVG divides by 1
    g = rng.standard_normal((b * h, d) if aggr == "AGGR_MODE_NONE" else (b, d)).astype(np.float32)
    ra, pa = ref.AggrMode[aggr], port.AggrMode[aggr]
    r_rows, r_grads = ref_emb.bag_row_grads(jnp.asarray(idx), jnp.asarray(g), ra, v)
    p_rows, p_grads = port_emb.bag_row_grads(torch.from_numpy(idx), torch.from_numpy(g), pa, v)
    np.testing.assert_array_equal(p_rows.numpy(), np.asarray(r_rows))
    # the same f32 division by the bag count
    np.testing.assert_array_equal(p_grads.numpy(), np.asarray(r_grads))
    r_rows, r_src, r_h = ref_emb.bag_row_src(jnp.asarray(idx), jnp.asarray(g), ra, v)
    p_rows, p_src, p_h = port_emb.bag_row_src(torch.from_numpy(idx), torch.from_numpy(g), pa, v)
    assert p_h == r_h
    np.testing.assert_array_equal(p_rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(p_src.numpy(), np.asarray(r_src))


def test_onehot_lookup_gradient_rounds_each_row_sum_once_like_jax():
    """A 4-row table with 3000 hits per batch: the JAX einsum over
    table.astype(bf16) rounds each row's f32 gradient sum to bf16 once;
    rounding every lookup's gradient first would be off by ~0.2 here."""
    rng = _rng(4)
    t = rng.standard_normal((4, 16)).astype(np.float32)
    idx = rng.integers(-1, 5, (3000, 1))
    g = rng.standard_normal((3000, 16)).astype(np.float32)

    def f(tj):
        pooled = ref_emb.embedding_bag_onehot(tj, jnp.asarray(idx), ref.AggrMode.AGGR_MODE_SUM, jnp.bfloat16)
        return jnp.sum(pooled * jnp.asarray(g))

    want = np.asarray(jax.grad(f)(jnp.asarray(t)))
    tt = torch.from_numpy(t).requires_grad_(True)
    pooled = port_emb.embedding_bag_onehot(tt, torch.from_numpy(idx), port.AggrMode.AGGR_MODE_SUM, torch.bfloat16)
    (pooled * torch.from_numpy(g)).sum().backward()
    # both round the f32 row sum to bf16; the f32 sums differ in order
    # only, which can flip that rounding by one bf16 step of the sum
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=BF16_UNIT, atol=0)


def test_bf16_leaf_gets_a_bf16_gradient_through_concat():
    """The pooled output of a bf16 table enters the f32 concat; the JAX
    cotangent of that output is bf16, so the port's override leaf must be
    bf16 to get the same rounding."""
    rng = _rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).to(torch.bfloat16)
    e.requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    (torch.cat([x, e], dim=1) * w).sum().backward()
    assert e.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(e.grad.float().numpy(), _bf16(w[:, 3:].numpy()))


# ----------------------------------------------------------------- the row update


def _jax_update(tables_np, dtypes, rows, payloads, d, stream, chunk_packs=1024):
    """packed_row_update_batched in interpret mode, unpacked to [V, D] f32."""
    packed = [pu.pack_table(jnp.asarray(t), chunk_packs).astype(dt) for t, dt in zip(tables_np, dtypes)]
    outs = pu.packed_row_update_batched(
        packed, [jnp.asarray(r) for r in rows], payloads, [t.shape[0] for t in tables_np], d,
        chunk_packs=chunk_packs, interpret=True, delta_dtype=stream,
    )
    return [np.asarray(pu.unpack_table(o.astype(jnp.float32), t.shape[0], d))
            for o, t in zip(outs, tables_np)]


def _row_update_tolerance(table, rows, deltas, bf16_table):
    """Per element: the f32 sums differ in order only, each within
    n * 2^-24 * (|t| + sum |delta|) of exact (n terms), so two of them within
    twice that; a bf16 table adds at most one bf16 step of the sum and one
    of the result where such an f32 difference flips a bf16 rounding."""
    v = table.shape[0]
    keep = (rows >= 0) & (rows < v)
    mag = np.abs(table).astype(np.float64)
    n = np.ones(v)
    np.add.at(mag, rows[keep], np.abs(deltas[keep]))
    np.add.at(n, rows[keep], 1)
    tol = 2 * n[:, None] * F32_UNIT * mag
    if bf16_table:
        tol = tol + 2 * BF16_UNIT * mag
    return tol


@pytest.mark.parametrize("d, stream", [(4, "bfloat16"), (16, "float32"), (128, "bfloat16")])
def test_row_update_plain_version_matches_packed_kernel(d, stream):
    """K1 regime: duplicates, rows < 0 and >= V, a (src, h=2) payload; an f32
    and a bf16 table in one batched call, as the engine groups them."""
    rng = _rng(10 + d)
    v, k, h = 300, 512, 2
    tables = [rng.standard_normal((v, d)).astype(np.float32) for _ in range(2)]
    tables[1] = _bf16(tables[1])
    rows = [rng.integers(-3, v + 3, k).astype(np.int32) for _ in range(2)]
    rows[0][:40] = 7  # a run of duplicates
    src = [rng.standard_normal((k // h, d)).astype(np.float32) for _ in range(2)]
    scale = np.float32(-0.05)
    want = _jax_update(
        tables, [jnp.float32, jnp.bfloat16], rows,
        [(jnp.asarray(scale * s), h) for s in src], d, jnp.dtype(stream),
    )
    sdt = getattr(torch, stream)
    for i, tdt in enumerate([torch.float32, torch.bfloat16]):
        table = torch.from_numpy(tables[i]).to(tdt)
        row_update([table], [torch.from_numpy(rows[i])], [(torch.from_numpy(src[i]), h)],
                   torch.tensor(scale), sdt)
        got = table.float().numpy()
        deltas = np.repeat(scale * src[i], h, axis=0)
        tol = _row_update_tolerance(tables[i], rows[i], deltas, tdt == torch.bfloat16)
        assert np.all(np.abs(got - want[i]) <= tol), np.abs(got - want[i]).max()
        untouched = np.setdiff1d(np.arange(v), rows[i])
        np.testing.assert_array_equal(got[untouched], tables[i][untouched])


def test_row_update_plain_version_matches_manual_sparse_kernel():
    """K2 regime, the case of test_manual_sparse_kernel_engages_and_matches:
    128 entries on a 500,000-row table (977 chunks of 64 packs), so the JAX
    package dispatches `_update_kernel_manual`; f32 deltas, f32 and bf16
    tables."""
    rng = np.random.RandomState(21)
    v, d, k, c = 500_000, 16, 128, 64
    assert k < 0.4 * pu.packed_num_packs(v, d, c)[1]  # the sparse gate holds
    table = rng.randn(v, d).astype(np.float32)
    rows = rng.randint(-2, v + 3, k).astype(np.int32)
    deltas = rng.randn(k, d).astype(np.float32)
    tables = [table, _bf16(table)]
    want = _jax_update(tables, [jnp.float32, jnp.bfloat16], [rows, rows],
                       [jnp.asarray(deltas)] * 2, d, jnp.float32, chunk_packs=c)
    for tnp, tdt, w in zip(tables, [torch.float32, torch.bfloat16], want):
        t = torch.from_numpy(tnp).to(tdt)
        row_update([t], [torch.from_numpy(rows)], [torch.from_numpy(deltas)],
                   torch.tensor(1.0), torch.float32)
        tol = _row_update_tolerance(tnp, rows, deltas, tdt == torch.bfloat16)
        assert np.all(np.abs(t.float().numpy() - w) <= tol)


def test_row_update_rounds_each_delta_then_the_sum_then_adds_in_bf16():
    """bf16 tables: the f32 sum is rounded to bf16, then added in bf16 (two
    roundings, `tp + acc.astype(tp.dtype)`); each delta is first rounded to
    the stream dtype. Values chosen so that one rounding fewer would show."""
    rows = torch.tensor([0, 0])
    t = torch.ones((1, 1), dtype=torch.bfloat16)
    # f32 sum 2^-8 + 2^-16 rounds (tie, to even) to 2^-8; 1 + 2^-8 ties to
    # 1.0. Rounding 1 + 2^-8 + 2^-16 once would give 1 + 2^-7.
    deltas = torch.tensor([[2.0**-9], [2.0**-9 + 2.0**-16]])
    row_update([t], [rows], [deltas], torch.tensor(1.0), torch.float32)
    assert t.item() == 1.0
    # bf16 stream: 2^-9 + 2^-17 rounds (tie, to even) to 2^-9 per delta
    f = torch.ones((1, 1))
    deltas = torch.full((2, 1), 2.0**-9 + 2.0**-17)
    row_update([f], [rows], [deltas], torch.tensor(1.0), torch.bfloat16)
    assert f.item() == 1.0 + 2.0**-8
    row_update([f], [rows], [deltas], torch.tensor(1.0), torch.float32)
    assert f.item() == 1.0 + 2.0**-7 + 2.0**-16


def test_row_update_checks_its_inputs():
    t = torch.zeros(10, 4)
    ok = (torch.zeros(3, dtype=torch.int64), torch.zeros(3, 4))
    with pytest.raises(TypeError):
        row_update([t.double()], [ok[0]], [ok[1]], torch.tensor(1.0))
    with pytest.raises(ValueError):
        row_update([torch.zeros(10, 129)], [ok[0]], [torch.zeros(3, 129)], torch.tensor(1.0))
    with pytest.raises(ValueError):
        row_update([t], [ok[0]], [(torch.zeros(2, 4), 2)], torch.tensor(1.0))  # 2*2 != 3
    with pytest.raises(ValueError):
        row_update([t], [ok[0]], [ok[1]], torch.tensor([1.0, 2.0]))
    row_update([t], [ok[0]], [ok[1]], torch.tensor(1.0))


# ----------------------------------------------------------------- the sparse engine


@functools.lru_cache(maxsize=None)
def _engine_case(route, tdt, wd):
    """Both packages' apply_sparse_updates on two sparse tables of one small
    DLRM (vocab 500 and 300; bag 2), from the same weights and pooled
    gradients. Returns (want, got): {table: [V, D] f32}."""
    rng = _rng(20)
    r_ops = [op for op in ref_dlrm.make_dlrm_model(_small_cfg(ref_dlrm)).graph.compute_ops
             if isinstance(op, ref_emb.Embedding)][:2]
    p_model = port_dlrm.make_dlrm_model(_small_cfg(port_dlrm), device="cpu")
    p_ops = [op for op in p_model.graph.compute_ops if isinstance(op, port_emb.Embedding)][:2]
    r_params, p_params, r_x, p_x, r_g, p_g = {}, {}, {}, {}, {}, {}
    gdt = torch.bfloat16 if tdt == "bfloat16" else torch.float32
    for r_op, p_op in zip(r_ops, p_ops):
        w = rng.standard_normal((r_op.num_entries, 16)).astype(np.float32)
        if tdt == "bfloat16":
            w = _bf16(w)
        idx = rng.integers(-1, r_op.num_entries + 2, (32, 2))
        idx[:8] = 3  # duplicates
        g = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32)).to(gdt)
        if route == "kernel":
            r_op.packed, r_op.chunk_packs = True, 1024
            r_params[r_op.name] = {"weight": pu.pack_table(jnp.asarray(w), 1024).astype(jnp.dtype(tdt))}
            p_op.kernel_route = True
        else:
            r_params[r_op.name] = {"weight": jnp.asarray(w)}
        p_params[p_op.name] = {"weight": torch.from_numpy(w).to(getattr(torch, tdt))}
        r_x[r_op.name], p_x[p_op.name] = [jnp.asarray(idx)], [torch.from_numpy(idx)]
        r_g[r_op.name] = [jnp.asarray(g.float().numpy()).astype(jnp.dtype(tdt))]
        p_g[p_op.name] = [g]
    r_opt, p_opt = ref.SGDOptimizer(lr=0.05, weight_decay=wd), port.SGDOptimizer(lr=0.05, weight_decay=wd)
    lr = 0.25  # the step's rate from the dense state, not opt.lr
    new, _ = ref_engine.apply_sparse_updates(
        r_ops, r_params, r_x, r_g, r_opt, {op.name: None for op in r_ops}, None, lr=jnp.float32(lr))
    port_engine.apply_sparse_updates(
        p_ops, p_params, p_x, p_g, p_opt, {op.name: None for op in p_ops}, None, lr=torch.tensor(lr))
    want, got = {}, {}
    for r_op in r_ops:
        w = new[r_op.name]["weight"]
        if route == "kernel":
            w = pu.unpack_table(w, r_op.num_entries, 16)
        want[r_op.name] = np.asarray(w.astype(jnp.float32))
        got[r_op.name] = p_params[r_op.name]["weight"].float().numpy()
    return want, got


@pytest.mark.parametrize(
    "route, tdt, wd",
    [("scatter", "float32", 1e-2), ("kernel", "float32", 0.0), ("kernel", "bfloat16", 1e-2)],
)
def test_sgd_sparse_engine_matches_reference(route, tdt, wd):
    want, got = _engine_case(route, tdt, wd)
    for name in want:
        # the same rounding sequence; f32 sums of at most 10 duplicates in
        # another order, 10 * 2^-24 relative to values of order 4; on bf16
        # tables such a difference may flip one bf16 rounding (2^-8 * 4)
        atol = 2**-6 if tdt == "bfloat16" else 4e-6
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol)
        assert np.mean(got[name] == want[name]) > 0.999


def test_the_two_routes_round_differently():
    """The kernel route rounds each -lr*g to bf16, the scatter route adds it
    in f32: mixing them up would show here as a ~2^-9 relative drift."""
    want_k, got_k = _engine_case("kernel", "float32", 0.0)
    want_s, got_s = _engine_case("scatter", "float32", 0.0)
    name = "table_0"
    assert np.array_equal(got_k[name], want_k[name]) and np.array_equal(got_s[name], want_s[name])
    assert not np.array_equal(got_k[name], got_s[name])


# ----------------------------------------------------------------- whole training runs


def _small_cfg(pkg):
    """tests/test_packed_update.py::_small_dlrm."""
    return pkg.DLRMConfig(sparse_feature_size=16, embedding_size=[500, 300, 800],
                          embedding_bag_size=2, mlp_bot=[4, 16, 16], mlp_top=[64, 16, 1],
                          batch_size=32)


def _pair(cfg_fn, ffkw, optimizer_kw, metrics=("METRICS_ACCURACY",)):
    """A JAX model and a port model (CPU) compiled alike, the port carrying
    the JAX model's initial weights."""
    rm = ref_dlrm.make_dlrm_model(cfg_fn(ref_dlrm), ref.FFConfig(**ffkw))
    rm.compile(ref.SGDOptimizer(**optimizer_kw), ref.LossType.LOSS_BINARY_CROSSENTROPY,
               [ref.MetricsType[m] for m in metrics])
    pm = port_dlrm.make_dlrm_model(cfg_fn(port_dlrm), port.FFConfig(**ffkw), device="cpu")
    pm.compile(port.SGDOptimizer(**optimizer_kw), port.LossType.LOSS_BINARY_CROSSENTROPY,
               [port.MetricsType[m] for m in metrics])
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    return rm, pm


def _train_both(rm, pm, cfg, bs, steps, seed):
    feeds, labels = ref_synthetic.random_batches(cfg, bs * steps, seed=seed)
    losses = {"ref": [], "port": []}
    for i in range(steps):
        sl = slice(bs * i, bs * (i + 1))
        batch = {k: v[sl] for k, v in feeds.items()}
        losses["ref"].append(float(rm.train_batch(batch, labels[sl])))
        loss = pm.train_batch(batch, labels[sl])
        assert loss.dim() == 0 and not loss.requires_grad
        losses["port"].append(float(loss))
    return losses


@pytest.mark.parametrize("packed", ["off", "on"])
def test_small_dlrm_trajectory_matches_reference(packed):
    """test_packed_update.py's packed-vs-scatter model, f32, 4 SGD steps,
    from carried weights, on the scatter route ("off") and the row-update
    kernel route ("on", JAX kernels in interpret mode)."""
    rm, pm = _pair(_small_cfg, dict(batch_size=32, compute_dtype="float32",
                                    onehot_embedding_threshold=0, packed_tables=packed),
                   dict(lr=0.05))
    assert [op.kernel_route for op in pm._sparse_ops] == [packed == "on"] * 3
    losses = _train_both(rm, pm, _small_cfg(ref_dlrm), 32, 4, seed=3)
    # the same f32 operations in another summation order (the reference's
    # own packed-vs-scatter test allows rtol=atol=2e-3 and 5e-3 on weights)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5, atol=1e-6)
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            np.testing.assert_allclose(pm.get_weights(op)[k], v, rtol=0, atol=1e-6)
    assert pm.get_metrics() == pytest.approx(rm.get_metrics())


def _kaggle_capped(pkg):
    cfg = pkg.kaggle_config(batch_size=128)
    cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
    return cfg


def test_kaggle_shaped_bf16_trajectory_matches_reference():
    """kaggle widths, vocabs capped at 20000: 16 tables on the one-hot path
    (dense f32 gradients), 10 on the row-update route with bf16 storage;
    bf16 compute; 3 SGD steps from carried weights."""
    rm, pm = _pair(_kaggle_capped, dict(batch_size=128, compute_dtype="bfloat16",
                                        table_dtype="bfloat16", packed_tables="on"),
                   dict(lr=0.05), metrics=("METRICS_ACCURACY", "METRICS_AUC_ROC"))
    kernel = {op.name for op in pm._sparse_ops if op.kernel_route}
    assert len(kernel) == 10 and len(pm._sparse_ops) == 10
    for op in pm.graph.compute_ops:
        if isinstance(op, port_emb.Embedding):
            want = torch.bfloat16 if op.name in kernel else torch.float32
            assert pm.get_parameters()[op.name]["weight"].dtype == want
    losses = _train_both(rm, pm, _kaggle_capped(ref_dlrm), 128, 3, seed=3)
    # bf16 operands summed in f32 in another order: where that flips one
    # bf16 rounding of an activation or of a row delta, the value moves by
    # one bf16 step (2^-8 relative) -- far inside the reference's own
    # bf16-vs-f32 table test (2e-2) and packed-vs-scatter test (2e-3, 5e-3)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-4, atol=1e-4)
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            np.testing.assert_allclose(pm.get_weights(op)[k], np.asarray(v, np.float32),
                                       rtol=0, atol=1e-4)
    np.testing.assert_allclose(pm.get_metrics()["auc"], rm.get_metrics()["auc"], atol=1e-6)


def _tiny(pkg):
    """tests/test_trajectory_parity.py's tiny DLRM: two tables on the
    one-hot path (threshold 100), two on the sparse path."""
    return pkg.DLRMConfig(sparse_feature_size=8, embedding_size=[120, 84, 260, 96],
                          embedding_bag_size=1, mlp_bot=[4, 16, 8], mlp_top=[40, 16, 1],
                          batch_size=32)


def test_fit_and_evaluate_history_match_reference():
    rm, pm = _pair(_tiny, dict(batch_size=32, compute_dtype="float32",
                               onehot_embedding_threshold=100, epochs=2),
                   dict(lr=0.1, weight_decay=1e-3),
                   metrics=("METRICS_ACCURACY", "METRICS_AUC_ROC", "METRICS_MEAN_SQUARED_ERROR"))
    feeds, labels = ref_synthetic.random_batches(_tiny(ref_dlrm), 32 * 5 + 7, seed=8)
    vx, vy = ref_synthetic.random_batches(_tiny(ref_dlrm), 64, seed=9)
    want = rm.fit(feeds, labels, verbose=False, shuffle=True, validation_data=(vx, vy))
    got = pm.fit(feeds, labels, verbose=False, shuffle=True, validation_data=(vx, vy))
    assert got.keys() == want.keys()
    assert {"epoch_time_s", "throughput", "first_epoch_time_s", "val_auc"} <= got.keys()
    for k in want:
        if k not in ("epoch_time_s", "throughput", "first_epoch_time_s"):
            # f32 trajectories of 10 steps; per-sample means in another order
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pm.evaluate(vx, vy)["mse"], rm.evaluate(vx, vy)["mse"], rtol=1e-5)
    loss = pm.eval_batch({k: v[:32] for k, v in vx.items()}, vy[:32])
    np.testing.assert_allclose(float(loss), float(rm.eval_batch({k: v[:32] for k, v in vx.items()}, vy[:32])),
                               rtol=1e-5)


def test_data_loader_gives_the_reference_batches():
    feeds, labels = ref_synthetic.random_batches(_tiny(ref_dlrm), 100, seed=1)
    for shuffle in (False, True):
        r, p = RefLoader(feeds, labels, 32, shuffle=shuffle, seed=4), PortLoader(feeds, labels, 32, shuffle=shuffle, seed=4)
        assert p.steps_per_epoch == r.steps_per_epoch == 3
        for _ in range(2):
            for (rf, rl), (pf, plb) in zip(r.epoch(), p.epoch()):
                np.testing.assert_array_equal(plb, rl)
                for k in rf:
                    np.testing.assert_array_equal(pf[k], rf[k])
    with pytest.raises(ValueError):
        PortLoader(feeds, labels, 101)


# ----------------------------------------------------------------- the model surface


def test_learning_rate_lives_in_state_and_drives_both_routes():
    _, pm = _pair(_small_cfg, dict(batch_size=32, compute_dtype="float32",
                                   onehot_embedding_threshold=0, packed_tables="on"),
                  dict(lr=0.05))
    assert pm.get_learning_rate() == pytest.approx(0.05)
    pm.set_learning_rate(0.0)
    before = {op: {k: v.copy() for k, v in pm.get_weights(op).items()} for op in pm.get_parameters()}
    feeds, labels = ref_synthetic.random_batches(_small_cfg(ref_dlrm), 32, seed=2)
    pm.train_batch(feeds, labels)
    for op, sub in before.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(pm.get_weights(op)[k], v)
    pm.set_learning_rate(0.5)
    assert pm.get_learning_rate() == 0.5
    pm.train_batch(feeds, labels)
    assert not np.array_equal(pm.get_weights("table_0")["weight"], before["table_0"]["weight"])
    assert not np.array_equal(pm.get_weights("top_mlp_0")["kernel"], before["top_mlp_0"]["kernel"])


def test_bf16_table_weight_io_widens_and_rounds():
    _, pm = _pair(_small_cfg, dict(batch_size=32, compute_dtype="float32",
                                   onehot_embedding_threshold=0, packed_tables="on",
                                   table_dtype="bfloat16"), dict(lr=0.05))
    assert pm.get_parameters()["table_0"]["weight"].dtype == torch.bfloat16
    w = pm.get_weights("table_0")["weight"]
    assert w.dtype == np.float32 and w.shape == (500, 16)
    np.testing.assert_array_equal(_bf16(w), w)  # the widening is exact
    w2 = _rng(6).standard_normal((500, 16)).astype(np.float32)
    pm.set_weights("table_0", {"weight": w2})
    np.testing.assert_array_equal(pm.get_weights("table_0")["weight"], _bf16(w2))


def test_kernel_route_gate_follows_the_config_on_the_cpu():
    """"auto" takes the kernel route only on CUDA (the JAX package's only on
    a TPU); "on" forces it; the table dtype applies to that route only."""
    def routes(**kw):
        m = port_dlrm.make_dlrm_model(_tiny(port_dlrm), port.FFConfig(
            batch_size=32, onehot_embedding_threshold=100, table_dtype="bfloat16", **kw), device="cpu")
        m.compile(port.SGDOptimizer(lr=0.1))
        return {op.name: (op.kernel_route, m.get_parameters()[op.name]["weight"].dtype)
                for op in m._sparse_ops}

    assert routes() == {"table_0": (False, torch.float32), "table_2": (False, torch.float32)}
    assert routes(packed_tables="on") == {"table_0": (True, torch.bfloat16),
                                          "table_2": (True, torch.bfloat16)}


@pytest.mark.parametrize("what", ["adam", "adagrad", "momentum"])
def test_ported_sparse_optimizers_train_on_the_kernel_route(what):
    """Adam, row-wise AdaGrad and momentum train the tables of the kernel
    route (tests/test_torch_port_sparse_optim.py holds each rule against the
    JAX package); their slot state has the kernel route's shapes."""
    opt = {"adam": port.AdamOptimizer(alpha=0.01), "adagrad": port.RowWiseAdagradOptimizer(lr=0.1),
           "momentum": port.SGDOptimizer(lr=0.1, momentum=0.9)}[what]
    m = port_dlrm.make_dlrm_model(_tiny(port_dlrm), port.FFConfig(
        batch_size=32, onehot_embedding_threshold=100, packed_tables="on"), device="cpu")
    m.compile(opt, port.LossType.LOSS_BINARY_CROSSENTROPY, [port.MetricsType.METRICS_ACCURACY])
    assert [op.kernel_route for op in m._sparse_ops] == [True, True]
    before = m.get_weights("table_0")["weight"].copy()
    feeds, labels = ref_synthetic.random_batches(_tiny(ref_dlrm), 64, seed=1)
    hist = m.fit(feeds, labels, epochs=1, verbose=False)
    assert np.isfinite(hist["accuracy"]) and not np.array_equal(m.get_weights("table_0")["weight"], before)
    st = m._opt_state["sparse"]["table_0"]
    if what == "adam":
        assert set(st) == {"m", "v"} and st["m"].shape == st["v"].shape == (120, 8)
    else:
        assert st.shape == ((120,) if what == "adagrad" else (120, 8)) and st.dtype == torch.float32


@pytest.mark.parametrize("what", ["profiling"])
def test_unported_training_features_raise_with_their_slice(what):
    ffkw = dict(batch_size=32, onehot_embedding_threshold=100, packed_tables="on")
    opt = port.SGDOptimizer(lr=0.1)
    if what == "profiling":
        ffkw["profiling"] = True
    m = port_dlrm.make_dlrm_model(_tiny(port_dlrm), port.FFConfig(**ffkw), device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        m.compile(opt, port.LossType.LOSS_BINARY_CROSSENTROPY)
        feeds, labels = ref_synthetic.random_batches(_tiny(ref_dlrm), 64, seed=1)
        m.fit(feeds, labels, verbose=False)


def test_dense_momentum_sgd_without_sparse_tables_matches_reference():
    """Momentum and nesterov are ported for dense parameters: a model whose
    tables all take the one-hot path trains with them."""
    kw = dict(batch_size=32, compute_dtype="float32", onehot_embedding_threshold=1000)
    rm, pm = _pair(_tiny, kw, dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-3))
    assert pm._sparse_ops == []
    losses = _train_both(rm, pm, _tiny(ref_dlrm), 32, 3, seed=4)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5, atol=1e-6)
    for op in rm.get_parameters():
        for k, v in rm.get_weights(op).items():
            np.testing.assert_allclose(pm.get_weights(op)[k], v, rtol=0, atol=2e-6)
