"""The port's sparse optimizers and the one-hot lookup's gradient against the
JAX package, on the CPU.

Lazy momentum and Nesterov, lazy Adam and row-wise AdaGrad, on both update
routes: the scatter rules (`Optimizer.sparse_row_update`) and the
row-update kernel route, whose plain versions the port's wrappers take on
the CPU (the CUDA kernels are held against those plain versions on the
card, in tests/test_torch_port_cuda.py and chip_smoke.py). The JAX side
runs as its own tests run it: on the CPU, its packed update kernels in
interpret mode (`packed_tables="on"`), tables compared through
`unpack_table`. Weights are carried by `convert.params_from_jax`.

Tolerances. Both sides do the same f32 operations in the same order but
for the sums of a row's duplicate entries, and but for XLA's CPU compiler,
which fuses a multiply and an add (`m * keep + acc`, `mu * v + G`) into one
rounding where the port rounds twice: an f32 sum of n terms is within
n * 2^-24 * sum |term| of the exact one, so the two within twice that, and
a fused multiply-add is one f32 rounding (2^-24) from the unfused one.
Where such a difference crosses a bf16 rounding (a kernel-route stream
entry, a bf16 table), the value moves by one bf16 step, at most 2^-8 of
its magnitude. Adam moves a weight by alpha_t * m / (sqrt(v) + eps) a step,
at most about alpha_t * (1 - beta1) / sqrt(1 - beta2) on the first step and
a few alpha_t after, whatever the gradient's size: a gradient component
near 0, whose sign two summation orders may set differently, can move the
two sides' weights apart by that much. The model-level Adam tests bound
every weight by it and ask that almost all agree to f32 rounding.
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
from dlrm_flexflow_tpu.ops.pallas.onehot_embedding import onehot_embedding_pallas
from dlrm_flexflow_tpu.training import sparse_engine as ref_engine

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm
from dlrm_flexflow_tpu_torch.ops import embedding as port_emb
from dlrm_flexflow_tpu_torch.ops.kernels.onehot_embedding import onehot_embedding
from dlrm_flexflow_tpu_torch.ops.kernels.row_update import (
    adam_reference,
    momentum_reference,
    row_update_adam,
    row_update_momentum,
)
from dlrm_flexflow_tpu_torch.training import sparse_engine as port_engine
from dlrm_flexflow_tpu_torch.training.optimizer import Optimizer

F32_UNIT = 2.0**-24
BF16_STEP = 2.0**-8  # one bf16 step relative to the value, at most 2^-7
SUM, AVG = port.AggrMode.AGGR_MODE_SUM, port.AggrMode.AGGR_MODE_AVG


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _opts(rule, **kw):
    """The same optimizer in both packages."""
    name, args = {
        "momentum": ("SGDOptimizer", dict(lr=0.1, momentum=0.9)),
        "nesterov": ("SGDOptimizer", dict(lr=0.1, momentum=0.9, nesterov=True)),
        "momentum-wd": ("SGDOptimizer", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
        "adam": ("AdamOptimizer", dict(alpha=0.01)),
        "adam-wd": ("AdamOptimizer", dict(alpha=0.01, weight_decay=0.01)),
        "adagrad": ("RowWiseAdagradOptimizer", dict(lr=0.1)),
    }[rule]
    args.update(kw)
    return getattr(ref, name)(**args), getattr(port, name)(**args)


def _close(got, want, rtol, atol, exact_share=None):
    """|got - want| <= rtol * |want| + atol everywhere; with exact_share, that
    share of the elements at least bit-equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert np.all(err <= rtol * np.abs(want) + atol), (err.max(), (err - rtol * np.abs(want)).max())
    if exact_share is not None:
        assert np.mean(got == want) >= exact_share, np.mean(got == want)


# ------------------------------------------------------------------ scatter rules


@pytest.mark.parametrize("rule", ["momentum", "nesterov", "momentum-wd", "adam", "adam-wd", "adagrad"])
def test_scatter_rule_matches_jax_rule(rule):
    """Three steps of `sparse_row_update` on one f32 table, the slot state
    carried: duplicates (a run of 12 on row 3) and rows >= V (dropped)."""
    rng = _rng(1)
    v, d, k = 50, 8, 64
    r_opt, p_opt = _opts(rule)
    table = rng.standard_normal((v, d)).astype(np.float32)
    r_t, r_s = jnp.asarray(table), r_opt.sparse_init((v, d))
    p_t = torch.from_numpy(table.copy())
    p_s = p_opt.sparse_init((v, d), "cpu")
    assert tuple(p_s.shape) == tuple(r_s.shape) and p_s.dtype == torch.float32
    for step in range(3):
        rows = rng.integers(0, v + 4, k).astype(np.int32)
        rows[:12] = 3
        g = rng.standard_normal((k, d)).astype(np.float32)
        lr = 0.01 * (step + 1) if rule.startswith("adam") else None  # an alpha_t
        r_t, r_s = r_opt.sparse_row_update(r_t, r_s, jnp.asarray(rows), jnp.asarray(g),
                                           lr=None if lr is None else jnp.float32(lr))
        p_s = p_opt.sparse_row_update(p_t, p_s, torch.from_numpy(rows), torch.from_numpy(g),
                                      lr=None if lr is None else torch.tensor(lr))
    # f32 sums of up to 13 duplicates in another order, over 3 steps; AdaGrad
    # also takes XLA's and torch's reciprocal square roots, an ulp apart
    _close(p_t.numpy(), r_t, rtol=1e-5, atol=1e-6, exact_share=0.5 if rule == "adagrad" else 0.9)
    _close(p_s.numpy(), r_s, rtol=1e-5, atol=1e-6)


def test_lazy_scatter_rules_leave_untouched_rows_and_drop_out_of_range_ones():
    rng = _rng(2)
    v, d = 20, 4
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    rows = torch.tensor([1, 1, 5, -1, v, v + 3])
    g = torch.from_numpy(rng.standard_normal((6, d)).astype(np.float32))
    for opt in (port.SGDOptimizer(lr=0.1, momentum=0.9), port.AdamOptimizer(),
                port.RowWiseAdagradOptimizer()):
        t = table.clone()
        st = opt.sparse_row_update(t, opt.sparse_init((v, d), "cpu"), rows, g)
        assert (t != table).any(dim=1).nonzero().reshape(-1).tolist() == [1, 5]
        pools = st if st.dim() == 3 else st[None]  # [pools, V, D] or [1, V(, D)]
        touched = (pools != 0).reshape(pools.shape[0], v, -1).any(dim=2).any(dim=0)
        assert touched.nonzero().reshape(-1).tolist() == [1, 5]


# ------------------------------------------------------------------ the kernel route, rule by rule


def _packed(x, dtype=jnp.float32):
    return pu.pack_table(jnp.asarray(x), 1024).astype(dtype)


def _unpacked(p, v, d):
    return np.asarray(pu.unpack_table(p.astype(jnp.float32), v, d))


def _rule_case(d, seed):
    rng = _rng(seed)
    v, k, h = 300, 256, 2
    table = _bf16(rng.standard_normal((v, d)) * 0.1)
    rows = rng.integers(0, v + 3, k).astype(np.int32)
    rows[:20] = 7  # a run of duplicates
    src = rng.standard_normal((k // h, d)).astype(np.float32)
    pool = np.abs(rng.standard_normal((v, d))).astype(np.float32) * 0.01
    return table, rows, src, h, pool


@pytest.mark.parametrize("d, nesterov, wd", [(8, False, 0.01), (16, True, 0.0)])
def test_momentum_plain_version_matches_packed_lazy_momentum(d, nesterov, wd):
    """The kernel route's plain version against `packed_lazy_momentum_batched`
    (K1's decay mode, interpreted) on a bf16 table with a [V, D] velocity."""
    table, rows, src, h, vel = _rule_case(d, 3 + d)
    v = table.shape[0]
    new_t, new_v = pu.packed_lazy_momentum_batched(
        [_packed(table, jnp.bfloat16)], [_packed(vel)], [jnp.asarray(rows)], [(jnp.asarray(src), h)],
        [v], d, lr=jnp.float32(0.05), momentum=0.9, nesterov=nesterov, weight_decay=wd,
        chunk_packs=1024, interpret=True)
    t = torch.from_numpy(table).to(torch.bfloat16)
    vv = torch.from_numpy(vel.copy())
    row_update_momentum([t], [vv], [torch.from_numpy(rows)], [(torch.from_numpy(src), h)],
                        torch.tensor(0.05), 0.9, nesterov, wd)
    # velocity: f32 sums of up to 21 bf16 entries in another order (MXU dot
    # against index_add_) and a fused multiply-add; table: one bf16 step
    # where that flips a rounding
    _close(vv.numpy(), _unpacked(new_v[0], v, d), rtol=44 * F32_UNIT, atol=1e-7)
    _close(t.float().numpy(), _unpacked(new_t[0], v, d), rtol=2 * BF16_STEP, atol=1e-6, exact_share=0.99)
    untouched = np.setdiff1d(np.arange(v), rows)
    assert np.array_equal(t.float().numpy()[untouched], table[untouched])
    assert np.array_equal(vv.numpy()[untouched], vel[untouched])


@pytest.mark.parametrize("d, wd", [(8, 0.0), (16, 0.01)])
def test_adam_plain_version_matches_packed_lazy_adam(d, wd):
    """The kernel route's plain version against `packed_lazy_adam_batched`
    (three interpreted passes: m and v in K1's decay mode, then the weight)
    on a bf16 table with two [V, D] f32 pools."""
    table, rows, src, h, m = _rule_case(d, 5 + d)
    v = table.shape[0]
    vp = m * m
    new_t, new_m, new_v = pu.packed_lazy_adam_batched(
        [_packed(table, jnp.bfloat16)], [_packed(m)], [_packed(vp)], [jnp.asarray(rows)],
        [(jnp.asarray(src), h)], [v], d, alpha_t=jnp.float32(0.003), beta1=0.9, beta2=0.999,
        epsilon=1e-8, weight_decay=wd, chunk_packs=1024, interpret=True)
    t = torch.from_numpy(table).to(torch.bfloat16)
    pm, pv = torch.from_numpy(m.copy()), torch.from_numpy(vp.copy())
    row_update_adam([t], [pm], [pv], [torch.from_numpy(rows)], [(torch.from_numpy(src), h)],
                    torch.tensor(0.003), 0.9, 0.999, 1e-8, wd)
    _close(pm.numpy(), _unpacked(new_m[0], v, d), rtol=44 * F32_UNIT, atol=1e-8)
    _close(pv.numpy(), _unpacked(new_v[0], v, d), rtol=44 * F32_UNIT, atol=1e-9)
    _close(t.float().numpy(), _unpacked(new_t[0], v, d), rtol=2 * BF16_STEP, atol=1e-6, exact_share=0.99)
    untouched = np.setdiff1d(np.arange(v), rows)
    assert np.array_equal(pm.numpy()[untouched], m[untouched])


@pytest.mark.parametrize("rule", ["adam", "momentum"])
def test_kernel_route_at_d4_follows_the_scatter_rule(rule):
    """At D <= 4 the JAX packed lazy Adam and momentum can alias their
    first-occurrence flag in bit 16 of the entry code (ADVICE r5), so the
    kernel route's plain version is held against the JAX scatter rule here.
    The routes differ by the kernel route's bf16 rounding of each stream
    entry and of the weight delta, each within half a bf16 step (2^-8 of
    its value); the gradients are positive, so no sum cancels and each
    pool is within 2^-8 of the scatter rule's, relatively, and each weight
    delta within 3 * 2^-8 (m, sqrt(v) and the delta's own rounding)."""
    rng = _rng(6)
    v, d, k = 40, 4, 96
    table = rng.standard_normal((v, d)).astype(np.float32)
    rows = rng.integers(0, v + 2, k).astype(np.int32)
    rows[:10] = 2
    g = (np.abs(rng.standard_normal((k, d))) + 0.1).astype(np.float32)
    r_opt, _ = _opts(rule)
    lr = 0.01 if rule == "adam" else 0.1
    r_t, r_s = r_opt.sparse_row_update(jnp.asarray(table), r_opt.sparse_init((v, d)), jnp.asarray(rows),
                                       jnp.asarray(g), lr=jnp.float32(lr))
    t = torch.from_numpy(table.copy())
    st = torch.zeros((2, v, d) if rule == "adam" else (v, d))
    if rule == "adam":
        adam_reference(t, st[0], st[1], torch.from_numpy(rows), torch.from_numpy(g),
                       torch.tensor(lr), 0.9, 0.999, 1e-8)
    else:
        momentum_reference(t, st, torch.from_numpy(rows), torch.from_numpy(g), torch.tensor(lr), 0.9)
    _close(st.numpy(), r_s, rtol=2.0**-8 + 4 * F32_UNIT, atol=0)
    delta = np.abs(np.asarray(r_t) - table)
    assert np.all(np.abs(t.numpy() - np.asarray(r_t)) <= 3 * 2.0**-8 * delta + 2 * F32_UNIT * np.abs(table))


# ------------------------------------------------------------------ the engines


def _small_cfg(pkg):
    """tests/test_packed_update.py::_small_dlrm: D = 16, bags of 2."""
    return pkg.DLRMConfig(sparse_feature_size=16, embedding_size=[500, 300, 800],
                          embedding_bag_size=2, mlp_bot=[4, 16, 16], mlp_top=[64, 16, 1],
                          batch_size=32)


def _tiny(pkg):
    """tests/test_trajectory_parity.py's tiny DLRM: D = 8, bags of 1."""
    return pkg.DLRMConfig(sparse_feature_size=8, embedding_size=[120, 84, 260, 96],
                          embedding_bag_size=1, mlp_bot=[4, 16, 8], mlp_top=[40, 16, 1],
                          batch_size=32)


@pytest.mark.parametrize("cfg_name", ["tiny", "small"])
def test_adagrad_kernel_route_engine_matches_jax_engine(cfg_name):
    """Both packages' `apply_sparse_updates` on the kernel route (the JAX
    package's packed tables, interpreted), bf16 tables, from the same
    weights, slot states (accumulators at 0.1) and pooled gradients; D = 8
    with single lookups or D = 16 with bags of 2. Row-wise AdaGrad, whose JAX kernel
    route is the engine's own two passes (`sparse_engine.py:160-199`); its
    accumulator is compared with lane 0 of the JAX package's lane-replicated
    packed copy. (Momentum and Adam: the rule tests above, and the models.)"""
    cfg_fn = {"tiny": _tiny, "small": _small_cfg}[cfg_name]
    rng = _rng(7)
    r_cfg = cfg_fn(ref_dlrm)
    d, bag = r_cfg.sparse_feature_size, r_cfg.embedding_bag_size
    r_ops = [op for op in ref_dlrm.make_dlrm_model(r_cfg).graph.compute_ops
             if isinstance(op, ref_emb.Embedding)][:2]
    p_ops = [op for op in port_dlrm.make_dlrm_model(cfg_fn(port_dlrm), device="cpu").graph.compute_ops
             if isinstance(op, port_emb.Embedding)][:2]
    r_opt, p_opt = _opts("adagrad", initial_accumulator=0.1)
    r_params, p_params, r_x, p_x, r_g, p_g, r_st, p_st = ({} for _ in range(8))
    for r_op, p_op in zip(r_ops, p_ops):
        vocab = r_op.num_entries
        w = _bf16(rng.standard_normal((vocab, d)) * 0.1)
        idx = rng.integers(-1, vocab + 2, (32, bag))
        idx[:8] = 3  # duplicates
        g = torch.from_numpy(rng.standard_normal((32, d)).astype(np.float32)).to(torch.bfloat16)
        r_op.packed, r_op.chunk_packs = True, 1024
        p_op.kernel_route = True
        r_params[r_op.name] = {"weight": _packed(w, jnp.bfloat16)}
        p_params[p_op.name] = {"weight": torch.from_numpy(w).to(torch.bfloat16)}
        r_x[r_op.name], p_x[p_op.name] = [jnp.asarray(idx)], [torch.from_numpy(idx)]
        r_g[r_op.name] = [jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)]
        p_g[p_op.name] = [g]
        r_st[r_op.name] = r_op.sparse_state_init(r_opt)
        p_st[p_op.name] = p_op.sparse_state_init(p_opt, "cpu")
    lr = 0.25  # the step's rate from the caller, not opt.lr
    new, r_st = ref_engine.apply_sparse_updates(
        r_ops, r_params, r_x, r_g, r_opt, r_st, None, lr=jnp.float32(lr))
    r_params.update(new)
    p_st = port_engine.apply_sparse_updates(
        p_ops, p_params, p_x, p_g, p_opt, p_st, None, lr=torch.tensor(lr))
    for r_op in r_ops:
        v = r_op.num_entries
        want_t = _unpacked(r_params[r_op.name]["weight"], v, d)
        got_t = p_params[r_op.name]["weight"].float().numpy()
        # bf16 table, f32 sums of at most 16 entries a row in another order:
        # one bf16 step of a value where that flips a rounding
        _close(got_t, want_t, rtol=2 * BF16_STEP, atol=1e-6, exact_share=0.99)
        want_s = _unpacked(r_st[r_op.name], v, d)
        assert np.array_equal(want_s, np.repeat(want_s[:, :1], d, axis=1))  # lane-replicated
        # f32 sums of up to 16 entries a row in another order
        _close(p_st[r_op.name].numpy(), want_s[:, 0], rtol=32 * F32_UNIT, atol=1e-9)


# ------------------------------------------------------------------ whole models


def _pair(cfg_fn, ffkw, opt_kw, sparse_kw=None, metrics=("METRICS_ACCURACY",)):
    """A JAX model and a port model (CPU) compiled alike, the port carrying
    the JAX model's initial weights. opt_kw / sparse_kw: (class name, args)."""
    def make(pkg, kw):
        return None if kw is None else getattr(pkg, kw[0])(**kw[1])

    rm = ref_dlrm.make_dlrm_model(cfg_fn(ref_dlrm), ref.FFConfig(**ffkw))
    rm.compile(make(ref, opt_kw), ref.LossType.LOSS_BINARY_CROSSENTROPY,
               [ref.MetricsType[m] for m in metrics], sparse_optimizer=make(ref, sparse_kw))
    pm = port_dlrm.make_dlrm_model(cfg_fn(port_dlrm), port.FFConfig(**ffkw), device="cpu")
    pm.compile(make(port, opt_kw), port.LossType.LOSS_BINARY_CROSSENTROPY,
               [port.MetricsType[m] for m in metrics], sparse_optimizer=make(port, sparse_kw))
    pm.set_parameters(params_from_jax({op: rm.get_weights(op) for op in rm.get_parameters()}))
    return rm, pm


def _train_both(rm, pm, cfg, bs, steps, seed):
    feeds, labels = ref_synthetic.random_batches(cfg, bs * steps, seed=seed)
    losses = {"ref": [], "port": []}
    for i in range(steps):
        sl = slice(bs * i, bs * (i + 1))
        batch = {k: v[sl] for k, v in feeds.items()}
        losses["ref"].append(float(rm.train_batch(batch, labels[sl])))
        losses["port"].append(float(pm.train_batch(batch, labels[sl])))
    return losses


def _weights_close(rm, pm, atol, share_atol=None, share=0.99):
    """Every weight within atol; with share_atol, that share of every op's
    weights within it."""
    for op in rm.get_parameters():
        for k, want in rm.get_weights(op).items():
            want = np.asarray(want, np.float32)
            err = np.abs(pm.get_weights(op)[k] - want)
            assert err.max() <= atol, (op, k, err.max())
            if share_atol is not None:
                assert np.mean(err <= share_atol) >= share, (op, k, np.mean(err <= share_atol))


ADAM_ALPHA = 0.01
# Adam: at most about alpha * (1 - beta1) / sqrt(1 - beta2) ~ 3.2 alpha a
# step where two summation orders give a gradient component near 0 other
# signs; over 3 steps
ADAM_ATOL = 3 * 3.2 * ADAM_ALPHA


@pytest.mark.parametrize("rule, tables", [
    ("momentum", "off"), ("nesterov", "off"), ("adam", "on"), ("adagrad", "on"),
])
def test_small_dlrm_trains_like_the_reference(rule, tables):
    """test_packed_update.py's small DLRM (3 sparse tables, D = 16, bags of
    2), f32 compute, 3 steps from carried weights, on the scatter route
    ("off") or the kernel route ("on", bf16 tables, JAX kernels
    interpreted)."""
    name = {"momentum": "SGDOptimizer", "nesterov": "SGDOptimizer", "adam": "AdamOptimizer",
            "adagrad": "RowWiseAdagradOptimizer"}[rule]
    args = {"momentum": dict(lr=0.05, momentum=0.9), "nesterov": dict(lr=0.05, momentum=0.9, nesterov=True),
            "adam": dict(alpha=ADAM_ALPHA), "adagrad": dict(lr=0.05)}[rule]
    ffkw = dict(batch_size=32, compute_dtype="float32", onehot_embedding_threshold=0, packed_tables=tables)
    if tables == "on":
        ffkw["table_dtype"] = "bfloat16"
    rm, pm = _pair(_small_cfg, ffkw, (name, args))
    assert [op.kernel_route for op in pm._sparse_ops] == [tables == "on"] * 3
    for op in pm._sparse_ops:  # bf16 route tables keep f32 pools (test_packed_update.py:555)
        st = pm._opt_state["sparse"][op.name]
        assert all(p.dtype == torch.float32 for p in (st.values() if isinstance(st, dict) else [st]))
    losses = _train_both(rm, pm, _small_cfg(ref_dlrm), 32, 3, seed=3)
    # f32 sums in another order; on bf16 tables a flipped rounding moves a
    # looked-up value one bf16 step, 2^-8 of values near 0.1
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-4, atol=1e-5)
    if rule == "adam":
        _weights_close(rm, pm, ADAM_ATOL, share_atol=2 * BF16_STEP * 0.2)
    elif rule == "adagrad":  # at most lr * sqrt(D) = 4 lr a step, as Adam's bound
        _weights_close(rm, pm, 3 * 4 * 0.05, share_atol=2 * BF16_STEP * 0.2)
    else:
        _weights_close(rm, pm, 2 * BF16_STEP * 0.2 if tables == "on" else 1e-5)


@pytest.mark.parametrize("tables", ["off", "on"])
def test_mixed_adam_dense_and_rowwise_adagrad_tables_like_the_reference(tables):
    """tests/test_training.py:290: compile(optimizer=Adam,
    sparse_optimizer=RowWiseAdagrad), the tables at the sparse optimizer's
    own rate; 3 steps against the JAX package."""
    cfg = lambda pkg: pkg.DLRMConfig(sparse_feature_size=16, embedding_size=[300, 200],  # noqa: E731
                                     embedding_bag_size=1, mlp_bot=[4, 16, 16], mlp_top=[48, 16, 1],
                                     batch_size=32)
    rm, pm = _pair(cfg, dict(batch_size=32, compute_dtype="float32", seed=7,
                             onehot_embedding_threshold=0, packed_tables=tables),
                   ("AdamOptimizer", dict(alpha=ADAM_ALPHA)), ("RowWiseAdagradOptimizer", dict(lr=0.05)))
    assert isinstance(pm.sparse_optimizer, port.RowWiseAdagradOptimizer)
    assert [op.kernel_route for op in pm._sparse_ops] == [tables == "on"] * 2
    losses = _train_both(rm, pm, cfg(ref_dlrm), 32, 3, seed=9)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-4, atol=1e-5)
    # the tables' row-wise AdaGrad moves a weight by at most lr * sqrt(D) =
    # 4 lr a step (acc holds at least the step's own mean of g^2), the same
    # for a row whose gradient is near 0
    _weights_close(rm, pm, max(ADAM_ATOL, 3 * 4 * 0.05),
                   share_atol=1e-5 if tables == "off" else 2 * BF16_STEP * 0.2)
    got = pm._opt_state["sparse"]["table_0"].numpy()
    want = rm._opt_state["sparse"]["table_0"]
    want = _unpacked(want, 300, 16)[:, 0] if tables == "on" else np.asarray(want)
    _close(got, want, rtol=1e-5, atol=1e-9)


def test_kaggle_shaped_adam_and_rowwise_adagrad_tables_at_lr_005_like_the_reference():
    """The CPU side of tests/test_torch_port_cuda.py's kaggle-shaped Adam +
    row-wise AdaGrad test (26 tables at D = 16, vocabs capped at 20000, 10
    on the kernel route in bf16, bf16 compute, batch 128, AdaGrad lr 0.05,
    3 steps) against the JAX package from the same weights, under that
    test's bounds: the two CPU implementations round the bf16 backward in
    other places too, and row-wise AdaGrad's normalized step carries a
    difference in a row's gradient direction into a share of lr (see
    there). Every weight within 3 * 4 * lr + 2e-3; all but 1 in 1000 of
    the weights AdaGrad does not normalize within 2e-3, and of all weights
    within 2e-3 + lr / 4."""
    lr, bs = 0.05, 128

    def cfg_fn(pkg):
        cfg = pkg.kaggle_config(batch_size=bs)
        cfg.embedding_size = [min(v, 20_000) for v in cfg.embedding_size]
        return cfg

    rm, pm = _pair(cfg_fn, dict(batch_size=bs, compute_dtype="bfloat16", table_dtype="bfloat16",
                                packed_tables="on", seed=5),
                   ("AdamOptimizer", dict(alpha=1e-3)), ("RowWiseAdagradOptimizer", dict(lr=lr)))
    route = {f"{op.name}/weight" for op in pm._sparse_ops if op.kernel_route}
    assert len(route) == 10
    losses = _train_both(rm, pm, cfg_fn(ref_dlrm), bs, 3, seed=5)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=0, atol=2e-3)
    errs = {f"{op}/{k}": np.abs(pm.get_weights(op)[k] - np.asarray(w, np.float32))
            for op in rm.get_parameters() for k, w in rm.get_weights(op).items()}
    flat = np.concatenate([e.reshape(-1) for e in errs.values()])
    rest = np.concatenate([e.reshape(-1) for n, e in errs.items() if n not in route])
    assert flat.max() <= 3 * 4 * lr + 2e-3, flat.max()
    assert np.mean(rest <= 2e-3) >= 0.999, np.mean(rest <= 2e-3)
    assert np.mean(flat <= 2e-3 + lr / 4) >= 0.999, np.mean(flat <= 2e-3 + lr / 4)


def test_dense_adam_alpha_t_and_dense_adagrad_match_the_reference():
    """A model whose tables all take the one-hot path: dense Adam with its
    bias-corrected alpha_t, then dense row-wise AdaGrad, 3 steps each."""
    kw = dict(batch_size=32, compute_dtype="float32", onehot_embedding_threshold=1000)
    rm, pm = _pair(_tiny, kw, ("AdamOptimizer", dict(alpha=ADAM_ALPHA, weight_decay=1e-3)))
    assert pm._sparse_ops == []
    losses = _train_both(rm, pm, _tiny(ref_dlrm), 32, 3, seed=4)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5, atol=1e-6)
    _weights_close(rm, pm, ADAM_ATOL, share_atol=1e-6)
    assert pm._opt_state["step"] == int(rm._opt_state["step"]) == 3
    for t in (1, 2, 7):  # the JAX package's alpha_t (optimizer.py:201-207), f32
        tf = jnp.float32(t)
        want = jnp.float32(ADAM_ALPHA) * jnp.sqrt(1.0 - jnp.power(0.999, tf)) / (1.0 - jnp.power(0.9, tf))
        got = float(port.AdamOptimizer(alpha=ADAM_ALPHA).alpha_t(None, t, "cpu"))
        np.testing.assert_allclose(got, float(want), rtol=2 * F32_UNIT)
    rm, pm = _pair(_tiny, kw, ("RowWiseAdagradOptimizer", dict(lr=0.1, initial_accumulator=0.1)))
    losses = _train_both(rm, pm, _tiny(ref_dlrm), 32, 3, seed=5)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5, atol=1e-6)
    _weights_close(rm, pm, 1e-5)


def test_sparse_adam_rate_is_alpha_t_of_the_dense_step():
    """The sparse Adam rate of step t is the dense state's rate times the
    bias correction at t, taken after the dense update (step 1: 0.316 of
    alpha); a distinct sparse optimizer keeps its own rate."""
    pm = port_dlrm.make_dlrm_model(_tiny(port_dlrm), port.FFConfig(batch_size=32), device="cpu")
    pm.compile(port.AdamOptimizer(alpha=0.02))
    # the step's scalars, as the step reads them from the device
    rate = pm._sparse_rate({"lr": torch.tensor(0.02), "step": 1},
                           torch.from_numpy(pm._scalar_table(1, 1)[0]))
    t = jnp.float32(1)  # the JAX package's formula (core/ffmodel.py:971-977), f32
    want = jnp.float32(0.02) * jnp.sqrt(1.0 - jnp.power(0.999, t)) / (1.0 - jnp.power(0.9, t))
    np.testing.assert_allclose(float(rate), float(want), rtol=2 * F32_UNIT)
    pm.compile(port.AdamOptimizer(alpha=0.02), sparse_optimizer=port.RowWiseAdagradOptimizer(lr=0.3))
    # the distinct optimizer's own rate, a device tensor made at compile
    own = pm._sparse_rate({"lr": torch.tensor(0.02), "step": 1}, torch.from_numpy(pm._scalar_table(1, 1)[0]))
    assert own.dtype == torch.float32 and float(own) == float(np.float32(0.3))


def test_set_learning_rate_leaves_a_distinct_sparse_optimizer_its_rate():
    """set_learning_rate sets the dense rate; the tables follow it when the
    sparse optimizer is the dense one, and keep their own otherwise, as in
    the JAX package."""
    feeds, labels = ref_synthetic.random_batches(_small_cfg(ref_dlrm), 32, seed=2)
    ffkw = dict(batch_size=32, compute_dtype="float32", onehot_embedding_threshold=0)
    for sparse_kw, tables_move in ((None, False), (("RowWiseAdagradOptimizer", dict(lr=0.05)), True)):
        rm, pm = _pair(_small_cfg, ffkw, ("SGDOptimizer", dict(lr=0.05)), sparse_kw)
        for m in (rm, pm):
            m.set_learning_rate(0.0)
        before = pm.get_weights("table_0")["weight"].copy()
        dense_before = pm.get_weights("top_mlp_0")["kernel"].copy()
        rm.train_batch(feeds, labels)
        pm.train_batch(feeds, labels)
        assert np.array_equal(pm.get_weights("top_mlp_0")["kernel"], dense_before)
        assert (not np.array_equal(pm.get_weights("table_0")["weight"], before)) == tables_move
        np.testing.assert_allclose(pm.get_weights("table_0")["weight"],
                                   np.asarray(rm.get_weights("table_0")["weight"], np.float32),
                                   rtol=0, atol=1e-5)


def test_custom_optimizer_subclass_keeps_the_scatter_route():
    """The kernel route takes SGD, Adam and row-wise AdaGrad; an Optimizer
    subclass of its own keeps its scatter rule (JAX package
    core/ffmodel.py:803-809), and trains."""

    class HalfSGD(Optimizer):
        supports_sparse = True

        def __init__(self):
            self.inner = port.SGDOptimizer(lr=0.05)

        def init(self, params, device):
            return self.inner.init(params, device)

        def update(self, grads, state, params):
            return self.inner.update(grads, state, params)

        def sparse_row_update(self, table, state, rows, row_grads, lr=None):
            return self.inner.sparse_row_update(table, state, rows, 0.5 * row_grads, lr=lr)

    pm = port_dlrm.make_dlrm_model(_small_cfg(port_dlrm), port.FFConfig(
        batch_size=32, onehot_embedding_threshold=0, packed_tables="on"), device="cpu")
    pm.compile(HalfSGD(), port.LossType.LOSS_BINARY_CROSSENTROPY)
    assert pm._sparse_ops and not any(op.kernel_route for op in pm._sparse_ops)
    before = pm.get_weights("table_0")["weight"].copy()
    feeds, labels = ref_synthetic.random_batches(_small_cfg(ref_dlrm), 32, seed=2)
    assert np.isfinite(float(pm.train_batch(feeds, labels)))
    assert not np.array_equal(pm.get_weights("table_0")["weight"], before)


@pytest.mark.parametrize("rule", ["momentum", "adam", "adagrad"])
def test_sparse_state_shapes_on_both_routes(rule):
    """velocity [V, D]; Adam [2, V, D] on the scatter route, {"m", "v"} of
    [V, D] on the kernel route; AdaGrad [V] at its initial value; all f32."""
    _, p_opt = _opts(rule, **({"initial_accumulator": 0.5} if rule == "adagrad" else {}))
    for route in (False, True):
        op = port_emb.Embedding("t", port.TensorSpec((8, 1), port.DataType.DT_INT64), 30, 4)
        op.kernel_route = route
        st = op.sparse_state_init(p_opt, "cpu")
        if rule == "adam" and route:
            assert set(st) == {"m", "v"} and all(s.shape == (30, 4) for s in st.values())
            continue
        want = {"momentum": (30, 4), "adam": (2, 30, 4), "adagrad": (30,)}[rule]
        assert tuple(st.shape) == want and st.dtype == torch.float32
        assert float(st.max()) == (0.5 if rule == "adagrad" else 0.0)


# ------------------------------------------------------------------ K5b


def _trap_bags(v, b, h, seed):
    idx = _rng(seed).integers(0, v, (b, h))
    idx[:, 1] = idx[:, 0]  # n_r >= 2
    idx[::3, 2] = idx[::3, 0]  # n_r = 3
    idx[::5, 3] = -1  # padding
    idx[::4, 4] = v + 2  # matches no row, counts in AVG's divisor
    idx[7] = -1  # a fully padded bag
    return idx


@pytest.mark.parametrize("aggr", [SUM, AVG], ids=["sum", "avg"])
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_onehot_backward_plain_version_matches_jax_grad(aggr, cdt):
    """K5b's plain version, through the op's autograd, against `jax.grad` of
    `onehot_embedding_pallas` (its `_bwd_kernel` interpreted): bags of 6
    with duplicates, indices >= V, padding and a fully padded bag."""
    v, d, b = 37, 16, 40
    table = _rng(8).standard_normal((v, d)).astype(np.float32)
    idx = _trap_bags(v, b, 6, 9)
    g = _rng(10).standard_normal((b, d)).astype(np.float32)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[cdt]
    r_aggr = getattr(ref.AggrMode, aggr.name)

    def f(t):
        return jnp.sum(onehot_embedding_pallas(t, jnp.asarray(idx), r_aggr, 8, True, jdt) * g)

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    (dt,) = torch.autograd.grad((onehot_embedding(tt, torch.from_numpy(idx), aggr, cdt)
                                 * torch.from_numpy(g)).sum(), [tt])
    # products of the same weight and cdt(g): exact in f32 for bf16, one f32
    # rounding each for f32; summed in f32 over the bags in another order
    mag = np.zeros((v, d))
    np.add.at(mag, np.where((idx >= 0) & (idx < v), idx, 0).reshape(-1),
              np.repeat(np.abs(g), 6, axis=0) * ((idx >= 0) & (idx < v)).reshape(-1, 1))
    assert np.all(np.abs(dt.numpy() - want) <= 2 * b * F32_UNIT * mag + 1e-7)
    assert np.array_equal(dt.numpy() == 0, want == 0)  # the same rows untouched
