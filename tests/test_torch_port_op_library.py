"""The port's op library against the JAX package, op by op, on the CPU.

Each op is built by the same FFModel verb in both packages; the JAX op's
parameters (its own initializers) are carried to the port through
`params_from_jax`, the same numpy inputs go through both graphs, and the
outputs, and where the op has a gradient the gradients of every parameter
and float input under one random cotangent, are compared.

Tolerances. With f32 compute both sides sum f32 products in other orders:
rtol 1e-5, atol 1e-6. With bf16 compute both round the same operands to
bf16 and sum exact products in f32, but a sum that differs in its last f32
bit can round an intermediate to the neighbouring bf16 value: one bf16
step (2^-8 relative) carried through the next product; the port's tests
bound that by 2e-3 on outputs (chip_smoke.py E2E_ATOL), and by the same
relative to the cotangent-weighted gradients.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.core.graph import OpContext as RefContext
from dlrm_flexflow_tpu.ops import cache as ref_cache
from dlrm_flexflow_tpu.ops import moe as ref_moe

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.core.graph import OpContext as PortContext
from dlrm_flexflow_tpu_torch.core.graph import hash32, keep_mask, step_key
from dlrm_flexflow_tpu_torch.ops import cache as port_cache
from dlrm_flexflow_tpu_torch.ops import moe as port_moe

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-3, atol=2e-3)
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(build, cdt="float32", batch=4):
    """The JAX and port models built by `build(model)` (its inputs named
    as it likes), the JAX parameters and their port copy."""
    r = ref.FFModel(ref.FFConfig(batch_size=batch, compute_dtype=cdt))
    build(r)
    p = port.FFModel(port.FFConfig(batch_size=batch, compute_dtype=cdt), device="cpu")
    build(p)
    rparams = r.graph.init_params(jax.random.PRNGKey(3))
    np_params = {op: {k: np.asarray(v) for k, v in sub.items()} for op, sub in rparams.items()}
    return r, p, rparams, params_from_jax(np_params)


def _run(build, feeds, cdt="float32", grads=True, seq_length=-1, batch=4):
    """(JAX outputs, port outputs, JAX grads, port grads) of the last op;
    grads: {("param", op, key) | ("input", name): array} of sum(out * cot)
    over the float outputs, cot from a seed."""
    r, p, rparams, pparams = _both(build, cdt, batch)
    r_op, p_op = r.graph.compute_ops[-1], p.graph.compute_ops[-1]
    rctx = RefContext(training=False, compute_dtype=jnp.dtype(cdt), seq_length=seq_length)
    pctx = PortContext(training=False, compute_dtype=DT[cdt], seq_length=seq_length)
    float_in = [k for k, v in feeds.items() if v.dtype == np.float32]
    cots = [_np(t.shape, 11 + i) for i, t in enumerate(r_op.outputs)]
    is_float = [jnp.issubdtype(t.dtype.to_jnp(), jnp.floating) for t in r_op.outputs]

    def ref_fn(params, fin):
        outs = r.graph.execute(params, {**feeds, **fin}, rctx, fetch=r_op.outputs)
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c, f in zip(outs, cots, is_float) if f), outs

    fin = {k: jnp.asarray(feeds[k]) for k in float_in}
    if grads:
        (_, r_outs), (g_par, g_in) = jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(rparams, fin)
    else:
        r_outs = ref_fn(rparams, fin)[1]
    leaves = {op: {k: v.clone().requires_grad_(grads) for k, v in sub.items()} for op, sub in pparams.items()}
    tin = {k: torch.from_numpy(v.copy()) for k, v in feeds.items()}
    for k in float_in:
        tin[k].requires_grad_(grads)
    p_outs = p.graph.execute(leaves, tin, pctx, fetch=p_op.outputs)
    out = {"ref": [np.asarray(jnp.asarray(o).astype(jnp.float32)) if f else np.asarray(o)
                   for o, f in zip(r_outs, is_float)],
           "port": [o.detach().float().numpy() if f else o.numpy() for o, f in zip(p_outs, is_float)]}
    if grads:
        total = sum((o.float() * torch.from_numpy(c)).sum() for o, c, f in zip(p_outs, cots, is_float) if f)
        flat = [(("param", op, k), v) for op, sub in leaves.items() for k, v in sub.items()]
        flat += [(("input", k), tin[k]) for k in float_in]
        gs = torch.autograd.grad(total, [v for _, v in flat], allow_unused=True, materialize_grads=True)
        out["port_grads"] = {key: g.numpy() for (key, _), g in zip(flat, gs)}
        out["ref_grads"] = {**{("param", op, k): np.asarray(v) for op, sub in g_par.items() for k, v in sub.items()},
                            **{("input", k): np.asarray(v) for k, v in g_in.items()}}
    return out


def _close(out, tol):
    for a, b in zip(out["ref"], out["port"]):
        assert a.shape == b.shape and a.dtype == b.dtype or (a.dtype.kind == b.dtype.kind == "f")
        np.testing.assert_allclose(b, a, **tol)
    if "port_grads" in out:
        assert out["port_grads"].keys() == out["ref_grads"].keys()
        for key, g in out["ref_grads"].items():
            np.testing.assert_allclose(out["port_grads"][key], g, **tol, err_msg=str(key))


# ------------------------------------------------------------------ elementwise
BINARY = ["add", "subtract", "multiply", "divide"]


@pytest.mark.parametrize("verb", BINARY)
def test_element_binary_broadcasts_like_jax(verb):
    def build(m):
        x = m.create_tensor([4, 3, 5], name="x")
        y = m.create_tensor([3, 1], name="y")
        getattr(m, verb)(x, y)

    feeds = {"x": _np((4, 3, 5), 1), "y": _np((3, 1), 2) + (3.0 if verb == "divide" else 0.0)}
    _close(_run(build, feeds), F32_TOL)


UNARY = [("relu", None), ("sigmoid", None), ("tanh", None), ("gelu", None), ("exp", None),
         ("identity", None), ("elu", None), ("scalar_multiply", 1.5), ("scalar_add", -0.25),
         ("scalar_sub", 2.0), ("scalar_truediv", 3.0)]


@pytest.mark.parametrize("verb, scalar", UNARY)
def test_element_unary_and_scalar_like_jax(verb, scalar):
    def build(m):
        x = m.create_tensor([6, 7], name="x")
        getattr(m, verb)(x) if scalar is None else getattr(m, verb)(x, scalar)

    _close(_run(build, {"x": _np((6, 7), 3, 2.0)}), F32_TOL)


# ------------------------------------------------------------------ regularizers
def test_softmax_like_jax():
    def build(m):
        m.softmax(m.create_tensor([5, 9], name="x"))

    _close(_run(build, {"x": _np((5, 9), 4, 10.0)}), F32_TOL)


def _dropout_model(rate, seed=7, shape=(64, 48), **cfg):
    m = port.FFModel(port.FFConfig(batch_size=shape[0], compute_dtype="float32", seed=seed, **cfg), device="cpu")
    x = m.create_tensor(list(shape), name="x")
    m.dropout(x, rate)
    m.compile(port.SGDOptimizer(lr=0.1))
    return m


def test_dropout_identity_cases_are_bit_for_bit():
    x = _np((64, 48), 5)
    at_zero = _dropout_model(0.0)
    assert not at_zero._stochastic
    assert np.array_equal(at_zero.forward({"x": x}, training=True).numpy(), x)
    m = _dropout_model(0.3)
    assert m._stochastic
    assert np.array_equal(m.forward({"x": x}, training=False).numpy(), x)
    assert np.array_equal(m.predict({"x": x}), x)


def test_dropout_keeps_x_over_keep_and_its_mask_is_a_function_of_seed_step_and_guid():
    """While training each entry is 0 or x / keep, the kept share within 5
    sigma of keep, and the mask depends on (config.seed, step, guid) alone:
    a second model of the same seed gives it again, the next step or
    another seed another. The JAX package's bits differ by design
    (threefry against the port's integer hash)."""
    rate, x = 0.3, _np((64, 48), 6) + 5.0  # no zero entries
    keep = 1.0 - rate
    a, b, other = _dropout_model(rate), _dropout_model(rate), _dropout_model(rate, seed=8)
    y = a.forward({"x": x}, training=True).numpy()
    kept = y != 0
    np.testing.assert_allclose(y[kept], (torch.from_numpy(x) / keep).numpy()[kept], rtol=0, atol=0)
    n = x.size
    assert abs(kept.mean() - keep) <= 5 * np.sqrt(keep * (1 - keep) / n)
    assert np.array_equal(b.forward({"x": x}, training=True).numpy(), y)
    assert not np.array_equal(other.forward({"x": x}, training=True).numpy() != 0, kept)
    a._step_count += 1
    assert not np.array_equal(a.forward({"x": x}, training=True).numpy() != 0, kept)
    # the op's key folds its guid into the step's key
    ctx = PortContext(rng=step_key(7, torch.tensor(0)))
    op = a.graph.compute_ops[0]
    mask = keep_mask(ctx.op_rng(op), x.shape, keep).numpy()
    assert np.array_equal(mask, kept)
    assert int(ctx.op_rng(op)) == hash32(hash32(hash32(7) ^ 0) ^ hash32(op.guid))


def test_dropout_in_training_steps_follows_the_step_count():
    """train_batch and train_chunk (a loop of the same steps on the CPU)
    draw the same masks step by step: one model trained by train_batch and
    one by train_chunk end with the same weights."""
    def make():
        m = port.FFModel(port.FFConfig(batch_size=16, compute_dtype="float32", seed=3), device="cpu")
        x = m.create_tensor([16, 12], name="x")
        m.dense(m.dropout(m.dense(x, 24, name="h"), 0.5), 2, name="out")
        m.compile(port.SGDOptimizer(lr=0.1))
        return m

    x, y = _np((3, 16, 12), 7), _np((3, 16, 2), 8)
    a, b = make(), make()
    for i in range(3):
        a.train_batch({"x": x[i]}, y[i])
    b.train_chunk({"x": x}, y)
    for name in ("h", "out"):
        for k, v in a.get_weights(name).items():
            assert np.array_equal(v, b.get_weights(name)[k])


# ------------------------------------------------------------------ shape ops
SHAPES = [
    ("split", lambda m, x: m.split(x, [2, 5], 1)),
    ("split-equal", lambda m, x: m.split(x, 3, 2)),
    ("flat", lambda m, x: m.flat(x)),
    ("reshape", lambda m, x: m.reshape(x, (4, 21, 3))),
    ("transpose", lambda m, x: m.transpose(x, (2, 0, 1))),
    ("reverse", lambda m, x: m.reverse(x, -2)),
]


@pytest.mark.parametrize("case, verb", SHAPES, ids=[c for c, _ in SHAPES])
def test_shape_ops_like_jax(case, verb):
    def build(m):
        verb(m, m.create_tensor([4, 7, 9], name="x"))

    out = _run(build, {"x": _np((4, 7, 9), 9)})
    assert out["ref"][0].shape == out["port"][0].shape
    for a, b in zip(out["ref"], out["port"]):
        assert np.array_equal(a, b)
    for key, g in out["ref_grads"].items():
        assert np.array_equal(out["port_grads"][key], g)


# ------------------------------------------------------------------ batch_matmul
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_batch_matmul_like_jax(cdt):
    def build(m):
        m.batch_matmul(m.create_tensor([2, 3, 5, 6], name="a"), m.create_tensor([2, 3, 6, 7], name="b"))

    out = _run(build, {"a": _np((2, 3, 5, 6), 10), "b": _np((2, 3, 6, 7), 11)}, cdt=cdt)
    _close(out, F32_TOL if cdt == "float32" else BF16_TOL)


def test_batch_matmul_seq_length_truncates_and_pads_like_jax():
    """tests/test_op_library.py:43's case: A's rows and B's columns cut to
    seq_length 3, the product zero-padded back to [2, 4, 4]."""
    def build(m):
        m.batch_matmul(m.create_tensor([2, 4, 6], name="a"), m.create_tensor([2, 6, 4], name="b"),
                       a_seq_length_dim=1, b_seq_length_dim=0)

    av, bv = _np((2, 4, 6), 1), _np((2, 6, 4), 2)
    out = _run(build, {"a": av, "b": bv}, seq_length=3, batch=2)
    _close(out, F32_TOL)
    y = out["port"][0]
    np.testing.assert_allclose(y[:, :3, :3], av[:, :3, :] @ bv[:, :, :3], rtol=1e-4, atol=1e-5)
    assert np.all(y[:, 3:, :] == 0) and np.all(y[:, :, 3:] == 0)


# ------------------------------------------------------------------ attention
ATTENTION = [
    # cdt, kdim, vdim, bias
    ("float32", 0, 0, True),
    ("float32", 6, 10, True),
    ("float32", 0, 0, False),
    ("bfloat16", 6, 10, True),
]


@pytest.mark.parametrize("cdt, kdim, vdim, bias", ATTENTION)
def test_multihead_attention_forward_and_every_gradient_like_jax(cdt, kdim, vdim, bias):
    dk, dv = kdim or 8, vdim or 8

    def build(m):
        q = m.create_tensor([2, 5, 8], name="q")
        k = m.create_tensor([2, 3, dk], name="k")
        v = m.create_tensor([2, 3, dv], name="v")
        m.multihead_attention(q, k, v, 8, 2, kdim=kdim, vdim=vdim, bias=bias)

    feeds = {"q": _np((2, 5, 8), 1), "k": _np((2, 3, dk), 2), "v": _np((2, 3, dv), 3)}
    out = _run(build, feeds, cdt=cdt, batch=2)
    keys = {k for _, _, k in (key for key in out["port_grads"] if key[0] == "param")}
    assert keys == ({"wq", "wk", "wv", "wo"} | ({"bq", "bk", "bv", "bo"} if bias else set()))
    _close(out, F32_TOL if cdt == "float32" else BF16_TOL)


def test_attention_dropout_drops_probabilities_only_while_training():
    m = port.FFModel(port.FFConfig(batch_size=2, compute_dtype="float32", seed=2), device="cpu")
    x = m.create_tensor([2, 6, 8], name="x")
    m.multihead_attention(x, x, x, 8, 2, dropout=0.5)
    m.compile(port.SGDOptimizer(lr=0.1))
    xv = _np((2, 6, 8), 4)
    plain = m.forward({"x": xv}).numpy()
    dropped = m.forward({"x": xv}, training=True).numpy()
    assert m._stochastic and np.isfinite(dropped).all() and not np.allclose(plain, dropped)
    assert np.array_equal(m.forward({"x": xv}, training=True).numpy(), dropped)


# ------------------------------------------------------------------ MoE
def test_top_k_matches_jax_and_puts_the_lower_index_first_among_ties():
    x = np.array([[0.1, 0.5, 0.5, 0.2, 0.5], [3.0, 3.0, 1.0, 3.0, 2.0], [0.0, 0.0, 0.0, 0.0, 0.0]],
                 np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 3)
    op = port_moe.TopK("topk", port.TensorSpec((3, 5)), 3)
    got_v, got_i = op.forward({}, [torch.from_numpy(x)], PortContext())
    assert got_i.dtype == torch.int32
    assert np.array_equal(got_i.numpy(), np.asarray(want_i)) and np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.numpy().tolist() == [[1, 2, 4], [0, 1, 3], [0, 1, 2]]

    def build(m):
        m.top_k(m.create_tensor([6, 7], name="x"), 3)

    _close(_run(build, {"x": _np((6, 7), 5)}), F32_TOL)


def _moe_pair(b, d, n, k, alpha):
    def build(m):
        data = m.create_tensor([b, d], name="data")
        gate = m.create_tensor([b, n], name="gate")
        vals, idx = m.top_k(gate, k)
        buckets = m.group_by(data, idx, n, alpha)
        m.aggregate([vals, idx, idx, gate] + buckets, n)
    return build


@pytest.mark.parametrize("b, n, k, alpha", [(12, 4, 2, 2.0), (16, 3, 2, 0.5), (9, 4, 1, 1.0)])
def test_group_by_and_aggregate_forward_and_gradients_like_jax(b, n, k, alpha):
    """GroupBy -> Aggregate through TopK at capacities that fit (alpha 2)
    and that drop tokens (alpha 0.5 and 1.0: capacity under the arrivals):
    outputs and the gradients of data and gate values match the dense-mask
    einsums; at alpha 0.5 GroupBy's buckets alone match bit for bit too
    (dropped tokens are the JAX package's exactly)."""
    d = 5
    feeds = {"data": _np((b, d), 1), "gate": _np((b, n), 2)}
    _close(_run(_moe_pair(b, d, n, k, alpha), feeds, batch=b), F32_TOL)
    if alpha != 0.5:
        return

    def buckets_only(m):
        data = m.create_tensor([b, d], name="data")
        gate = m.create_tensor([b, n], name="gate")
        m.group_by(data, m.top_k(gate, k)[1], n, alpha)

    out = _run(buckets_only, feeds, batch=b)
    for a, g in zip(out["ref"], out["port"]):
        assert np.array_equal(a, g)
    np.testing.assert_allclose(out["port_grads"][("input", "data")], out["ref_grads"][("input", "data")],
                               **F32_TOL)


def test_dispatch_slots_drop_exactly_the_jax_packages_tokens():
    rng = np.random.default_rng(3)
    assign = rng.integers(-1, 5, size=(40, 3)).astype(np.int32)  # -1 and 4 are outside n = 4
    for cap in (1, 5, 13, 40):
        mask = np.asarray(ref_moe.dispatch_mask(jnp.asarray(assign), 4, cap))  # [B, K, n, cap]
        dest = port_moe.dispatch_slots(torch.from_numpy(assign), 4, cap).numpy()
        want = np.full(assign.shape, 4 * cap)
        bb, jj, ee, cc = np.nonzero(mask)
        want[bb, jj] = ee * cap + cc
        assert np.array_equal(dest, want), cap
    assert port_moe.moe_capacity(2, 4, 16384, 2.0) == ref_moe.moe_capacity(2, 4, 16384, 2.0) == 16384


def test_aggregate_spec_and_the_load_balance_loss_like_jax():
    b, d, n, k = 10, 4, 3, 2

    def build(m):
        data = m.create_tensor([b, d], name="data")
        gate = m.create_tensor([b, n], name="gate")
        vals, idx = m.top_k(gate, k)
        m.aggregate_spec([vals, idx, idx, gate] + m.group_by(data, idx, n, 1.5), n, lambda_bal=0.1)

    p = port.FFModel(port.FFConfig(batch_size=b), device="cpu")
    build(p)
    assert type(p.graph.compute_ops[-1]).__name__ == "AggregateSpec" and p.graph.compute_ops[-1].lambda_bal == 0.1
    feeds = {"data": _np((b, d), 3), "gate": _np((b, n), 4)}
    _close(_run(build, feeds, batch=b), F32_TOL)
    probs = np.abs(_np((b, n), 5))
    assign = np.random.default_rng(6).integers(0, n, size=(b, k)).astype(np.int32)
    want = float(ref_moe.moe_load_balance_loss(jnp.asarray(probs), jnp.asarray(assign), n))
    got = float(port_moe.moe_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(assign), n))
    np.testing.assert_allclose(got, want, **F32_TOL)


# ------------------------------------------------------------------ cache
def test_cache_score_and_recompile_state_like_jax():
    a = np.array([[0, 1], [2, 3]])
    batches = [a, a, np.array([[0, 1], [2, 0]]), np.array([[1, 1], [1, 1]])]
    rc = ref_cache.Cache("c", ref.FFModel(ref.FFConfig(batch_size=2)).create_tensor([2, 2]), 4)
    pc = port_cache.Cache("c", port.TensorSpec((2, 2)), 4)
    for v in batches:
        assert pc.update_cache(v) == rc.update_cache(v)
    assert pc.batch_ctr == rc.batch_ctr == 3
    assert port_cache.default_cache_score(a, a[:1]) == ref_cache.default_cache_score(a, a[:1]) == 0.0
    for cls in (ref_cache.RecompileState, port_cache.RecompileState):
        seen = []
        st = cls(lambda s: len(seen) < 1, lambda s: seen.append(1))
        assert st.trigger()
        st.alter()
        assert not st.trigger() and st.recompilations == 1


def test_cache_serves_its_value_after_recompile_and_keeps_the_state():
    m = port.FFModel(port.FFConfig(batch_size=4, compute_dtype="float32", seed=1), device="cpu")
    x = m.create_tensor([4, 3], name="x")
    c = m.cache(x, 2)
    m.dense(c, 2, name="head")
    m.compile(port.AdamOptimizer(alpha=0.01), port.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    x1, x2, y = _np((4, 3), 1), _np((4, 3), 2), _np((4, 2), 3)
    m.train_batch({"x": x1}, y)
    op = m.get_layer_by_name("cache")
    op.update_cache(x1)
    w, st = m.get_weights("head"), m._opt_state
    state = port_cache.RecompileState(lambda s: True, lambda s: setattr(op, "use_cached", True))
    assert m.recompile_on_condition(state) and state.recompilations == 1
    assert m._step_count == 1 and m._opt_state is st
    for k, v in w.items():
        assert np.array_equal(m.get_weights("head")[k], v)
    # the cached batch, not the fed one, goes through
    np.testing.assert_allclose(m.forward({"x": x2}).numpy(), m.forward({"x": x1}).numpy(), rtol=0, atol=0)


# ------------------------------------------------------------------ constants, introspection
def test_introspection_and_constant_like_jax(capsys):
    """tests/test_op_library.py:262's case in the port."""
    m = port.FFModel(port.FFConfig(batch_size=4, compute_dtype="float32"), device="cpu")
    x = m.create_tensor([4, 8], name="x")
    c = m.create_constant([4, 8], 2.5, name="two_and_half")
    y = m.add(x, c, name="plus_c")
    m.dense(y, 3, name="head")
    assert [op.name for op in m.get_layers()] == ["plus_c", "head"]
    assert m.get_layer_by_name("head").out_dim == 3
    assert m.get_layer_by_id(m.get_layer_by_name("head").guid).name == "head"
    with pytest.raises(KeyError):
        m.get_layer_by_name("nothing")
    m.print_layers()
    assert "Dense 'head' (plus_c) -> (4, 3)" in capsys.readouterr().out
    m.compile(port.SGDOptimizer(lr=0.1), port.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [port.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    out = m.forward({"x": np.zeros((4, 8), np.float32)}).numpy()
    w = m.get_weights("head")
    np.testing.assert_allclose(out[0], 2.5 * w["kernel"].sum(axis=1) + w["bias"], rtol=1e-5, atol=1e-6)


def test_constants_feed_every_call_and_keep_their_dtype():
    """tests/test_op_library.py:283's case: constants in fit(steps_per_call
    = 2), eval and predict; an int constant keeps its dtype."""
    m = port.FFModel(port.FFConfig(batch_size=4, compute_dtype="float32"), device="cpu")
    x = m.create_tensor([4, 8], name="x")
    c = m.create_constant([4, 8], 1.0, name="ones")
    m.dense(m.add(x, c), 2, name="head")
    m.compile(port.SGDOptimizer(lr=0.1), port.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [port.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    assert m._constants["ones"].dtype == torch.float32
    feeds, labels = {"x": _np((16, 8), 0)}, _np((16, 2), 1)
    hist = m.fit(feeds, labels, epochs=1, verbose=False, steps_per_call=2)
    assert np.isfinite(hist["mse"])
    assert np.isfinite(m.evaluate(feeds, labels)["mse"]) and m.predict(feeds).shape == (16, 2)
    m2 = port.FFModel(port.FFConfig(batch_size=4), device="cpu")
    m2.dense(m2.create_tensor([4, 1], name="x"), 1)
    m2.create_constant([4, 1], 3, dtype=port.DataType.DT_INT64, name="three")
    m2.compile()
    assert m2._constant_feeds["three"][2] is port.DataType.DT_INT64
    assert m2._constants["three"].dtype == torch.int64 and int(m2._constants["three"][0, 0]) == 3


def test_later_slice_verbs_refuse_naming_their_item():
    """conv2d, pool2d, batch_norm and lstm build their ops
    (tests/test_torch_port_conv_rnn.py holds them against the JAX package),
    and compile(mesh=, plan=data_parallel_plan()) takes a graph of them
    (refused, naming item 9b, before the op library trained under a mesh;
    tests/test_torch_port_mesh_zoo.py holds them on 4 ranks): in a world of
    one, one SGD step equal bit for bit to the same graph's compiled with
    no mesh."""
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.launch import initialize
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.plan import data_parallel_plan

    def build():
        m = port.FFModel(port.FFConfig(batch_size=2), device="cpu")
        x = m.create_tensor([2, 1, 4, 4], name="x")
        t = m.batch_norm(m.pool2d(m.conv2d(x, 2, 3, 3, 1, 1, 1, 1), 2, 2, 2, 2))
        seq, _, _ = m.lstm(m.create_tensor([2, 3, 4], name="seq"), 2)
        m.dense(m.concat([m.flat(t), m.flat(seq)], 1), 3)
        return m

    models = [build(), build()]
    assert [type(op).__name__ for op in models[0].graph.compute_ops] == [
        "Conv2D", "Pool2D", "BatchNorm", "LSTM", "Flat", "Flat", "Concat", "Dense"]
    feeds, labels = {"x": _np((2, 1, 4, 4), 1), "seq": _np((2, 3, 4), 2)}, _np((2, 3), 3)
    assert not dist.is_initialized()
    initialize("cpu")
    try:
        mesh = make_mesh(device="cpu")
        for m, msh in zip(models, (mesh, None)):
            m.compile(port.SGDOptimizer(lr=0.1), port.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE, mesh=msh,
                      plan=data_parallel_plan() if msh is not None else None)
        assert float(models[0].train_batch(feeds, labels)) == float(models[1].train_batch(feeds, labels))
    finally:
        dist.destroy_process_group()
    for name in models[1].get_parameters():
        for k, v in models[1].get_weights(name).items():
            np.testing.assert_array_equal(models[0].get_weights(name)[k], v)
