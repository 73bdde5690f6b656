"""The port's convolutional and recurrent ops against the JAX package, on
the CPU: Conv2D, Pool2D, BatchNorm (`ops/conv.py`) and LSTM (`ops/rnn.py`).

Each op is built by the same FFModel verb in both packages; the JAX op's
parameters (its own initializers, perturbed where they start constant) are
carried to the port through `params_from_jax`, the same numpy inputs go
through both graphs, and the outputs and the gradients of every parameter
and float input under one random cotangent are compared.

Tolerances.
- f32 compute: both sides sum f32 products in other orders: rtol 1e-5,
  atol 1e-6 plus 1e-5 of the largest magnitude (a sum that cancels keeps the
  absolute error of its largest terms).
- bf16 compute, Conv2D: both round the operands to bf16, sum the exact
  products in f32 and round the result to bf16 once (the JAX package's
  convolution has no preferred_element_type); so do the input's and the
  kernel's gradients. Summed in another order, a result can round to the
  neighbouring bf16 value: one bf16 step, at most 2^-7 of its magnitude
  (rtol 2^-7), and for values near 0 at most 2^-7 of the largest one
  (atol); the activations that follow have slopes of at most 1 but GELU's
  1.13, which the rtol and atol together cover.
- bf16 compute, LSTM: derived step by step in `lstm_bound` below.
"""
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.core.graph import OpContext as RefContext

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.core.graph import OpContext as PortContext
from dlrm_flexflow_tpu_torch.ops import conv as port_conv

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_UNIT = 2.0**-24
BF16_STEP = 2.0**-7  # one bf16 step, relative to the value: at most 2^-7
ACTS = {"none": "AC_MODE_NONE", "relu": "AC_MODE_RELU", "sigmoid": "AC_MODE_SIGMOID", "tanh": "AC_MODE_TANH",
        "gelu": "AC_MODE_GELU"}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tol(cdt, want):
    big = float(np.abs(want).max()) if np.size(want) else 0.0
    if cdt == "float32":
        return dict(rtol=1e-5, atol=1e-6 + 1e-5 * big)
    return dict(rtol=BF16_STEP, atol=BF16_STEP * big)


def _run(build, feeds, cdt="float32", batch=4, perturb=False, fetch_all=False):
    """Outputs and gradients of the last op (every op's outputs with
    `fetch_all`) in both packages: {"ref": [...], "port": [...],
    "ref_grads": {...}, "port_grads": {...}}, the gradients of sum(out *
    cot) over the outputs, keyed ("param", op, key) or ("input", name).
    `perturb` adds normal noise of 0.5 to the JAX parameters first
    (BatchNorm's start at 1 and 0)."""
    r = ref.FFModel(ref.FFConfig(batch_size=batch, compute_dtype=cdt))
    build(r)
    p = port.FFModel(port.FFConfig(batch_size=batch, compute_dtype=cdt), device="cpu")
    build(p)
    rparams = r.graph.init_params(jax.random.PRNGKey(3))
    if perturb:
        rparams = {op: {k: v + 0.5 * _np(v.shape, 21 + i) for i, (k, v) in enumerate(sub.items())}
                   for op, sub in rparams.items()}
    pparams = params_from_jax({op: {k: np.asarray(v) for k, v in sub.items()} for op, sub in rparams.items()})
    r_out = [t for op in r.graph.compute_ops for t in op.outputs] if fetch_all else r.graph.compute_ops[-1].outputs
    p_out = [t for op in p.graph.compute_ops for t in op.outputs] if fetch_all else p.graph.compute_ops[-1].outputs
    rctx = RefContext(training=True, compute_dtype=jnp.dtype(cdt))
    pctx = PortContext(training=True, compute_dtype=DT[cdt])
    cots = [_np(t.shape, 11 + i) for i, t in enumerate(r_out)]

    def ref_fn(params, fin):
        outs = r.graph.execute(params, fin, rctx, fetch=r_out)
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(outs, cots)), outs

    fin = {k: jnp.asarray(v) for k, v in feeds.items()}
    (_, r_outs), (g_par, g_in) = jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(rparams, fin)
    leaves = {op: {k: v.clone().requires_grad_(True) for k, v in sub.items()} for op, sub in pparams.items()}
    tin = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in feeds.items()}
    p_outs = p.graph.execute(leaves, tin, pctx, fetch=p_out)
    total = sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(p_outs, cots))
    flat = [(("param", op, k), v) for op, sub in leaves.items() for k, v in sub.items()]
    flat += [(("input", k), v) for k, v in tin.items()]
    gs = torch.autograd.grad(total, [v for _, v in flat], allow_unused=True, materialize_grads=True)
    return {
        "ref": [np.asarray(jnp.asarray(o).astype(jnp.float32)) for o in r_outs],
        "port": [o.detach().float().numpy() for o in p_outs],
        "ref_grads": {**{("param", op, k): np.asarray(v) for op, sub in g_par.items() for k, v in sub.items()},
                      **{("input", k): np.asarray(v) for k, v in g_in.items()}},
        "port_grads": {key: g.numpy() for (key, _), g in zip(flat, gs)},
        "params": rparams,
    }


def _close(out, cdt, grads=True):
    for a, b in zip(out["ref"], out["port"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **_tol(cdt, a))
    if grads:
        assert out["port_grads"].keys() == out["ref_grads"].keys()
        for key, g in out["ref_grads"].items():
            np.testing.assert_allclose(out["port_grads"][key], g, **_tol(cdt, g), err_msg=str(key))


# ------------------------------------------------------------------ Conv2D
# name -> (in [N, C, H, W], out channels, kernel, stride, padding, groups, bias, activation)
CONV_CASES = {
    "3x3-s1-p1-relu": ((2, 4, 7, 7), 6, (3, 3), (1, 1), (1, 1), 1, True, "relu"),
    "1x7-p0x3-none": ((2, 5, 6, 9), 4, (1, 7), (1, 1), (0, 3), 1, True, "none"),
    "7x1-s2x1-p3x0-sigmoid": ((2, 3, 11, 5), 4, (7, 1), (2, 1), (3, 0), 1, True, "sigmoid"),
    "3x3-s2-groups2-nobias-tanh": ((2, 6, 9, 8), 4, (3, 3), (2, 2), (0, 1), 2, False, "tanh"),
    "11x11-s4-p2-gelu": ((2, 3, 23, 23), 5, (11, 11), (4, 4), (2, 2), 1, True, "gelu"),
}


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_forward_and_gradients_match_jax(case, cdt):
    """Strides, asymmetric kernels and paddings, groups, with and without a
    bias, each activation: the output, and the gradients of the input, the
    kernel and the bias."""
    shape, out_c, (kh, kw), (sh, sw), (ph, pw), groups, bias, act = CONV_CASES[case]

    def build(m):
        x = m.create_tensor(list(shape), name="x")
        pkg = ref if isinstance(m, ref.FFModel) else port
        m.conv2d(x, out_c, kh, kw, sh, sw, ph, pw, activation=getattr(pkg.ActiMode, ACTS[act]), groups=groups,
                 use_bias=bias)

    out = _run(build, {"x": _np(shape, 1)}, cdt, batch=shape[0], perturb=bias)
    _close(out, cdt)
    assert out["port"][0].shape == (shape[0], out_c, (shape[2] + 2 * ph - kh) // sh + 1,
                                    (shape[3] + 2 * pw - kw) // sw + 1)
    assert {k[2] for k in out["port_grads"] if k[0] == "param"} == ({"kernel", "bias"} if bias else {"kernel"})


def test_conv2d_rounds_its_result_to_bf16_once():
    """Small integer inputs and weights: every sum of products is exact in
    f32 whatever its order, so the JAX package and the port round the same
    value to bf16 and agree bit for bit (the sums stay below 288 * 32^2 <
    2^24). Sums above 256 are not all bf16 values, so rounding in f32
    instead (the port's Dense keeps f32 products) would differ, by up to
    half a bf16 step, in most outputs."""
    rng = np.random.default_rng(7)
    x = rng.integers(-32, 33, (2, 32, 5, 5)).astype(np.float32)
    w = rng.integers(-32, 33, (8, 32, 3, 3)).astype(np.float32)
    b = np.full((8,), 0.375, np.float32)

    def build(m):
        m.conv2d(m.create_tensor([2, 32, 5, 5], name="x"), 8, 3, 3, 1, 1, 1, 1)

    r = ref.FFModel(ref.FFConfig(batch_size=2, compute_dtype="bfloat16"))
    build(r)
    p = port.FFModel(port.FFConfig(batch_size=2, compute_dtype="bfloat16"), device="cpu")
    build(p)
    params = {"conv2d": {"kernel": w, "bias": b}}
    want = np.asarray(r.graph.execute({"conv2d": {k: jnp.asarray(v) for k, v in params["conv2d"].items()}},
                                      {"x": jnp.asarray(x)}, RefContext(compute_dtype=jnp.bfloat16))[0])
    got = p.graph.execute(params_from_jax(params), {"x": torch.from_numpy(x)},
                          PortContext(compute_dtype=torch.bfloat16))[0].numpy()
    np.testing.assert_array_equal(got, want)
    exact = torch.nn.functional.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                                       padding=1).numpy() + 0.375
    unrounded = exact.astype(np.float32)
    assert np.abs(unrounded).max() > 4096
    differs = np.abs(got - unrounded) > 0
    assert differs.mean() > 0.5, differs.mean()
    assert np.abs(got - unrounded).max() <= BF16_STEP / 2 * np.abs(unrounded).max()


def test_conv2d_sets_its_own_cudnn_flags_for_forward_and_backward(monkeypatch):
    """With the caller's cuDNN flags at TF32 on, deterministic off and
    benchmarking on, the convolution's forward and its backward (run later
    by autograd, outside any block around the forward) each run with cuDNN
    on, TF32 off, deterministic algorithms and no benchmarking; the
    caller's flags are back after each."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    seen = []

    def flags():
        return (cudnn.enabled, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)

    fwd, bwd = torch.nn.functional.conv2d, torch.ops.aten.convolution_backward

    def rec_fwd(*a, **kw):
        seen.append(("forward", flags()))
        return fwd(*a, **kw)

    def rec_bwd(*a, **kw):
        seen.append(("backward", flags()))
        return bwd(*a, **kw)

    monkeypatch.setattr(port_conv.F, "conv2d", rec_fwd)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", rec_bwd)
    x = torch.from_numpy(_np((2, 3, 6, 6), 1)).requires_grad_(True)
    w = torch.from_numpy(_np((4, 3, 3, 3), 2)).requires_grad_(True)
    y = port_conv.conv2d(x, w, None, (1, 1), (1, 1), 1, port.ActiMode.AC_MODE_RELU, torch.float32)
    after_forward = flags()
    y.sum().backward()
    assert seen == [("forward", (True, False, True, False)), ("backward", (True, False, True, False))]
    assert after_forward == flags() == (cudnn.enabled, True, False, True)
    assert x.grad is not None and w.grad is not None


# ------------------------------------------------------------------ Pool2D
# name -> (kernel, stride, padding, pool type, activation)
POOL_CASES = {
    "max-3x3-s2-p1": ((3, 3), (2, 2), (1, 1), "POOL_MAX", "none"),
    "max-3x3-s2-p0": ((3, 3), (2, 2), (0, 0), "POOL_MAX", "none"),
    "max-3x3-s1-p2": ((3, 3), (1, 1), (2, 2), "POOL_MAX", "none"),
    "avg-3x3-s1-p1": ((3, 3), (1, 1), (1, 1), "POOL_AVG", "none"),
    "avg-2x2-s2-relu": ((2, 2), (2, 2), (0, 0), "POOL_AVG", "relu"),
    "avg-3x3-s2-p2-tanh": ((3, 3), (2, 2), (2, 2), "POOL_AVG", "tanh"),
    "avg-7x7-global": ((7, 7), (1, 1), (0, 0), "POOL_AVG", "none"),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool2d_forward_and_gradients_match_jax(case):
    """MAX pads with -inf, AVG divides by the whole window, the padded cells
    included; floor-mode sizes; the activation after the pool; padding
    wider than half a window too (explicit in the port)."""
    (kh, kw), (sh, sw), (ph, pw), pool, act = POOL_CASES[case]

    def build(m):
        pkg = ref if isinstance(m, ref.FFModel) else port
        m.pool2d(m.create_tensor([2, 3, 7, 8 if kw < 7 else 7], name="x"), kh, kw, sh, sw, ph, pw,
                 pool_type=getattr(pkg.PoolType, pool), activation=getattr(pkg.ActiMode, ACTS[act]))

    _close(_run(build, {"x": _np((2, 3, 7, 8 if kw < 7 else 7), 2)}, batch=2), "float32")


def test_avg_pool_border_cells_divide_by_the_whole_window():
    """A 3x3 AVG window at stride 1, padding 1 on ones: 4 / 9 in a corner,
    6 / 9 on an edge, 1 inside, in both packages."""
    def build(m):
        pkg = ref if isinstance(m, ref.FFModel) else port
        m.pool2d(m.create_tensor([1, 1, 4, 4], name="x"), 3, 3, 1, 1, 1, 1, pool_type=pkg.PoolType.POOL_AVG)

    out = _run(build, {"x": np.ones((1, 1, 4, 4), np.float32)}, batch=1)
    got = out["port"][0][0, 0]
    np.testing.assert_allclose(got[0, 0], 4 / 9, rtol=1e-6)
    np.testing.assert_allclose(got[0, 1], 6 / 9, rtol=1e-6)
    np.testing.assert_allclose(got[1, 1], 1.0, rtol=1e-6)
    np.testing.assert_array_equal(got, out["ref"][0][0, 0])


@pytest.mark.parametrize("stride", [2, 1])
def test_max_pool_positive_ties_send_the_gradient_where_jax_does(stride):
    """Inputs of 1s and 2s (many tied maxima, overlapping 3x3 windows): the
    gradient goes to one element of each tied window, the first in
    row-major order, in the port as in JAX's select_and_scatter; bit for
    bit."""
    x = np.random.default_rng(4).integers(1, 3, (2, 2, 9, 9)).astype(np.float32)

    def build(m):
        m.pool2d(m.create_tensor([2, 2, 9, 9], name="x"), 3, 3, stride, stride, 1, 1)

    out = _run(build, {"x": x}, batch=2)
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    g_port, g_ref = out["port_grads"][("input", "x")], out["ref_grads"][("input", "x")]
    np.testing.assert_array_equal(g_port, g_ref)
    assert (g_ref != 0).sum() < x.size // 2


# ------------------------------------------------------------------ BatchNorm
@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_forward_and_gradients_match_jax(relu):
    def build(m):
        m.batch_norm(m.create_tensor([3, 4, 5, 5], name="x"), relu=relu)

    _close(_run(build, {"x": _np((3, 4, 5, 5), 5, 2.0) + 1.5}, batch=3, perturb=True), "float32")


def test_batch_norm_uses_the_batchs_own_statistics_in_predict():
    """No running statistics: `predict` normalises each chunk by its own
    mean and variance, so x and 3 x + 5 give the same outputs, and each
    matches the JAX package's `predict`."""
    def build(pkg, dev):
        kw = {"device": dev} if dev else {}
        m = pkg.FFModel(pkg.FFConfig(batch_size=4, compute_dtype="float32"), **kw)
        m.batch_norm(m.create_tensor([4, 3, 4, 4], name="x"), relu=False)
        m.compile()
        return m

    r, p = build(ref, None), build(port, "cpu")
    x = _np((4, 3, 4, 4), 6)
    for feed in (x, 3.0 * x + 5.0):
        want = np.asarray(r.predict({"x": feed}))
        got = p.predict({"x": feed})
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, p.predict({"x": x}), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.mean(axis=(0, 2, 3)), 0.0, atol=1e-5)


# ------------------------------------------------------------------ LSTM
def _lstm_build(t, e, h, with_state):
    def build(m):
        x = m.create_tensor([3, t, e], name="x")
        state = (m.create_tensor([3, h], name="h0"), m.create_tensor([3, h], name="c0")) if with_state else None
        m.lstm(x, h, initial_state=state)
    return build


def _lstm_feeds(t, e, h, with_state):
    feeds = {"x": _np((3, t, e), 8)}
    if with_state:
        feeds.update(h0=_np((3, h), 9, 0.5), c0=_np((3, h), 10, 0.5))
    return feeds


def lstm_bound(x, wx, wh, bias, hs, cs, h0, c0, bf16, flips):
    """A bound on |port - JAX| of an LSTM's h_t and c_t, step by step, from
    the JAX side's trajectory (hs [B, T, H], and cs bounding |c_t|).

    Both sides compute one function of the same rounded weights. A gate's
    f32 sum of n = E + H + 1 terms lies within n 2^-24 sum|terms| of the
    exact one on each side (eps_g, twice that between them); sigmoid and
    tanh are a few f32 units apart between XLA and torch (eps_f = 8 2^-24,
    absolute: their values are below 1). With sigmoid' <= 1/4, tanh' <= 1
    and |sigmoid|, |tanh| <= 1, a gate error dg and a state error dc give
        dc' <= dc + (|c| / 4 + 1 / 4 + 1) dg + (|c| + 2) eps_f,
        dh' <= dg / 4 + dc' + 2 eps_f.
    The gates see the state through the rounded h: dg <= A dh_r + eps_g,
    A the largest row sum of |wh|. In f32 the rounding is exact (dh_r =
    dh). In bf16, at a step whose input h rounds alike on both sides
    (`flips[s]` False) dh_r = 0; where it may not, dh_r <= dh plus one bf16
    step, at most 2^-8 for |h| < 1."""
    u = F32_UNIT
    r = (lambda a: np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())) if bf16 else (lambda a: a)
    wx_r, wh_r = r(wx).astype(np.float64), r(wh).astype(np.float64)
    a = np.abs(wh_r).sum(axis=1).max()
    n = wx.shape[1] + wh.shape[1] + 1
    eps_f = 8 * u
    dh = dc = 0.0
    h_prev = h0
    bounds = []
    for s in range(x.shape[1]):
        terms = (np.abs(r(x[:, s])) @ np.abs(wx_r).T + np.abs(r(h_prev)) @ np.abs(wh_r).T + np.abs(bias))
        eps_g = 2 * n * u * terms.max()
        dh_r = (dh + 2.0**-8 if flips[s] else 0.0) if bf16 else dh
        dg = a * dh_r + eps_g
        cmax = cs[:, s].max()
        dc = dc + (cmax / 4 + 1.25) * dg + (cmax + 2) * eps_f
        dh = dg / 4 + dc + 2 * eps_f
        bounds.append((dh, dc))
        h_prev = hs[:, s]
    return bounds


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_outputs_match_jax_under_a_derived_bound(with_state, cdt):
    """The hidden sequence, h_T and c_T, zero or given initial state, in f32
    and bf16: every output within `lstm_bound`, whose bf16 steps take a
    flipped rounding into account only where the two sides' rounded h
    differ. In f32 the gradients too (f32 tolerance)."""
    t, e, h = 7, 6, 8
    feeds = _lstm_feeds(t, e, h, with_state)
    out = _run(_lstm_build(t, e, h, with_state), feeds, cdt, batch=3)
    (y_r, h_r, c_r), (y_p, h_p, c_p) = out["ref"], out["port"]
    assert y_p.shape == (3, t, h) and h_p.shape == c_p.shape == (3, h)
    np.testing.assert_array_equal(h_p, y_p[:, -1])
    prm = {k: np.asarray(v) for k, v in out["params"]["lstm"].items()}
    zeros = np.zeros((3, h), np.float32)
    h0, c0 = (feeds["h0"], feeds["c0"]) if with_state else (zeros, zeros)
    # |c_t| <= |c_{t-1}| + 1 (|sigmoid|, |tanh| <= 1); only c_T is an output
    cs = np.broadcast_to(np.arange(1, t + 1, dtype=np.float64)[None, :, None] + np.abs(c0).max(), (3, t, h))
    bf16 = cdt == "bfloat16"
    # step s's product reads h_{s-1} rounded: h0 alike on both sides, then
    # the outputs' h_t
    flips = np.zeros(t, bool)
    if bf16:
        rb = lambda v: torch.from_numpy(np.array(v)).to(torch.bfloat16)  # noqa: E731
        flips[1:] = [not torch.equal(rb(y_p[:, s]), rb(y_r[:, s])) for s in range(t - 1)]
    bounds = lstm_bound(feeds["x"], prm["wx"], prm["wh"], prm["bias"], y_r, cs, h0, c0, bf16, flips)
    dh = np.array([b[0] for b in bounds])
    assert np.all(np.abs(y_p - y_r).max(axis=(0, 2)) <= dh), (np.abs(y_p - y_r).max(axis=(0, 2)), dh)
    assert np.abs(h_p - h_r).max() <= dh[-1]
    assert np.abs(c_p - c_r).max() <= bounds[-1][1]
    if not bf16:
        _close(out, cdt)


def test_lstm_gradients_through_an_encoder_decoder_chain_match_jax():
    """An encoder LSTM's (h_T, c_T) as the decoder's initial state, both
    layers' outputs fetched: the gradients of every weight, of the encoder's
    input and the decoder's, in f32."""
    def build(m):
        src = m.create_tensor([3, 5, 6], name="src")
        dst = m.create_tensor([3, 4, 6], name="dst")
        enc, h_t, c_t = m.lstm(src, 8, name="enc")
        m.lstm(dst, 8, initial_state=(h_t, c_t), name="dec")

    out = _run(build, {"src": _np((3, 5, 6), 12), "dst": _np((3, 4, 6), 13)}, batch=3, fetch_all=True)
    _close(out, "float32")
    assert {k[1] for k in out["port_grads"] if k[0] == "param"} == {"enc", "dec"}
    assert np.abs(out["port_grads"][("input", "src")]).max() > 0


def test_lstm_is_torch_nn_lstm_with_one_bias():
    """The gate layout is torch.nn.LSTM's ([i, f, g, o]); its two biases
    summed are the one bias here (f32, on the CPU)."""
    b, t, e, h = 3, 5, 6, 8
    rng = np.random.default_rng(14)
    wx, wh = rng.standard_normal((4 * h, e)) * 0.3, rng.standard_normal((4 * h, h)) * 0.3
    bias = rng.standard_normal(4 * h) * 0.3
    x, h0, c0 = rng.standard_normal((b, t, e)), rng.standard_normal((b, h)) * 0.5, rng.standard_normal((b, h)) * 0.5
    tt = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    from dlrm_flexflow_tpu_torch.ops.rnn import lstm

    y, h_t, c_t = lstm(tt(x), tt(wx), tt(wh), tt(bias), tt(h0), tt(c0), torch.float32)
    tl = torch.nn.LSTM(e, h, batch_first=True)
    with torch.no_grad():
        tl.weight_ih_l0.copy_(tt(wx))
        tl.weight_hh_l0.copy_(tt(wh))
        tl.bias_ih_l0.copy_(tt(bias))
        tl.bias_hh_l0.zero_()
        ty, (th, tc) = tl(tt(x), (tt(h0)[None], tt(c0)[None]))
    for got, want in ((y, ty), (h_t, th[0]), (c_t, tc[0])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ the verbs
@pytest.mark.parametrize("verb", ["conv2d", "pool2d", "batch_norm", "lstm"])
def test_verbs_take_the_jax_signatures_and_default_names(verb):
    """The same parameters, defaults and default op names as the JAX
    package's verbs; no NotImplementedError any more."""
    def sig(pkg):
        return [(p.name, getattr(p.default, "name", p.default))
                for p in inspect.signature(getattr(pkg.FFModel, verb)).parameters.values()]

    assert sig(port) == sig(ref)
    m = port.FFModel(port.FFConfig(batch_size=2), device="cpu")
    x = m.create_tensor([2, 3, 8, 8] if verb != "lstm" else [2, 4, 3], name="x")
    call = {"conv2d": lambda t: m.conv2d(t, 4, 3, 3), "pool2d": lambda t: m.pool2d(t, 2, 2, 2, 2),
            "batch_norm": lambda t: m.batch_norm(t), "lstm": lambda t: m.lstm(t, 5)[0]}[verb]
    call(x)
    call(x)
    assert [op.name for op in m.graph.compute_ops] == [verb, f"{verb}_1"]


@pytest.mark.parametrize("verb", ["conv2d", "lstm"])
def test_cost_stats_match_jax(verb):
    """Conv2D's and LSTM's analytic costs (FLOPs, bytes, parameter bytes),
    as the JAX package counts them."""
    def build(m):
        if verb == "conv2d":
            m.conv2d(m.create_tensor([2, 6, 9, 8], name="x"), 4, 3, 5, 2, 1, 1, 2, groups=2)
        else:
            m.lstm(m.create_tensor([2, 7, 5], name="x"), 6)

    r = ref.FFModel(ref.FFConfig(batch_size=2))
    p = port.FFModel(port.FFConfig(batch_size=2), device="cpu")
    build(r)
    build(p)
    assert p.graph.compute_ops[-1].cost_stats() == r.graph.compute_ops[-1].cost_stats()
