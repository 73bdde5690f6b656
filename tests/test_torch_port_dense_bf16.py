"""The Dense products' bf16 route (`ops/dense.py` `Bf16Product`)
and its exact three-way split of the cotangent
(`ops/kernels/bf16_split.py`), on the CPU.

Here the route's products run in f32 and the split in its plain version; on
the card the same code sends the products to the tensor cores and the split
to its kernel (`tests/test_torch_port_cuda.py` holds those against the
plain f32 products). The reference is autograd through the plain `dense`:
the operands rounded to bf16, multiplied in f32, and the gradients rounded
to bf16 by the casts' backward.
"""
import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu_torch.ffconst import ActiMode
from dlrm_flexflow_tpu_torch.ops import dense as dense_mod
from dlrm_flexflow_tpu_torch.ops.common import apply_activation
from dlrm_flexflow_tpu_torch.ops.dense import Bf16Product, dense
from dlrm_flexflow_tpu_torch.ops.kernels.bf16_split import split_bf16x3, split_bf16x3_reference
from dlrm_flexflow_tpu_torch.ops.kernels.fused_mlp import padded_k

U = 2.0**-24  # f32's unit roundoff
M = 512


def _route(x, w, b, act):
    """`dense`'s bf16 route, which it takes on CUDA only: `Bf16Product`
    (here with f32 products and the plain split) and `dense`'s tail."""
    y = Bf16Product.apply(x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1], w.shape[0])
    return apply_activation(y + b.float(), act).to(x.dtype)


def _parts(g3: torch.Tensor, n: int) -> tuple:
    np_ = g3.shape[1] // 3
    v = g3.view(g3.shape[0], 3, np_)
    return v[:, 0, :n], v[:, 1, :n], v[:, 2, :n], v[:, :, n:]


def _sums(g: torch.Tensor) -> tuple:
    """hi + mid + lo in f32, in that order, and the padding's columns."""
    hi, mid, lo, pad = _parts(split_bf16x3(g, padded_k(g.shape[1])), g.shape[1])
    return (hi.float() + mid.float()) + lo.float(), pad, hi


@pytest.mark.parametrize("lo_exp, hi_exp, n", [(-110, -61, 64), (-60, -1, 61), (0, 59, 16), (60, 120, 1)])
def test_split_reconstructs_every_f32_bit_for_bit(lo_exp, hi_exp, n):
    """Every f32 of each exponent in [lo_exp, hi_exp], random significands
    of 24 bits, both signs: hi + mid + lo gives its bits back. Three 8-bit
    significands cover f32's 24, and each residual is exact in f32. hi is
    the value rounded to bf16; zeros split into zeros (-0 into -0, +0, +0,
    which sum to +0); the padding past N is zero."""
    rng = np.random.default_rng(lo_exp + 1000)
    exps = np.repeat(np.arange(lo_exp, hi_exp + 1), 64)
    sig = rng.integers(2**23, 2**24, size=exps.size).astype(np.float64)
    vals = sig * np.exp2(exps - 23.0) * rng.choice([-1.0, 1.0], size=exps.size)
    vals = np.concatenate([vals, [0.0, -0.0]])
    vals = np.resize(vals, (-(-vals.size // n), n)).astype(np.float32)
    g = torch.from_numpy(vals)
    got, pad, hi = _sums(g)
    nonzero = g != 0
    assert torch.equal(got.view(torch.int32)[nonzero], g.view(torch.int32)[nonzero])
    assert bool((got[~nonzero] == 0).all())
    assert torch.equal(hi, g.to(torch.bfloat16))
    assert pad.numel() == 0 or not bool(pad.float().abs().sum())


def test_split_below_two_to_minus_110_is_exact_on_bf16s_smallest_step():
    """From 2^-120 to 2^-111 a full 24-bit significand reaches below
    2^-133, bf16's smallest step: there a value that is a multiple of
    2^-133 still splits exactly, and any other is off by at most half that
    step (lo rounds its tail)."""
    rng = np.random.default_rng(7)
    exps = np.repeat(np.arange(-120, -110), 64)
    sig = rng.integers(2**23, 2**24, size=exps.size).astype(np.float64)
    full = sig * np.exp2(exps - 23.0) * rng.choice([-1.0, 1.0], size=exps.size)
    on_step = np.round(full / 2.0**-133) * 2.0**-133
    for vals, atol in ((on_step, 0.0), (full, 2.0**-134)):
        g = torch.from_numpy(vals.astype(np.float32).reshape(-1, 8))
        got, _, _ = _sums(g)
        assert float((got.double() - g.double()).abs().max()) <= atol


def test_split_of_infinities_and_nan():
    """An infinite g (or one that rounds past bf16's largest value) keeps
    hi and zero mid and lo; NaN stays NaN in hi."""
    g = torch.tensor([[float("inf"), -float("inf"), float("nan"), 3.4e38, 1.0, 0.0, -2.5, 1e-30]])
    hi, mid, lo, _ = _parts(split_bf16x3(g, 8), 8)
    assert torch.isinf(hi[0, :2]).all() and torch.isnan(hi[0, 2]) and torch.isinf(hi[0, 3])
    assert not bool(mid[0, [0, 1, 3]].float().abs().sum()) and not bool(lo[0, [0, 1, 3]].float().abs().sum())
    assert torch.equal((hi.float() + mid.float() + lo.float())[0, 4:], g[0, 4:])


@pytest.mark.parametrize("bad", ["rank", "dtype", "strided", "n_pad"])
def test_split_refuses_what_the_kernel_does_not_take(bad):
    g = torch.randn(16, 24)
    args = {"rank": (g.view(-1), 24), "dtype": (g.double(), 24), "strided": (g.t(), 16),
            "n_pad": (g, 20)}[bad]
    with pytest.raises(ValueError):
        split_bf16x3(*args)


def _bf16_step(t: torch.Tensor) -> torch.Tensor:
    """One bf16 step (unit in the last place) at |t|; 2^-133 at least."""
    e = torch.frexp(t.float()).exponent
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), (e - 8).clamp(min=-133))


def _grads(fn, x, w, b, up, need_x=True):
    leaves = [x.clone().requires_grad_(need_x), w.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    y = fn(*leaves)
    want = [t for t in leaves if t.requires_grad]
    return [y.detach()] + list(torch.autograd.grad((y.float() * up).sum(), want))


def _check(got, want, x, w, up, act, need_x=True):
    """Forward: two f32 sums of the same exact products in another order,
    each within (K + 1) u sum|terms| of the exact one (the bias add is the
    + 1; ReLU and sigmoid do not widen a gap). The cotangent g at the
    product then differs by at most |up| x 0.1 x that gap under sigmoid
    (|sigmoid''| < 0.1) and not at all under ReLU (no output this close to
    0 here) or none. Gradients: f32 sums of exact products (the
    cotangent's parts times bf16 values) in another order, 3N terms
    against N for the input's, 3M against M for the kernel's, then rounded
    to bf16: within both sums' order bound, the gap carried from g, and
    one bf16 step where the gap crosses a rounding boundary. The bias
    gradient is autograd's sum on both sides. Returns the share of the
    input and kernel gradients' elements that differ at all."""
    k, n = x.shape[-1], w.shape[0]
    xa = x.to(torch.bfloat16).float().abs().reshape(-1, k)
    wa = w.to(torch.bfloat16).float().abs()
    fwd_tol = 2 * (k + 1) * U * (xa @ wa.t() + 1.0)
    assert bool(((got[0] - want[0]).abs().reshape(-1, n) <= fwd_tol).all())
    ga = up.abs().reshape(-1, n)  # bounds |g|: the activations' slopes are at most 1
    dg = ga * 0.1 * fwd_tol if act is ActiMode.AC_MODE_SIGMOID else torch.zeros_like(ga)
    m = ga.shape[0]
    bounds = ([2 * 3 * n * U * (ga @ wa) + dg @ wa] if need_x else []) + [2 * 3 * m * U * (ga.t() @ xa) + dg.t() @ xa]
    *pairs, (db, db_want) = list(zip(got[1:], want[1:]))
    assert bool(((db - db_want).abs() <= 2 * m * U * ga.sum(0) + dg.sum(0)).all())
    differing, total = 0, 0
    for (a, c), bound in zip(pairs, bounds):
        a, c = a.reshape(bound.shape), c.reshape(bound.shape)
        tol = bound + _bf16_step(torch.maximum(a.abs(), c.abs()))
        assert bool(((a - c).abs() <= tol).all()), float(((a - c).abs() / tol).max())
        differing += int((a != c).sum())
        total += a.numel()
    return differing / total


ACTS = [ActiMode.AC_MODE_RELU, ActiMode.AC_MODE_SIGMOID, ActiMode.AC_MODE_NONE]


@pytest.mark.parametrize("act", ACTS, ids=lambda a: a.name)
@pytest.mark.parametrize("k, n", [(13, 512), (432, 512), (256, 64), (64, 16), (256, 1)])
def test_bf16_route_matches_autograd_through_plain_dense(k, n, act):
    """kaggle's Dense shapes at M = 512 (K = 13 and N = 1 padded to 16 and
    8): the route's forward and its input, kernel and bias gradients
    against autograd through the plain `dense`. Gradient elements that
    differ at all: 0-0.05% of them in these cases; bounded at 1%."""
    gen = torch.Generator().manual_seed(k * 1000 + n)
    x = torch.randn((M, k), generator=gen)
    w = torch.randn((n, k), generator=gen) * (2.0 / k) ** 0.5
    b = torch.randn((n,), generator=gen) * 0.1
    up = torch.randn((M, n), generator=gen)
    before = (Bf16Product.forwards, Bf16Product.backwards)
    got = _grads(lambda *t: _route(*t, act), x, w, b, up)
    assert (Bf16Product.forwards, Bf16Product.backwards) == (before[0] + 1, before[1] + 1)
    want = _grads(lambda *t: dense(*t, act, torch.bfloat16), x, w, b, up)
    assert all(a.dtype == c.dtype and a.shape == c.shape for a, c in zip(got, want))
    assert _check(got, want, x, w, up, act) <= 0.01


def test_bf16_route_flattens_a_rank_3_input():
    """The zoo's attention Dense: x [B, T, K] flattens to [B * T, K] and the
    output and the input's gradient take the leading dimensions back."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 64, 96), generator=gen)
    w = torch.randn((40, 96), generator=gen) * 0.1
    b = torch.randn((40,), generator=gen) * 0.1
    up = torch.randn((8, 64, 40), generator=gen)
    act = ActiMode.AC_MODE_RELU
    got = _grads(lambda *t: _route(*t, act), x, w, b, up)
    want = _grads(lambda *t: dense(*t, act, torch.bfloat16), x, w, b, up)
    assert got[0].shape == (8, 64, 40) and got[1].shape == x.shape
    assert _check(got, want, x, w, up, act) <= 0.01


def test_bf16_route_skips_the_input_gradient_where_none_is_needed(monkeypatch):
    """The first bottom layer (its input is the dense features): the
    backward splits the cotangent and makes the kernel's gradient, and
    takes no input-gradient product: 2 products in all, not 3."""
    calls = []
    real = dense_mod._mm_f32
    monkeypatch.setattr(dense_mod, "_mm_f32", lambda a, b: calls.append(a.shape) or real(a, b))
    gen = torch.Generator().manual_seed(13)
    x = torch.randn((M, 13), generator=gen)
    w = torch.randn((512, 13), generator=gen) * 0.4
    b = torch.zeros((512,))
    up = torch.randn((M, 512), generator=gen)
    act = ActiMode.AC_MODE_RELU
    got = _grads(lambda *t: _route(*t, act), x, w, b, up, need_x=False)
    assert len(calls) == 2 and len(got) == 3
    want = _grads(lambda *t: dense(*t, act, torch.bfloat16), x, w, b, up, need_x=False)
    assert _check(got, want, x, w, up, act, need_x=False) <= 0.01


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_dense_on_the_cpu_computes_as_before(cdt):
    """On the CPU `dense` keeps its plain product (the route is for CUDA):
    no call of `Bf16Product`, and the f32 product of the rounded operands
    bit for bit."""
    gen = torch.Generator().manual_seed(5)
    x, w, b = torch.randn((64, 48), generator=gen), torch.randn((24, 48), generator=gen), torch.randn((24,), generator=gen)
    before = (Bf16Product.forwards, dense.f32_products)
    got = dense(x, w, b, ActiMode.AC_MODE_RELU, cdt)
    assert (Bf16Product.forwards, dense.f32_products) == before
    want = torch.relu(torch.matmul(x.to(cdt).float(), w.to(cdt).float().t()) + b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m, n", [(5, 1), (7, 13), (16, 64)])
def test_split_wrapper_takes_the_plain_version_on_the_cpu(m, n):
    """On the CPU the wrapper is the plain version, and counts no launch."""
    g = torch.randn((m, n))
    before = split_bf16x3.launches
    assert torch.equal(split_bf16x3(g, padded_k(n)), split_bf16x3_reference(g, padded_k(n)))
    assert split_bf16x3.launches == before
