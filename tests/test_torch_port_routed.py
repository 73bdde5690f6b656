"""The port's routed exchange against the JAX package's, on the host, in
one process (no torch.distributed).

`dlrm_flexflow_tpu_torch/parallel/routed_exchange.py` copies the JAX
package's routing arithmetic. Everything a rank computes before its first
all-to-all is integer work, so it must be equal, not close: the plan
(`RoutedPlan`), the classification of each lookup, the (slot, row) sort and
its permutation, the unique ranks and the compacted order, each slot's run
of unique rows, the capacity buckets and each entry's bucket position (the
entries that drop). The host-side drop count (`routed_drop_stats`) and the
byte count (`step_exchange_bytes`, tests/test_routed_exchange.py and
tests/test_wire_bytes_crosscheck.py) must be equal too; what the padded
buckets carry (`step_bucket_bytes`) is held against the buffers the
all-to-alls are handed. The exchange itself
runs in 4 gloo processes (tests/test_torch_port_mesh.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu.parallel import embedding_collection as ref_ec
from dlrm_flexflow_tpu.parallel import routed_exchange as ref_rx
from dlrm_flexflow_tpu.parallel.plan import greedy_subtable_assignment

from dlrm_flexflow_tpu_torch.parallel import embedding_collection as port_ec
from dlrm_flexflow_tpu_torch.parallel import routed_exchange as port_rx

DIM = 16


def _layouts(vocabs, split, n, hash_rows=False, cap=2.0, dim=DIM):
    subs = ref_ec.expand_subtables(vocabs, split)
    owner = greedy_subtable_assignment(subs, [length for _, _, length in subs], n)
    kw = dict(split=list(split) if split else None, exchange="routed", routed_cap_factor=cap,
              hash_rows=hash_rows)
    return (ref_ec.ShardedEmbeddingLayout(list(vocabs), dim, n, owner, **kw),
            port_ec.ShardedEmbeddingLayout(list(vocabs), dim, n, owner, **kw))


def _zipf(rng, vocab, size, a=1.05):
    """Zipf(a) over [0, vocab): hot rows at low ids (the overflow case)."""
    return np.minimum(rng.zipf(a, size=size).astype(np.int64) - 1, vocab - 1)


# name -> (vocabs, split, shards, B_loc, H, cap_factor, hash_rows, ids)
CASES = {
    "unsplit-exact": ([50, 123, 77, 260], None, 4, 16, 1, 0.0, False, "uniform"),
    "splits-bag2-exact": ([50, 123, 77, 260], [2, 3, 1, 8], 4, 16, 2, 0.0, False, "uniform"),
    "splits-cap2-skew": ([400, 1000, 300], [4, 8, 2], 4, 64, 1, 2.0, False, "skew"),
    "splits-cap2-zipf-hashed": ([400, 1000, 300], [4, 8, 2], 4, 64, 1, 2.0, True, "zipf"),
    "splits-cap0.5-bag3-oov": ([90, 200], [3, 2], 2, 24, 3, 0.5, False, "oov"),
}


def _local_indices(vocabs, b, h, ids, seed):
    rng = np.random.default_rng(seed)
    cols = []
    for v in vocabs:
        if ids == "zipf":
            x = _zipf(rng, v, (b, h))
        elif ids == "skew":  # the first quarter of the rows: more unique rows than a slot holds
            x = rng.integers(0, v // 4, size=(b, h))
        else:
            x = rng.integers(0, v, size=(b, h))
        if ids == "oov":  # past the vocab, and below -1: both drop
            r = rng.random((b, h))
            x = np.where(r > 0.8, x + v, np.where(r < 0.05, -3, x))
        x[rng.random((b, h)) < 0.1] = -1
        cols.append(x)
    return np.stack(cols, axis=1).astype(np.int64)


@pytest.mark.parametrize("case", list(CASES))
def test_routed_plan_matches_jax(case):
    vocabs, split, n, b_loc, h, cap, hashed, _ = CASES[case]
    ref_lay, lay = _layouts(vocabs, split, n, hashed, cap)
    want = ref_rx.RoutedPlan(ref_lay, b_loc, h, cap)
    got = port_rx.routed_plan(lay, b_loc, h, cap)
    assert port_rx.routed_plan(lay, b_loc, h, cap) is got  # made once
    for name in ("table_base", "table_chunk", "slot_dest", "slot_lbase", "slot_rstart", "slot_cap",
                 "slot_bucket_off"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.c_max, got.n, got.h, got.b_loc, got.s_count) == (
        want.c_max, want.n, want.h, want.b_loc, want.s_count)


@pytest.mark.parametrize("case", list(CASES))
def test_routing_before_the_exchange_matches_jax(case):
    """One rank's routing, integer for integer: `_classify`, `_route_sorted`
    (a stable sort with the tie order of `jax.lax.sort` over (keys, rows,
    iota)), the index buckets `_fill_buckets` sends and each entry's bucket
    position `_entry_bucket_pos` (N * C_max where the entry drops)."""
    vocabs, split, n, b_loc, h, cap, hashed, ids = CASES[case]
    ref_lay, lay = _layouts(vocabs, split, n, hashed, cap)
    idx = _local_indices(vocabs, b_loc, h, ids, seed=len(case))
    idx[2] = idx[5]  # whole examples repeated: duplicates in every table
    rplan = ref_rx.RoutedPlan(ref_lay, b_loc, h, cap)
    plan = port_rx.routed_plan(lay, b_loc, h, cap)
    ref_idx = ref_lay.perm_rows(jnp.asarray(idx))
    port_idx = lay.perm_rows(torch.from_numpy(idx))
    np.testing.assert_array_equal(port_idx.numpy(), np.asarray(ref_idx))

    rslot, rlrow = ref_rx._classify(rplan, ref_lay, ref_idx)
    slot, lrow = port_rx._classify(plan, lay, port_idx)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(lrow.numpy(), np.asarray(rlrow))

    want = ref_rx._route_sorted(rplan, rslot, rlrow)
    got = port_rx._route_sorted(plan, lay, slot, lrow)
    # (ustart, uend, keys_s, lrow_s, order, uniq_rank, order2); the JAX
    # package also returns each table's valid count, which nothing reads
    for name, g, w in zip(("ustart", "uend", "keys_s", "lrow_s", "order", "uniq_rank", "order2"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    ustart, uend, keys_s, lrow_s, _, uq, order2 = got
    lrow_u = lrow_s.gather(1, order2)
    bucket = port_rx._fill_buckets(plan, lay, lrow_u.reshape(-1), ustart, uend, lay.r_pad)
    rlrow_u = jnp.take_along_axis(want[3], want[6], axis=1)
    rbucket = ref_rx._fill_buckets(rplan, rlrow_u.reshape(-1), want[0], want[1], jnp.int32(ref_lay.r_pad))
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(rbucket))
    pos = port_rx._entry_bucket_pos(plan, lay, keys_s, uq, ustart)
    rpos = ref_rx._entry_bucket_pos(rplan, want[2], want[5], want[0])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos).reshape(pos.shape))
    dropped = int((pos.numpy() == n * plan.c_max).sum()) - int((keys_s.numpy() == plan.s_count).sum())
    if ids == "skew":
        assert dropped > 0  # the case exercises drops


def test_segment_sums_match_a_sequential_sum():
    """The duplicate gradients' segmented scan: at each run's last entry,
    the run's sum, within the f32 bound of summing n terms in another
    order ((n - 1) 2^-24 sum |g|)."""
    rng = np.random.default_rng(0)
    t, m, d = 3, 37, 5
    seg = np.sort(rng.integers(0, 9, size=(t, m)), axis=1)
    x = rng.standard_normal((t, m, d)).astype(np.float32)
    got = port_rx._segment_sums(torch.from_numpy(x), torch.from_numpy(seg)).numpy()
    for tt in range(t):
        for s in np.unique(seg[tt]):
            run = np.nonzero(seg[tt] == s)[0]
            want = x[tt, run].astype(np.float64).sum(axis=0)
            bound = (len(run) - 1) * 2.0**-24 * np.abs(x[tt, run]).sum(axis=0) + 1e-30
            assert np.all(np.abs(got[tt, run[-1]] - want) <= bound)


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("cap", [0.0, 0.5, 2.0])
def test_routed_drop_stats_match_jax(hashed, cap):
    """The host's drop count on Zipf(1.05) ids, (dropped, valid, fraction)
    equal to the JAX package's, with padding and out-of-vocab ids."""
    vocabs, split, n = [5000, 20000, 3000], [4, 8, 2], 4
    ref_lay, lay = _layouts(vocabs, split, n, hashed, cap)
    rng = np.random.default_rng(1)
    idx = np.stack([_zipf(rng, v, (256, 2)) for v in vocabs], axis=1)
    idx[:3, 0, 0] = -1
    idx[5, 1, 1] = vocabs[1] + 4
    want = ref_rx.routed_drop_stats(ref_lay, idx)
    got = port_rx.routed_drop_stats(lay, idx)
    assert got == want
    assert got[1] == idx.size - 4
    assert port_rx.routed_drop_stats(lay, idx[:, :, 0]) == ref_rx.routed_drop_stats(ref_lay, idx[:, :, 0])


def test_zipf_drops_quantified_and_hash_fixes_them():
    """tests/test_routed_robustness.py's check at its shapes: on Zipf(1.05)
    at cap 2.0 the unhashed layout drops over 2% of the lookups, the
    hash-permuted one under 0.1%."""
    n, b, h = 8, 4096, 1
    vocabs = [100_000, 200_000, 50_000, 400_000]
    split = [8, 8, 8, 16]
    rng = np.random.RandomState(0)
    idx = np.stack([np.minimum(rng.zipf(1.05, size=(b, h)).astype(np.int64) - 1, v - 1) for v in vocabs],
                   axis=1)
    _, plain = _layouts(vocabs, split, n, False)
    _, hashed = _layouts(vocabs, split, n, True)
    d0, t0, f0 = port_rx.routed_drop_stats(plain, idx)
    d1, t1, f1 = port_rx.routed_drop_stats(hashed, idx)
    assert t0 == t1 == b * len(vocabs)
    assert f0 > 0.02 and f1 < 0.001, (f0, f1)


@pytest.mark.parametrize("split", [[1, 1, 1, 1], [2, 2, 2, 2], [4, 2, 1, 1], [1, 8, 8, 1]])
@pytest.mark.parametrize("cap", [0.0, 2.0])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_routed_step_exchange_bytes_match_jax(split, cap, dtype_bytes):
    """`step_exchange_bytes` under exchange="routed" (tests/
    test_routed_exchange.py::test_step_exchange_bytes_reporting and
    tests/test_wire_bytes_crosscheck.py's routed cases): equal to the JAX
    package's, the formula's value, and independent of the split degree
    at a cap factor above 0."""
    n, b = 4, 64
    vocabs = [1024, 896, 1280, 960]
    subs = ref_ec.expand_subtables(vocabs, split)
    owner = [i % n for i in range(len(subs))]
    kw = dict(split=split, exchange="routed", routed_cap_factor=cap)
    ref_lay = ref_ec.ShardedEmbeddingLayout(vocabs, DIM, n, owner, **kw)
    lay = port_ec.ShardedEmbeddingLayout(vocabs, DIM, n, owner, **kw)
    for bag in (1, 2):
        got = lay.step_exchange_bytes(b, bag, dtype_bytes)
        assert got == ref_lay.step_exchange_bytes(b, bag, dtype_bytes)
        expect = sum(int(b * bag * (1.0 if s == 1 or cap <= 0 else cap) * (2 * 4 + 2 * DIM * dtype_bytes))
                     for s in split)
        assert got == expect * (n - 1) // n
    if cap > 0:  # the reported entries against the buckets a rank ships (the JAX test's cap 2.0)
        plan = port_rx.RoutedPlan(lay, b // n, 1, cap)
        reported = sum(b // n * (1.0 if s == 1 else cap) for s in split)
        assert reported <= int(plan.slot_cap.sum()) <= reported + 8 * len(subs)
    dense = port_ec.ShardedEmbeddingLayout(vocabs, DIM, n, owner, split=split)
    assert dense.step_exchange_bytes(b, 1, dtype_bytes) == ref_ec.ShardedEmbeddingLayout(
        vocabs, DIM, n, owner, split=split).step_exchange_bytes(b, 1, dtype_bytes)


@pytest.mark.parametrize("case", ["splits-bag2-exact", "splits-cap2-zipf-hashed"])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
def test_step_bucket_bytes_count_what_the_all_to_alls_send(case, pool_dtype, monkeypatch):
    """`RoutedPlan.step_bucket_bytes` against the buffers one rank's lookup
    and update hand to the all-to-all (recorded by a stand-in that returns
    its input, so the rank is its own owner; the shapes do not depend on
    that): N - 1 of their N equal chunks leave the rank, times N ranks.
    With padded buckets it counts more than `step_exchange_bytes` does."""
    vocabs, split, n, b_loc, h, cap, hashed, ids = CASES[case]
    _, lay = _layouts(vocabs, split, n, hashed, cap)
    sent = []

    def a2a(x, group=None):
        sent.append(x.numel() * x.element_size())
        return x.contiguous().clone()

    monkeypatch.setattr(port_rx, "_a2a", a2a)
    plan = port_rx.routed_plan(lay, b_loc, h, cap)
    idx = lay.perm_rows(torch.as_tensor(_local_indices(vocabs, b_loc, h, ids, seed=3)))
    pool = torch.zeros((lay.r_pad, DIM), dtype=pool_dtype)
    g = torch.ones((b_loc, len(vocabs), DIM), dtype=pool_dtype)
    port_rx.routed_lookup_local(plan, lay, pool, idx)
    from dlrm_flexflow_tpu_torch import SGDOptimizer

    port_rx.routed_update_local(plan, lay, pool, None, idx, g, SGDOptimizer(lr=0.1))
    assert len(sent) == 4
    row_bytes = torch.empty((), dtype=pool_dtype).element_size()
    assert plan.step_bucket_bytes(DIM, row_bytes) == n * sum(sent) * (n - 1) // n
    assert plan.step_bucket_bytes(DIM, row_bytes) > lay.step_exchange_bytes(n * b_loc, h, row_bytes)
