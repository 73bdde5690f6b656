"""The port's sharded-embedding layout and strategy plan against the JAX
package's, in one process (no torch.distributed).

`dlrm_flexflow_tpu_torch/parallel/embedding_collection.py` and `plan.py`
copy the JAX package's numpy arithmetic: every derived array of a layout
(slots, offsets, r_pad with and without the packed-pool alignment, the
hierarchical selection matrices), the placements (greedy, round robin,
host-aware with splits), the hash row permutation and the byte accounting
must be equal, not close. The strategy file loads in either package. The
exchange itself runs in 4 gloo processes (tests/test_torch_port_mesh.py).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu.core.initializers import GlorotUniform as RefGlorot
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm
from dlrm_flexflow_tpu.parallel import embedding_collection as ref_ec
from dlrm_flexflow_tpu.parallel import plan as ref_plan

from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.parallel import embedding_collection as port_ec
from dlrm_flexflow_tpu_torch.parallel import plan as port_plan
from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh

VOCABS = [300, 1000, 50, 120, 700, 90, 33, 410, 64, 256]
KAGGLE_FUSED = [v for v in ref_dlrm.kaggle_config().embedding_size if v > 8192]
MLPERF_LITE_FUSED = [v for v in ref_dlrm.mlperf_lite_config().embedding_size if v > 8192]

# (vocabs, dim, shards, policy, split, chips_per_host, packed_pool)
LAYOUTS = {
    "greedy": (VOCABS, 8, 4, "greedy", None, None, False),
    "round-robin": (VOCABS, 8, 4, "round_robin", None, None, False),
    "greedy-packed": (VOCABS, 8, 4, "greedy", None, None, True),
    "splits": (VOCABS, 8, 4, "greedy", [2, 4, 1, 1, 3, 1, 1, 2, 1, 1], None, False),
    "hierarchical-splits": (VOCABS, 8, 4, "greedy", [2, 2, 1, 1, 2, 1, 1, 1, 1, 1], 2, True),
    "hierarchical-8": (VOCABS, 16, 8, "greedy", [4, 2, 1, 1, 3, 1, 1, 1, 1, 1], 2, False),
    "kaggle": (KAGGLE_FUSED, 16, 4, "greedy", None, None, True),
    "mlperf-lite": (MLPERF_LITE_FUSED, 128, 4, "greedy", None, None, True),
    "odd-dim": ([40, 70, 9], 12, 2, "greedy", None, None, True),  # D does not divide 128: unpacked
}
DERIVED = ("owner", "t_max", "r_pad", "row_offset", "slot_sub", "slot_tid", "slot_start", "slot_len",
           "slot_offset_arr", "chips_per_host", "packed_pool", "th_max", "host_tables", "sel_host",
           "sel_global", "subs")


def _plans(policy, split, cph, packed, **kw):
    out = []
    for mod in (ref_plan, port_plan):
        p = mod.dlrm_hybrid_plan(policy)
        p.table_split, p.chips_per_host, p.packed_pool = split, cph, packed
        for k, v in kw.items():
            setattr(p, k, v)
        out.append(p)
    return out


def _layouts(name, **kw):
    vocabs, dim, n, policy, split, cph, packed = LAYOUTS[name]
    rp, pp = _plans(policy, split, cph, packed, **kw)
    return rp.make_layout(vocabs, dim, n), pp.make_layout(vocabs, dim, n), rp, pp


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_jax(name):
    """Every derived field, the plan's recorded assignment and hash_rows."""
    ref, port, rp, pp = _layouts(name)
    for field in DERIVED:
        _same(getattr(ref, field), getattr(port, field))
    assert pp.table_assignment == rp.table_assignment
    assert pp.hash_rows == rp.hash_rows
    _same(ref.table_select_matrix(), port.table_select_matrix())
    assert port.param_shape() == ref.param_shape() and port.has_splits == ref.has_splits
    assert port.hierarchical == ref.hierarchical and port.num_hosts == ref.num_hosts
    if ref.hierarchical:
        assert port._host_groups() == ref._host_groups()
        assert port._cross_host_groups() == ref._cross_host_groups()


@pytest.mark.parametrize("name", ["greedy", "splits", "hierarchical-splits", "kaggle", "mlperf-lite"])
@pytest.mark.parametrize("batch, bag, dtype_bytes", [(65536, 1, 2), (4096, 3, 4)])
def test_byte_accounting_matches_jax(name, batch, bag, dtype_bytes):
    ref, port, _, _ = _layouts(name)
    for fn, args in (("hbm_bytes_per_shard", (dtype_bytes,)),
                     ("pooled_exchange_bytes", (batch, dtype_bytes)),
                     ("dcn_pooled_exchange_bytes", (batch, dtype_bytes)),
                     ("step_exchange_bytes", (batch, bag, dtype_bytes))):
        assert getattr(port, fn)(*args) == getattr(ref, fn)(*args), fn
    assert port.pool_packs == ref.pool_packs


def test_routed_byte_accounting_matches_jax():
    ref, port, _, _ = _layouts("splits", exchange="routed")
    assert ref.hash_rows and port.hash_rows
    assert port.step_exchange_bytes(8192, 2, 2) == ref.step_exchange_bytes(8192, 2, 2)


def test_kaggle_and_mlperf_lite_figures():
    """The full-width layouts of the mesh path on 4 shards (greedy)."""
    k = port_plan.dlrm_hybrid_plan().make_layout(KAGGLE_FUSED, 16, 4)
    assert len(KAGGLE_FUSED) == 10 and k.owner == [0, 3, 2, 2, 1, 2, 3, 2, 2, 2]
    assert k.t_max == 6 and k.r_pad == 10_131_232
    p = port_plan.dlrm_hybrid_plan()
    p.packed_pool = True
    k = p.make_layout(KAGGLE_FUSED, 16, 4)
    assert k.r_pad == 10_141_696 and k.hbm_bytes_per_shard(2) == 324_534_272
    assert k.step_exchange_bytes(65536, dtype_bytes=2) == 122_683_392
    m = port_plan.dlrm_hybrid_plan().make_layout(MLPERF_LITE_FUSED, 128, 4)
    assert len(MLPERF_LITE_FUSED) == 13 and m.t_max == 7 and m.r_pad == 4_000_000
    assert m.hbm_bytes_per_shard(2) == 1_024_000_000


@pytest.mark.parametrize("cph, n", [(1, 4), (3, 4), (4, 4), (0, 4), (2, 6)])
def test_degenerate_hierarchical_falls_back_flat(cph, n):
    """A host size of 1, one that does not divide the shards, or all of
    them: the flat exchange, in both packages (6 shards of 2 stay
    hierarchical)."""
    ref = ref_ec.ShardedEmbeddingLayout([100] * n, 8, n, list(range(n)), chips_per_host=cph or None)
    port = port_ec.ShardedEmbeddingLayout([100] * n, 8, n, list(range(n)), chips_per_host=cph or None)
    assert port.hierarchical == ref.hierarchical == ((cph, n) == (2, 6))
    assert port.chips_per_host == ref.chips_per_host
    assert port.dcn_pooled_exchange_bytes(256) == ref.dcn_pooled_exchange_bytes(256)
    rp, pp = _plans("greedy", None, cph or None, False)
    assert pp.make_layout([100] * n, 8, n).hierarchical == rp.make_layout([100] * n, 8, n).hierarchical


@pytest.mark.parametrize("name", ["greedy", "splits", "hierarchical-8"])
def test_per_table_assignment_with_splits_stripes_like_jax(name):
    vocabs, dim, n, _, split, cph, _ = LAYOUTS[name]
    if split is None:
        split = [2] * len(vocabs)
    rp, pp = _plans("greedy", split, cph, False, table_assignment=[i % n for i in range(len(vocabs))])
    assert pp.make_layout(vocabs, dim, n).owner == rp.make_layout(vocabs, dim, n).owner


def test_hash_permutation_matches_jax():
    """perm_rows (int64 in the port, a uint32 double-and-add in the JAX
    package) is the same bijection; indices < 0 or >= vocab pass."""
    vocabs = [7, 100, 65_537, 1_000_003, 292_775_614]
    ref = ref_ec.ShardedEmbeddingLayout(vocabs, 8, 2, [0, 1, 0, 1, 0], hash_rows=True)
    port = port_ec.ShardedEmbeddingLayout(vocabs, 8, 2, [0, 1, 0, 1, 0], hash_rows=True)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(-2, v + 3, size=(64, 3)) for v in vocabs], axis=1)
    idx[0, :, 0] = [v - 1 for v in vocabs]
    want = np.asarray(ref.perm_rows(jnp.asarray(idx, jnp.int32)))
    got = port.perm_rows(torch.from_numpy(idx.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    for t, v in enumerate(vocabs[:4]):
        pos = port.perm_table_np(t)
        np.testing.assert_array_equal(pos, ref.perm_table_np(t))
        assert np.array_equal(np.sort(pos), np.arange(v))
        np.testing.assert_array_equal(port._inv_positions(t, 0, v)[pos], np.arange(v))
    plain = port_ec.ShardedEmbeddingLayout(vocabs, 8, 2, [0, 1, 0, 1, 0])
    np.testing.assert_array_equal(plain.perm_rows(torch.from_numpy(idx)).numpy(), idx)


@pytest.mark.parametrize("hash_rows", [False, True])
def test_init_and_extract_keep_every_table(hash_rows):
    """A pool made by `init_pool` (the whole pool or one shard at a time)
    gives back each table through `extract_table`, which reads the JAX
    package's pool [N, R_pad, D] as the JAX function does."""
    vocabs, split = [50, 130, 17, 64], [3, 2, 1, 1]
    subs = port_ec.expand_subtables(vocabs, split)
    owner = port_plan.greedy_subtable_assignment(subs, [ln for _, _, ln in subs], 4)
    port = port_ec.ShardedEmbeddingLayout(vocabs, 4, 4, owner, split=split, hash_rows=hash_rows)
    ref = ref_ec.ShardedEmbeddingLayout(vocabs, 4, 4, owner, split=split, hash_rows=hash_rows)
    tables = [torch.arange(v * 4, dtype=torch.float32).reshape(v, 4) + 1000 * t for t, v in enumerate(vocabs)]
    whole = port.init_pool(lambda t: tables[t], None, "cpu")
    shards = torch.cat([port.init_pool(lambda t: tables[t], s, "cpu") for s in range(4)])
    assert torch.equal(whole, shards)
    for t in range(len(vocabs)):
        assert torch.equal(port.extract_table(whole, t), tables[t])
        want = ref.extract_table(jnp.asarray(whole.numpy()).reshape(4, -1, 4), t)
        np.testing.assert_array_equal(port.extract_table(whole.numpy(), t), np.asarray(want))


def test_jax_init_converts_to_the_port_pool():
    """The JAX package's pool, packed [N, P, 128] or not, gives each rank
    its shard through `params_from_jax(..., shard=)`."""
    vocabs = [300, 120, 77, 500]
    for packed in (False, True):
        ref = ref_ec.ShardedEmbeddingLayout(vocabs, 16, 4, [0, 1, 2, 3], packed_pool=packed, pool_chunk_packs=8)
        pool = np.asarray(ref.init_params(jax.random.PRNGKey(0), RefGlorot()))
        assert pool.shape == ref.param_shape()
        flat = np.asarray(pool).reshape(4, ref.r_pad, 16)
        for s in range(4):
            got = params_from_jax({"c": {"pool": pool}}, like={"c": {"pool": (ref.r_pad, 16)}}, shard=s)
            np.testing.assert_array_equal(got["c"]["pool"].numpy(), flat[s])
        got = params_from_jax({"c": {"pool": pool}}, like={"c": {"pool": (4 * ref.r_pad, 16)}})
        np.testing.assert_array_equal(got["c"]["pool"].numpy(), flat.reshape(-1, 16))


def _specs_plan(mod, pspec):
    p = mod.dlrm_hybrid_plan()
    p.table_split = [2, 1, 4]
    p.chips_per_host = 2
    p.replicated_tables = [5]
    p.host_tail_rows = [0, 0, 64]
    p.make_layout([100, 200, 300], 8, 4)
    p.op_specs["dense_0"] = mod.OpShardSpec(output_specs=[pspec("data", None)],
                                            param_specs={"kernel": pspec(None, ("data", "model"))})
    return p


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_strategy_file_loads_in_both_packages(tmp_path, writer):
    from jax.sharding import PartitionSpec as P

    path = str(tmp_path / "strategy.json")
    src = _specs_plan(ref_plan, P) if writer == "jax" else _specs_plan(port_plan, lambda *a: [
        list(x) if isinstance(x, tuple) else x for x in a])
    src.save(path)
    ref, port = ref_plan.ShardingPlan.load(path), port_plan.ShardingPlan.load(path)
    for field in ("mesh_axes", "batch_axis", "embedding_mode", "assignment_policy", "table_assignment",
                  "table_split", "replicated_tables", "chips_per_host", "exchange", "routed_cap_factor",
                  "packed_pool", "hash_rows", "host_tail_rows"):
        assert getattr(port, field) == getattr(ref, field) == getattr(src, field), field
    assert port.op_specs["dense_0"].to_json() == ref.op_specs["dense_0"].to_json()
    assert port.op_specs["dense_0"].to_json() == {"outputs": [["data", None]],
                                                  "params": {"kernel": [None, ["data", "model"]]}}
    port.save(str(tmp_path / "again.json"))
    with open(path) as f, open(tmp_path / "again.json") as g:
        assert json.load(f) == json.load(g)


def test_data_parallel_plan_and_two_d_refusals():
    """The plans' defaults; enable_parameter_parallel's specs on a graph as
    the JAX package writes them (every even Dense of 64 outputs or more:
    kaggle's 512, 256 and 64 wide layers, not its 16 or 1 wide ones); a 2-D
    mesh needs a process group and ("data", "model") axes of a world's
    size."""
    from dlrm_flexflow_tpu.models import dlrm as ref_dlrm

    from dlrm_flexflow_tpu_torch.models import dlrm as port_dlrm

    assert port_plan.data_parallel_plan().embedding_mode == ref_plan.data_parallel_plan().embedding_mode
    assert port_plan.dlrm_hybrid_plan("round_robin").assignment_policy == "round_robin"
    port_graph = port_dlrm.make_dlrm_model(port_dlrm.kaggle_config(batch_size=8), device="cpu").graph
    ref_graph = ref_dlrm.make_dlrm_model(ref_dlrm.kaggle_config(batch_size=8)).graph
    pp = port_plan.enable_parameter_parallel(port_plan.dlrm_hybrid_plan(), port_graph)
    jp = ref_plan.enable_parameter_parallel(ref_plan.dlrm_hybrid_plan(), ref_graph)
    assert {k: v.to_json() for k, v in pp.op_specs.items()} == {k: v.to_json() for k, v in jp.op_specs.items()}
    assert sorted(pp.op_specs) == ["bot_mlp_0", "bot_mlp_1", "bot_mlp_2", "top_mlp_0", "top_mlp_1"]
    assert pp.mesh_axes == ("data", "model")
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh((2, 2), ("data", "model"))  # no process group in this process
    with pytest.raises(ValueError, match="2-D mesh"):
        make_mesh((2, 2), ("model", "data"))
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(device="cpu")  # no process group in this process
