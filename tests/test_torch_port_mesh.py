"""The port's hybrid-parallel path in 4 gloo processes against the JAX
package on a 4-device CPU mesh.

Four worker processes are started once for the module (`workers`): each
imports the port and torch only (no JAX), joins a gloo group through a
`file://` rendezvous under the test's temporary directory, makes a
4-rank "data" mesh on the CPU, and then runs the code of each case on its
own rank, as a rank of a real mesh does; one torch thread a worker. The JAX
side runs here, on `make_mesh((4,), ("data",), jax.devices()[:4])` (the 8
CPU devices of conftest.py), and weights go to the workers by
`convert.params_from_jax(..., shard=rank)`. The cases follow
tests/test_sharding.py: the sharded lookup (SUM, AVG, row splits,
hierarchical at chips_per_host=2), the sparse update under SGD, momentum,
Adam and row-wise AdaGrad (the JAX side on its packed pool, the packed
update kernels interpreted; the port on the kernel route, whose wrappers
take their plain versions on the CPU), 3 steps of the small hybrid DLRM of
`__graft_entry__.py` (flat and hierarchical with splits) and `predict`;
then the replicated parameters after `compile`, the refusals, `train_chunk`
and `fit(steps_per_call=2)` under the mesh, the routed exchange (lookup and
update against the JAX package's and the dense exchange, a routed DLRM),
sharded checkpoints, the 2-D ("data", "model") mesh with column-parallel
Dense layers (against the JAX package's (2, 2) mesh under
`enable_parameter_parallel`, the port's (4,) mesh, one device, its CUDA-
graph path, checkpoints and strategy files), the launcher, `bench --mesh`
and the workers' import boundary. The data axis of 1 runs in this process,
in a gloo world of one (with int8 serving of a fused collection against
the JAX package's).

Tolerances. The lookups gather and sum the same f32 rows: the JAX package
sums a bag in another order (rtol 1e-5, atol 1e-6). The row updates: both
sides round each stream entry to bf16 and sum a row's entries in f32, in
another order for duplicates (a row's run of n entries: within n * 2^-24
of each other, relatively), and XLA fuses a multiply-add where the port
rounds twice; the pools within rtol 1e-5 and atol 1e-6 under SGD and
momentum, and AdaGrad's reciprocal square roots (XLA's and torch's, an ulp
apart) within rtol 1e-4 and atol 1e-5, the bound of the JAX package's own
AdaGrad host-tail test. Adam's update alpha_t * m / (sqrt(v) + eps) moves
a weight whose gradient is near 0 by up to alpha_t * (1 - beta1) /
sqrt(1 - beta2) = 3.2 alpha_t whatever the sign two summation orders give
that gradient: Adam's pools are held within rtol 1e-5, atol 1e-6, and its
weights within that bound with almost all (99%) within rtol 1e-5, atol
1e-6. The DLRM steps are f32 on both sides with the same operations but
for f32 summation orders (the losses within rtol 1e-5, atol 1e-6; weights
within rtol 1e-4, atol 1e-5, as tests/test_torch_port_training.py holds
its Adam models). The 2-D mesh's cases take tests/test_sharding.py's
bound for tensor parallelism against a 1-D mesh (losses within rtol 2e-4,
atol 2e-5) and the weights' bound above.
"""
import json
import os
import pickle
import queue
import struct
import subprocess
import sys
import textwrap
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.core.initializers import GlorotUniform as RefGlorot
from dlrm_flexflow_tpu.data import synthetic as ref_synthetic
from dlrm_flexflow_tpu.models import dlrm as ref_dlrm
from dlrm_flexflow_tpu.ops.embedding_collection_op import EmbeddingCollection as RefCollection
from dlrm_flexflow_tpu.parallel import embedding_collection as ref_ec
from dlrm_flexflow_tpu.parallel import routed_exchange as ref_rx
from dlrm_flexflow_tpu.parallel.mesh import make_mesh as ref_make_mesh
from dlrm_flexflow_tpu.parallel.plan import data_parallel_plan as ref_data_parallel_plan
from dlrm_flexflow_tpu.parallel.plan import dlrm_hybrid_plan as ref_hybrid_plan

REPO = Path(__file__).resolve().parent.parent
N = 4
CASE_TIMEOUT_S = 120

# the worker: a loop of (code, args) read from stdin, each run in one
# namespace that persists between cases, the result (or the traceback)
# written back as a pickle on the original stdout
_WORKER = r"""
import os, pickle, struct, sys, traceback
out = os.fdopen(os.dup(1), "wb")
os.dup2(2, 1)
sys.stdout = sys.stderr
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["RENDEZVOUS"], rank=rank, world_size=world)
ns = {"rank": rank, "world": world}
inp = sys.stdin.buffer
while True:
    head = inp.read(8)
    if len(head) < 8:
        break
    code, args = pickle.loads(inp.read(struct.unpack("<Q", head)[0]))
    ns["args"], ns["result"] = args, None
    try:
        exec(code, ns)
        res = ("ok", ns["result"])
    except BaseException:
        res = ("err", traceback.format_exc())
    blob = pickle.dumps(res)
    out.write(struct.pack("<Q", len(blob)) + blob)
    out.flush()
dist.destroy_process_group()
"""

_PRELUDE = """
import numpy as np
import torch
import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
from dlrm_flexflow_tpu_torch.parallel import embedding_collection as pec
from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
from dlrm_flexflow_tpu_torch.parallel.plan import data_parallel_plan, dlrm_hybrid_plan
from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors
mesh = make_mesh(device="cpu")
assert (mesh.rank, mesh.size, str(mesh.device)) == (rank, world, "cpu")

def local(x):
    return x[mesh.batch_slice(x.shape[0])]

def state_np(st):
    if st is None:
        return None
    if isinstance(st, dict):
        return {k: v.numpy().copy() for k, v in st.items()}
    return st.numpy().copy()

def dlrm(kw, opt, plan_kw, **ffkw):
    cfg = pdlrm.DLRMConfig(**kw)
    m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=cfg.batch_size, compute_dtype="float32",
                                                 onehot_embedding_threshold=0, **ffkw), device="cpu")
    plan = dlrm_hybrid_plan()
    for k, v in plan_kw.items():
        setattr(plan, k, v)
    m.compile(getattr(port, opt[0])(**opt[1]), port.LossType.LOSS_BINARY_CROSSENTROPY,
              [port.MetricsType.METRICS_ACCURACY], mesh=mesh, plan=plan)
    return m

# a DLRM of config `kw` under `plan` ("dp": data_parallel_plan(), "hybrid":
# dlrm_hybrid_plan()) on the 4-rank mesh, or on one device with mesh None;
# f32, FFConfig(**ffkw) over these defaults
def build(kw, opt, plan, mesh=mesh, **ffkw):
    cfg = pdlrm.DLRMConfig(**kw)
    ff = dict(batch_size=cfg.batch_size, compute_dtype="float32", onehot_embedding_threshold=0)
    m = pdlrm.make_dlrm_model(cfg, port.FFConfig(**{**ff, **ffkw}), device="cpu")
    m.compile(getattr(port, opt[0])(**opt[1]), port.LossType.LOSS_BINARY_CROSSENTROPY,
              [port.MetricsType.METRICS_ACCURACY], mesh=mesh,
              plan=None if mesh is None else data_parallel_plan() if plan == "dp" else dlrm_hybrid_plan())
    return m

# one hash of every tensor of the state that the ranks replicate (all but
# a sharded collection's) and of every host-tail store's state
def replica_digest(m):
    import hashlib
    h = hashlib.sha256()
    for path, t in sorted(state_tensors(m).items()):
        if "embedding_collection" not in path:
            h.update(path.encode() + t.numpy().tobytes())
    for name, (store, *_rest) in sorted((m._host_tail.entries if m._host_tail else {}).items()):
        for a in store.state():
            h.update(a.tobytes())
    return h.hexdigest()

# tests/test_host_tail.py's tables: table t from RandomState(100 + t), its
# hot prefix on the device and its tail rows in the store
def preseed_tails(m, vocabs, hot, dim):
    for t, name in enumerate(sorted((n for n in m.get_parameters() if n.startswith("table_")),
                                    key=lambda n: int(n.split("_")[1]))):
        full = np.random.RandomState(100 + t).randn(vocabs[t], dim).astype(np.float32) * 0.05
        if m._host_tail is not None and name in m._host_tail.entries:
            m.set_weights(name, {"weight": full[:hot]})
            m._host_tail.entries[name][0].load_state(np.arange(hot, vocabs[t]), full[hot:])
        else:
            m.set_weights(name, {"weight": full})

# the meshes over the 4 ranks, each made once (a 2-D one makes its groups,
# a collective every rank reaches in one order)
_meshes = {(world,): mesh}
def mesh_of(shape):
    if shape not in _meshes:
        _meshes[shape] = make_mesh(shape, ("data", "model")[:len(shape)], device="cpu")
    return _meshes[shape]

# tests/test_sharding.py's model of the parameter-parallel case on `mesh`
# (None: one device), FFConfig(enable_parameter_parallel=epp), under the
# plan `plan`: "hybrid", "routed" (the hybrid plan's exchange routed, exact)
# or "dp" (data_parallel_plan())
def tp_dlrm(kw, opt, mesh, seed=11, epp=True, plan="hybrid", **ffkw):
    cfg = pdlrm.DLRMConfig(**kw)
    m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=cfg.batch_size, compute_dtype="float32", seed=seed,
                                                 onehot_embedding_threshold=0, enable_parameter_parallel=epp,
                                                 **ffkw), device="cpu")
    p = data_parallel_plan() if plan == "dp" else dlrm_hybrid_plan()
    if plan == "routed":
        p.exchange, p.routed_cap_factor = "routed", 0.0
    m.compile(getattr(port, opt[0])(**opt[1]), port.LossType.LOSS_BINARY_CROSSENTROPY,
              [port.MetricsType.METRICS_ACCURACY], mesh=mesh, plan=None if mesh is None else p)
    return m

# a hash of every host-tail store's state
def store_digest(m):
    import hashlib
    h = hashlib.sha256()
    for name, (store, *_rest) in sorted((m._host_tail.entries if m._host_tail else {}).items()):
        for a in store.state():
            h.update(a.tobytes())
    return h.hexdigest()

# every op's weights whole: the towers (a column-parallel one gathered over
# the model group) and the tables fused into the collection (collective)
def whole_weights(m):
    coll = m._op("embedding_collection")
    names = [n for n in m.get_parameters() if coll is None or n != coll.name]
    return {n: m.get_weights(n) for n in names + (coll.table_names if coll is not None else [])}

# (a hash of the state a rank's model peers hold alike: all but the
# column-parallel tensors; a hash of those, which its data peers hold alike)
def split_digests(m):
    import hashlib
    rest, tp = hashlib.sha256(), hashlib.sha256()
    for path, t in sorted(state_tensors(m).items()):
        op, key = path.split("/")[-2:]
        (tp if key in m._model_parallel.get(op, ()) else rest).update(path.encode() + t.numpy().tobytes())
    return rest.hexdigest(), tp.hexdigest()
"""


class Workers:
    """The 4 resident worker processes."""

    def __init__(self, tmp: Path):
        rendezvous = f"file://{tmp / 'rendezvous'}"
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT")}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", WORLD_SIZE=str(N), RENDEZVOUS=rendezvous,
                   PYTHONWARNINGS="ignore")
        self.logs = [open(tmp / f"worker{r}.log", "w") for r in range(N)]
        self.procs = [subprocess.Popen([sys.executable, "-c", _WORKER], cwd=REPO, env={**env, "RANK": str(r)},
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.logs[r])
                      for r in range(N)]
        self.replies = [queue.Queue() for _ in range(N)]
        for p, q in zip(self.procs, self.replies):
            threading.Thread(target=self._read, args=(p.stdout, q), daemon=True).start()
        self.tmp = tmp

    @staticmethod
    def _read(stream, q):
        while True:
            head = stream.read(8)
            if len(head) < 8:
                q.put(("err", "the worker exited"))
                return
            q.put(pickle.loads(stream.read(struct.unpack("<Q", head)[0])))

    def run(self, code: str, args=None) -> list:
        """Run `code` on every rank; returns each rank's `result`."""
        blob = pickle.dumps((textwrap.dedent(code), args))
        for p in self.procs:
            p.stdin.write(struct.pack("<Q", len(blob)) + blob)
            p.stdin.flush()
        out = []
        for r, q in enumerate(self.replies):
            try:
                status, value = q.get(timeout=CASE_TIMEOUT_S)
            except queue.Empty:
                self.close()
                raise AssertionError(f"rank {r} gave no reply in {CASE_TIMEOUT_S} s: "
                                     f"{(self.tmp / f'worker{r}.log').read_text()[-3000:]}")
            if status != "ok":
                raise AssertionError(f"rank {r}:\n{value}")
            out.append(value)
        return out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    w = Workers(tmp_path_factory.mktemp("mesh"))
    try:
        w.run(_PRELUDE)
        yield w
    finally:
        w.close()


@pytest.fixture(scope="module")
def jmesh():
    return ref_make_mesh((N,), ("data",), jax.devices()[:N])


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    over = err - rtol * np.abs(want)
    assert np.all(over <= atol), (float(err.max()), float(over.max()))


# ------------------------------------------------------------------ the exchange

VOCABS = [300, 1000, 50, 120, 700, 90, 33, 410]
# name -> (split, chips_per_host, aggr, policy)
LOOKUPS = {
    "greedy-sum": (None, None, "SUM", "greedy"),
    "round-robin-avg": (None, None, "AVG", "round_robin"),
    "splits-sum": ([2, 4, 1, 1, 3, 1, 1, 2], None, "SUM", "greedy"),
    "hierarchical-cph2": ([2, 2, 1, 1, 2, 1, 1, 1], 2, "SUM", "greedy"),
}


def _ref_layout(vocabs, dim, split, cph, policy="greedy", packed=False, chunk_packs=2048):
    plan = ref_hybrid_plan(policy)
    plan.table_split, plan.chips_per_host, plan.packed_pool = split, cph, packed
    lay = plan.make_layout(vocabs, dim, N)
    if packed:  # small chunks keep r_pad (and the interpreted kernel) small
        lay = ref_ec.ShardedEmbeddingLayout(vocabs, dim, N, lay.owner, split=split, chips_per_host=cph,
                                            packed_pool=True, pool_chunk_packs=chunk_packs)
    return lay


def _layout_args(lay) -> dict:
    return dict(vocab_sizes=list(lay.vocab_sizes), dim=lay.dim, num_shards=lay.num_shards,
                owner=list(lay.owner),
                split=lay.split, chips_per_host=lay._phys_chips_per_host, packed_pool=lay.packed_pool,
                pool_chunk_packs=lay.pool_chunk_packs)


def _indices(vocabs, b, h, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, v, size=(b, h)) for v in vocabs], axis=1).astype(np.int32)
    idx[0, 0, 1:] = -1
    idx[3, 5, :] = -1  # an empty bag
    return idx


@pytest.mark.parametrize("case", list(LOOKUPS))
def test_sharded_lookup_matches_jax(workers, jmesh, case):
    split, cph, aggr, policy = LOOKUPS[case]
    lay = _ref_layout(VOCABS, 8, split, cph, policy)
    assert lay.hierarchical == (cph is not None)
    pool = np.asarray(lay.init_params(jax.random.PRNGKey(0), RefGlorot()))
    idx = _indices(VOCABS, 16, 3, 1)
    jaggr = getattr(ref.AggrMode, f"AGGR_MODE_{aggr}")
    want = np.asarray(ref_ec.sharded_embedding_lookup(lay, jnp.asarray(pool), jnp.asarray(idx), jmesh, jaggr))
    got = workers.run("""
        lay = pec.ShardedEmbeddingLayout(**args["layout"])
        out = pec.sharded_embedding_lookup(lay, torch.from_numpy(args["pool"][rank]),
                                           torch.from_numpy(local(args["idx"])), mesh,
                                           getattr(port.AggrMode, args["aggr"]))
        result = (out.numpy(), lay.hierarchical)
    """, {"layout": _layout_args(lay), "pool": pool, "idx": idx, "aggr": f"AGGR_MODE_{aggr}"})
    assert all(h == lay.hierarchical for _, h in got)
    _close(np.concatenate([o for o, _ in got]), want, 1e-5, 1e-6)


# name -> (optimizer class, kwargs, rtol, atol, split, chips_per_host,
# the kernel route); the hierarchical case tests the exchange, on the
# scatter route
UPDATES = {
    "sgd": ("SGDOptimizer", dict(lr=0.1), 1e-5, 1e-6, None, None, True),
    "momentum": ("SGDOptimizer", dict(lr=0.1, momentum=0.9), 1e-5, 1e-6, None, None, True),
    "adam": ("AdamOptimizer", dict(alpha=0.01), 1e-5, 1e-6, None, None, True),
    "adagrad": ("RowWiseAdagradOptimizer", dict(lr=0.1), 1e-4, 1e-5, None, None, True),
    "adam-hierarchical-splits": ("AdamOptimizer", dict(alpha=0.01), 1e-5, 1e-6, [2, 2, 1, 1, 2, 1, 1, 1], 2,
                                 False),
}


def _ref_state(st, lay, adagrad):
    """The JAX package's state as the port keeps it, shard-leading: a
    packed pool [N, P, 128] as [N, R_pad, D], AdaGrad's lane-replicated
    packed accumulator as [N, R_pad]."""
    if isinstance(st, dict):
        return {k: _ref_state(v, lay, adagrad) for k, v in st.items()}
    if not lay.packed_pool:
        return np.asarray(st)
    full = np.asarray(st).reshape(lay.num_shards, lay.r_pad, lay.dim)
    return full[..., 0] if adagrad else full


@pytest.mark.parametrize("case", list(UPDATES))
def test_sharded_sparse_update_matches_jax(workers, jmesh, case):
    """Two steps of `sharded_embedding_sparse_update`, the slot state
    carried, bags of 2 with duplicate rows: on a kernel-route layout (the
    JAX package's packed pool) for each rule, and on the scatter route
    through the hierarchical exchange with splits."""
    name, kw, rtol, atol, split, cph, packed = UPDATES[case]
    lay = _ref_layout(VOCABS, 8, split, cph, packed=packed, chunk_packs=16)
    assert lay.packed_pool == packed and lay.hierarchical == (cph is not None)
    opt = getattr(ref, name)(**kw)
    pool = lay.init_params(jax.random.PRNGKey(2), RefGlorot())
    st = RefCollection.sparse_state_init(types.SimpleNamespace(layout=lay), opt)
    rng = np.random.default_rng(3)
    steps = []
    for step in range(2):
        idx = _indices(VOCABS, 16, 2, 10 + step)
        idx[4:8, :, 0] = 7  # duplicates of one row in every table
        steps.append((idx, rng.standard_normal((16, len(VOCABS), 8)).astype(np.float32),
                      0.003 * (step + 1) if name == "AdamOptimizer" else None))
    pool0 = np.asarray(pool).reshape(N, lay.r_pad, 8)
    # one trace of the interpreted kernels for both steps
    update = jax.jit(lambda p, s, i, g, lr: ref_ec.sharded_embedding_sparse_update(
        lay, p, s, i, g, jmesh, opt, lr=lr))
    for idx, g, lr in steps:
        pool, st = update(pool, st, jnp.asarray(idx), jnp.asarray(g), None if lr is None else jnp.float32(lr))
    got = workers.run("""
        lay = pec.ShardedEmbeddingLayout(**args["layout"])
        opt = getattr(port, args["opt"])(**args["kw"])
        pool = torch.from_numpy(args["pool"][rank].copy())
        st = opt.sparse_init((lay.r_pad, lay.dim), "cpu")
        if lay.packed_pool and st is not None and st.dim() == 3:
            st = {"m": st[0], "v": st[1]}
        for idx, g, lr in args["steps"]:
            st = pec.sharded_embedding_sparse_update(
                lay, pool, st, torch.from_numpy(local(idx)), torch.from_numpy(local(g)), mesh, opt,
                lr=None if lr is None else torch.tensor(lr))
        result = (pool.numpy(), state_np(st))
    """, {"layout": _layout_args(lay), "opt": name, "kw": kw, "pool": pool0, "steps": steps})
    want = np.asarray(pool).reshape(N, lay.r_pad, 8)
    got_pool = np.stack([p for p, _ in got])
    assert not np.array_equal(want, pool0)
    if name == "AdamOptimizer":
        bound = 3.2 * 0.003 * 2 * 2  # two steps at up to 2 * alpha_t
        err = np.abs(got_pool - want)
        assert err.max() <= bound and np.mean(err <= 1e-5 * np.abs(want) + 1e-6) >= 0.99
    else:
        _close(got_pool, want, rtol, atol)
    if st is None:
        assert all(s is None for _, s in got)
        return
    want_st = _ref_state(st, lay, name == "RowWiseAdagradOptimizer")
    if isinstance(want_st, dict):
        for k in want_st:
            _close(np.stack([s[k] for _, s in got]), want_st[k], rtol, atol)
    else:
        _close(np.stack([s for _, s in got]), want_st, rtol, atol)


# ------------------------------------------------------------------ the model

GRAFT = dict(sparse_feature_size=8, embedding_size=[64, 200, 48, 96, 300, 40, 56, 128, 72, 500],
             embedding_bag_size=2, mlp_bot=[4, 16, 8], mlp_top=[88, 16, 1], batch_size=8 * N)
PLANS = {"flat": {}, "hierarchical": {"chips_per_host": 2, "table_split": [1, 2, 1, 1, 2, 1, 1, 1, 1, 2]}}
OPT = ("AdamOptimizer", dict(alpha=0.01))
STEPS = 3


@pytest.fixture(scope="module")
def trained(workers, jmesh):
    """{plan: (JAX model, losses, port results)} after 3 steps on both sides
    from the same weights."""
    out = {}
    cfg = ref_dlrm.DLRMConfig(**GRAFT)
    feeds, labels = ref_synthetic.random_batches(cfg, GRAFT["batch_size"] * STEPS, seed=0)
    for name, plan_kw in PLANS.items():
        m = ref_dlrm.make_dlrm_model(cfg, ref.FFConfig(batch_size=GRAFT["batch_size"], compute_dtype="float32",
                                                       onehot_embedding_threshold=0))
        plan = ref_hybrid_plan()
        for k, v in plan_kw.items():
            setattr(plan, k, v)
        m.compile(getattr(ref, OPT[0])(**OPT[1]), ref.LossType.LOSS_BINARY_CROSSENTROPY,
                  [ref.MetricsType.METRICS_ACCURACY], mesh=jmesh, plan=plan)
        weights = {op: m.get_weights(op) for op in m.get_parameters()}
        bs = GRAFT["batch_size"]
        batches = [({k: v[i * bs:(i + 1) * bs] for k, v in feeds.items()}, labels[i * bs:(i + 1) * bs])
                   for i in range(STEPS)]
        got = workers.run("""
            model = dlrm(args["cfg"], args["opt"], args["plan"])
            model.set_parameters(params_from_jax(args["weights"], like=model.get_parameters(), shard=rank))
            coll = model._op("embedding_collection")
            losses = [float(model.train_batch(f, l)) for f, l in args["batches"]]
            tables = {n: model.get_weights(n)["weight"] for n in coll.table_names}
            dense = {n: model.get_weights(n) for n in model.get_parameters() if n != coll.name}
            models = globals().setdefault("models", {})
            models[args["name"]] = model
            result = {"losses": losses, "metrics": model.get_metrics(), "tables": tables, "dense": dense,
                      "cost_stats": coll.cost_stats(),
                      "hierarchical": coll.layout.hierarchical, "shard": coll.shard,
                      "pool": model.get_weights(coll.name)["pool"]}
        """, {"cfg": GRAFT, "opt": OPT, "plan": plan_kw, "weights": weights, "batches": batches, "name": name})
        losses = [float(m.train_batch(f, l)) for f, l in batches]
        out[name] = (m, losses, got, feeds)
    return out


@pytest.mark.parametrize("plan", list(PLANS))
def test_hybrid_dlrm_trains_like_jax(trained, plan):
    """3 Adam steps of the graft DLRM: every rank's loss, accuracy, fused
    tables (through `extract_table` on the JAX side) and towers."""
    m, losses, got, _ = trained[plan]
    lay = m._embedding_layout
    assert [r["shard"] for r in got] == list(range(N))
    assert all(r["cost_stats"] == m._op_by_name("embedding_collection").cost_stats() for r in got)
    assert all(r["hierarchical"] == lay.hierarchical == (plan == "hierarchical") for r in got)
    want_metrics = m.get_metrics()
    pool = m.get_weights("embedding_collection")["pool"]
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-6)
        assert r["metrics"]["accuracy"] == want_metrics["accuracy"]
        assert r["metrics"]["samples"] == GRAFT["batch_size"] * STEPS
        for t, name in enumerate(sorted(r["tables"], key=lambda n: int(n.split("_")[1]))):
            _close(r["tables"][name], lay.extract_table(pool, t), 1e-4, 1e-5)
        for name, sub in r["dense"].items():
            for k, w in sub.items():
                _close(w, m.get_weights(name)[k], 1e-4, 1e-5)
        _close(r["pool"], pool, 1e-4, 1e-5)


@pytest.mark.parametrize("plan", list(PLANS))
def test_hybrid_dlrm_predict_matches_jax(workers, trained, plan):
    """`predict` of 70 examples (two full chunks of 32, a ragged one) on
    the trained models: every rank returns all of them."""
    m, _, _, feeds = trained[plan]
    sample = {k: v[:70] for k, v in feeds.items()}
    want = m.predict(sample)
    got = workers.run("result = models[args['name']].predict(args['feeds'])", {"name": plan, "feeds": sample})
    for y in got:
        assert y.shape == want.shape == (70, 1)
        _close(y, want, 1e-5, 1e-6)


def test_replicated_parameters_equal_on_every_rank(workers):
    """After `compile` every rank holds the same replicated parameters
    (drawn from one seed in one order) and its own pool shard."""
    got = workers.run("""
        import hashlib
        model = dlrm(args, ("SGDOptimizer", {"lr": 0.1}), {})
        coll = model._op("embedding_collection")
        result = {(n, k): hashlib.sha256(v.numpy().tobytes()).hexdigest()
                  for n, sub in model.get_parameters().items() for k, v in sub.items()}
        result["shard"] = coll.shard
    """, {**GRAFT, "embedding_size": [64, 20, 48, 96, 300, 40, 56, 128, 72, 500]})
    keys = [k for k in got[0] if k != "shard" and k[0] != "embedding_collection"]
    assert len(keys) >= 6
    for r in got[1:]:
        assert all(r[k] == got[0][k] for k in keys)
    assert len({r[("embedding_collection", "pool")] for r in got}) == N
    assert [r["shard"] for r in got] == list(range(N))


def test_mesh_refusals(workers):
    """Under a data axis of 4, int8 serving of the sharded collection
    raises ValueError, as in the JAX package."""
    got = workers.run("""
        model = dlrm(args, ("SGDOptimizer", {"lr": 0.1}), {})
        try:
            model.quantize_embeddings("int8")
            result = None
        except ValueError as e:
            result = f"ValueError: {e}"
    """, GRAFT)
    for r in got:
        assert r == got[0]
    assert got[0].startswith("ValueError") and "sharded" in got[0]


# ------------------------------------------------------------------ sparse tables outside the collection


def _jax_dlrm(kw, opt, plan, jmesh, **ffkw):
    cfg = ref_dlrm.DLRMConfig(**kw)
    m = ref_dlrm.make_dlrm_model(cfg, ref.FFConfig(**{**dict(batch_size=kw["batch_size"], compute_dtype="float32",
                                                             onehot_embedding_threshold=0), **ffkw}))
    m.compile(getattr(ref, opt[0])(**opt[1]), ref.LossType.LOSS_BINARY_CROSSENTROPY,
              [ref.MetricsType.METRICS_ACCURACY], mesh=jmesh,
              plan=ref_data_parallel_plan() if plan == "dp" else ref_hybrid_plan())
    return m


def _batches(kw, steps, seed):
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**kw), kw["batch_size"] * steps, seed=seed)
    bs = kw["batch_size"]
    return [({k: v[i * bs:(i + 1) * bs] for k, v in feeds.items()}, labels[i * bs:(i + 1) * bs])
            for i in range(steps)]


# name -> (config, plan, optimizer, FFConfig keywords)
UNFUSED = dict(GRAFT, embedding_size=[64, 200, 48], mlp_top=[32, 16, 1])
DP_SGD, DP_ADAM = ("SGDOptimizer", {"lr": 0.1}), OPT
REPLICATED = {
    "hybrid-lone-table": (UNFUSED, "hybrid", DP_ADAM, {"onehot_embedding_threshold": 100}),
    "dp-sgd-scatter": (GRAFT, "dp", DP_SGD, {}),
    "dp-adam-scatter": (GRAFT, "dp", DP_ADAM, {}),
    "dp-sgd-kernel": (GRAFT, "dp", DP_SGD, {"packed_tables": "on"}),
    "dp-adam-kernel": (GRAFT, "dp", DP_ADAM, {"packed_tables": "on"}),
}


@pytest.fixture(scope="module")
def jax_replicated(jmesh):
    """{(config, plan, optimizer, the one-hot threshold): (the JAX model's
    initial weights, its 3 steps' losses, its weights after)} on the
    4-device mesh; the JAX package scatters on both of the port's routes."""
    out = {}

    def get(case):
        kw, plan, opt, ffkw = REPLICATED[case]
        thr = ffkw.get("onehot_embedding_threshold", 0)
        key = (tuple(kw["embedding_size"]), plan, opt[0], thr)
        if key not in out:
            m = _jax_dlrm(kw, opt, plan, jmesh, onehot_embedding_threshold=thr)
            w0 = {op: m.get_weights(op) for op in m.get_parameters()}
            losses = [float(m.train_batch(f, lbl)) for f, lbl in _batches(kw, STEPS, seed=11)]
            out[key] = (w0, losses, {op: m.get_weights(op) for op in m.get_parameters()})
        return out[key]
    return get


@pytest.mark.parametrize("case", list(REPLICATED))
def test_replicated_sparse_tables_train_like_jax(workers, jax_replicated, case):
    """Sparse tables outside a fused collection under a data axis of 4,
    against the JAX package's 4-device run (GSPMD: every table updated by
    the global batch's gradient) and the port's one-device model, all from
    the same weights, 3 steps at a global batch of 32: the hybrid plan with
    a lone sparse table (vocab 200 above the one-hot threshold 100, the
    others one-hot: no collection), and `data_parallel_plan()` (every table
    replicated) on the graft DLRM under SGD and Adam, on the scatter route
    and on the kernel route (packed_tables="on"; the row-update kernel's
    plain version here). Every rank gathers the global stream and applies
    it, so the ranks' replicas and states are equal bit for bit (one
    digest), and every rank's losses are the JAX package's and one
    device's within rtol 1e-5, atol 1e-6. The weights within the file's
    DLRM bound (rtol 1e-4, atol 1e-5; f32 on both sides, other summation
    orders): on the scatter route against the JAX package's; on the kernel
    route against one device's kernel route, since the JAX package
    scatters under a mesh (its kernel route needs mesh None), so there the
    port rounds each stream entry to bf16 where the JAX package adds f32
    (the kernel route's own tests hold it against the JAX package's packed
    kernel)."""
    kw, plan, opt, ffkw = REPLICATED[case]
    w0, losses, w1 = jax_replicated(case)
    got = workers.run("""
        models = [build(args["kw"], args["opt"], args["plan"], mesh=mesh_, **args["ffkw"]) for mesh_ in (mesh, None)]
        out = []
        for m in models:
            m.set_parameters(params_from_jax(args["w0"], like=m.get_parameters()))
            losses = [float(m.train_batch(f, l)) for f, l in args["batches"]]
            out.append({"losses": losses, "digest": replica_digest(m),
                        "kernel_route": [op.kernel_route for op in m._sparse_ops],
                        "sparse": sorted(op.name for op in m._sparse_ops),
                        "coll": m._op("embedding_collection") is not None,
                        "weights": {n: m.get_weights(n) for n in m.get_parameters()}})
        result = out
    """, {"kw": kw, "opt": opt, "plan": plan, "ffkw": ffkw, "w0": w0, "batches": _batches(kw, STEPS, seed=11)})
    assert len({r[0]["digest"] for r in got}) == 1
    r, one = got[0]
    kernel = ffkw.get("packed_tables") == "on"
    assert not r["coll"] and r["kernel_route"] == [kernel] * len(r["kernel_route"]) == one["kernel_route"]
    assert r["sparse"] == (["table_1"] if plan == "hybrid" else [f"table_{t}" for t in range(10)])
    np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5, atol=1e-6)
    # the kernel route against one card's kernel route; the scatter route
    # against the JAX package's
    want = one["weights"] if kernel else w1
    for name, sub in r["weights"].items():
        for k, w in sub.items():
            _close(w, want[name][k], 1e-4, 1e-5)


def test_host_routing_under_the_mesh_matches_device_sorted_steps(workers):
    """Under config.host_routing the routes of a replicated table on the
    kernel route are `compute_routes` of the global batch's feeds, given to
    every rank (the gathered stream is in their order; `_route:` keys are
    no graph input and are not sliced): 3 steps under data_parallel_plan()
    and Adam, with the routes given in the feeds and computed inside, equal
    bit for bit on every rank to steps that sort on the device."""
    got = workers.run("""
        sorted_, inside, given = (build(args["kw"], args["opt"], "dp", packed_tables="on", host_routing=h)
                                  for h in (False, True, True))
        losses = [[float(m.train_batch(f, l)) for f, l in args["batches"]] for m in (sorted_, inside)]
        losses.append([float(given.train_batch({**f, **given.compute_routes(f)}, l)) for f, l in args["batches"]])
        result = {"losses": losses, "inside": sorted(state_diff(sorted_, inside)),
                  "given": sorted(state_diff(sorted_, given)), "digest": replica_digest(given),
                  "route_keys": sorted(given.compute_routes(args["batches"][0][0]))}
    """, {"kw": GRAFT, "opt": DP_ADAM, "batches": _batches(GRAFT, STEPS, seed=12)})
    assert len({r["digest"] for r in got}) == 1
    for r in got:
        assert r["losses"][0] == r["losses"][1] == r["losses"][2] and not r["inside"] and not r["given"], r
        assert len(r["route_keys"]) == 2 * len(GRAFT["embedding_size"])


def test_train_chunk_with_replicated_tables_under_the_mesh(workers, jax_replicated):
    """`train_chunk` of K = 3 on the global [3, B, ...] stacks under
    data_parallel_plan() (every table replicated, SGD on the kernel route).
    On the CPU a chunk is a loop of the eager steps, so it is bit for bit 3
    `train_batch` calls from the same weights, and so is `fit(
    steps_per_call=2)`; the ranks' replicas are equal bit for bit, and every
    loss is the JAX package's 4-device run's within rtol 1e-5, atol 1e-6.
    (The captured step's two all-gathers are held on four cards by
    tools/mesh_smoke.py `[mesh-dp]`.)"""
    w0, jlosses, _ = jax_replicated("dp-sgd-kernel")
    batches = _batches(GRAFT, STEPS, seed=11)
    stacks = {k: np.stack([f[k] for f, _ in batches]) for k in batches[0][0]}
    labels = np.stack([lbl for _, lbl in batches])
    got = workers.run("""
        eager, chunk, fitted = (build(args["kw"], args["opt"], "dp", packed_tables="on") for _ in range(3))
        for m in (eager, chunk, fitted):
            m.set_parameters(params_from_jax(args["w0"], like=m.get_parameters()))
        losses = [float(eager.train_batch({k: v[i] for k, v in args["stacks"].items()}, args["labels"][i]))
                  for i in range(3)]
        last = float(chunk.train_chunk(args["stacks"], args["labels"]))
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in args["stacks"].items()}
        fitted.fit(flat, args["labels"].reshape(-1, 1), epochs=1, steps_per_call=2, verbose=False)
        result = {"losses": losses, "last": last, "chunk": sorted(state_diff(eager, chunk)),
                  "fit": sorted(state_diff(eager, fitted)), "digest": replica_digest(chunk),
                  "steps": [m._step_count for m in (eager, chunk, fitted)]}
    """, {"kw": GRAFT, "opt": DP_SGD, "w0": w0, "stacks": stacks, "labels": labels})
    assert len({r["digest"] for r in got}) == 1
    for r in got:
        assert not r["chunk"] and not r["fit"] and r["steps"] == [STEPS] * 3 and r["last"] == r["losses"][-1]
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ host-tail offload under the mesh

HT_VOCABS, HT_HOT, HT_STEPS, HT_OPT = [50, 200, 120], 40, 5, ("SGDOptimizer", {"lr": 0.05})
# tests/test_host_tail.py::_cfg at batch 16 (4 a rank)
HOST_TAIL = dict(sparse_feature_size=8, embedding_size=HT_VOCABS, embedding_bag_size=2, mlp_bot=[4, 16, 8],
                 mlp_top=[32, 16, 1], batch_size=16)


def _ht_ffkw(cap):
    return dict(host_tail_threshold=HT_HOT, host_tail_cap_frac=cap, fuse_embeddings=False)


@pytest.mark.parametrize("cap", [1.0, 0.25])
def test_host_tail_under_the_mesh_matches_jax_and_one_device(workers, jmesh, cap):
    """tests/test_host_tail.py::test_host_tail_composes_with_8device_mesh on
    a data axis of 4 (vocabs [50, 200, 120], hot 40, a global batch of 16,
    5 SGD steps, every table with a tail and none fused): every rank runs
    the global batch's host half on its replica stores and stages its block
    of the partials, and g_val comes from the gathered global gradient. At
    cap 1.0 nothing drops; at cap 0.25 (K_cap 8 of about 25 tail lookups a
    batch) the drop counters equal the JAX package's. The losses of every
    rank are the JAX package's 4-device run's and the port's one-device
    run's within rtol 1e-5, atol 1e-6, as are the hot prefixes, the towers
    and every store row (the same rows touched) against one device's;
    every rank's replicas, stores included, are equal bit for bit."""
    jm = _jax_dlrm(HOST_TAIL, HT_OPT, "hybrid", jmesh, **_ht_ffkw(cap))
    from dlrm_flexflow_tpu.ops.embedding import Embedding as RefEmbedding

    for t, op in enumerate(o for o in jm.graph.compute_ops if isinstance(o, RefEmbedding)):
        full = np.random.RandomState(100 + t).randn(HT_VOCABS[t], 8).astype(np.float32) * 0.05
        jm.set_weights(op.name, {"weight": full[:op.num_entries]})
        jm._host_tail.entries[op.name][0].load_state(np.arange(HT_HOT, HT_VOCABS[t]), full[HT_HOT:])
    dense = {op: jm.get_weights(op) for op in jm.get_parameters() if not op.startswith("table_")}
    batches = _batches(HOST_TAIL, HT_STEPS, seed=3)
    jlosses = [float(jm.train_batch(f, lbl)) for f, lbl in batches]
    got = workers.run("""
        out = []
        for mesh_ in (mesh, None):
            m = build(args["kw"], args["opt"], "hybrid", mesh=mesh_, **args["ffkw"])
            m.set_parameters(params_from_jax({**args["dense"], **{n: m.get_weights(n) for n in m.get_parameters()
                                                                 if n.startswith("table_")}},
                                             like=m.get_parameters()))
            preseed_tails(m, args["kw"]["embedding_size"], args["hot"], 8)
            losses = [float(m.train_batch(f, l)) for f, l in args["batches"]]
            out.append({"losses": losses, "digest": replica_digest(m), "dropped": m.host_tail_dropped,
                        "total": m._host_tail.total, "tails": sorted(m._host_tail.entries),
                        "weights": {n: m.get_weights(n) for n in m.get_parameters()},
                        "stores": {n: e[0].state() for n, e in m._host_tail.entries.items()}})
        result = out
    """, {"kw": HOST_TAIL, "opt": HT_OPT, "ffkw": _ht_ffkw(cap), "dense": dense, "batches": batches,
          "hot": HT_HOT})
    assert len({r[0]["digest"] for r in got}) == 1
    r, one = got[0]
    assert r["tails"] == ["table_0", "table_1", "table_2"]
    assert (r["dropped"], r["total"]) == (one["dropped"], one["total"]) == (jm.host_tail_dropped, jm._host_tail.total)
    assert (r["dropped"] == 0) == (cap == 1.0)
    np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5, atol=1e-6)
    for name, sub in r["weights"].items():
        for k, w in sub.items():
            np.testing.assert_allclose(w, one["weights"][name][k], rtol=1e-5, atol=1e-6)
    for name, (rows, vals, _) in r["stores"].items():
        np.testing.assert_array_equal(rows, one["stores"][name][0])
        np.testing.assert_allclose(vals, one["stores"][name][1], rtol=1e-5, atol=1e-6)


def test_host_tail_checkpoint_under_the_mesh(workers, tmp_path):
    """A host-tail model under a data axis of 4 after 2 steps: save (rank 0
    writes, with `host_tail.npz` from its replica stores), restore into
    another model on every rank: the state and every store bit for
    bit, the next step's loss within rtol 1e-5, atol 1e-6 (tests/
    test_host_tail.py's round trip). The restored model has the saved one's
    seed (a store's untouched rows are drawn from it) and has taken a step
    of its own on another batch. `train_chunk` refuses a host-tail model
    under the mesh as on one device."""
    got = workers.run("""
        from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
        first, second = (build(args["kw"], args["opt"], "hybrid", **args["ffkw"]) for _ in range(2))
        for f, l in args["batches"][:2]:
            first.train_batch(f, l)
        save_checkpoint(args["path"], first)
        second.train_batch(*args["batches"][3])
        before = replica_digest(second) != replica_digest(first)
        manifest = restore_checkpoint(args["path"], second)
        same = replica_digest(second) == replica_digest(first) and not state_diff(first, second)
        l1, l2 = (float(m.train_batch(*args["batches"][2])) for m in (first, second))
        try:
            first.train_chunk({k: v[None] for k, v in args["batches"][3][0].items()}, args["batches"][3][1][None])
            refused = None
        except RuntimeError as e:
            refused = str(e)
        import os
        result = {"before": before, "same": same, "l1": l1, "l2": l2, "step": manifest["step"],
                  "host_tail": manifest["host_tail"], "refused": refused,
                  "files": sorted(os.listdir(args["path"])),
                  "touched": first._host_tail.entries["table_1"][0].touched_rows}
    """, {"kw": HOST_TAIL, "opt": HT_OPT, "ffkw": _ht_ffkw(1.0), "batches": _batches(HOST_TAIL, 4, seed=5),
          "path": str(tmp_path / "ck")})
    for r in got:
        assert r["before"] and r["same"] and r["step"] == 2 and r["host_tail"] and r["touched"] > 0
        assert "host_tail.npz" in r["files"] and "train_chunk" in r["refused"]
        np.testing.assert_allclose(r["l2"], r["l1"], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ the multi-step call under the mesh



def test_train_chunk_under_the_mesh_matches_train_batch_and_jax(workers, jmesh):
    """`train_chunk` of K = 3 on the global [3, B, ...] stacks under the
    4-rank mesh (each rank slices axis 1, as the JAX package shards them
    P(None, batch)). On the CPU a chunk is a loop of the eager steps, so
    its losses, tables and optimizer pools are bit for bit those of 3
    `train_batch` calls from the same weights, and so is `fit(
    steps_per_call=2)` over the same 3 batches (a chunk of 2, then one of
    1). Against the JAX package's mesh `train_chunk` (one scanned call)
    from those weights: the last loss, the fused tables and the towers
    within the bounds of test_hybrid_dlrm_trains_like_jax (f32 on both
    sides, other summation orders)."""
    cfg = ref_dlrm.DLRMConfig(**GRAFT)
    bs = GRAFT["batch_size"]
    feeds, labels = ref_synthetic.random_batches(cfg, bs * STEPS, seed=3)
    m = ref_dlrm.make_dlrm_model(cfg, ref.FFConfig(batch_size=bs, compute_dtype="float32",
                                                   onehot_embedding_threshold=0))
    m.compile(getattr(ref, OPT[0])(**OPT[1]), ref.LossType.LOSS_BINARY_CROSSENTROPY,
              [ref.MetricsType.METRICS_ACCURACY], mesh=jmesh, plan=ref_hybrid_plan())
    weights = {op: m.get_weights(op) for op in m.get_parameters()}
    stacks = {k: v.reshape((STEPS, bs) + v.shape[1:]) for k, v in feeds.items()}
    slabels = labels.reshape((STEPS, bs) + labels.shape[1:])
    jloss = float(m.train_chunk(stacks, slabels))
    got = workers.run("""
        models = []
        for _ in range(3):
            model = dlrm(args["cfg"], args["opt"], {})
            model.set_parameters(params_from_jax(args["weights"], like=model.get_parameters(), shard=rank))
            models.append(model)
        eager, chunk, fitted = models
        losses = [float(eager.train_batch({k: v[i] for k, v in args["stacks"].items()}, args["labels"][i]))
                  for i in range(len(args["labels"]))]
        last = float(chunk.train_chunk(args["stacks"], args["labels"]))
        fitted.fit(args["feeds"], args["flat_labels"], epochs=1, steps_per_call=2, verbose=False)
        coll = chunk._op("embedding_collection")
        result = {"losses": losses, "last": last, "chunk_equal": not state_diff(eager, chunk),
                  "fit_equal": not state_diff(eager, fitted),
                  "steps": [x._step_count for x in models],
                  "tables": {n: chunk.get_weights(n)["weight"] for n in coll.table_names},
                  "dense": {n: chunk.get_weights(n) for n in chunk.get_parameters() if n != coll.name}}
    """, {"cfg": GRAFT, "opt": OPT, "weights": weights, "stacks": stacks, "labels": slabels,
          "feeds": feeds, "flat_labels": labels})
    lay = m._embedding_layout
    pool = m.get_weights("embedding_collection")["pool"]
    for r in got:
        assert r["chunk_equal"] and r["fit_equal"] and r["steps"] == [STEPS] * 3
        assert r["last"] == r["losses"][-1] == got[0]["last"]
        np.testing.assert_allclose(r["last"], jloss, rtol=1e-5, atol=1e-6)
        for t, name in enumerate(sorted(r["tables"], key=lambda n: int(n.split("_")[1]))):
            _close(r["tables"][name], lay.extract_table(pool, t), 1e-4, 1e-5)
        for name, sub in r["dense"].items():
            for k, w in sub.items():
                _close(w, m.get_weights(name)[k], 1e-4, 1e-5)


# ------------------------------------------------------------------ the routed exchange

ROUTED_VOCABS = [300, 1000, 50, 120, 700, 90]
# name -> (split, H, cap_factor, hash_rows, ids); B = 64 global (16 a rank)
ROUTED = {
    "exact": (None, 2, 0.0, False, "uniform"),
    "exact-splits-oov": ([2, 4, 1, 1, 3, 1], 2, 0.0, False, "oov"),
    "exact-hashed-splits": ([2, 4, 1, 1, 3, 1], 1, 0.0, True, "uniform"),
    "cap2-splits-skew": ([2, 4, 1, 1, 3, 1], 2, 2.0, False, "skew"),
    "cap2-hashed-splits-zipf": ([2, 4, 1, 1, 3, 1], 1, 2.0, True, "zipf"),
}


def _routed_layout(split, cap, hashed, packed=False):
    plan = ref_hybrid_plan()
    plan.table_split, plan.exchange, plan.routed_cap_factor, plan.hash_rows = split, "routed", cap, hashed
    lay = plan.make_layout(ROUTED_VOCABS, 8, N)
    if packed:  # small chunks keep r_pad (and the interpreted kernel) small
        lay = ref_ec.ShardedEmbeddingLayout(ROUTED_VOCABS, 8, N, lay.owner, split=split, exchange="routed",
                                            routed_cap_factor=cap, hash_rows=hashed, packed_pool=True,
                                            pool_chunk_packs=16)
    assert lay.exchange == "routed" and lay.hash_rows == hashed
    return lay


def _routed_indices(h, ids, seed, b=64):
    rng = np.random.default_rng(seed)
    cols = []
    for v in ROUTED_VOCABS:
        if ids == "skew":  # the first quarter of the rows: more unique rows than a split slot holds
            x = rng.integers(0, v // 4, size=(b, h))
        elif ids == "zipf":
            x = np.minimum(rng.zipf(1.05, size=(b, h)) - 1, v - 1)
        else:
            x = rng.integers(0, v, size=(b, h))
        if ids == "oov":  # past the vocab and below -1: both drop, as in the dense exchange
            r = rng.random((b, h))
            x = np.where(r > 0.85, x + v, np.where(r < 0.05, -2, x))
        x[rng.random((b, h)) < 0.1] = -1
        cols.append(x)
    idx = np.stack(cols, axis=1).astype(np.int32)
    idx[20:24] = idx[16:20]  # whole examples repeated inside one rank's slice
    return idx


def _routed_args(lay):
    return dict(_layout_args(lay), exchange="routed", routed_cap_factor=lay.routed_cap_factor,
                hash_rows=lay.hash_rows)


@pytest.mark.parametrize("case", list(ROUTED))
def test_routed_lookup_matches_jax_and_the_dense_exchange(workers, jmesh, case):
    """`routed_embedding_lookup` on 4 ranks against the JAX package's at
    the same cap factor: the same entries drop (an entry's output is its
    row or nothing, so a different drop would miss by a whole row), the
    rest within the bag sum's other order (rtol 1e-5, atol 1e-6). In exact
    mode (cap 0) it equals the port's dense exchange bit for bit: both
    gather the same f32 rows and add a bag's two members once."""
    split, h, cap, hashed, ids = ROUTED[case]
    lay = _routed_layout(split, cap, hashed)
    pool = np.asarray(lay.init_params(jax.random.PRNGKey(4), RefGlorot()))
    idx = _routed_indices(h, ids, seed=len(case))
    lookup = jax.jit(lambda p, i: ref_rx.routed_embedding_lookup(lay, p, i, jmesh, cap_factor=cap))
    want = np.asarray(lookup(jnp.asarray(pool), jnp.asarray(idx)))
    got = workers.run("""
        from dlrm_flexflow_tpu_torch.parallel import routed_exchange as prx
        lay = pec.ShardedEmbeddingLayout(**args["layout"])
        p, i = torch.from_numpy(args["pool"][rank]), torch.from_numpy(local(args["idx"]))
        out = prx.routed_embedding_lookup(lay, p, i, mesh, cap_factor=args["cap"])
        dense = pec.sharded_embedding_lookup(lay, p, i, mesh)
        result = (out.numpy(), bool(torch.equal(out, dense)))
    """, {"layout": _routed_args(lay), "pool": pool, "idx": idx, "cap": cap})
    _close(np.concatenate([o for o, _ in got]), want, 1e-5, 1e-6)
    if cap == 0.0:
        assert all(eq for _, eq in got)
    if ids == "skew":
        assert ref_rx.routed_drop_stats(lay, idx, cap_factor=cap)[0] > 0  # the case drops lookups


# name -> (optimizer, kwargs, ROUTED case, the kernel route)
ROUTED_UPDATES = {
    "sgd-scatter-cap2-skew": ("SGDOptimizer", dict(lr=0.1), "cap2-splits-skew", False),
    "sgd-kernel-exact-oov": ("SGDOptimizer", dict(lr=0.1), "exact-splits-oov", True),
    "adagrad-kernel-cap2-zipf": ("RowWiseAdagradOptimizer", dict(lr=0.1), "cap2-hashed-splits-zipf", True),
}


@pytest.mark.parametrize("case", list(ROUTED_UPDATES))
def test_routed_update_matches_jax_and_the_dense_exchange(workers, jmesh, case):
    """`routed_embedding_sparse_update` on 4 ranks against the JAX
    package's, the slot state carried over two steps: on the scatter route
    and on the kernel route (the JAX package's packed pool, its kernel
    interpreted; the port's row-update kernel's plain version). A rank's
    duplicate rows' gradients are summed before the exchange: by a
    cumulative-sum difference in the JAX package, by a segmented scan in
    the port. Both sum a table's M = B_loc * H <= 32 entries a rank in f32,
    within 2 M 2^-24 sum|g| (about 2.4e-5 for 32 N(0, 1) gradients) of each
    other before the rate (0.1) scales them, so on the scatter route the
    pools agree within rtol 1e-5 and atol 1e-5. The kernel route rounds
    each (pre-summed) stream entry -lr * g to bf16, so where the two f32
    sums straddle a bf16 rounding boundary the results part by one bf16
    step of that entry: within 2^-8 lr sum|g| over the row's entries, a
    step; the pools are held within that bound, summed over the steps,
    and almost all entries (99.9%) within rtol 1e-5, atol 1e-5 (AdaGrad's
    reciprocal square roots add an ulp: rtol 1e-4, as its dense-exchange
    case holds it). The same bound holds the exact mode's update against
    the port's dense exchange, which rounds each duplicate's entry to bf16
    apart and sums them at the owner (there every row a rank repeats
    differs, so no share within rtol is asked)."""
    name, kw, rcase, packed = ROUTED_UPDATES[case]
    split, h, cap, hashed, ids = ROUTED[rcase]
    rtol, atol = (1e-4, 1e-5) if name == "RowWiseAdagradOptimizer" else (1e-5, 1e-5)
    lay = _routed_layout(split, cap, hashed, packed=packed)
    opt = getattr(ref, name)(**kw)
    pool = lay.init_params(jax.random.PRNGKey(5), RefGlorot())
    st = RefCollection.sparse_state_init(types.SimpleNamespace(layout=lay), opt)
    rng = np.random.default_rng(6)
    steps = [(_routed_indices(h, ids, seed=20 + i), rng.standard_normal((64, len(ROUTED_VOCABS), 8))
              .astype(np.float32)) for i in range(2)]
    pool0 = np.asarray(pool).reshape(N, lay.r_pad, 8)
    update = jax.jit(lambda p, s, i, g: ref_rx.routed_embedding_sparse_update(lay, p, s, i, g, jmesh, opt,
                                                                              cap_factor=cap))
    for idx, g in steps:
        pool, st = update(pool, st, jnp.asarray(idx), jnp.asarray(g))
    got = workers.run("""
        from dlrm_flexflow_tpu_torch.parallel import routed_exchange as prx
        lay = pec.ShardedEmbeddingLayout(**args["layout"])
        opt = getattr(port, args["opt"])(**args["kw"])
        pools, states = [], []
        for routed in (True, False):
            pool = torch.from_numpy(args["pool"][rank].copy())
            st = opt.sparse_init((lay.r_pad, lay.dim), "cpu")
            for idx, g in args["steps"]:
                i, gg = torch.from_numpy(local(idx)), torch.from_numpy(local(g))
                if routed:
                    st = prx.routed_embedding_sparse_update(lay, pool, st, i, gg, mesh, opt, cap_factor=args["cap"])
                else:
                    st = pec.sharded_embedding_sparse_update(lay, pool, st, i, gg, mesh, opt)
            pools.append(pool.numpy())
            states.append(state_np(st))
        result = (pools, states)
    """, {"layout": _routed_args(lay), "opt": name, "kw": kw, "pool": pool0, "steps": steps, "cap": cap})
    want = np.asarray(pool).reshape(N, lay.r_pad, 8)
    routed = np.stack([p[0] for p, _ in got])
    assert not np.array_equal(want, pool0)
    # a step's largest sum |g| over one row's entries (every rank's)
    row_abs = 0.0
    for idx, g in steps:
        for t, v in enumerate(ROUTED_VOCABS):
            for r in np.unique(idx[:, t][(idx[:, t] >= 0) & (idx[:, t] < v)]):
                hits = (idx[:, t] == r).sum(axis=1)
                row_abs = max(row_abs, float((hits[:, None] * np.abs(g[:, t])).sum(axis=0).max()))
    bound = len(steps) * 2.0**-8 * kw["lr"] * row_abs + atol

    def held(a, b, share):
        if not packed:
            return _close(a, b, rtol, atol)
        err = np.abs(a - b)
        assert err.max() <= bound and np.mean(err <= rtol * np.abs(b) + atol) >= share, (err.max(), bound)

    held(routed, want, 0.999)
    if st is not None:
        _close(np.stack([s[0] for _, s in got]), _ref_state(st, lay, name == "RowWiseAdagradOptimizer"), rtol, atol)
    if cap == 0.0:  # each duplicate rounded apart: no share holds, the bound does
        held(routed, np.stack([p[1] for p, _ in got]), 0.0)


def test_routed_dlrm_trains_like_jax(workers, jmesh):
    """3 Adam steps of the graft DLRM with plan.exchange="routed" at cap
    2.0 with splits (hash_rows on by default there): the port's losses,
    tables and towers against the JAX package's as the dense exchange's
    are held (test_hybrid_dlrm_trains_like_jax), the per-batch
    `routed_drop_fraction` equal to the JAX package's, and the step's
    exchange bytes (`step_exchange_bytes`) too."""
    cfg = ref_dlrm.DLRMConfig(**GRAFT)
    bs = GRAFT["batch_size"]
    feeds, labels = ref_synthetic.random_batches(cfg, bs * STEPS, seed=8)
    plan_kw = {"exchange": "routed", "routed_cap_factor": 2.0, "table_split": [1, 2, 1, 1, 4, 1, 1, 2, 1, 4]}
    m = ref_dlrm.make_dlrm_model(cfg, ref.FFConfig(batch_size=bs, compute_dtype="float32",
                                                   onehot_embedding_threshold=0))
    plan = ref_hybrid_plan()
    for k, v in plan_kw.items():
        setattr(plan, k, v)
    m.compile(getattr(ref, OPT[0])(**OPT[1]), ref.LossType.LOSS_BINARY_CROSSENTROPY,
              [ref.MetricsType.METRICS_ACCURACY], mesh=jmesh, plan=plan)
    assert m._embedding_layout.hash_rows
    weights = {op: m.get_weights(op) for op in m.get_parameters()}
    batches = [({k: v[i * bs:(i + 1) * bs] for k, v in feeds.items()}, labels[i * bs:(i + 1) * bs])
               for i in range(STEPS)]
    drops = [m.routed_drop_fraction(f) for f, _ in batches]
    losses = [float(m.train_batch(f, lbl)) for f, lbl in batches]
    got = workers.run("""
        model = dlrm(args["cfg"], args["opt"], args["plan"])
        model.set_parameters(params_from_jax(args["weights"], like=model.get_parameters(), shard=rank))
        coll = model._op("embedding_collection")
        drops = [model.routed_drop_fraction(f) for f, _ in args["batches"]]
        losses = [float(model.train_batch(f, l)) for f, l in args["batches"]]
        result = {"drops": drops, "losses": losses, "layout": (coll.layout.exchange, coll.layout.hash_rows),
                  "bytes": coll.layout.step_exchange_bytes(64, 2, 2),
                  "tables": {n: model.get_weights(n)["weight"] for n in coll.table_names},
                  "dense": {n: model.get_weights(n) for n in model.get_parameters() if n != coll.name}}
    """, {"cfg": GRAFT, "opt": OPT, "plan": plan_kw, "weights": weights, "batches": batches})
    lay = m._embedding_layout
    pool = m.get_weights("embedding_collection")["pool"]
    for r in got:
        assert r["layout"] == ("routed", True) and r["drops"] == drops
        assert r["bytes"] == lay.step_exchange_bytes(64, 2, 2)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-6)
        for t, name in enumerate(sorted(r["tables"], key=lambda n: int(n.split("_")[1]))):
            _close(r["tables"][name], lay.extract_table(pool, t), 1e-4, 1e-5)
        for name, sub in r["dense"].items():
            for k, w in sub.items():
                _close(w, m.get_weights(name)[k], 1e-4, 1e-5)


# ------------------------------------------------------------------ sharded checkpoints


@pytest.mark.parametrize("opt", [("SGDOptimizer", {"lr": 0.1}), ("AdamOptimizer", {"alpha": 0.01})])
def test_sharded_checkpoint_roundtrip(workers, tmp_path, opt):
    """tests/test_sharding.py::test_sharded_checkpoint_roundtrip on 4 ranks:
    a model sharded over the mesh is saved after a step (the shards of the
    pool and of its sparse optimizer state gathered to rank 0, stacked
    [N, ...]), restored into a model built from another seed, and its next
    step's loss equals the saved model's within the reference test's
    rtol 1e-5, atol 1e-6; every rank then holds the saved model's state
    bit for bit."""
    got = workers.run("""
        import json
        from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
        cfg = pdlrm.DLRMConfig(**args["cfg"])
        def build(seed):
            m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=cfg.batch_size, compute_dtype="float32",
                                                         onehot_embedding_threshold=0, seed=seed), device="cpu")
            m.compile(getattr(port, args["opt"][0])(**args["opt"][1]), port.LossType.LOSS_BINARY_CROSSENTROPY,
                      [port.MetricsType.METRICS_ACCURACY], mesh=mesh, plan=dlrm_hybrid_plan())
            return m
        feeds, labels = args["batch"]
        m1 = build(5)
        m1.train_batch(feeds, labels)
        save_checkpoint(args["path"], m1)
        m2 = build(6)
        before = not state_diff(m1, m2)
        manifest = restore_checkpoint(args["path"], m2)
        restored = not state_diff(m1, m2)
        with np.load(args["path"] + "/params.npz") as z:
            pool_shape = z["embedding_collection/pool"].shape
        l1, l2 = float(m1.train_batch(feeds, labels)), float(m2.train_batch(feeds, labels))
        coll = m1._op("embedding_collection")
        from dlrm_flexflow_tpu_torch.training.checkpoint import _gather_shards
        shard = (torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7 + rank).to(torch.bfloat16)
        gathered = _gather_shards(shard, rank, world)  # a bf16 pool's shards, as f16 bits on the wire
        bf16_gather = (gathered is None if rank else
                       gathered.dtype == torch.bfloat16 and torch.equal(
                           gathered, torch.stack([(torch.arange(6.0).reshape(2, 3) / 7 + r).to(torch.bfloat16)
                                                  for r in range(world)])))
        result = {"before": before, "restored": restored, "l1": l1, "l2": l2, "step": manifest["step"],
                  "bf16_gather": bf16_gather,
                  "pool_shape": pool_shape, "want_shape": (world, coll.layout.r_pad, coll.layout.dim),
                  "after": not state_diff(m1, m2)}
    """, {"cfg": GRAFT, "opt": opt, "path": str(tmp_path / "ck"),
          "batch": ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**GRAFT), GRAFT["batch_size"], seed=6)})
    for r in got:
        assert not r["before"] and r["restored"] and r["after"] and r["step"] == 1 and r["bf16_gather"]
        assert tuple(r["pool_shape"]) == r["want_shape"]
        np.testing.assert_allclose(r["l2"], r["l1"], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ the 2-D data x model mesh

# tests/test_sharding.py::test_parameter_parallel_matches_single_device's
# model: bot_mlp_0 (4 -> 64) and top_mlp_0 (32 -> 64) column-parallel
TPM = dict(sparse_feature_size=8, embedding_size=[64, 96, 300], embedding_bag_size=2, mlp_bot=[4, 64, 8],
           mlp_top=[32, 64, 1], batch_size=16)
TP_OPTS = {"sgd": ("SGDOptimizer", {"lr": 0.05}), "adam": ("AdamOptimizer", {"alpha": 0.01})}
TP_OPS = ["bot_mlp_0", "top_mlp_0"]
TP_LOSS = dict(rtol=2e-4, atol=2e-5)  # tests/test_sharding.py:220


@pytest.fixture(scope="module")
def jmesh22():
    return ref_make_mesh((2, 2), ("data", "model"), jax.devices()[:N])


def _jax_tp(opt, jmesh):
    ffc = ref.FFConfig(batch_size=TPM["batch_size"], compute_dtype="float32", seed=11, onehot_embedding_threshold=0)
    ffc.enable_parameter_parallel = True
    m = ref_dlrm.make_dlrm_model(ref_dlrm.DLRMConfig(**TPM), ffc)
    m.compile(getattr(ref, opt[0])(**opt[1]), ref.LossType.LOSS_BINARY_CROSSENTROPY,
              [ref.MetricsType.METRICS_ACCURACY], mesh=jmesh, plan=ref_hybrid_plan())
    return m


@pytest.mark.parametrize("opt", list(TP_OPTS))
def test_two_d_mesh_trains_like_jax(workers, jmesh22, opt):
    """The port's (2, 2) mesh under enable_parameter_parallel against the
    JAX package's, from the JAX model's weights (`params_from_jax(...,
    shard=data index, model=model index, column_parallel=)`: the
    column-parallel kernels and biases cut to each rank's row block): 3 steps' losses within the
    reference test's bound, the weights (whole) and, under Adam, the
    column-parallel layers' m and v (each rank's row block, shard-sized)
    within the module's weight bound; the collection has 2 shards, one a
    data index; `predict` of 40 examples against the JAX model's."""
    m = _jax_tp(TP_OPTS[opt], jmesh22)
    assert sorted(m.plan.op_specs) == TP_OPS
    weights = {op: m.get_weights(op) for op in m.get_parameters()}
    batches = _batches(TPM, STEPS, seed=5)
    feeds = {k: np.concatenate([f[k] for f, _ in batches])[:40] for k in batches[0][0]}
    got = workers.run("""
        mesh2 = mesh_of((2, 2))
        model = tp_dlrm(args["cfg"], args["opt"], mesh2)
        model.set_parameters(params_from_jax(args["weights"], like=model.get_parameters(), shard=mesh2.data_index,
                                             model=mesh2.model_index, column_parallel=model._model_parallel))
        losses = [float(model.train_batch(f, l)) for f, l in args["batches"]]
        coll = model._op("embedding_collection")
        st = model._opt_state["dense"]
        result = {"losses": losses, "metrics": model.get_metrics(), "shards": coll.layout.num_shards,
                  "shard": coll.shard, "index": (mesh2.data_index, mesh2.model_index),
                  "tp": sorted(model._model_parallel), "weights": whole_weights(model),
                  "pool": model.get_weights(coll.name)["pool"],
                  "blocks": {n: {k: tuple(model.get_parameters()[n][k].shape) for k in keys}
                             for n, keys in model._model_parallel.items()},
                  "moments": {n: {k: [st[s][n][k].numpy().copy() for s in ("m", "v")] for k in keys}
                              for n, keys in model._model_parallel.items()} if "m" in st else None,
                  "predict": model.predict(args["feeds"])}
    """, {"cfg": TPM, "opt": TP_OPTS[opt], "weights": weights, "batches": batches, "feeds": feeds})
    losses = [float(m.train_batch(f, lbl)) for f, lbl in batches]
    lay = m._embedding_layout
    pool = m.get_weights("embedding_collection")["pool"]
    want_predict = m.predict(feeds)
    assert [r["index"] for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in got:
        assert r["shards"] == lay.num_shards == 2 and r["shard"] == r["index"][0]
        assert r["tp"] == TP_OPS
        assert r["blocks"] == {"bot_mlp_0": {"kernel": (32, 4), "bias": (32,)},
                               "top_mlp_0": {"kernel": (32, 32), "bias": (32,)}}
        np.testing.assert_allclose(r["losses"], losses, **TP_LOSS)
        assert r["metrics"]["samples"] == TPM["batch_size"] * STEPS
        for name, sub in r["weights"].items():
            for k, w in sub.items():
                want = lay.extract_table(pool, int(name.split("_")[1])) if name.startswith("table_") else \
                    m.get_weights(name)[k]
                assert w.shape == want.shape
                _close(w, want, 1e-4, 1e-5)
        _close(r["pool"], pool, 1e-4, 1e-5)
        if opt == "adam":
            for name, sub in r["moments"].items():
                for k, (mo, ve) in sub.items():
                    rows = slice(r["index"][1] * mo.shape[0], (r["index"][1] + 1) * mo.shape[0])
                    _close(mo, np.asarray(m._opt_state["dense"]["m"][name][k])[rows], 1e-4, 1e-5)
                    _close(ve, np.asarray(m._opt_state["dense"]["v"][name][k])[rows], 1e-4, 1e-5)
        assert r["predict"].shape == (40, 1)
        _close(r["predict"], want_predict, 1e-4, 1e-5)


# name -> (plan, optimizer, FFConfig keywords): the collection's dense and
# routed exchanges, every table replicated (parallel/replicated_tables.py),
# every table with a host tail (hot 40, none fused: replicated hot prefixes,
# `rank_block` by data index). The routed case trains under SGD: its
# duplicate rows' partial sums follow the batch's split over the ranks,
# and Adam moves a weight whose summed gradient is near 0 by up to 3.2
# alpha_t whatever its sign (the module's note), which the (4,) mesh's
# routed and dense exchanges already show against each other (2-3e-4 in a
# loss); under SGD the two meshes agree within an ulp
TWO_D_CASES = {"hybrid": ("hybrid", "adam", {}), "routed": ("routed", "sgd", {}), "dp": ("dp", "adam", {}),
               "host-tail": ("hybrid", "sgd", dict(host_tail_threshold=40, host_tail_cap_frac=1.0))}


@pytest.mark.parametrize("case", list(TWO_D_CASES))
def test_two_d_mesh_matches_the_one_d_mesh(workers, case):
    """tests/test_sharding.py::test_parameter_parallel_matches_single_device
    ported: the port's (2, 2) mesh with enable_parameter_parallel against
    its (4,) mesh from the same seed (every rank draws a column-parallel
    kernel whole, so both start from the same weights, bit for bit): the
    plan's param_specs name "model", 3 steps' losses within the reference's
    bound and the weights within the module's; the invariants: along the
    model axis every tensor of the state but the column-parallel ones
    (the collection shard, the replicated towers and tables, their
    optimizer state, the metrics) equal bit for bit, and along the data
    axis the column-parallel tensors equal bit for bit (a hash each); the
    host-tail stores equal on every rank. Under the hybrid plan (dense or
    routed exchange) the two data indices hold different shards; under
    data_parallel_plan() and host-tail offload every rank holds the same
    replicas. The groups: rank r at data index r // 2, model index r % 2; a
    partition of the data indices taken at each model index
    (`data_subgroup`)."""
    plan, opt, ffkw = TWO_D_CASES[case]
    got = workers.run("""
        one_d = tp_dlrm(args["cfg"], args["opt"], mesh, plan=args["plan"], **args["ffkw"])
        two_d = tp_dlrm(args["cfg"], args["opt"], mesh_of((2, 2)), plan=args["plan"], **args["ffkw"])
        start = whole_weights(one_d), whole_weights(two_d)
        same_start = all(np.array_equal(start[0][n][k], start[1][n][k]) for n in start[0] for k in start[0][n])
        l1 = [float(one_d.train_batch(f, l)) for f, l in args["batches"]]
        l2 = [float(two_d.train_batch(f, l)) for f, l in args["batches"]]
        specs = [s for e in two_d.plan.op_specs.values() for s in (e.param_specs or {}).values()]
        coll = two_d._op("embedding_collection")
        result = {"same_start": same_start, "l1": l1, "l2": l2, "model_in_specs": any("model" in s for s in specs),
                  "w1": whole_weights(one_d), "w2": whole_weights(two_d), "digests": split_digests(two_d),
                  "stores": store_digest(two_d), "sharded": coll is not None and coll.sharded,
                  "tails": sorted(two_d._host_tail.entries) if two_d._host_tail else [],
                  "exchange": None if coll is None else coll.layout.exchange,
                  "one_d_tp": one_d._model_parallel, "eval": two_d.evaluate(args["feeds"], args["labels"]),
                  "eval_1d": one_d.evaluate(args["feeds"], args["labels"]),
                  "groups": [torch.distributed.get_process_group_ranks(g) for g in (
                      mesh_of((2, 2)).data_group(), mesh_of((2, 2)).model_group(),
                      mesh_of((2, 2)).data_subgroup([[0], [1]]))]}
    """, {"cfg": TPM, "opt": TP_OPTS[opt], "plan": plan, "ffkw": ffkw, "batches": _batches(TPM, STEPS, seed=7),
          **dict(zip(("feeds", "labels"), ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**TPM), 32, seed=8)))})
    for rank, r in enumerate(got):
        d, m = divmod(rank, 2)
        assert r["groups"] == [[m, 2 + m], [2 * d, 2 * d + 1], [rank]]
        assert r["same_start"] and r["model_in_specs"] and r["one_d_tp"] == {}
        assert r["sharded"] == (plan != "dp" and case != "host-tail")
        assert r["tails"] == (["table_0", "table_1", "table_2"] if case == "host-tail" else [])
        assert r["exchange"] == {"hybrid": "dense", "routed": "routed"}.get(case)
        assert r["stores"] == got[0]["stores"]
        np.testing.assert_allclose(r["l2"], r["l1"], **TP_LOSS)
        for name, sub in r["w1"].items():
            for k, w in sub.items():
                _close(r["w2"][name][k], w, 1e-4, 1e-5)
        assert r["eval"]["samples"] == r["eval_1d"]["samples"] == 32
        np.testing.assert_allclose(r["eval"]["accuracy"], r["eval_1d"]["accuracy"], atol=1 / 32)
    rest = [r["digests"][0] for r in got]
    tp = [r["digests"][1] for r in got]
    assert rest[0] == rest[1] and rest[2] == rest[3] and (rest[0] != rest[2]) == got[0]["sharded"]
    assert tp[0] == tp[2] and tp[1] == tp[3] and tp[0] != tp[1]


def test_pure_tensor_parallel_matches_one_device(workers):
    """A (1, 4) mesh (data axis 1: the flat collection, no batch split;
    every Dense of 64 outputs in blocks of 16 over 4 ranks) against one
    device's model of the same seed with the flat collection
    (fuse_embeddings): the same start bit for bit, 3 SGD steps' losses
    within the reference's bound, the weights within the module's, every
    rank's `predict` of 40 examples within the weights' bound."""
    got = workers.run("""
        one = tp_dlrm(args["cfg"], args["opt"], None, fuse_embeddings=True)
        pure = tp_dlrm(args["cfg"], args["opt"], mesh_of((1, 4)))
        start = whole_weights(one), whole_weights(pure)
        same_start = all(np.array_equal(start[0][n][k], start[1][n][k]) for n in start[0] for k in start[0][n])
        l1 = [float(one.train_batch(f, l)) for f, l in args["batches"]]
        l2 = [float(pure.train_batch(f, l)) for f, l in args["batches"]]
        result = {"same_start": same_start, "l1": l1, "l2": l2, "w1": whole_weights(one), "w2": whole_weights(pure),
                  "blocks": {n: tuple(pure.get_parameters()[n]["kernel"].shape) for n in pure._model_parallel},
                  "shards": pure._op("embedding_collection").layout.num_shards, "data_mesh": pure._data_mesh,
                  "p1": one.predict(args["feeds"]), "p2": pure.predict(args["feeds"])}
    """, {"cfg": TPM, "opt": TP_OPTS["sgd"], "batches": _batches(TPM, STEPS, seed=9),
          "feeds": ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**TPM), 40, seed=10)[0]})
    for r in got:
        assert r["same_start"] and r["shards"] == 1 and r["data_mesh"] is None
        assert r["blocks"] == {"bot_mlp_0": (16, 4), "top_mlp_0": (16, 32)}
        np.testing.assert_allclose(r["l2"], r["l1"], **TP_LOSS)
        for name, sub in r["w1"].items():
            for k, w in sub.items():
                _close(r["w2"][name][k], w, 1e-4, 1e-5)
        _close(r["p2"], r["p1"], 1e-4, 1e-5)


def test_two_d_mesh_train_chunk_matches_eager_steps(workers):
    """`train_chunk` of K = 3 and `fit(steps_per_call=2)` on the (2, 2)
    mesh from one seed, against 3 `train_batch` calls: every loss and every
    tensor of each rank's state bit for bit (on the CPU a chunk is a loop of
    eager steps; on CUDA one step captured with the model group's gathers
    and all-reduces, which tools/mesh_smoke.py's `2d` phase holds against
    eager steps on four cards)."""
    got = workers.run("""
        models = [tp_dlrm(args["cfg"], args["opt"], mesh_of((2, 2))) for _ in range(3)]
        eager, chunk, fitted = models
        losses = [float(eager.train_batch({k: v[i] for k, v in args["stacks"].items()}, args["labels"][i]))
                  for i in range(len(args["labels"]))]
        last = float(chunk.train_chunk(args["stacks"], args["labels"]))
        fitted.fit(args["feeds"], args["flat_labels"], epochs=1, steps_per_call=2, verbose=False)
        result = {"losses": losses, "last": last, "chunk": state_diff(eager, chunk), "fit": state_diff(eager, fitted),
                  "steps": [x._step_count for x in models]}
    """, _chunk_args(TPM, TP_OPTS["adam"], 11))
    for r in got:
        assert r["chunk"] == {} and r["fit"] == {} and r["steps"] == [STEPS] * 3
        assert r["last"] == r["losses"][-1] == got[0]["last"]


def _chunk_args(kw, opt, seed):
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**kw), kw["batch_size"] * STEPS, seed=seed)
    bs = kw["batch_size"]
    return {"cfg": kw, "opt": opt, "feeds": feeds, "flat_labels": labels,
            "stacks": {k: v.reshape((STEPS, bs) + v.shape[1:]) for k, v in feeds.items()},
            "labels": labels.reshape((STEPS, bs) + labels.shape[1:])}


def test_two_d_mesh_checkpoint_roundtrip(workers, tmp_path):
    """A (2, 2) model under Adam saved after a step: the column-parallel
    kernels, biases and their m and v are written whole in the JAX
    package's shapes ([out, in], [out]), the collection's pool and sparse
    state stacked [2, ...] (2 data indices); restored into a model of
    another seed, every rank's state equals the saved model's bit for bit,
    and so does the next step's loss."""
    got = workers.run("""
        from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
        mesh2 = mesh_of((2, 2))
        feeds, labels = args["batch"]
        m1 = tp_dlrm(args["cfg"], args["opt"], mesh2, seed=5)
        m1.train_batch(feeds, labels)
        save_checkpoint(args["path"], m1)
        m2 = tp_dlrm(args["cfg"], args["opt"], mesh2, seed=6)
        before = bool(state_diff(m1, m2))
        manifest = restore_checkpoint(args["path"], m2)
        restored = state_diff(m1, m2)
        with np.load(args["path"] + "/params.npz") as z, np.load(args["path"] + "/opt_state.npz") as o:
            shapes = {k: z[k].shape for k in z.files if k.split("/")[0] in ("bot_mlp_0", "top_mlp_0", "embedding_collection")}
            shapes.update({k: o[k].shape for k in o.files if "bot_mlp_0" in k})
        l1, l2 = float(m1.train_batch(feeds, labels)), float(m2.train_batch(feeds, labels))
        result = {"before": before, "restored": restored, "after": state_diff(m1, m2), "l1": l1, "l2": l2,
                  "step": manifest["step"], "shapes": shapes}
    """, {"cfg": TPM, "opt": TP_OPTS["adam"], "path": str(tmp_path / "ck"),
          "batch": ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**TPM), TPM["batch_size"], seed=12)})
    for r in got:
        assert r["before"] and r["restored"] == {} and r["after"] == {} and r["step"] == 1
        assert r["l2"] == r["l1"]
        assert r["shapes"]["bot_mlp_0/kernel"] == (64, 4) and r["shapes"]["top_mlp_0/kernel"] == (64, 32)
        assert r["shapes"]["bot_mlp_0/bias"] == r["shapes"]["top_mlp_0/bias"] == (64,)
        assert r["shapes"]["dense/m/bot_mlp_0/kernel"] == r["shapes"]["dense/v/bot_mlp_0/kernel"] == (64, 4)
        assert r["shapes"]["embedding_collection/pool"][0] == 2


def test_four_by_one_mesh_is_the_one_d_mesh(workers):
    """A (4, 1) mesh (model axis 1, enable_parameter_parallel on: the plan
    gets its specs, nothing runs column-parallel) is the (4,) mesh: 3 Adam
    steps' losses and every tensor of each rank's state bit for bit."""
    got = workers.run("""
        a = tp_dlrm(args["cfg"], args["opt"], mesh)
        b = tp_dlrm(args["cfg"], args["opt"], mesh_of((4, 1)))
        la = [float(a.train_batch(f, l)) for f, l in args["batches"]]
        lb = [float(b.train_batch(f, l)) for f, l in args["batches"]]
        result = {"la": la, "lb": lb, "diff": state_diff(a, b), "tp": b._model_parallel,
                  "specs": sorted(b.plan.op_specs), "groups": mesh_of((4, 1)).data_group()}
    """, {"cfg": TPM, "opt": TP_OPTS["adam"], "batches": _batches(TPM, STEPS, seed=13)})
    for r in got:
        assert r["la"] == r["lb"] and r["diff"] == {} and r["tp"] == {} and r["groups"] is None
        assert r["specs"] == TP_OPS


_EIGHT = """
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
from dlrm_flexflow_tpu_torch.launch import initialize
from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan
initialize("cpu")
meshes = {"1d": make_mesh(device="cpu"), "2d": make_mesh((4, 2), ("data", "model"), device="cpu")}
cfg = pdlrm.DLRMConfig(**json.loads(sys.argv[1]))
feeds, labels = random_batches(cfg, cfg.batch_size, seed=5)
out = {}
for case, cph in (("flat", 0), ("hierarchical", 4)):
    for key, mesh in meshes.items():
        m = pdlrm.make_dlrm_model(cfg, port.FFConfig(
            batch_size=cfg.batch_size, compute_dtype="float32", seed=11, onehot_embedding_threshold=0,
            enable_parameter_parallel=True, chips_per_host=cph), device="cpu")
        m.compile(port.SGDOptimizer(lr=0.05), port.LossType.LOSS_BINARY_CROSSENTROPY,
                  [port.MetricsType.METRICS_ACCURACY], mesh=mesh, plan=dlrm_hybrid_plan())
        lay = m._embedding_layout
        out[case + "/" + key] = {"losses": [float(m.train_batch(feeds, labels)) for _ in range(3)],
                                 "shards": lay.num_shards, "hosts": lay.num_hosts if lay.hierarchical else 0,
                                 "tp": sorted(m._model_parallel)}
with open(f"out{dist.get_rank()}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def test_the_reference_eight_device_case_on_eight_ranks(tmp_path):
    """tests/test_sharding.py::test_parameter_parallel_matches_single_device
    at its own mesh shapes, on 8 gloo ranks under the launcher: the (4, 2)
    mesh with enable_parameter_parallel against the (8,) mesh, the same
    plan and seed, 3 SGD steps on one batch within the reference's bound;
    flat, and with FFConfig(chips_per_host=4), which the model axis cuts
    to 2 cards a host along the data axis (the JAX package's
    `core/ffmodel.py:626-634`): the (4, 2) collection's hierarchical
    exchange then runs 2 hosts of 2 shards over each model index's data
    ranks (`Mesh.data_subgroup`), the (8,) one 2 hosts of 4."""
    (tmp_path / "job.py").write_text(_EIGHT)
    res = _launch(["--nproc-per-node", "8", "job.py", json.dumps(TPM)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(8)]
    for r in got:
        assert r == got[0]
        for case in ("flat", "hierarchical"):
            one, two = r[f"{case}/1d"], r[f"{case}/2d"]
            assert (one["shards"], two["shards"]) == (8, 4) and one["tp"] == [] and two["tp"] == TP_OPS
            assert (one["hosts"], two["hosts"]) == ((0, 0) if case == "flat" else (2, 2))
            np.testing.assert_allclose(two["losses"], one["losses"], **TP_LOSS)


def test_strategy_files_with_model_specs_load_in_either_package(tmp_path):
    """`enable_parameter_parallel` writes the same specs in both packages on
    one model, and a plan holding them, saved by either, loads in the other
    with its specs and mesh axes."""
    from dlrm_flexflow_tpu.parallel import plan as ref_plan

    from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
    from dlrm_flexflow_tpu_torch.parallel import plan as port_plan

    ref_model = ref_dlrm.make_dlrm_model(ref_dlrm.DLRMConfig(**{**TPM, "mlp_top": [32, 64, 64, 1]}),
                                         ref.FFConfig(batch_size=16))
    port_model = pdlrm.make_dlrm_model(pdlrm.DLRMConfig(**{**TPM, "mlp_top": [32, 64, 64, 1]}),
                                       __import__("dlrm_flexflow_tpu_torch").FFConfig(batch_size=16), device="cpu")
    jp = ref_plan.enable_parameter_parallel(ref_plan.dlrm_hybrid_plan(), ref_model.graph, only=["top_mlp_1",
                                                                                             "bot_mlp_0"])
    pp = port_plan.enable_parameter_parallel(port_plan.dlrm_hybrid_plan(), port_model.graph,
                                             only=["top_mlp_1", "bot_mlp_0"])
    assert {k: v.to_json() for k, v in jp.op_specs.items()} == {k: v.to_json() for k, v in pp.op_specs.items()}
    assert sorted(pp.op_specs) == ["bot_mlp_0", "top_mlp_1"] and pp.mesh_axes == jp.mesh_axes == ("data", "model")
    assert port_plan.tensor_parallel_ops(pp, port_model.graph, ("data", "model")) == {
        "bot_mlp_0": ("kernel", "bias"), "top_mlp_1": ("kernel", "bias")}
    jp.save(str(tmp_path / "jax.json"))
    pp.save(str(tmp_path / "port.json"))
    into_port = port_plan.ShardingPlan.load(str(tmp_path / "jax.json"))
    into_jax = ref_plan.ShardingPlan.load(str(tmp_path / "port.json"))
    assert {k: v.to_json() for k, v in into_port.op_specs.items()} == {k: v.to_json() for k, v in jp.op_specs.items()}
    assert into_jax.op_specs["bot_mlp_0"].param_specs == jp.op_specs["bot_mlp_0"].param_specs
    assert into_jax.op_specs["top_mlp_1"].output_specs == jp.op_specs["top_mlp_1"].output_specs
    assert into_port.mesh_axes == into_jax.mesh_axes == ("data", "model")
    with pytest.raises(NotImplementedError, match="column-parallel"):
        bad = port_plan.dlrm_hybrid_plan()
        bad.op_specs["bot_mlp_0"] = port_plan.OpShardSpec(param_specs={"kernel": [None, "model"]})
        port_plan.tensor_parallel_ops(bad, port_model.graph, ("data", "model"))


# ------------------------------------------------------------------ a data axis of 1, in this process


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.launch import initialize
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    initialize("cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _port_model(mesh=None, plan_kw=None, **ffkw):
    import dlrm_flexflow_tpu_torch as port
    from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
    from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan

    cfg = pdlrm.DLRMConfig(**GRAFT)
    m = pdlrm.make_dlrm_model(cfg, port.FFConfig(batch_size=GRAFT["batch_size"], compute_dtype="float32",
                                                 onehot_embedding_threshold=0, seed=5, **ffkw), device="cpu")
    plan = dlrm_hybrid_plan()
    for k, v in (plan_kw or {}).items():
        setattr(plan, k, v)
    m.compile(port.AdamOptimizer(alpha=0.01), port.LossType.LOSS_BINARY_CROSSENTROPY,
              [port.MetricsType.METRICS_ACCURACY], mesh=mesh, plan=plan if mesh is not None else None)
    return m


def test_data_axis_of_one_is_the_flat_collection_off_the_kernel_route(world_of_one):
    """At a data axis of 1 the collection is the flat one and stays off
    the kernel route even under packed_tables="on" (the JAX package would
    set its packed pool and then assert in its flat fallback, ROADMAP.md
    Queue 3): it trains as FFConfig(fuse_embeddings=True) does without a
    mesh, bit for bit."""
    mesh_model = _port_model(world_of_one, packed_tables="on")
    coll = mesh_model._op("embedding_collection")
    assert mesh_model.plan.packed_pool is False and not coll.layout.packed_pool
    assert coll.shard is None and coll.layout.num_shards == 1 and mesh_model._data_mesh is None
    fused = _port_model(None, packed_tables="on", fuse_embeddings=True)
    assert not fused._op("embedding_collection").layout.packed_pool
    cfg = ref_dlrm.DLRMConfig(**GRAFT)
    feeds, labels = ref_synthetic.random_batches(cfg, 64, seed=4)
    for name in fused.get_parameters():
        np.testing.assert_array_equal(mesh_model.get_weights(name)[next(iter(fused.get_weights(name)))],
                                      fused.get_weights(name)[next(iter(fused.get_weights(name)))])
    for i in range(2):
        b = {k: v[i * 32:(i + 1) * 32] for k, v in feeds.items()}
        assert float(mesh_model.train_batch(b, labels[i * 32:(i + 1) * 32])) == float(
            fused.train_batch(b, labels[i * 32:(i + 1) * 32]))
    np.testing.assert_array_equal(mesh_model.predict(feeds), fused.predict(feeds))


@pytest.mark.parametrize("what", ["search", "param-specs", "parameter-parallel"])
def test_mesh_compile_refuses_later_slices(world_of_one, what):
    """The strategy search is a later slice (item 10). On a 1-D mesh a spec
    naming the "model" axis it lacks raises ValueError, and
    enable_parameter_parallel does nothing, as in the JAX package (no
    "model" axis: no specs, the model trains as without it)."""
    from dlrm_flexflow_tpu_torch.parallel.plan import OpShardSpec

    if what == "search":
        with pytest.raises(NotImplementedError, match="item 10"):
            _port_model(world_of_one, {}, search_budget=10)
    elif what == "param-specs":
        with pytest.raises(ValueError, match="lacks"):
            _port_model(world_of_one, {"op_specs": {"bot_mlp_0": OpShardSpec(param_specs={"kernel": ["model", None]})}})
    else:
        epp = _port_model(world_of_one, {}, enable_parameter_parallel=True)
        plain = _port_model(world_of_one, {})
        assert epp.plan.op_specs == {} and epp._model_parallel == {}
        feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**GRAFT), 32, seed=4)
        assert float(epp.train_batch(feeds, labels)) == float(plain.train_batch(feeds, labels))


INT8 = dict(sparse_feature_size=16, embedding_size=[500, 300, 800], embedding_bag_size=2, mlp_bot=[4, 16, 16],
            mlp_top=[64, 16, 1], batch_size=64)


def _int8_port_model(mesh=None):
    import dlrm_flexflow_tpu_torch as port
    from dlrm_flexflow_tpu_torch.models import dlrm as pdlrm
    from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan

    m = pdlrm.make_dlrm_model(pdlrm.DLRMConfig(**INT8), port.FFConfig(
        batch_size=64, compute_dtype="float32", onehot_embedding_threshold=0, fuse_embeddings=mesh is None),
        device="cpu")
    m.compile(port.SGDOptimizer(lr=0.1), port.LossType.LOSS_BINARY_CROSSENTROPY,
              [port.MetricsType.METRICS_ACCURACY], mesh=mesh, plan=dlrm_hybrid_plan() if mesh is not None else None)
    return m


def test_int8_serving_of_a_fused_collection_matches_jax():
    """tests/test_training.py::test_quantize_embeddings_int8_fused_collection
    against the port: the flat [N * R_pad, D] pool of a fused collection on
    one device quantizes to `pool_q` and `pool_scale` (one array), equal
    to the JAX package's bit for bit (f32 pool, the scale computed in f32
    on both sides); the int8 forward is within the JAX test's atol 0.08 of
    the f32 one and within rtol 1e-5, atol 1e-6 of the JAX package's int8
    forward (the same dequantized rows, other f32 summation orders); the
    quantized model refuses to train."""
    cfg = ref_dlrm.DLRMConfig(**INT8)
    jm = ref_dlrm.make_dlrm_model(cfg, ref.FFConfig(batch_size=64, compute_dtype="float32",
                                                    onehot_embedding_threshold=0, fuse_embeddings=True))
    jm.compile(ref.SGDOptimizer(lr=0.1), ref.LossType.LOSS_BINARY_CROSSENTROPY, [ref.MetricsType.METRICS_ACCURACY])
    m = _int8_port_model()
    from dlrm_flexflow_tpu_torch.convert import params_from_jax

    m.set_parameters(params_from_jax({op: jm.get_weights(op) for op in jm.get_parameters()},
                                     like=m.get_parameters()))
    feeds, labels = ref_synthetic.random_batches(cfg, 64, seed=6)
    y32 = m.predict(feeds)
    assert jm.quantize_embeddings("int8") == m.quantize_embeddings("int8") == 1
    sub, jsub = m.get_parameters()["embedding_collection"], jm._params["embedding_collection"]
    assert set(sub) == {"pool_q", "pool_scale"}
    np.testing.assert_array_equal(sub["pool_q"].numpy(), np.asarray(jsub["pool_q"]))
    np.testing.assert_array_equal(sub["pool_scale"].numpy(), np.asarray(jsub["pool_scale"]))
    y8 = m.predict(feeds)
    np.testing.assert_allclose(y8, y32, atol=0.08)
    np.testing.assert_allclose(y8, np.asarray(jm.predict(feeds)), rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="quantized"):
        m.train_batch(feeds, labels)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_serving_of_a_fused_collection_matches_jax(dtype):
    """quantize_embeddings("bfloat16"/"float16") of a fused collection on
    one device casts its f32 pool, as the JAX package does: the cast pools
    are equal bit for bit (both round to nearest even) and the forwards
    within rtol 1e-5, atol 1e-6 of each other (the same 16-bit rows, other
    f32 summation orders); the quantized model refuses to train."""
    cfg = ref_dlrm.DLRMConfig(**INT8)
    jm = ref_dlrm.make_dlrm_model(cfg, ref.FFConfig(batch_size=64, compute_dtype="float32",
                                                    onehot_embedding_threshold=0, fuse_embeddings=True))
    jm.compile(ref.SGDOptimizer(lr=0.1), ref.LossType.LOSS_BINARY_CROSSENTROPY, [ref.MetricsType.METRICS_ACCURACY])
    m = _int8_port_model()
    from dlrm_flexflow_tpu_torch.convert import params_from_jax

    m.set_parameters(params_from_jax({op: jm.get_weights(op) for op in jm.get_parameters()},
                                     like=m.get_parameters()))
    feeds, labels = ref_synthetic.random_batches(cfg, 64, seed=6)
    assert m.quantize_embeddings(dtype) == jm.quantize_embeddings(dtype) >= 1
    pool, jpool = m.get_parameters()["embedding_collection"]["pool"], jm._params["embedding_collection"]["pool"]
    assert str(pool.dtype) == f"torch.{dtype}" and str(jpool.dtype) == dtype
    np.testing.assert_array_equal(pool.float().numpy(), np.asarray(jpool.astype(jnp.float32)).reshape(pool.shape))
    np.testing.assert_allclose(m.predict(feeds), np.asarray(jm.predict(feeds)), rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="quantized"):
        m.train_batch(feeds, labels)


def test_int8_serving_at_a_data_axis_of_one(world_of_one):
    """compile(mesh=) in a world of one makes the same flat collection:
    its int8 forward equals the one-device fused model's bit for bit."""
    a, b = _int8_port_model(world_of_one), _int8_port_model()
    b.set_parameters({name: a.get_weights(name) for name in a.get_parameters()})
    assert a.quantize_embeddings("int8") == b.quantize_embeddings("int8") == 1
    feeds, _ = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**INT8), 100, seed=7)
    np.testing.assert_array_equal(a.predict(feeds), b.predict(feeds))


def test_routed_plan_at_a_data_axis_of_one_is_the_flat_collection(world_of_one):
    """exchange="routed" in a world of one compiles to the flat collection
    (no exchange), as the dense plan does: the two train bit for bit."""
    routed = _port_model(world_of_one, {"exchange": "routed", "routed_cap_factor": 2.0})
    dense = _port_model(world_of_one)
    assert routed._embedding_layout.exchange == "routed" and routed._data_mesh is None
    feeds, labels = ref_synthetic.random_batches(ref_dlrm.DLRMConfig(**GRAFT), 64, seed=4)
    for i in range(2):
        b = {k: v[i * 32:(i + 1) * 32] for k, v in feeds.items()}
        assert float(routed.train_batch(b, labels[i * 32:(i + 1) * 32])) == float(
            dense.train_batch(b, labels[i * 32:(i + 1) * 32]))


# ------------------------------------------------------------------ the launcher and the bench


def _launch(args, cwd, **env_kw):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore", **env_kw)
    return subprocess.run([sys.executable, "-m", "dlrm_flexflow_tpu_torch.launch", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


_SCRIPT = """
import os, sys
import torch
import torch.distributed as dist
from dlrm_flexflow_tpu_torch.launch import initialize
if os.environ["RANK"] == os.environ.get("FAIL_RANK"):
    sys.exit(3)
initialize("cpu")
r = dist.get_rank()
x = torch.tensor([float(r + 1)])
dist.all_reduce(x)
with open(f"out{r}.txt", "w") as f:
    f.write(f"rank {r} of {dist.get_world_size()} local {os.environ['LOCAL_RANK']} sum {x.item()} "
            f"args {sys.argv[1:]}")
dist.destroy_process_group()
"""


def test_launcher_runs_every_rank(tmp_path):
    (tmp_path / "job.py").write_text(_SCRIPT)
    res = _launch(["--nproc-per-node", "3", "job.py", "--flag", "x"], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert [(tmp_path / f"out{r}.txt").read_text() for r in range(3)] == [
        f"rank {r} of 3 local {r} sum 6.0 args ['--flag', 'x']" for r in range(3)]


def test_launcher_fails_when_a_rank_fails(tmp_path):
    """Rank 1 exits 3 before it joins the group that rank 0 waits to form:
    the launcher ends rank 0 and exits with 3."""
    (tmp_path / "job.py").write_text(_SCRIPT)
    res = _launch(["--nproc-per-node", "2", "job.py"], tmp_path, FAIL_RANK="1")
    assert res.returncode == 3, (res.returncode, res.stderr[-3000:])
    assert "local rank 1 exited with 3" in res.stderr
    assert not list(tmp_path.glob("out*.txt"))


def test_launcher_port_is_free_on_every_address():
    """The coordinator's port is probed on every local address, where rank
    0's store listens (a port probed on the loopback alone can be held on
    another address; a four-card run once failed so, with EADDRINUSE at
    init_process_group): a port held on another address is never handed
    out while held, and each port handed out binds on the wildcard address.
    The race itself is not reproducible in a test."""
    import socket

    from dlrm_flexflow_tpu_torch.launch import _free_port

    with socket.socket() as held:
        held.bind(("127.0.0.2", 0))
        taken = held.getsockname()[1]
        ports = [_free_port() for _ in range(20)]
        assert taken not in ports
    for port in ports[:3]:
        with socket.socket() as s:
            s.bind(("", port))


def test_launcher_usage(tmp_path):
    for args in ([], ["--nproc-per-node", "x", "a.py"], ["--nodes", "2", "a.py"]):
        res = _launch(args, tmp_path)
        assert res.returncode == 2 and "usage" in res.stderr


def test_bench_mesh_on_two_cpu_ranks(tmp_path):
    """`bench --mesh` under the launcher (tests/test_bench_mesh.py's
    check, at 2 ranks): rank 0 prints one JSON line with the root bench's
    keys, `devices` 2 and a positive all-to-all rate."""
    res = _launch(["--nproc-per-node", "2", "-m", "dlrm_flexflow_tpu_torch.bench", "--mesh", "--device", "cpu",
                   "--config", "tiny", "--batch-size", "64", "--steps", "3", "--warmup", "1"], REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [line for line in res.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, res.stdout
    doc = json.loads(lines[0])
    assert doc["devices"] == 2 and doc["all_to_all_gbps"] > 0, doc
    assert doc["value"] > 0 and doc["examples_per_sec_per_chip"] == doc["value"] / 2
    assert np.isfinite(doc["loss"]) and "steps=eager" in res.stderr


def test_bench_mesh_trains_mlperf_full_under_host_tail_offload(tmp_path):
    """`bench --mesh --config mlperf-full` on 2 CPU ranks at a cut batch
    (64) and hot prefix (16384 rows, where the cards keep 2^20; the one-hot
    threshold at 1000, so that tables of 1543-12973 rows fuse into the
    sharded collection beside the 11 host-tail tables): eager steps on
    every rank, rank 0 prints bench.py's host-tail keys with `devices` 2."""
    res = _launch(["--nproc-per-node", "2", "-m", "dlrm_flexflow_tpu_torch.bench", "--mesh", "--device", "cpu",
                   "--config", "mlperf-full", "--batch-size", "64", "--steps", "2", "--warmup", "1",
                   "--host-tail-threshold", "16384", "--onehot-threshold", "1000"], REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [line for line in res.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, res.stdout
    doc = json.loads(lines[0])
    assert doc["devices"] == 2 and doc["host_tail_tables"] == 11 and doc["host_tail_touched_rows"] > 0, doc
    assert 0.0 <= doc["host_tail_drop_fraction"] < 1.0 and doc["examples_per_sec_per_chip"] == doc["value"] / 2
    assert np.isfinite(doc["loss"]) and "steps=eager" in res.stderr and "mesh=yes" in res.stderr


def test_workers_import_no_jax(workers):
    """Last: after every case, no worker has imported JAX or the JAX
    package."""
    got = workers.run("""
        import sys
        result = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dlrm_flexflow_tpu"))
    """)
    assert got == [[]] * N
