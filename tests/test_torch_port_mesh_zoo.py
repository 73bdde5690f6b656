"""The op library's graphs and expert parallelism on the port's (4,) mesh of
4 gloo processes, against the JAX package on the CPU.

The 4 resident workers of tests/test_torch_port_mesh.py (`Workers`: one
process a rank, torch only, one thread each) are started once for this
module. Every rank is fed the global batch and steps on its block
(`Mesh.batch_slice`); the JAX side runs here on one device, which GSPMD's
global-batch program equals, or, for `expert_parallel_ffn`, on a (4,) CPU
mesh. Weights go to the workers by `convert.params_from_jax`. The cases:
nmt (its two tables replicated on the sparse path, unpooled lookups
gathered over the ranks), moe_mlp under a capacity that drops tokens (each
rank's token slots against the JAX package's global `dispatch_mask`, the
losses, metrics, `eval_batch` and `predict`, a sharded checkpoint), a graph
of Conv2D, BatchNorm, Dropout, Flat, Reshape and a batch-shaped constant
(the forward and every gradient against the JAX package's; Dropout's mask
bit for bit the port's one-card mask; with a Cache in front, serving its
block of the cached batch), the multi-step call, the refusals of what the
port does not compute over the global batch, `--taskgraph`, and
`expert_parallel_ffn` with E = 8 experts over the 4 ranks.

Tolerances. f32 on both sides with the same operations but for summation
orders (BatchNorm's statistics add the blocks' partial sums): the losses
of a step within rtol 1e-5, atol 1e-6 (nmt's within rtol 1e-4 over its
two steps, tests/test_nmt.py's bound for its data-parallel run against one
device); outputs within atol 1e-6 plus 1e-5 of the largest magnitude, as
the op library's tests hold f32 outputs; a gradient read from one SGD step
at lr 1 (w - w') within rtol 1e-4, atol 1e-5 (the subtraction costs an ulp
of the weight). `expert_parallel_ffn` at tests/test_sharding.py's bounds:
the forward within rtol 1e-4, atol 1e-5, w1's gradient within rtol 1e-3,
atol 1e-4.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import dlrm_flexflow_tpu as ref
from dlrm_flexflow_tpu.models import zoo as ref_zoo
from dlrm_flexflow_tpu.ops import moe as ref_moe
from dlrm_flexflow_tpu.parallel import expert_parallel as ref_ep
from dlrm_flexflow_tpu.parallel.mesh import make_mesh as ref_make_mesh

import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.parallel import expert_parallel as port_ep
from test_torch_port_mesh import Workers, _close

N = 4
NMT_SMALL = dict(batch_size=4, src_len=6, dst_len=5, hidden_size=32, embed_size=24, vocab_size=50, num_layers=2)
MOE = dict(batch_size=64, in_dim=32, num_classes=5, alpha=0.5)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# the graph of the BatchNorm case, built by either package (exec'd here and
# on the workers)
_CONV_GRAPH = """
def conv_graph(pkg, rate, cache=False, **device):
    m = pkg.FFModel(pkg.FFConfig(batch_size=8, seed=5, compute_dtype="float32"), **device)
    t = m.create_tensor([8, 3, 6, 6], name="img")
    if cache:
        t = m.cache(t, 2, name="cache")
    t = m.conv2d(t, 4, 3, 3, 1, 1, 1, 1, name="conv")
    t = m.batch_norm(t, name="bn")
    t = m.dropout(t, rate, name="drop")
    t = m.reshape(m.flat(t), (8, 12, 12))
    t = m.add(t, m.create_constant([8, 12, 12], 0.5, name="half"))
    m.dense(m.flat(t), 5, name="out")
    return m
"""
exec(_CONV_GRAPH)

_PRELUDE = _CONV_GRAPH + """
import dataclasses
import numpy as np
import torch
import dlrm_flexflow_tpu_torch as port
from dlrm_flexflow_tpu_torch.convert import params_from_jax
from dlrm_flexflow_tpu_torch.models import zoo
from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
from dlrm_flexflow_tpu_torch.parallel.plan import data_parallel_plan
mesh = make_mesh(device="cpu")

def local(x):
    return x[mesh.batch_slice(x.shape[0])]

def gather(t):
    out = [torch.empty_like(t) for _ in range(world)]
    torch.distributed.all_gather(out, t.contiguous())
    return torch.cat(out).numpy()

# compile under SGD at lr on the 4-rank mesh (data_parallel_plan()), or on
# one device with on_mesh False
def compile_on(m, lr, loss, on_mesh=True, metrics=()):
    m.compile(port.SGDOptimizer(lr=lr), getattr(port.LossType, loss), list(metrics),
              mesh=mesh if on_mesh else None, plan=data_parallel_plan() if on_mesh else None)
    return m

def weights(m):
    return {n: m.get_weights(n) for n in m.get_parameters()}
"""


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    w = Workers(tmp_path_factory.mktemp("mesh_zoo"))
    try:
        w.run(_PRELUDE)
        yield w
    finally:
        w.close()


def _jax_weights(m):
    return {op: {k: np.asarray(v) for k, v in m.get_weights(op).items()} for op in m.get_parameters()}


def _out_close(got, want):
    _close(got, want, 1e-5, 1e-6 + 1e-5 * float(np.abs(want).max()))


# ------------------------------------------------------------------ the zoo

def test_nmt_two_sgd_steps_on_four_ranks_match_jax(workers):
    """nmt at NMT_SMALL (one row a rank), both tables above the one-hot
    threshold: replicated on the sparse path, each step gathering the
    ranks' [B_loc, T] ids and [B_loc, T, D] unpooled gradients
    (parallel/replicated_tables.py). Two SGD steps against the JAX model on
    one device, as tests/test_nmt.py holds its data-parallel run."""
    cfg = dict(batch_size=4, onehot_embedding_threshold=16, compute_dtype="float32")
    r = ref_zoo.nmt(config=ref.FFConfig(**cfg), **NMT_SMALL)
    r.compile(ref.SGDOptimizer(lr=0.3), ref.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(2)
    feeds = {"src_tokens": rng.integers(0, 50, (4, 6)).astype(np.int32),
             "dst_tokens": rng.integers(0, 50, (4, 5)).astype(np.int32)}
    w0 = _jax_weights(r)
    want = [float(r.train_batch(feeds, feeds["dst_tokens"])) for _ in range(2)]
    got = workers.run("""
m = compile_on(zoo.nmt(config=port.FFConfig(**args["cfg"]), device="cpu", **args["shape"]), 0.3,
               "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY")
m.set_parameters(params_from_jax(args["w0"]))
f = args["feeds"]
result = {"sparse": [op.name for op in m._sparse_ops],
          "losses": [float(m.train_batch(f, f["dst_tokens"])) for _ in range(2)]}
""", {"cfg": cfg, "shape": NMT_SMALL, "w0": w0, "feeds": feeds})
    for res in got:
        assert res["sparse"] == ["src_embed", "dst_embed"]
        np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
        assert res["losses"] == got[0]["losses"]


def test_moe_mlp_on_four_ranks_drops_the_one_card_tokens_and_matches_jax(workers, tmp_path):
    """moe_mlp at alpha 0.5 (capacity 16 of the global batch of 64: about
    half the tokens dropped): each rank's token slots, from the global
    arrival order (`dispatch_slots` with the mesh), put together equal the
    JAX package's `dispatch_mask` of the global batch, for the model's own
    top-2 assignment and for a skewed one; then two SGD steps, the
    accuracy, `eval_batch` and `predict` against the JAX model; a
    checkpoint saved on the mesh and restored into a model of another seed
    gives the next step's loss."""
    r = ref_zoo.moe_mlp(config=ref.FFConfig(batch_size=64, compute_dtype="float32"), **MOE)
    r.compile(ref.SGDOptimizer(lr=0.1), ref.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [ref.MetricsType.METRICS_ACCURACY])
    rng = np.random.default_rng(7)
    feeds, labels = {"input": rng.standard_normal((64, 32)).astype(np.float32)}, rng.integers(0, 5, (64, 1))
    skewed = rng.choice(4, size=(64, 2), p=[0.55, 0.25, 0.15, 0.05]).astype(np.int32)
    cap = r.get_layer_by_name("group_by").capacity
    w0 = _jax_weights(r)

    def jax_slots(a):
        mask = np.asarray(ref_moe.dispatch_mask(jnp.asarray(a), 4, cap)).reshape(64, 2, -1)
        return np.where(mask.any(-1), mask.argmax(-1), 4 * cap)

    want_losses = [float(r.train_batch(feeds, labels)) for _ in range(2)]
    want_acc = r.get_metrics()["accuracy"]
    want_eval = float(r.eval_batch(feeds, labels))
    want_pred = np.asarray(r.predict(feeds))
    got = workers.run("""
from dlrm_flexflow_tpu_torch.ops.moe import dispatch_slots
from dlrm_flexflow_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
def moe(seed):
    return compile_on(zoo.moe_mlp(config=port.FFConfig(batch_size=64, seed=seed, compute_dtype="float32"), device="cpu",
                                  **args["moe"]), 0.1,
                      "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", metrics=[port.MetricsType.METRICS_ACCURACY])
m = moe(0)
m.set_parameters(params_from_jax(args["w0"]))
gb = m.get_layer_by_name("group_by")
with torch.no_grad():
    (top,) = m.graph.execute(m.get_parameters(), m._stage(args["feeds"]), m._ctx,
                             fetch=[m.get_layer_by_name("topk").outputs[1]])
slots = [gather(dispatch_slots(a, 4, gb.capacity, m._ctx.block_mesh(gb)))
         for a in (top, torch.as_tensor(local(args["skewed"])))]
result = {"top": gather(top), "slots": slots, "capacity": gb.capacity,
          "losses": [float(m.train_batch(args["feeds"], args["labels"])) for _ in range(2)]}
result["accuracy"] = m.get_metrics()["accuracy"]
result["eval"] = float(m.eval_batch(args["feeds"], args["labels"]))
result["predict"] = m.predict(args["feeds"])
save_checkpoint(args["path"], m)
back = moe(9)
restore_checkpoint(args["path"], back)
result["resumed"] = [float(mm.train_batch(args["feeds"], args["labels"])) for mm in (m, back)]
""", {"moe": MOE, "w0": w0, "feeds": feeds, "labels": labels, "skewed": skewed, "path": str(tmp_path / "ck")})
    top = got[0]["top"]
    for res in got:
        assert res["capacity"] == cap == 16
        np.testing.assert_array_equal(res["top"], top)
        np.testing.assert_array_equal(res["slots"][0], jax_slots(top))
        np.testing.assert_array_equal(res["slots"][1], jax_slots(skewed))
        assert 0.3 < float(np.mean(res["slots"][0] == 4 * cap)) < 0.7
        np.testing.assert_allclose(res["losses"], want_losses, **F32_TOL)
        assert res["accuracy"] == pytest.approx(want_acc)
        np.testing.assert_allclose(res["eval"], want_eval, **F32_TOL)
        _out_close(res["predict"], want_pred)
        assert res["resumed"][0] == res["resumed"][1]


def test_batch_norm_dropout_reshape_constant_graph_on_four_ranks_matches_jax(workers):
    """The graph at dropout rate 0: the forward (BatchNorm on the global
    batch's statistics), the loss and every gradient (one SGD step at lr 1)
    against the JAX package's on one device. At rate 0.3: the Dropout op's
    mask on the 4 ranks' blocks, put together, bit for bit the one-card
    port's, and the training forward and two steps' losses close to one
    card's. With a Cache in front serving a cached batch (after
    `recompile`), each rank serves its block of it."""
    r = conv_graph(ref, 0.0)
    r.compile(ref.SGDOptimizer(lr=1.0), ref.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    rng = np.random.default_rng(11)
    x, x2, y = (rng.standard_normal(s).astype(np.float32) for s in ((8, 3, 6, 6), (8, 3, 6, 6), (8, 5)))
    w0 = _jax_weights(r)
    want_fwd = np.asarray(r.forward({"img": x}))
    want_loss = float(r.train_batch({"img": x}, y))
    w1 = _jax_weights(r)
    got = workers.run("""
def build(rate, on_mesh, cache=False):
    m = compile_on(conv_graph(port, rate, cache, device="cpu"), 1.0, "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE", on_mesh)
    m.set_parameters(params_from_jax(args["w0"]))
    return m
x, x2, y = args["x"], args["x2"], args["y"]
m = build(0.0, True)
result = {"fwd": gather(m.forward({"img": x})),
          "block_inputs": sorted(set(m._ctx.batch_ops) & {iop.name for iop in m.graph.inputs}),
          "half": tuple(m._constants["half"].shape), "loss": float(m.train_batch({"img": x}, y)),
          "w1": weights(m)}
drop, one = build(0.3, True), build(0.3, False)
op = drop.get_layer_by_name("drop")
masks = []
for mm, shape in ((drop, (2, 4, 6, 6)), (one, (8, 4, 6, 6))):
    ctx = dataclasses.replace(mm._ctx, training=True, rng=mm._step_key(None))
    masks.append(op.forward({}, [torch.ones(shape)], ctx)[0] != 0)
result["mask"], result["one_mask"] = gather(masks[0]), masks[1].numpy()
result["train_fwd"] = [gather(drop.forward({"img": x}, training=True)), one.forward({"img": x}, training=True).numpy()]
result["losses"] = [[float(mm.train_batch({"img": x}, y)) for _ in range(2)] for mm in (drop, one)]
served = []
for on_mesh in (True, False):
    c = build(0.0, on_mesh, cache=True)
    c.get_layer_by_name("cache").update_cache(x)
    c.get_layer_by_name("cache").use_cached = True
    c.recompile()
    out = c.forward({"img": x2})
    served.append(gather(out) if on_mesh else out.numpy())
result["served"] = served
""", {"w0": w0, "x": x, "x2": x2, "y": y})
    for res in got:
        assert res["block_inputs"] == ["half", "img"] and res["half"] == (2, 12, 12)
        _out_close(res["fwd"], want_fwd)
        np.testing.assert_allclose(res["loss"], want_loss, **F32_TOL)
        for op in w0:
            for k in w0[op]:
                np.testing.assert_allclose(w0[op][k] - res["w1"][op][k], w0[op][k] - w1[op][k],
                                           err_msg=f"{op}/{k}", **GRAD_TOL)
        np.testing.assert_array_equal(res["mask"], res["one_mask"])
        assert 0.2 < 1.0 - float(res["mask"].mean()) < 0.4
        _out_close(*res["train_fwd"])
        np.testing.assert_allclose(res["losses"][0], res["losses"][1], **F32_TOL)
        _out_close(res["served"][0], res["served"][1])
        _out_close(res["served"][0], want_fwd)


def test_train_chunk_on_four_ranks_equals_train_batch(workers):
    """`train_chunk` of [K, B_global, ...] stacks on the mesh, and
    `fit(steps_per_call=2)` (a chunk of 2, then one of 1), take the steps
    `train_batch` takes, Dropout's step keys included: the losses and every
    weight bit for bit after 3 steps; `evaluate` of fresh models (one
    seed) on the mesh and on one device alike."""
    rng = np.random.default_rng(12)
    xs, ys = rng.standard_normal((3, 8, 3, 6, 6)).astype(np.float32), rng.standard_normal((3, 8, 5)).astype(np.float32)
    got = workers.run("""
def build(on_mesh=True):
    m = conv_graph(port, 0.3, device="cpu")
    m.compile(port.SGDOptimizer(lr=0.01), port.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [port.MetricsType.METRICS_MEAN_SQUARED_ERROR], mesh=mesh if on_mesh else None,
              plan=data_parallel_plan() if on_mesh else None)
    return m
a, b, c = build(), build(), build()
chunk = float(a.train_chunk({"img": args["xs"]}, args["ys"]))
steps = [float(b.train_batch({"img": x}, y)) for x, y in zip(args["xs"], args["ys"])]
c.fit({"img": args["xs"].reshape(24, 3, 6, 6)}, args["ys"].reshape(24, 5), epochs=1, verbose=False, steps_per_call=2)
wa, wb, wc = weights(a), weights(b), weights(c)
evals = [m.evaluate({"img": args["xs"].reshape(24, 3, 6, 6)}, args["ys"].reshape(24, 5))["mse"]
         for m in (build(), build(False))]
result = {"chunk": chunk, "steps": steps, "counts": [a._step_count, b._step_count, c._step_count], "evals": evals,
          "equal": all(np.array_equal(wa[o][k], wb[o][k]) and np.array_equal(wc[o][k], wb[o][k])
                       for o in wa for k in wa[o])}
""", {"xs": xs, "ys": ys})
    for res in got:
        assert res["chunk"] == res["steps"][-1] and res["counts"] == [3, 3, 3] and res["equal"]
        np.testing.assert_allclose(res["evals"][0], res["evals"][1], **F32_TOL)


# ------------------------------------------------------------------ refusals

def _refusal_graph(case: str):
    m = port.FFModel(port.FFConfig(batch_size=8, compute_dtype="float32"), device="cpu")
    x = m.create_tensor([8, 4, 6], name="x")
    if case == "transpose":
        t = m.transpose(x, (1, 0, 2))
    elif case == "reverse":
        t = m.reverse(x, 0)
    elif case == "concat":
        t = m.concat([x, x], 0)
    elif case == "split":
        t = m.split(x, 2, 0)[0]
    elif case == "softmax":
        from dlrm_flexflow_tpu_torch.ops.regularizers import Softmax
        t = m.graph.add_op(Softmax("softmax0", x, axis=0)).outputs[0]
    elif case == "reshape":
        t = m.reshape(x, (6, 4, 8))
    elif case == "between":
        _, idx = m.top_k(m.dense(m.flat(x), 4), 2)
        buckets = m.group_by(m.flat(x), idx, 4, 2.0)
        t = m.aggregate([m.flat(x), idx, idx, m.flat(x)] + [m.transpose(b, (1, 0)) for b in buckets], 4)
    elif case == "mixed":
        w = m.reshape(m.create_constant([2, 16, 6], 1.0, name="w"), (8, 6, 4))
        t = m.batch_matmul(x, w)
    else:  # the output follows no batch
        t = m.create_constant([3, 5], 1.0, name="c")
    m.dense(m.flat(t) if len(t.shape) > 2 else t, 2)
    return m


REFUSALS = {"transpose": "moves the batch axis", "reverse": "reverses the batch axis",
            "concat": "runs along the batch axis", "split": "runs along the batch axis",
            "softmax": "normalises along the batch axis", "reshape": "does not split into 4 blocks",
            "between": "between a GroupBy and its Aggregate", "mixed": "mixes a batch-sharded input with a whole one",
            "output": "output is not batch-sharded"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_mesh_compile_refuses_what_it_does_not_compute_over_the_global_batch(case):
    """Under a data axis of 4 compile raises NotImplementedError, with the
    reason, for each op that would need the global batch the port does not
    compute (parallel/global_batch.py `batch_ops`); the check runs before
    the mesh is read further, so a stand-in mesh of its data size does."""
    m = _refusal_graph(case)
    with pytest.raises(NotImplementedError, match=REFUSALS[case]):
        m.compile(port.SGDOptimizer(lr=0.1), mesh=types.SimpleNamespace(data_size=4), plan=None)


def test_mesh_compile_takes_every_zoo_model():
    """Every zoo model passes the check at a data axis of 4 (at batch 8, 2
    rows a rank, each model's own widths), its output on the batch's
    blocks; moe_mlp's expert layers run on its GroupBy's buffers, off the
    blocks."""
    from dlrm_flexflow_tpu_torch.models import zoo
    from dlrm_flexflow_tpu_torch.parallel.global_batch import batch_ops

    for name in ("mnist_mlp", "mnist_cnn", "cifar10_cnn", "alexnet", "resnet", "inception_v3", "nmt", "moe_mlp",
                 "transformer", "candle_uno", "bert_proxy"):
        m = getattr(zoo, name)(batch_size=8, config=port.FFConfig(batch_size=8), device="cpu")
        ops = batch_ops(m.graph, {}, 8, 4)
        assert m.graph.compute_ops[-1].name in ops, name
        experts = {op.name for op in m.graph.compute_ops if op.name.startswith("expert")}
        assert not ops & experts and (name != "moe_mlp" or len(experts) == 12), name


def test_taskgraph_raises_naming_item_10(tmp_path):
    """config.export_strategy_task_graph_file (--taskgraph): compile writes
    the Graphviz file, byte for byte the JAX package's for the same graph
    (the name is kept from the slice that refused it)."""
    got, want = tmp_path / "port.dot", tmp_path / "jax.dot"
    cfg = port.FFConfig(batch_size=8)
    assert cfg.update_from_args(["--taskgraph", str(got)]) == []
    assert cfg.export_strategy_task_graph_file == str(got)
    m = conv_graph(port, 0.25, device="cpu")
    m.config.export_strategy_task_graph_file = cfg.export_strategy_task_graph_file
    m.compile()
    j = conv_graph(ref, 0.25)
    j.config.export_strategy_task_graph_file = str(want)
    j.compile()
    assert got.read_bytes() == want.read_bytes() and got.read_text().startswith("digraph")


# ------------------------------------------------------------------ expert parallelism

EP = dict(B=64, D=8, H=16, E=8, K=2)


def _ep_inputs():
    rng = np.random.RandomState(0)
    b, d, h, e = EP["B"], EP["D"], EP["H"], EP["E"]
    return (rng.randn(b, d).astype(np.float32), (rng.randn(d, e) * 0.3).astype(np.float32),
            (rng.randn(e, d, h) * 0.2).astype(np.float32), (rng.randn(e, h) * 0.1).astype(np.float32),
            (rng.randn(e, h, d) * 0.2).astype(np.float32), (rng.randn(e, d) * 0.1).astype(np.float32))


def test_moe_gate_matches_jax():
    x, gate_w = _ep_inputs()[:2]
    gv, assign = ref_ep.moe_gate(jnp.asarray(x), jnp.asarray(gate_w), EP["K"])
    pv, pa = port_ep.moe_gate(torch.as_tensor(x), torch.as_tensor(gate_w), EP["K"])
    np.testing.assert_array_equal(pa.numpy(), np.asarray(assign))
    np.testing.assert_allclose(pv.numpy(), np.asarray(gv), **F32_TOL)


def test_expert_parallel_ffn_on_four_ranks_matches_jax(workers):
    """E = 8 experts, 2 a rank: the forward against the JAX package's
    `expert_parallel_ffn` on a (4,) mesh, its `reference_moe_ffn(shards=4)`
    and the port's, and each rank's shard of w1's gradient (of the sum of
    the squared outputs) against the JAX gradient, at tests/test_sharding.py's
    bounds; the per-shard capacity drops tokens on both sides alike."""
    x, gate_w, w1, b1, w2, b2 = _ep_inputs()
    jmesh = ref_make_mesh((N,), ("data",), jax.devices()[:N])
    gv, assign = ref_ep.moe_gate(jnp.asarray(x), jnp.asarray(gate_w), EP["K"])

    def sharded(w1_):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("data", None)))
        return ref_ep.expert_parallel_ffn(xs, gv, assign, w1_, jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
                                          jmesh)

    want = np.asarray(sharded(jnp.asarray(w1)))
    want_ref = np.asarray(ref_ep.reference_moe_ffn(jnp.asarray(x), gv, assign, *map(jnp.asarray, (w1, b1, w2, b2)),
                                                   shards=N))
    want_g = np.asarray(jax.grad(lambda w: jnp.sum(sharded(w) ** 2))(jnp.asarray(w1)))
    got = workers.run("""
from dlrm_flexflow_tpu_torch.parallel.expert_parallel import expert_parallel_ffn, reference_moe_ffn
x, gv, assign, w1, b1, w2, b2 = (torch.as_tensor(a) for a in args["arrays"])
e_loc = w1.shape[0] // world
sh = slice(rank * e_loc, (rank + 1) * e_loc)
w1_loc = w1[sh].clone().requires_grad_(True)
out = expert_parallel_ffn(local(x), local(gv), local(assign), w1_loc, b1[sh], w2[sh], b2[sh], mesh)
(g,) = torch.autograd.grad((out ** 2).sum(), [w1_loc])
result = {"out": gather(out.detach()), "g": gather(g), "ref": reference_moe_ffn(x, gv, assign, w1, b1, w2, b2,
                                                                                 shards=world).numpy()}
""", {"arrays": [x, np.asarray(gv), np.asarray(assign), w1, b1, w2, b2]})
    cap = ref_moe.moe_capacity(EP["K"], EP["E"], EP["B"] // N, 2.0)
    dropped = np.mean([not np.asarray(ref_moe.dispatch_mask(assign[s * 16:(s + 1) * 16], EP["E"], cap))[i, j].any()
                       for s in range(N) for i in range(16) for j in range(EP["K"])])
    assert dropped > 0
    np.testing.assert_allclose(want, want_ref, rtol=1e-4, atol=1e-5)
    for res in got:
        np.testing.assert_allclose(res["out"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["ref"], want_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["g"], want_g, rtol=1e-3, atol=1e-4)
