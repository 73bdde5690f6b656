"""The hybrid-parallel path on several cards, held against one card.

    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m dlrm_flexflow_tpu_torch.tools.mesh_smoke
    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m dlrm_flexflow_tpu_torch.tools.mesh_smoke \\
        --device cpu --batch-size 256 --vocab-cap 20000 --steps 2 --hot 4096   # a rehearsal on gloo, small
    ... -m dlrm_flexflow_tpu_torch.tools.mesh_smoke --phases dp,full     # some of the checks
    ... -m dlrm_flexflow_tpu_torch.tools.mesh_smoke --phases 2d          # the (2, 2) mesh (4 ranks)
    ... -m dlrm_flexflow_tpu_torch.tools.mesh_smoke --phases zoo,ep      # the op library, expert parallelism
    ... --device cpu --phases zoo,ep --zoo-small --zoo-steps 2            # their rehearsal on gloo
    ... -m dlrm_flexflow_tpu_torch.tools.mesh_smoke --phases search      # the strategy search

Every rank of the launcher's world runs it; rank 0 prints one line a
check, with every rank's numbers gathered, and last `{"ok": true, ...}`.
A failed check raises on the rank that finds it, which fails the launcher.
The checks, at kaggle's full width (the 10 tables above 8192 rows fused,
D = 16) and a global batch of `--batch-size` (65536: 16384 a rank on 4):

  [mesh-cards]    each rank's card, power limit and NCCL version;
  [mesh-layout]   owners, t_max, r_pad, pool bytes a card, exchange bytes a
                  step (`step_exchange_bytes`);
  [mesh-exchange] `sharded_embedding_lookup` and
                  `sharded_embedding_sparse_update` (SGD, K1 on each
                  shard's bf16 pool) against one card's flat collection of
                  the same tables (rank 0), flat and hierarchical
                  (chips_per_host 2, the two largest tables split 2 ways):
                  the lookup bit for bit, every table after the update
                  within the row-update kernel's tolerance, the launches a
                  rank;
                  and the routed exchange in exact mode (cap_factor 0)
                  on the flat layout: its lookup bit for bit against the
                  dense one's;
  [mesh-train]    `--steps` kaggle steps (after 2 warm-up steps) under SGD
                  and Adam: the losses of every step against one card's
                  model trained on the same batches from the same weights
                  (rank 0, the single-table row-update route), examples/s
                  global and a card, row-update launches a rank and step,
                  the exchange's GB/s, peak memory a rank, kernel ms and
                  busy share a rank from torch.profiler; then the same as
                  `train_chunk` replays of one captured step a rank (the
                  exchange's all-to-alls and the two all-reduces in it):
                  ms a step, examples/s, busy share a rank, the captured
                  step's K1 and NCCL kernel nodes a rank; then, under
                  deterministic algorithms, 8 eager steps against 2 chunks
                  of 4 on fresh models: every loss and every tensor of
                  each rank's state bit for bit;
  [mesh-routed]   kaggle under exchange="routed" at cap_factor 2.0 with the
                  two largest tables split two ways (hash_rows on) on
                  Zipf(1.05) ids: `routed_drop_fraction` of a batch, the
                  bytes a step (`step_exchange_bytes`, and what the padded
                  buckets carry, `step_bucket_bytes`) against the dense
                  exchange's count, one eager step (one K1 launch
                  at each owner), then `train_chunk` replays (the routed
                  exchange captured): ms a step and K1 nodes a rank;
  [mesh-checkpoint] kaggle at full width under Adam (a bf16 pool on the
                  kernel route, its m and v f32): one step,
                  `save_checkpoint` (the shards gathered to rank 0),
                  `restore_checkpoint` into a model of another seed; the
                  state bit for bit and the next step's loss within rtol
                  1e-5, atol 1e-6 on every rank; the files' bytes, save and
                  restore seconds, each rank's peak host memory and rank
                  0's peak device memory in the save;
  [mesh-mlperf-lite] `predict` of 4 global batches and a ragged one, then 3
                  train steps, K3 (dot_interaction) and K1 launches a rank;
  [mesh-dp]       kaggle under `data_parallel_plan()` (every table
                  replicated; the 10 large ones on K1 with the global
                  batch's stream, parallel/replicated_tables.py), SGD and
                  Adam: eager steps (ms, K1 launches a rank and step, the
                  losses against one card's model trained on the same
                  batches from the same weights), then `train_chunk`
                  replays (ms a step, the captured step's K1 and NCCL
                  kernel nodes, kernel ms against NCCL kernel ms and busy
                  share a rank), replays against eager steps bit for bit,
                  and every rank's replicated state equal bit for bit to
                  rank 0's;
  [mesh-full]     mlperf-full (882,774,559 rows; `--vocab-cap` cuts it in a
                  rehearsal) under `dlrm_hybrid_plan()` and host-tail
                  offload at hot = `--hot` (2^20), Zipf(1.05) ids, SGD and
                  row-wise AdaGrad tables: eager steps (ms a step, the step
                  by phase from the `STEP_PHASES` profiler ranges and
                  kernel ms a rank), touched tail rows, drop fraction and
                  host memory a rank, every rank's store replicas (a hash
                  of each store's state) and replicated state equal, the
                  losses against one card's model (rank 0) trained on the
                  same batches from the same weights and stores;
  [mesh-2d-scatter-order] a scatter-add at a (2, 2) rank's one-hot
                  backward shapes, 5 times by `index_add_` and by
                  `ops.common.index_add_rows`: the distinct results (the
                  second must give one);
  [mesh-2d]       kaggle on the 2-D ("data", "model") mesh of shape (2, 2)
                  under `dlrm_hybrid_plan()` and enable_parameter_parallel
                  (the 512, 256 and 64 wide Dense layers column-parallel
                  over the model axis, parallel/tensor_parallel.py; the
                  collection sharded over the 2 data indices), SGD and
                  Adam: eager steps against the (4,) mesh's model of the
                  same seed and one card's model of the same weights (the
                  losses of every step), the state's digests (each model
                  peer's non-column-parallel state alike, each data peer's
                  column-parallel blocks alike), NCCL kernel ms a step by
                  process group (model, data) from profiled eager steps
                  (every `tensor_parallel:*` range must show device time),
                  then `train_chunk` replays on (2, 2) and on (4,)
                  (ms a step, busy share, kernel nodes) and replays against
                  eager steps bit for bit; the column-parallel layers'
                  collectives timed alone, a layer;
  [mesh-2d-dp]    [mesh-dp] on (2, 2) under enable_parameter_parallel, SGD
                  and Adam: the replicated tables' digests alike on every
                  rank, the column-parallel blocks' on their data peers;
  [mesh-2d-mlperf-lite] mlperf-lite on (2, 2) and on (1, 4) (`predict` of 4
                  global batches and a ragged one, 3 train steps, K3
                  launches a rank, the collectives a layer, the digests as
                  in [mesh-2d]; on (1, 4) the flat collection takes the
                  scatter rule);
  [mesh-zoo]      the op library's graphs under `data_parallel_plan()`,
                  bf16, at 4 x chip_smoke.py's one-card batches (each card
                  runs the batch one card ran): ResNet-50 at a global batch
                  of 256 (224 x 224, SGD), nmt at the reference's widths at
                  256 (SGD; both tables replicated on the scatter rule, the
                  unpooled ids and gradients gathered), moe_mlp at 65536
                  (Adam; the global arrival order by one all-gather of the
                  expert counts): eager steps (ms, busy share, kernel and
                  NCCL kernel ms a rank), every rank's state bit for bit
                  against rank 0's, `train_chunk` replays against eager
                  steps bit for bit, ms a step replayed, the losses of every
                  step against one card's model (rank 0) trained from the
                  same weights on the same global batches within
                  ZOO_MOVE_RTOL of the loss's movement plus LOSS_ATOL,
                  examples/s against one card; moe_mlp's `predict` under
                  use_pallas="on", K6 launches a rank (10 a chunk);
  [mesh-ep]       `expert_parallel_ffn` at moe_mlp's widths (D 784, H 64, top
                  2, alpha 2, 16384 tokens a card) with 4 and 8 experts, f32
                  and bf16: the forward and w1's gradient against
                  `reference_moe_ffn(shards=4)` on rank 0 (`ep_tolerance`),
                  the dropped share, ms of the forward and backward, each
                  all-to-all's ms and GB/s alone;
  [mesh-search]   kaggle under `--search-budget` (config.search_budget):
                  rank 0 calibrates its card into the machine file beside
                  the exported strategy (a temporary directory) and
                  searches, every rank takes the broadcast plan (checked by
                  digest); the searched and the default `dlrm_hybrid_plan()`
                  models from the same weights: 4 eager steps each (every
                  loss within LOSS_ATOL of the default plan's), then 20
                  `train_chunk` replays each, ms a step; each plan's
                  predicted step (the cost model's, times the one-card step
                  residual that rank 0 measures with
                  `calibrate_step_residual`) against its measured ms.

The weights are random, from seeds; the indices uniform, the labels noise
(the zoo's data carries its class: chip_smoke.py's images and clusters,
nmt's copy task).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import AdamOptimizer, FFConfig, LossType, MetricsType, SGDOptimizer
from ..core.graph import InputOp
from ..data.synthetic import random_batches
from ..ffconst import AggrMode
from ..launch import initialize
from ..models.dlrm import kaggle_config, make_dlrm_model, mlperf_config, mlperf_lite_config
from ..ops.common import index_add_rows
from ..ops.embedding import embedding_bag
from ..ops.kernels.dot_interaction import dot_interaction
from ..ops.kernels.row_update import row_update, row_update_adagrad, row_update_adam
from ..parallel import embedding_collection as pec
from ..parallel import routed_exchange as prx
from ..parallel.mesh import make_mesh
from ..parallel.plan import data_parallel_plan, dlrm_hybrid_plan
from .state import state_diff, state_tensors

SEED = 0
WARMUP, PROFILED = 2, 3
DETERMINISTIC_STEPS = 8  # eager steps against chunks of 4
PHASES = ("exchange", "train", "routed", "checkpoint", "mlperf-lite", "dp", "full", "2d", "zoo", "ep", "search")
F32_UNIT, BF16_UNIT = 2.0**-24, 2.0**-8
# one card's step against the mesh's: the same operations but for f32
# summation orders, so a flipped bf16 rounding (of an activation or a
# table entry) moves a value by one bf16 step; bound on each step's loss,
# the chip smoke's CUDA-against-CPU bound
LOSS_ATOL = 2e-3


class Run:
    def __init__(self, args, mesh):
        self.args, self.mesh = args, mesh
        self.device = mesh.device
        self.cuda = self.device.type == "cuda"
        self.out = open(args.out, "w") if args.out and mesh.rank == 0 else None

    def log(self, tag: str, obj) -> None:
        if self.mesh.rank == 0:
            line = f"{tag} {json.dumps(obj)}" if tag else json.dumps(obj)
            print(line, flush=True)
            if self.out:
                self.out.write(line + "\n")
                self.out.flush()

    def gather(self, obj) -> list:
        out = [None] * self.mesh.size
        dist.all_gather_object(out, obj)
        return out

    def sync_device(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def sync(self) -> None:
        self.sync_device()
        dist.barrier()

    def check(self, ok: bool, what: str, res) -> None:
        if not ok:
            raise AssertionError(f"rank {self.mesh.rank}: {what}: {json.dumps(res)}")


def card_line(run: Run) -> dict:
    if not run.cuda:
        return {"rank": run.mesh.rank, "device": "cpu"}
    idx = run.device.index
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return {"rank": run.mesh.rank, "device": str(run.device), "nvidia_smi": smi[idx],
            "name": torch.cuda.get_device_name(run.device),
            "nccl": ".".join(map(str, torch.cuda.nccl.version())), "torch": torch.__version__}


def kaggle_fused(cap: int) -> list:
    return [min(v, cap) for v in kaggle_config().embedding_size if v > 8192]


def make_table_fn(device, d: int, vocabs):
    def make_table(t):
        g = torch.Generator(device=device).manual_seed(SEED + 100 + t)
        return (torch.rand((vocabs[t], d), generator=g, device=device) - 0.5) * 0.02
    return make_table


def exchange_check(run: Run, vocabs, hierarchical: bool) -> dict:
    """One layout's lookup and update against one card's flat collection."""
    mesh, dev, args = run.mesh, run.device, run.args
    n, d, b = mesh.size, 16, args.batch_size
    plan = dlrm_hybrid_plan()
    plan.packed_pool = run.cuda
    if hierarchical:
        big = sorted(range(len(vocabs)), key=lambda t: -vocabs[t])[:2]
        plan.chips_per_host = 2
        plan.table_split = [2 if t in big else 1 for t in range(len(vocabs))]
    lay = plan.make_layout(vocabs, d, n)
    run.check(lay.hierarchical == (hierarchical and n > 2), "layout", {"hierarchical": lay.hierarchical})
    dtype = torch.bfloat16 if run.cuda else torch.float32
    make_table = make_table_fn(dev, d, vocabs)
    pool = lay.init_pool(make_table, mesh.rank, dev, dtype)
    rng = np.random.default_rng(SEED + 7)
    idx = torch.from_numpy(np.stack([rng.integers(0, v, size=(b, 1)) for v in vocabs], 1)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    g = torch.randn((b, len(vocabs), d), generator=gen, device=dev) * 0.01
    sl = mesh.batch_slice(b)
    out = pec.sharded_embedding_lookup(lay, pool, idx[sl], mesh)
    routed_equal = None
    if not hierarchical:
        routed = pec.ShardedEmbeddingLayout(lay.vocab_sizes, d, n, lay.owner, packed_pool=lay.packed_pool,
                                            exchange="routed", routed_cap_factor=0.0)
        routed_equal = run.gather(bool(torch.equal(prx.routed_embedding_lookup(routed, pool, idx[sl], mesh), out)))
    got = torch.empty((b,) + tuple(out.shape[1:]), dtype=out.dtype, device=dev)
    dist.all_gather_into_tensor(got, out.contiguous())
    opt = SGDOptimizer(lr=0.01)
    row_update.launches = 0
    pec.sharded_embedding_sparse_update(lay, pool, None, idx[sl], g[sl], mesh, opt)
    launches = run.gather(row_update.launches)
    shards = torch.empty((n * lay.r_pad, d), dtype=dtype, device=dev)
    dist.all_gather_into_tensor(shards, pool.contiguous())
    res = {"hierarchical": lay.hierarchical, "owner": lay.owner, "t_max": lay.t_max, "r_pad": lay.r_pad,
           "row_update_launches_by_rank": launches, "routed_exact_lookup_bit_equal_by_rank": routed_equal}
    run.check(routed_equal is None or all(routed_equal), "routed exact lookup", res)
    if mesh.rank == 0:
        flat_lay = pec.ShardedEmbeddingLayout(vocabs, d, 1, [0] * len(vocabs), packed_pool=run.cuda)
        flat = flat_lay.init_pool(make_table, None, dev, dtype)
        rows = (idx + torch.as_tensor(flat_lay.table_bases(), device=dev)[None, :, None]).reshape(-1)
        want = embedding_bag(flat, rows[:, None], AggrMode.AGGR_MODE_SUM).reshape(got.shape)
        res["lookup_bit_equal"] = bool(torch.equal(got, want))
        src = g.reshape(-1, d).contiguous()
        # the kernel's tolerance against another summation order
        # (chip_smoke.row_update_tolerance): within 2 n 2^-24 of |t| +
        # sum |delta|, and a bf16 step of it where a rounding flips
        mag = flat.float().abs().index_add_(0, rows, (0.01 * src).abs())
        cnt = torch.zeros(flat.shape[0], device=dev).index_add_(0, rows, torch.ones(rows.numel(), device=dev))
        tol = 2.0 * cnt[:, None] * F32_UNIT * mag + (2.0 * BF16_UNIT * mag if run.cuda else 0.0)
        before = row_update.launches
        pec.local_pool_row_update(flat_lay, flat, None, rows, (src, 1), opt)
        res["one_card_launches"] = row_update.launches - before
        errs, over, equal = [], [], []
        for t in range(len(vocabs)):
            a = lay.extract_table(shards, t).float()
            w = flat_lay.extract_table(flat, t).float()
            e = (a - w).abs()
            errs.append(e.max().item())
            over.append((e / flat_lay.extract_table(tol, t).clamp_min(1e-30)).max().item())
            equal.append(torch.equal(a, w))
        res.update({"max_abs_err": max(errs), "max_err_over_tol": max(over),
                    "tables_bit_equal": int(sum(equal)), "tables": len(vocabs)})
        run.check(res["lookup_bit_equal"] and res["max_err_over_tol"] <= 1.0, "exchange", res)
    run.check(all(x == (1 if run.cuda else 0) for x in launches), "row-update launches", res)
    return res


def kaggle_model(run: Run, cfg, rule: str, mesh, seed: int = SEED, plan=None, **ffkw):
    model = make_dlrm_model(cfg, FFConfig(batch_size=cfg.batch_size, seed=seed, compute_dtype="bfloat16",
                                          table_dtype="bfloat16", **ffkw), device=run.device)
    opt = AdamOptimizer(alpha=0.001) if rule == "adam" else SGDOptimizer(lr=0.01)
    model.compile(opt, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY], mesh=mesh,
                  plan=(plan or dlrm_hybrid_plan()) if mesh is not None else None)
    return model


def stacks(batches) -> tuple:
    """The staged global batches as [K, B, ...] stacks (train_chunk's input)."""
    return ({k: torch.stack([f[k] for f, _ in batches]) for k in batches[0][0]},
            torch.stack([lbl for _, lbl in batches]))


def staged_batches(cfg, b: int, dev, seed: int, zipf: float = 0.0) -> list:
    feeds, labels = random_batches(cfg, 4 * b, seed=seed, learnable=False, zipf=zipf)
    return [({k: torch.as_tensor(v[j * b:(j + 1) * b]).to(dev) for k, v in feeds.items()},
             torch.as_tensor(labels[j * b:(j + 1) * b]).to(dev)) for j in range(4)]


def graph_kernels(run: Run, model) -> dict:
    """The kernel nodes of the model's captured step (tools/graph_nodes.py):
    K1's (a row-update launch runs 2 kernels under SGD and Adam) and
    NCCL's; the step's phase stamps counted apart ("phase_stamp", 8)."""
    if not run.cuda:
        return {"k1_kernel_nodes": "not measured (CPU: no graph)"}
    from .graph_nodes import node_counts, stamps_apart

    nodes = stamps_apart(node_counts(model._step_graph.graph, kernel_names=True))
    return {"nodes": {k: v for k, v in nodes.items() if k != "kernels"},
            "k1_kernel_nodes": sum(n for name, n in nodes["kernels"].items() if "row_update" in name),
            "nccl_kernel_nodes": sum(n for name, n in nodes["kernels"].items() if "nccl" in name.lower())}


def profile_steps(run: Run, fn, steps: int, ms_per_step: float) -> dict:
    """Kernel ms a step and the busy share of the unprofiled step, from
    torch.profiler over `fn()`, which runs `steps` steps. The NCCL kernels
    are summed apart: a collective's kernel runs from its launch until the
    slowest rank joins, so its time holds the wait for the peers; the
    profiler's "nccl:*" rows repeat their time and are left out."""
    if not run.cuda:
        return {"kernel_ms_per_step": "not measured (CPU)"}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(run.device)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset", "step:", "nccl:"))
               and not getattr(e, "is_user_annotation", False)]  # the port's ranges mirrored on the card
    per_step = {e.key: e.self_device_time_total / 1e3 / steps for e in kernels}
    nccl = sum(v for k, v in per_step.items() if k.startswith("ncclDevKernel"))
    busy = sum(per_step.values()) - nccl
    if busy == 0.0:
        return {"kernel_ms_per_step": "not measured (the profiler saw no device time)"}
    top = sorted(((k, v) for k, v in per_step.items() if not k.startswith("ncclDevKernel")),
                 key=lambda kv: -kv[1])
    return {"kernel_ms_per_step": busy, "busy_share": busy / ms_per_step, "nccl_kernel_ms_per_step": nccl,
            "nccl_share": nccl / ms_per_step, "top_kernels_ms_per_step": {k[:50]: v for k, v in top[:5]}}


def train_check(run: Run, rule: str) -> dict:
    mesh, dev, args = run.mesh, run.device, run.args
    b, steps = args.batch_size, args.steps
    cfg = kaggle_config(batch_size=b)
    cfg.embedding_size = [min(v, args.vocab_cap) for v in cfg.embedding_size]
    model = kaggle_model(run, cfg, rule, mesh)
    coll = model._op("embedding_collection")
    lay = coll.layout
    batches = staged_batches(cfg, b, dev, SEED + 1)
    one = kaggle_model(run, cfg, rule, None) if mesh.rank == 0 else None
    for name in coll.table_names + [n for n in model.get_parameters() if n != coll.name]:
        w = model.get_weights(name)  # a fused table: collective
        if one is not None:
            one.set_weights(name, w)
    wrapper = row_update_adam if rule == "adam" else row_update
    losses = [model.train_batch(*batches[i % 4]) for i in range(WARMUP)]
    run.sync()
    wrapper.launches = 0
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses += [model.train_batch(*batches[(WARMUP + i) % 4]) for i in range(steps)]
    float(losses[-1])
    dt = time.perf_counter() - t0
    launches = wrapper.launches
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if run.cuda else "not measured (CPU)"
    ms = dt / steps * 1e3
    prof = profile_steps(run, lambda: [model.train_batch(*batches[i % len(batches)]) for i in range(PROFILED)],
                         PROFILED, ms)
    mine = {"rank": mesh.rank, "row_update_launches_per_step": launches / steps, "ms_per_step": ms,
            "peak_memory_gb": peak, "pool_dtype": str(model.get_parameters()[coll.name]["pool"].dtype),
            **prof}
    by_rank = run.gather(mine)
    losses = [float(x) for x in losses]
    res = {"rule": rule, "global_batch": b, "steps": steps, "seconds": dt,
           "examples_per_s": steps * b / dt, "examples_per_s_per_card": steps * b / dt / mesh.size,
           "all_to_all_gbps": lay.step_exchange_bytes(b, dtype_bytes=2 if run.cuda else 4) * steps / dt / 1e9,
           "packed_pool": lay.packed_pool, "losses": losses, "by_rank": by_rank}
    run.check(all(np.isfinite(losses)), "losses", res)
    run.check(all(r["row_update_launches_per_step"] == (1 if run.cuda else 0) for r in by_rank),
              "launches", res)
    if one is not None:
        one_losses = [one.train_batch(*batches[i % 4]) for i in range(WARMUP)]
        if run.cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        one_losses += [one.train_batch(*batches[(WARMUP + i) % 4]) for i in range(steps)]
        float(one_losses[-1])
        one_ms = (time.perf_counter() - t1) / steps * 1e3
        one_losses = [float(x) for x in one_losses]
        res["one_card"] = {"losses": one_losses, "ms_per_step": one_ms, "examples_per_s": b / one_ms * 1e3,
                           "max_loss_err": max(abs(x - y) for x, y in zip(losses, one_losses)),
                           "loss_atol": LOSS_ATOL}
        run.check(res["one_card"]["max_loss_err"] <= LOSS_ATOL, "losses against one card", res)
    del model, one
    if run.cuda:
        torch.cuda.empty_cache()
    res["replays"] = replay_check(run, cfg, rule, batches)
    res["replays_vs_eager_deterministic"] = bits_check(run, cfg, rule, batches)
    del batches
    if run.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def replay_check(run: Run, cfg, rule: str, batches, plan=None, k1_nodes: int = 2, mesh=None, **ffkw) -> dict:
    """`train_chunk` replays on the 4 staged global batches, from the
    seeded weights: the first chunk's first step runs eagerly and the
    step is captured; then timed chunks of 4, a profiled chunk, and the
    captured step's kernel nodes a rank (`k1_nodes` of K1's). `mesh`:
    the run's unless given."""
    mesh, b = mesh or run.mesh, run.args.batch_size
    model = kaggle_model(run, cfg, rule, mesh, plan=plan, **ffkw)
    stack, labels = stacks(batches)
    model.train_chunk({k: v[:WARMUP] for k, v in stack.items()}, labels[:WARMUP])  # captures
    run.sync()
    chunks = max(1, -(-run.args.steps // 4))
    t0 = time.perf_counter()
    for _ in range(chunks):
        loss = model.train_chunk(stack, labels)
    loss = float(loss)
    dt = time.perf_counter() - t0
    steps = 4 * chunks
    ms = dt / steps * 1e3
    mine = {"rank": mesh.rank, "ms_per_step": ms, "loss": loss, **graph_kernels(run, model),
            **profile_steps(run, lambda: model.train_chunk(stack, labels), 4, ms)}
    by_rank = run.gather(mine)
    lay = model._embedding_layout
    res = {"steps": steps, "seconds": dt, "ms_per_step": ms, "examples_per_s": steps * b / dt,
           "examples_per_s_per_card": steps * b / dt / mesh.size,
           "all_to_all_gbps": None if lay is None else (
               lay.step_exchange_bytes(b, dtype_bytes=2 if run.cuda else 4) * steps / dt / 1e9),
           "by_rank": by_rank}
    run.check(all(np.isfinite(r["loss"]) for r in by_rank), "replayed losses", res)
    run.check(not run.cuda or all(r["k1_kernel_nodes"] == k1_nodes for r in by_rank), "K1 nodes", res)
    del model
    return res


def bits_check(run: Run, cfg, rule: str, batches, plan=None, mesh=None, **ffkw) -> dict:
    """Under deterministic algorithms (the one-hot lookups' backward sums
    with float atomics otherwise), 8 eager steps against 2 chunks of 4 on
    fresh models: every loss and every tensor of each rank's state bit
    for bit. `mesh`: the run's unless given."""
    eager, chunk = (kaggle_model(run, cfg, rule, mesh or run.mesh, plan=plan, **ffkw) for _ in range(2))
    stack, labels = stacks(batches)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_e = [eager.train_batch(*batches[i % 4]) for i in range(DETERMINISTIC_STEPS)]
        losses_g = [chunk.train_chunk(stack, labels) for _ in range(DETERMINISTIC_STEPS // 4)]
        run.sync()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = sorted(state_diff(eager, chunk))
    mine = {"rank": run.mesh.rank, "tensors": len(state_tensors(eager)), "differing_tensors": diff,
            "losses_bit_identical": all(torch.equal(a, b) for a, b in zip(losses_e[3::4], losses_g)),
            "step_counts": [eager._step_count, chunk._step_count]}
    res = {"steps": DETERMINISTIC_STEPS, "by_rank": run.gather(mine)}
    run.check(all(not r["differing_tensors"] and r["losses_bit_identical"] for r in res["by_rank"]),
              "replays against eager steps", res)
    del eager, chunk
    return res


def routed_check(run: Run) -> dict:
    """Kaggle under exchange="routed" at cap_factor 2.0, the two largest
    fused tables split two ways (hash_rows on by default there), Zipf(1.05)
    ids: the drop fraction of a batch, the bytes a step by the JAX
    package's count (`step_exchange_bytes`) and as the padded buckets carry
    them (`RoutedPlan.step_bucket_bytes`) against the dense exchange's
    count, one eager step's K1 launches a rank, then replays."""
    mesh, dev, b = run.mesh, run.device, run.args.batch_size
    cfg = kaggle_config(batch_size=b)
    cfg.embedding_size = [min(v, run.args.vocab_cap) for v in cfg.embedding_size]
    fused = [v for v in cfg.embedding_size if v > 8192]
    big = sorted(range(len(fused)), key=lambda t: -fused[t])[:2]
    plan = dlrm_hybrid_plan()
    plan.exchange, plan.routed_cap_factor = "routed", 2.0
    plan.table_split = [2 if t in big else 1 for t in range(len(fused))]
    feeds, labels = random_batches(cfg, 4 * b, seed=SEED + 3, learnable=False, zipf=1.05)
    batches = [({k: torch.as_tensor(v[j * b:(j + 1) * b]).to(dev) for k, v in feeds.items()},
                torch.as_tensor(labels[j * b:(j + 1) * b]).to(dev)) for j in range(4)]
    model = kaggle_model(run, cfg, "sgd", mesh, plan=plan)
    lay = model._embedding_layout
    drop = model.routed_drop_fraction({k: v[:b] for k, v in feeds.items()})
    dense = pec.ShardedEmbeddingLayout(lay.vocab_sizes, lay.dim, lay.num_shards, lay.owner, split=lay.split,
                                       packed_pool=lay.packed_pool)
    row_update.launches = 0
    loss = float(model.train_batch(*batches[0]))
    launches = run.gather(row_update.launches)
    rplan = prx.routed_plan(lay, b // mesh.size, 1, lay.routed_cap_factor)
    res = {"split": plan.table_split, "hash_rows": lay.hash_rows, "cap_factor": lay.routed_cap_factor,
           "drop_fraction": drop, "step_exchange_bytes_bf16": lay.step_exchange_bytes(b, dtype_bytes=2),
           "c_max": rplan.c_max, "slot_caps": int(rplan.slot_cap.sum()),
           "step_bucket_bytes_bf16": rplan.step_bucket_bytes(lay.dim, 2),
           "dense_step_exchange_bytes_bf16": dense.step_exchange_bytes(b, dtype_bytes=2),
           "eager_loss": loss, "row_update_launches_by_rank": launches}
    run.check(lay.hash_rows and np.isfinite(loss) and all(x == (1 if run.cuda else 0) for x in launches),
              "routed step", res)
    del model
    res["replays"] = replay_check(run, cfg, "sgd", batches, plan=plan)
    del batches
    if run.cuda:
        torch.cuda.empty_cache()
    return res


def host_memory_gib() -> dict:
    """This process's resident memory now (/proc/self/statm) and its peak
    so far (getrusage's ru_maxrss, KiB on Linux)."""
    import resource

    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return {"rss_gib": rss / 2**30, "peak_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def checkpoint_check(run: Run) -> dict:
    """The sharded checkpoint round trip at kaggle's full width under Adam
    (the pool and its m and v sharded): one step, save, restore into a
    model of another seed, the state bit for bit and the next step's loss
    within tests/test_sharding.py's rtol 1e-5, atol 1e-6, on every rank;
    the files' bytes, the save's and the restore's seconds, each rank's
    host memory before the save and its peak after the save and after the
    restore, and rank 0's peak device memory in the save (the shards
    gathered there)."""
    import shutil

    from ..training.checkpoint import restore_checkpoint, save_checkpoint

    mesh, dev, b = run.mesh, run.device, run.args.batch_size
    cfg = kaggle_config(batch_size=b)
    cfg.embedding_size = [min(v, run.args.vocab_cap) for v in cfg.embedding_size]
    feeds, labels = random_batches(cfg, b, seed=SEED + 4, learnable=False)
    batch = ({k: torch.as_tensor(v).to(dev) for k, v in feeds.items()}, torch.as_tensor(labels).to(dev))
    path = Path("build") / "mesh_smoke_checkpoint"
    first = kaggle_model(run, cfg, "adam", mesh)
    first.train_batch(*batch)
    resumed = kaggle_model(run, cfg, "adam", mesh, seed=SEED + 1)
    differed = bool(state_diff(first, resumed))
    host = {"before_save": host_memory_gib()}
    if run.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    save_checkpoint(str(path), first)
    save_s = time.perf_counter() - t0
    host["after_save"] = host_memory_gib()
    save_device = (torch.cuda.max_memory_allocated() - base) / 2**30 if run.cuda else "not measured (CPU)"
    t0 = time.perf_counter()
    manifest = restore_checkpoint(str(path), resumed)
    restore_s = time.perf_counter() - t0
    host["after_restore"] = host_memory_gib()
    after = sorted(state_diff(first, resumed))
    l1, l2 = float(first.train_batch(*batch)), float(resumed.train_batch(*batch))
    mine = {"rank": mesh.rank, "differed_before": differed, "differing_after_restore": after,
            "loss_saved_model": l1, "loss_restored": l2, "step": manifest["step"], "restore_s": restore_s,
            "host_memory": host, "save_device_peak_gib_above_before": save_device}
    res = {"vocabs": [v for v in cfg.embedding_size if v > 8192],
           "pool_dtype": str(first.get_parameters()[first._op("embedding_collection").name]["pool"].dtype),
           "file_bytes": {f.name: f.stat().st_size for f in sorted(path.iterdir())} if mesh.rank == 0 else None,
           "save_s": save_s, "by_rank": run.gather(mine)}
    dist.barrier()
    if mesh.rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    run.check(all(r["differed_before"] and not r["differing_after_restore"] and r["step"] == 1
                  and abs(r["loss_restored"] - r["loss_saved_model"]) <= 1e-6 + 1e-5 * abs(r["loss_saved_model"])
                  for r in res["by_rank"]), "checkpoint round trip", res)
    del first, resumed
    if run.cuda:
        torch.cuda.empty_cache()
    return res


def mlperf_lite_check(run: Run, mesh=None, **ffkw) -> dict:
    """mlperf-lite on `mesh` (the run's unless given): `predict` of 4 global
    batches and a ragged one, then 3 train steps; K3 launches a rank (5 and
    3) and K1's (one a step for a sharded collection on the kernel route,
    none for the flat one at a data axis of 1, which takes the scatter
    rule); under column-parallel layers, the replicas' digests
    (`replicas_alike`)."""
    mesh, dev, args = mesh or run.mesh, run.device, run.args
    b = args.batch_size
    cfg = mlperf_lite_config(batch_size=b, vocab_cap=min(2_000_000, args.vocab_cap))
    model = make_dlrm_model(cfg, FFConfig(batch_size=b, seed=SEED, compute_dtype="bfloat16",
                                          table_dtype="bfloat16", **ffkw), device=dev)
    model.compile(SGDOptimizer(lr=0.01), LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                  mesh=mesh, plan=dlrm_hybrid_plan())
    coll = model._op("embedding_collection")
    feeds, labels = random_batches(cfg, 4 * b + 1000, seed=SEED + 2, learnable=False)
    dot_interaction.launches = 0
    t0 = time.perf_counter()
    y = model.predict(feeds)
    predict_s = time.perf_counter() - t0
    k3_predict = dot_interaction.launches
    dot_interaction.launches = row_update.launches = 0
    run.sync()
    t0 = time.perf_counter()
    losses = [float(model.train_batch({k: v[i * b:(i + 1) * b] for k, v in feeds.items()},
                                      labels[i * b:(i + 1) * b])) for i in range(3)]
    mine = {"rank": mesh.rank, "index": [mesh.data_index, mesh.model_index], "k3_predict": k3_predict,
            "k3_train": dot_interaction.launches, "row_update_train": row_update.launches, "predict_s": predict_s,
            "eager_ms_per_step": (time.perf_counter() - t0) / 3 * 1e3}
    if model._model_parallel:
        mine.update(split_digests(model), tp_collectives=tp_collective_ms(run, model, b // mesh.data_size))
    by_rank = run.gather(mine)
    res = {"mesh": list(mesh.shape), "tensor_parallel": sorted(model._model_parallel),
           "fused_tables": len(coll.table_names), "shards": coll.layout.num_shards, "t_max": coll.layout.t_max,
           "r_pad": coll.layout.r_pad,
           "pool_dtype": str(model.get_parameters()[coll.name]["pool"].dtype), "predicted": list(y.shape),
           "predict_in_0_1": bool(np.all((y > 0) & (y < 1))), "losses": losses, "by_rank": by_rank}
    want = (5, 3, 3 if coll.layout.packed_pool else 0) if run.cuda else (0, 0, 0)
    run.check(res["predict_in_0_1"] and y.shape == (4 * b + 1000, 1) and all(np.isfinite(losses))
              and all((r["k3_predict"], r["k3_train"], r["row_update_train"]) == want for r in by_rank),
              "mlperf-lite", res)
    if model._model_parallel:
        res["replicas_alike_by_digest"] = replicas_alike(by_rank)
        run.check(res["replicas_alike_by_digest"], "mlperf-lite model-axis replicas and data-axis blocks", res)
    return res


def replicas_equal(run: Run, model) -> dict:
    """Every tensor of this rank's state that the ranks replicate (all but
    a sharded collection's) against rank 0's, bit for bit: each tensor's
    bytes broadcast from rank 0 (one tensor at a time) and compared here."""
    differing, n = [], 0
    for path, t in sorted(state_tensors(model).items()):
        if "embedding_collection" in path:
            continue
        mine = t.detach().contiguous().reshape(-1).view(torch.uint8)
        theirs = mine.clone() if run.mesh.rank == 0 else torch.empty_like(mine)
        dist.broadcast(theirs, src=0)
        n += 1
        if not torch.equal(mine, theirs):
            differing.append(path)
    return {"rank": run.mesh.rank, "tensors": n, "differing_from_rank_0": differing}


def one_card_losses(run: Run, one, batches, steps: int) -> tuple:
    """(losses, ms a step) of `steps` eager steps of rank 0's one-card model
    after WARMUP, round robin."""
    losses = [one.train_batch(*batches[i % 4]) for i in range(WARMUP)]
    run.sync_device()
    t0 = time.perf_counter()
    losses += [one.train_batch(*batches[(WARMUP + i) % 4]) for i in range(steps)]
    losses = [float(x) for x in losses]
    return losses, (time.perf_counter() - t0) / steps * 1e3


def dp_check(run: Run, rule: str, mesh=None, **ffkw) -> dict:
    """Kaggle under data_parallel_plan() on `mesh` (the run's unless
    given): every table replicated, the 10 above 8192 rows sparse on K1
    (bf16), each rank applying the global batch's gathered stream. Eager
    steps against one card's model from the same weights, every rank's
    replicas against rank 0's (on a 2-D mesh by digest, `replicas_alike`:
    the tables alike on every rank, a column-parallel block on its data
    peers), then replays."""
    mesh, dev, args = mesh or run.mesh, run.device, run.args
    b, steps = args.batch_size, args.steps
    cfg = kaggle_config(batch_size=b)
    cfg.embedding_size = [min(v, args.vocab_cap) for v in cfg.embedding_size]
    model = kaggle_model(run, cfg, rule, mesh, plan=data_parallel_plan(), **ffkw)
    route = [op for op in model._sparse_ops if op.kernel_route]
    run.check(model._op("embedding_collection") is None and len(model._sparse_ops) == 10
              and len(route) == (10 if run.cuda else 0), "the replicated tables", {"sparse": len(model._sparse_ops)})
    batches = staged_batches(cfg, b, dev, SEED + 5)
    one = kaggle_model(run, cfg, rule, None) if mesh.rank == 0 else None
    for name in model.get_parameters():
        w = model.get_weights(name)  # collective for a column-parallel Dense
        if one is not None:
            one.set_weights(name, w)
    wrapper = row_update_adam if rule == "adam" else row_update
    losses = [model.train_batch(*batches[i % 4]) for i in range(WARMUP)]
    run.sync()
    wrapper.launches = 0
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses += [model.train_batch(*batches[(WARMUP + i) % 4]) for i in range(steps)]
    losses = [float(x) for x in losses]
    dt = time.perf_counter() - t0
    ms = dt / steps * 1e3
    two_d = bool(model._model_parallel)
    mine = {"rank": mesh.rank, "index": [mesh.data_index, mesh.model_index],
            "row_update_launches_per_step": wrapper.launches / steps, "eager_ms_per_step": ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if run.cuda else "not measured (CPU)",
            "table_dtype": str(model.get_parameters()[model._sparse_ops[0].name]["weight"].dtype),
            **(split_digests(model) if two_d else replicas_equal(run, model))}
    res = {"rule": rule, "mesh": list(mesh.shape), "tensor_parallel": sorted(model._model_parallel),
           "global_batch": b, "steps": steps, "eager_ms_per_step": ms,
           "eager_examples_per_s": steps * b / dt, "losses": losses, "by_rank": run.gather(mine)}
    res["replicas_alike"] = (replicas_alike(res["by_rank"], everywhere=True) if two_d
                             else not any(r["differing_from_rank_0"] for r in res["by_rank"]))
    run.check(all(np.isfinite(losses)), "losses", res)
    run.check(all(r["row_update_launches_per_step"] == (10 if run.cuda else 0) for r in res["by_rank"])
              and res["replicas_alike"], "launches and replicas", res)
    if one is not None:
        one_losses, one_ms = one_card_losses(run, one, batches, steps)
        res["one_card"] = {"losses": one_losses, "ms_per_step": one_ms,
                           "max_loss_err": max(abs(x - y) for x, y in zip(losses, one_losses)),
                           "loss_atol": LOSS_ATOL}
        run.check(res["one_card"]["max_loss_err"] <= LOSS_ATOL, "losses against one card", res)
    del model, one
    if run.cuda:
        torch.cuda.empty_cache()
    res["replays"] = replay_check(run, cfg, rule, batches, plan=data_parallel_plan(), k1_nodes=20, mesh=mesh,
                                  **ffkw)
    res["replays_vs_eager_deterministic"] = bits_check(run, cfg, rule, batches, plan=data_parallel_plan(),
                                                       mesh=mesh, **ffkw)
    del batches
    if run.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def step_phases(run: Run, model, batches, steps: int) -> dict:
    """This rank's step by phase over `steps` profiled eager steps: each
    `STEP_PHASES` range's host ms and the span of the device work launched
    in it, and kernel ms a step (torch.profiler)."""
    if not run.cuda:
        return {"phases": "not measured (CPU)"}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..core.ffmodel import STEP_PHASES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            model.train_batch(*batches[i % len(batches)])
        torch.cuda.synchronize(run.device)
    rows = prof.key_averages()
    spans = {e.key: e.device_time_total / 1e3 / steps for e in rows
             if e.device_type == DeviceType.CUDA and e.key in STEP_PHASES}
    phases = {e.key.split(":")[1]: {"host_ms": e.cpu_time_total / 1e3 / steps,
                                    "device_span_ms": spans.get(e.key, "not measured")}
              for e in rows if e.device_type == DeviceType.CPU and e.key in STEP_PHASES}
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA and e.key not in STEP_PHASES
               and not e.key.startswith(("Memcpy", "Memset", "nccl:"))
               and not getattr(e, "is_user_annotation", False)]
    nccl = sum(e.self_device_time_total for e in kernels if e.key.startswith("ncclDevKernel")) / 1e3 / steps
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps - nccl
    return {"phases": phases, "kernel_ms_per_step": busy, "nccl_kernel_ms_per_step": nccl}


def full_model(run: Run, cfg, rule: str, mesh):
    from .. import RowWiseAdagradOptimizer

    b = cfg.batch_size
    model = make_dlrm_model(cfg, FFConfig(batch_size=b, seed=SEED, compute_dtype="bfloat16", table_dtype="bfloat16",
                                          host_tail_threshold=run.args.hot, host_tail_cap_frac=0.25),
                            device=run.device)
    model.compile(SGDOptimizer(lr=0.01), LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY],
                  sparse_optimizer=RowWiseAdagradOptimizer(lr=0.01) if rule == "adagrad" else None,
                  mesh=mesh, plan=dlrm_hybrid_plan() if mesh is not None else None)
    return model


def store_digests(model) -> dict:
    """{table: sha256 of its store's state (rows, values, accumulators)}."""
    import hashlib

    out = {}
    for name, (store, *_rest) in sorted(model._host_tail.entries.items()):
        h = hashlib.sha256()
        for a in store.state():
            h.update(a.tobytes())
        out[name] = h.hexdigest()[:16]
    return out


def full_check(run: Run, rule: str) -> dict:
    """mlperf-full under the hybrid plan and host-tail offload: the tables
    above `--hot` rows replicated with their tails in each rank's replica
    stores, the other tables above 8192 rows fused and sharded; Zipf(1.05)
    ids at the global batch; eager steps (the host's half between steps)
    against one card's model (rank 0) from the same weights and the same
    stores (one seed)."""
    mesh, dev, args = run.mesh, run.device, run.args
    b, steps = args.batch_size, args.full_steps
    cfg = mlperf_config(batch_size=b)
    cfg.embedding_size = [min(v, args.vocab_cap) for v in cfg.embedding_size]
    t0 = time.perf_counter()
    model = full_model(run, cfg, rule, mesh)
    coll = model._op("embedding_collection")
    ht = model._host_tail
    one = full_model(run, cfg, rule, None) if mesh.rank == 0 else None
    for name in (coll.table_names if coll is not None else []) + [
            n for n in model.get_parameters() if coll is None or n != coll.name]:
        w = model.get_weights(name)  # a fused table: collective
        if one is not None:
            one.set_weights(name, w)
    feeds, labels = random_batches(cfg, 4 * b, seed=SEED + 6, learnable=False, zipf=1.05)
    batches = [({k: v[j * b:(j + 1) * b] for k, v in feeds.items()}, labels[j * b:(j + 1) * b]) for j in range(4)]
    setup = {"rows": sum(cfg.embedding_size), "hot": args.hot, "host_tail_tables": sorted(ht.entries),
             "fused_tables": len(coll.table_names) if coll is not None else 0,
             "replicated_sparse_tables": len([op for op in model._sparse_ops if op is not coll]),
             "k_cap": sorted({e[4] for e in ht.entries.values()}), "rule": ht.rule,
             "set_up_s": time.perf_counter() - t0}
    run.check(len(ht.entries) == len([v for v in cfg.embedding_size if v > args.hot]) > 0, "the split", setup)
    losses = [model.train_batch(*batches[i % 4]) for i in range(WARMUP)]
    float(losses[-1])
    run.sync()
    wrapper = row_update_adagrad if rule == "adagrad" else row_update
    wrapper.launches = dot_interaction.launches = 0
    t0 = time.perf_counter()
    losses += [model.train_batch(*batches[(WARMUP + i) % 4]) for i in range(steps)]
    losses = [float(x) for x in losses]
    ms = (time.perf_counter() - t0) / steps * 1e3
    # K1: one launch a replicated table on the kernel route and one for the
    # shard of a collection on it; K3: the interaction's forward
    k1 = len([op for op in model._sparse_ops if op.kernel_route]) + int(bool(coll and coll.layout.packed_pool))
    launches = {"row_update_per_step": wrapper.launches / steps, "dot_interaction_per_step":
                dot_interaction.launches / steps}
    run.check(not run.cuda or launches == {"row_update_per_step": k1, "dot_interaction_per_step": 1},
              "launches", {"launches": launches, "k1": k1})
    prof = step_phases(run, model, batches, 2)
    mine = {"rank": mesh.rank, "ms_per_step": ms, **launches, **prof, "touched_tail_rows": sum(
        e[0].touched_rows for e in ht.entries.values()), "tail_lookups": ht.total, "dropped": ht.dropped,
        "drop_fraction": model.host_tail_drop_fraction(), "host_memory": host_memory_gib(),
        "store_digests": store_digests(model), **replicas_equal(run, model)}
    by_rank = run.gather(mine)
    res = {"rule": rule, "global_batch": b, "steps": steps, "set_up": setup, "ms_per_step": ms,
           "examples_per_s": b / ms * 1e3, "examples_per_s_per_card": b / ms * 1e3 / mesh.size, "losses": losses,
           "by_rank": by_rank}
    run.check(all(np.isfinite(losses)), "losses", res)
    run.check(all(r["store_digests"] == by_rank[0]["store_digests"] and not r["differing_from_rank_0"]
                  and (r["touched_tail_rows"], r["dropped"]) == (by_rank[0]["touched_tail_rows"], by_rank[0]["dropped"])
                  for r in by_rank), "replicas", res)
    if one is not None:
        one_losses, one_ms = one_card_losses(run, one, batches, steps)
        res["one_card"] = {"losses": one_losses, "ms_per_step": one_ms, "examples_per_s": b / one_ms * 1e3,
                           "max_loss_err": max(abs(x - y) for x, y in zip(losses, one_losses)),
                           "loss_atol": LOSS_ATOL, "dropped": one._host_tail.dropped,
                           "touched_tail_rows": sum(e[0].touched_rows for e in one._host_tail.entries.values())}
        run.check(res["one_card"]["max_loss_err"] <= LOSS_ATOL and res["one_card"]["dropped"] == ht.dropped,
                  "losses against one card", res)
    del model, one, batches, feeds
    if run.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def tp_collective_ms(run: Run, model, b_loc: int, reps: int = 20) -> dict:
    """The collectives of each column-parallel layer of `model`, timed alone
    at the step's shapes a rank (b_loc rows of the layer's compute dtype
    and width): the forward's all-gather of [b_loc, out / M] blocks and,
    where the layer's input takes a gradient (not the first layer's dense
    features), the backward's all-reduce of [b_loc, in] in f32; ms a call
    from CUDA events over `reps` eager calls after a warm-up, with the bytes
    each rank sends (not measured on the CPU)."""
    if not run.cuda:
        return {"tp_collective_ms": "not measured (CPU)"}
    mesh, dev = model.mesh, run.device
    group, m = mesh.model_group(), mesh.model_size
    out = {}
    for name in model._model_parallel:
        op = model._op(name)
        blk = torch.zeros((b_loc, op.out_dim // m), dtype=model._ctx.compute_dtype, device=dev)
        full = torch.empty((m * b_loc, op.out_dim // m), dtype=blk.dtype, device=dev)
        grad = torch.zeros((b_loc, op.in_dim), dtype=torch.float32, device=dev)
        takes_grad = not isinstance(op.inputs[0].owner_op, InputOp)
        row = {}
        for kind, call in (("all_gather", lambda: dist.all_gather_into_tensor(full, blk, group=group)),
                           ("all_reduce", lambda: dist.all_reduce(grad, group=group))):
            if kind == "all_reduce" and not takes_grad:
                continue
            call()
            run.sync()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            row[f"{kind}_ms"] = start.elapsed_time(end) / reps
            row[f"{kind}_bytes"] = (blk if kind == "all_gather" else grad).numel() * (
                blk if kind == "all_gather" else grad).element_size()
        out[name] = row
    return out


def device_digest(tensors) -> str:
    """One sha256 over a digest of each tensor computed on the device: its
    bytes as int64 words (zero-padded), their sum and their sum weighted by
    position (mod 1,000,003), each wrapping in int64; any two tensors that
    differ in a byte differ here but for a collision."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        b = torch.cat([b, b.new_zeros((-b.numel()) % 8)]).view(torch.int64)
        a = w = torch.zeros((), dtype=torch.int64, device=b.device)
        for lo in range(0, b.numel(), 1 << 24):
            part = b[lo:lo + (1 << 24)]
            pos = torch.arange(lo, lo + part.numel(), dtype=torch.int64, device=b.device) % 1_000_003 + 1
            a = a + part.sum()
            w = w + (part * pos).sum()
        h.update(np.array([a.item(), w.item(), b.numel()], np.int64).tobytes())
    return h.hexdigest()[:16]


def split_digests(model) -> dict:
    """The state a rank's model peers must hold alike (every tensor but the
    column-parallel ones: the collection shard and its slot state, the
    replicated towers and their optimizer state, the metrics) and the
    column-parallel blocks its data peers must hold alike, a digest each."""
    rest, tp = [], []
    for path, t in sorted(state_tensors(model).items()):
        op, key = path.split("/")[-2:]
        (tp if key in model._model_parallel.get(op, ()) else rest).append(t)
    return {"replicated": device_digest(rest), "column_parallel": device_digest(tp),
            "tensors": [len(rest), len(tp)]}


def replicas_alike(by_rank, everywhere: bool = False) -> bool:
    """Whether the ranks' `split_digests` (with their "index", [data,
    model]) agree as a 2-D mesh must: the replicated state alike on the
    model peers of a data index (on every rank when `everywhere`: no
    collection shard), the column-parallel blocks alike on the data peers
    of a model index, and, as a check on the digests, unlike where the
    shard or the block differs."""
    return all(
        (r["replicated"] == q["replicated"]) == (everywhere or r["index"][0] == q["index"][0])
        and (r["column_parallel"] == q["column_parallel"]) == (r["index"][1] == q["index"][1])
        for r in by_rank for q in by_rank)


def scatter_order_probe(run: Run, b_loc: int, rows: int = 1460, d: int = 16, reps: int = 5) -> dict:
    """A scatter-add of b_loc rows of f32 into `rows` x `d` zeros (a (2, 2)
    rank's one-hot backward on kaggle's first table; one seed), `reps`
    times by `index_add_` and by `ops.common.index_add_rows`: the distinct
    results of each. Float atomics may give more than one on the card,
    which is why the model peers' dense gradients are broadcast and the
    scatter rules take index_add_rows; index_add_rows must give one."""
    g = torch.Generator().manual_seed(SEED)
    idx = torch.randint(0, rows, (b_loc,), generator=g).to(run.device)
    src = torch.randn((b_loc, d), generator=g).to(run.device)
    zeros = torch.zeros((rows, d), device=run.device)
    atomics = {device_digest([zeros.clone().index_add_(0, idx, src)]) for _ in range(reps)}
    ordered = {device_digest([index_add_rows(zeros.clone(), idx, src)]) for _ in range(reps)}
    return {"lookups": b_loc, "rows": rows, "dim": d, "reps": reps,
            "index_add_distinct": len(atomics), "index_add_rows_distinct": len(ordered)}


def nccl_by_group(run: Run, model, batches, steps: int) -> dict:
    """NCCL kernel ms a step over `steps` profiled eager steps, by
    collective (the kernels' names: AllGather, AllReduce, Broadcast,
    SendRecv, the all-to-all's) and by process group: the model group's is
    the device time of the column-parallel layers' collectives (the
    `tensor_parallel.RANGES` ranges; under the hybrid plan every
    all-gather of a step is theirs), the data group's the rest but the
    replicated gradients' broadcast over the model group; and the compute
    kernels' ms a step. A collective's kernel runs from its launch until
    the slowest peer joins, so its time holds the waits."""
    if not run.cuda:
        return {"nccl_ms_per_step_by_group": "not measured (CPU)"}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.tensor_parallel import RANGES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            model.train_batch(*batches[i % len(batches)])
        torch.cuda.synchronize(run.device)
    rows = prof.key_averages()
    ranges = {}
    for e in rows:  # a range's device time: its kernels', on the CPU row or a GPU annotation row
        if e.key in RANGES:
            ranges[e.key] = max(ranges.get(e.key, 0.0), e.device_time_total / 1e3 / steps)
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA and e.key not in RANGES
               and not e.key.startswith(("Memcpy", "Memset", "nccl:", "step:"))
               and not getattr(e, "is_user_annotation", False)]
    by_kind = {}
    for e in kernels:
        if e.key.startswith("ncclDevKernel"):
            kind = next((k for k in ("AllGather", "AllReduce", "Broadcast", "SendRecv") if k in e.key), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3 / steps
    nccl = sum(by_kind.values())
    model_ms = sum(ranges.values()) + by_kind.get("Broadcast", 0.0)
    return {"nccl_ms_per_step_by_kind": by_kind, "tensor_parallel_range_ms_per_step": ranges,
            "nccl_ms_per_step_by_group": {"model": model_ms, "data": nccl - model_ms},
            "eager_compute_kernel_ms_per_step": sum(e.self_device_time_total for e in kernels) / 1e3 / steps - nccl}


def twod_check(run: Run, rule: str, mesh2, mesh1) -> dict:
    """Kaggle on the (2, 2) mesh (`mesh2`) under the hybrid plan and
    enable_parameter_parallel against the (4,) mesh (`mesh1`) from the same
    seed (a column-parallel kernel is drawn whole, so both start alike) and
    one card's model (rank 0) from the same weights: each step's loss
    within LOSS_ATOL of both (the same operations but for f32 summation
    orders: the input gradients' partial sums all-reduced over the model
    group), eager ms a step on both meshes, the replicas' digests, NCCL ms
    by group; then replays on both meshes and replays against eager steps
    bit for bit."""
    dev, args = run.device, run.args
    b, steps = args.batch_size, args.steps
    cfg = kaggle_config(batch_size=b)
    cfg.embedding_size = [min(v, args.vocab_cap) for v in cfg.embedding_size]
    model = kaggle_model(run, cfg, rule, mesh2, enable_parameter_parallel=True)
    coll = model._op("embedding_collection")
    flat = kaggle_model(run, cfg, rule, mesh1)
    one = kaggle_model(run, cfg, rule, None) if run.mesh.rank == 0 else None
    for name in coll.table_names + [n for n in model.get_parameters() if n != coll.name]:
        w = model.get_weights(name)  # collective: a fused table, a column-parallel Dense
        if one is not None:
            one.set_weights(name, w)
    batches = staged_batches(cfg, b, dev, SEED + 7)
    wrapper = row_update_adam if rule == "adam" else row_update
    out = {}
    for key, m in (("2d", model), ("1d", flat)):
        losses = [m.train_batch(*batches[i % 4]) for i in range(WARMUP)]
        run.sync()
        wrapper.launches = 0
        t0 = time.perf_counter()
        losses += [m.train_batch(*batches[(WARMUP + i) % 4]) for i in range(steps)]
        losses = [float(x) for x in losses]
        out[key] = (losses, (time.perf_counter() - t0) / steps * 1e3, wrapper.launches / steps)
    losses, ms, launches = out["2d"]
    mine = {"rank": run.mesh.rank, "index": [mesh2.data_index, mesh2.model_index], "eager_ms_per_step": ms,
            "row_update_launches_per_step": launches, "shard": coll.shard,
            "blocks": {n: list(model.get_parameters()[n]["kernel"].shape) for n in model._model_parallel},
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if run.cuda else "not measured (CPU)",
            **split_digests(model), **nccl_by_group(run, model, batches, PROFILED)}
    by_rank = run.gather(mine)
    res = {"rule": rule, "mesh": list(mesh2.shape), "global_batch": b, "steps": steps,
           "tensor_parallel": sorted(model._model_parallel), "shards": coll.layout.num_shards,
           "eager_ms_per_step": ms, "eager_examples_per_s": b / ms * 1e3, "losses": losses,
           "one_d": {"eager_ms_per_step": out["1d"][1], "losses": out["1d"][0],
                     "max_loss_err": max(abs(x - y) for x, y in zip(losses, out["1d"][0])), "loss_atol": LOSS_ATOL},
           "by_rank": by_rank}
    run.check(all(np.isfinite(losses)) and res["one_d"]["max_loss_err"] <= LOSS_ATOL, "losses against (4,)", res)
    run.check(all(r["row_update_launches_per_step"] == (1 if run.cuda else 0) for r in by_rank), "launches", res)
    peers_alike = replicas_alike(by_rank)
    res["replicas_alike_by_digest"] = peers_alike
    run.check(peers_alike, "model-axis replicas and data-axis blocks", res)
    if run.cuda:
        from ..parallel.tensor_parallel import RANGES

        res["tensor_parallel_ranges_timed"] = all(
            r["tensor_parallel_range_ms_per_step"].get(k, 0.0) > 0.0 for r in by_rank for k in RANGES)
        run.check(res["tensor_parallel_ranges_timed"], "device time in every tensor_parallel range", res)
    if one is not None:
        one_losses, one_ms = one_card_losses(run, one, batches, steps)
        res["one_card"] = {"losses": one_losses, "ms_per_step": one_ms,
                           "max_loss_err": max(abs(x - y) for x, y in zip(losses, one_losses)),
                           "loss_atol": LOSS_ATOL}
        run.check(res["one_card"]["max_loss_err"] <= LOSS_ATOL, "losses against one card", res)
    if rule == "sgd":
        res["tp_collectives_by_layer"] = run.gather(tp_collective_ms(run, model, b // mesh2.data_size))
    del model, flat, one
    if run.cuda:
        torch.cuda.empty_cache()
    res["replays"] = replay_check(run, cfg, rule, batches, mesh=mesh2, enable_parameter_parallel=True)
    res["replays_one_d"] = replay_check(run, cfg, rule, batches, mesh=mesh1)
    res["replays_vs_eager_deterministic"] = bits_check(run, cfg, rule, batches, mesh=mesh2,
                                                       enable_parameter_parallel=True)
    del batches
    if run.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return res


# ------------------------------------------------------------------ the zoo and expert parallelism
# global batches: 4 x chip_smoke.py's one-card batches (ZOO_CNN_BATCH,
# ZOO_NMT_BATCH, ZOO_MOE_BATCH), so each card runs the batch one card ran
ZOO_BATCH = {"resnet": 256, "nmt": 256, "moe_mlp": 65536}
# a rehearsal's models and batches (--zoo-small): mnist_cnn in resnet's
# place, nmt at small widths
ZOO_SMALL_BATCH = {"resnet": 8, "nmt": 8, "moe_mlp": 256}
NMT_SMALL = dict(src_len=6, dst_len=5, hidden_size=32, embed_size=24, vocab_size=50)
ZOO_LR = {"resnet": 0.02, "nmt": 2.0}  # SGD (chip_smoke.py's); moe_mlp: Adam at ZOO_ADAM
ZOO_ADAM = 0.001
ZOO_K6_A_CHUNK = 10  # moe_mlp's Dense layers: K6 launches a request chunk under "on", on each rank
# a step's loss on the mesh against one card's, both in bf16 compute: each
# rank rounds the gradients of its block's products to bf16 before the
# all-reduce (a product's operand gradients come back in the compute
# dtype), one card rounds the whole batch's once, so a step's update parts
# from one card's by up to one bf16 step (2^-8) of itself; the losses then
# part by at most 2^-8 of how far the loss has moved since the first step
# (a first-order bound: the loss moved by the updates), doubled for the
# rounding of the update's effect on the next activations, plus LOSS_ATOL
# for a flipped bf16 rounding of an activation (or, in moe_mlp, a gate
# near-tie routed to the other expert)
ZOO_MOVE_RTOL = 2.0**-7


def zoo_model(run: Run, name: str, b: int, mesh, use_pallas: str = "auto"):
    """The zoo model `name` at global batch b, bf16 compute, compiled on
    `mesh` under data_parallel_plan() (one card with mesh None)."""
    from ..models import zoo

    small = run.args.zoo_small
    cfg = FFConfig(batch_size=b, seed=SEED + 60, compute_dtype="bfloat16", use_pallas=use_pallas)
    if name == "resnet":
        m = (zoo.mnist_cnn if small else zoo.resnet)(batch_size=b, config=cfg, device=run.device)
        opt = SGDOptimizer(lr=ZOO_LR[name])
    elif name == "nmt":
        m = zoo.nmt(batch_size=b, config=cfg, device=run.device, **(NMT_SMALL if small else {}))
        opt = SGDOptimizer(lr=ZOO_LR[name])
    else:
        m = zoo.moe_mlp(batch_size=b, num_experts=4, k=2, alpha=2.0, in_dim=784, num_classes=10, config=cfg,
                        device=run.device)
        opt = AdamOptimizer(alpha=ZOO_ADAM)
    m.compile(opt, LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.METRICS_ACCURACY], mesh=mesh,
              plan=data_parallel_plan() if mesh is not None else None)
    return m


def zoo_batches(run: Run, name: str, model, b: int, count: int = 4, seed: int = SEED + 61) -> list:
    """`count` global batches on the card, the same on every rank (one
    seed): images that carry their class, the copy task's tokens, or
    clustered points (chip_smoke.py's data)."""
    dev = run.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    iop = model.graph.inputs[0].outputs[0]
    out = []
    if name == "nmt":
        vocab = model.get_layer_by_name("src_embed").num_entries
        for _ in range(count):
            src = torch.randint(0, vocab, (b, iop.shape[1]), generator=gen, device=dev, dtype=torch.int32)
            dst = src[:, :model.graph.inputs[1].outputs[0].shape[1]].contiguous()
            out.append(({"src_tokens": src, "dst_tokens": dst}, dst.float()))
        return out
    shape = tuple(iop.shape[1:])
    centers = torch.randn((10,) + shape, generator=gen, device=dev)
    noise = 0.5 if name == "resnet" else 0.3
    for _ in range(count):
        y = torch.randint(0, 10, (b,), generator=gen, device=dev)
        x = centers[y] + noise * torch.randn((b,) + shape, generator=gen, device=dev)
        out.append(({model.graph.inputs[0].name: x}, y[:, None].float()))
    return out


def zoo_train(run: Run, model, batches, steps: int) -> tuple:
    """(losses of WARMUP + `steps` eager steps round robin, ms a timed step)."""
    losses = [model.train_batch(*batches[i % len(batches)]) for i in range(WARMUP)]
    run.sync()
    t0 = time.perf_counter()
    losses += [model.train_batch(*batches[(WARMUP + i) % len(batches)]) for i in range(steps)]
    losses = [float(x) for x in losses]
    return losses, (time.perf_counter() - t0) / steps * 1e3


def zoo_replays(run: Run, name: str, b: int, batches) -> dict:
    """Two fresh mesh models (one seed): 2 chunks of 4 `train_chunk` replays
    (the step captured with its all-reduces, the MoE count all-gathers and
    the replicated tables' gathers) against 8 eager steps under
    deterministic algorithms, every loss and tensor of the rank's state bit
    for bit; then 2 more chunks timed against as many eager steps, and a
    profiled chunk (kernel and NCCL kernel ms a step, busy share)."""
    eager, chunk = (zoo_model(run, name, b, run.mesh) for _ in range(2))
    stack, labels = stacks(batches)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_e = [eager.train_batch(*batches[i % 4]) for i in range(DETERMINISTIC_STEPS)]
        losses_g = [chunk.train_chunk(stack, labels) for _ in range(DETERMINISTIC_STEPS // 4)]
        run.sync()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = sorted(state_diff(eager, chunk))
    same = all(torch.equal(a, b_) for a, b_ in zip(losses_e[3::4], losses_g))
    run.sync()
    t0 = time.perf_counter()
    for i in range(8):
        loss = eager.train_batch(*batches[i % 4])
    float(loss)
    eager_ms = (time.perf_counter() - t0) / 8 * 1e3
    run.sync()
    t0 = time.perf_counter()
    for _ in range(2):
        loss = chunk.train_chunk(stack, labels)
    float(loss)
    graph_ms = (time.perf_counter() - t0) / 8 * 1e3
    mine = {"rank": run.mesh.rank, "tensors": len(state_tensors(eager)), "differing_tensors": diff,
            "losses_bit_identical": same, "captured": chunk._step_graph is not None or not run.cuda,
            "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms, **graph_kernels(run, chunk),
            **profile_steps(run, lambda: chunk.train_chunk(stack, labels), 4, graph_ms)}
    mine.pop("k1_kernel_nodes", None)
    res = {"steps": DETERMINISTIC_STEPS, "by_rank": run.gather(mine)}
    run.check(all(not r["differing_tensors"] and r["losses_bit_identical"] and r["captured"]
                  for r in res["by_rank"]), "replays against eager steps", res)
    del eager, chunk
    return res


def zoo_serve_on(run: Run, trained, b: int) -> dict:
    """moe_mlp `predict` of 4 global batches and a ragged part under
    use_pallas="on" (K6 on every Dense layer of each rank's block) against
    "auto", both on the mesh with the trained weights: K6 launches a rank,
    the outputs alike on every rank, and the rows within chip_smoke.py's
    E2E_ON_ATOL of "auto" (a gate near-tie that the bf16 rounding of K6's
    outputs flips routes a row to another expert: at most 1%)."""
    from ..ops.kernels.fused_mlp import fused_dense

    on, auto = (zoo_model(run, "moe_mlp", b, run.mesh, use_pallas=u) for u in ("on", "auto"))
    for m in (on, auto):
        m.set_parameters({n: trained.get_weights(n) for n in trained.get_parameters()})
    n = 4 * b + b // 8
    gen = torch.Generator(device=run.device).manual_seed(SEED + 62)
    x = torch.randn((n, 784), generator=gen, device=run.device).cpu().numpy()
    fused_dense.launches = 0
    run.sync()
    t0 = time.perf_counter()
    y_on = on.predict({"input": x})
    on_s = time.perf_counter() - t0
    k6 = fused_dense.launches
    y_auto = auto.predict({"input": x})
    within = np.abs(y_on - y_auto).max(axis=1) <= 2.0**-7
    mine = {"rank": run.mesh.rank, "k6_launches": k6, "digest": device_digest([torch.from_numpy(y_on)])}
    chunks = -(-n // b)
    res = {"examples": n, "chunks": chunks, "on_predict_s": on_s, "examples_per_s": n / on_s,
           "rows_within_atol": float(within.mean()), "atol": 2.0**-7,
           "max_abs_err_within": float(np.abs(y_on - y_auto)[within].max()), "by_rank": run.gather(mine)}
    want = ZOO_K6_A_CHUNK * chunks if run.cuda else 0
    run.check(all(r["k6_launches"] == want and r["digest"] == res["by_rank"][0]["digest"] for r in res["by_rank"])
              and np.isfinite(y_on).all() and y_on.shape == (n, 10) and res["rows_within_atol"] >= 0.99,
              "moe_mlp predict under 'on'", res)
    del on, auto
    return res


def zoo_check(run: Run, name: str) -> dict:
    """One zoo model on the data axis: eager steps (ms, busy share, NCCL
    kernel ms a step), every rank's replicated state against rank 0's bit
    for bit, the losses of every step against one card's model trained
    from the same weights on the same global batches (rank 0, after the
    mesh's models are freed; then its replays), replays bit for bit, and
    for moe_mlp serving under "on"."""
    mesh, args = run.mesh, run.args
    b = (ZOO_SMALL_BATCH if args.zoo_small else ZOO_BATCH)[name]
    steps = args.zoo_steps
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    model = zoo_model(run, name, b, mesh)
    w0 = {n: {k: v.copy() for k, v in model.get_weights(n).items()} for n in model.get_parameters()}
    batches = zoo_batches(run, name, model, b)
    losses, ms = zoo_train(run, model, batches, steps)
    gb = next((op for op in model.graph.compute_ops if type(op).__name__ == "GroupBy"), None)
    mine = {"rank": mesh.rank, "eager_ms_per_step": ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated(run.device) / 1e9 if run.cuda else "not measured (CPU)",
            **profile_steps(run, lambda: [model.train_batch(*batches[i]) for i in range(4)], 4, ms),
            **replicas_equal(run, model)}
    params = sum(p.numel() for sub in model.get_parameters().values() for p in sub.values())
    res = {"model": name, "global_batch": b, "batch_per_card": b // mesh.data_size, "parameters": params,
           "steps": steps, "eager_ms_per_step": ms, "eager_examples_per_s": b / ms * 1e3,
           "losses": losses, "by_rank": run.gather(mine)}
    if gb is not None:
        res["moe_capacity"] = gb.capacity
        res["count_all_gather_bytes_per_step"] = mesh.data_size * gb.n * 8
    if name == "nmt":
        # the replicated tables' gathers a step (parallel/replicated_tables.py):
        # each table's [B_loc, T] int32 ids and its [B_loc, T, D] f32 gradients
        d = model.get_layer_by_name("src_embed").out_dim
        t = sum(model.graph.inputs[i].outputs[0].shape[1] for i in range(2))
        res["replicated_table_gather_bytes_per_step"] = {"ids": b * t * 4, "gradients": b * t * d * 4}
    res["replicas_alike"] = not any(r["differing_from_rank_0"] for r in res["by_rank"])
    run.check(all(np.isfinite(losses)) and res["replicas_alike"], "losses and replicas", res)
    if name == "moe_mlp":
        res["serve_on"] = zoo_serve_on(run, model, b)
    del model
    if run.cuda:
        torch.cuda.empty_cache()
    res["replays"] = zoo_replays(run, name, b, batches)
    if run.cuda:
        torch.cuda.empty_cache()
    if mesh.rank == 0:
        one = zoo_model(run, name, b, None)
        for n, w in w0.items():
            one.set_weights(n, w)
        one_losses, one_ms = zoo_train(run_one(run), one, batches, steps)
        moved = np.concatenate([[0.0], np.cumsum(np.abs(np.diff(one_losses)))])
        tol = LOSS_ATOL + ZOO_MOVE_RTOL * moved
        err = np.abs(np.asarray(losses) - np.asarray(one_losses))
        # then one card's replays: a chunk of 4 to capture, 2 timed
        stack, labels = stacks(batches)
        float(one.train_chunk(stack, labels))
        t0 = time.perf_counter()
        for _ in range(2):
            loss = one.train_chunk(stack, labels)
        float(loss)
        one_graph_ms = (time.perf_counter() - t0) / 8 * 1e3
        graph_ms = float(np.mean([r["graph_ms_per_step"] for r in res["replays"]["by_rank"]]))
        res["one_card"] = {"losses": one_losses, "ms_per_step": one_ms, "examples_per_s": b / one_ms * 1e3,
                           "graph_ms_per_step": one_graph_ms, "graph_examples_per_s": b / one_graph_ms * 1e3,
                           "max_loss_err": float(err.max()), "max_err_over_tol": float((err / tol).max()),
                           "loss_atol": LOSS_ATOL, "move_rtol": ZOO_MOVE_RTOL}
        # global examples/s on the mesh over one card's at the global batch
        res["speedup_over_one_card"] = {"eager": one_ms / ms, "replayed": one_graph_ms / graph_ms}
        del one, stack, labels
        run.check(res["one_card"]["max_err_over_tol"] <= 1.0, "losses against one card", res)
    if run.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def run_one(run: Run) -> Run:
    """A view of `run` whose sync waits for this card alone (rank 0's one-
    card model runs while the other ranks wait at a barrier)."""
    one = Run.__new__(Run)
    one.__dict__.update(run.__dict__)
    one.sync = run.sync_device
    return one


EP = dict(d=784, h=64, k=2, alpha=2.0, tokens=16384)  # moe_mlp's widths, 16384 tokens a card
EP_REPS = 10


def ep_tolerance(dtype) -> dict:
    """{"out" | "grad": (rtol, atol, whether atol is a share of the
    oracle's largest magnitude)} of expert_parallel_ffn against
    reference_moe_ffn(shards=N). f32: tests/test_sharding.py's bounds (the
    same products in other orders), but w1's atol taken of its largest
    entry: at 16384 tokens a card an entry sums about 2^16 products that
    cancel to a small share of their magnitudes, so a summation order
    moves it by a share of the gradient's scale, not of the entry (the
    sharded path adds each expert's rows in one [N * C, D] product, the
    oracle in N). bf16: the sharded path rounds each expert's output y to
    bf16 before the combine, which the oracle does not (the JAX package's
    two functions differ so), and both round the combined output once: the
    forward within 2^-8 of the largest |out| plus 2^-7 relative (one step
    each of the two roundings); w1's gradient, whose cotangent carries the
    same rounding, within 2^-7 relative and 2^-7 of its largest entry."""
    if dtype == torch.float32:
        return {"out": (1e-4, 1e-5, False), "grad": (1e-3, 1e-4, True)}
    return {"out": (2.0**-7, 2.0**-8, True), "grad": (2.0**-7, 2.0**-7, True)}


def ep_check(run: Run, e: int, dtype) -> dict:
    """`expert_parallel_ffn` at moe_mlp's widths, E experts over the data
    group: the forward and w1's gradient (of the sum of the squared
    outputs) against `reference_moe_ffn(shards=N)` on rank 0, the dropped
    share, ms of the forward and backward, and each all-to-all's ms and
    GB/s (timed alone on its buffer: the bytes that leave a rank over the
    time)."""
    from ..parallel.expert_parallel import RANGES, _exchange, expert_parallel_ffn, moe_gate, reference_moe_ffn
    from ..ops.moe import dispatch, dispatch_slots, moe_capacity

    mesh, dev = run.mesh, run.device
    n = mesh.data_size
    d, h, k, alpha, t = (EP[key] for key in ("d", "h", "k", "alpha", "tokens"))
    if run.args.zoo_small:
        t = 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 70 + e)
    x = torch.randn((n * t, d), generator=gen, device=dev).to(dtype)
    gate_w = torch.randn((d, e), generator=gen, device=dev) * 0.05
    w1 = torch.randn((e, d, h), generator=gen, device=dev) * d**-0.5
    b1 = torch.randn((e, h), generator=gen, device=dev) * 0.1
    w2 = torch.randn((e, h, d), generator=gen, device=dev) * h**-0.5
    b2 = torch.randn((e, d), generator=gen, device=dev) * 0.1
    sl = mesh.batch_slice(n * t)
    e_loc = e // n
    sh = slice(mesh.data_index * e_loc, (mesh.data_index + 1) * e_loc)
    # the gate of the global batch on every rank (rank 0's oracle reads it
    # whole: a product of another M may round a near-tie the other way)
    gv_all, assign_all = moe_gate(x, gate_w, k)
    gv, assign = gv_all[sl], assign_all[sl]
    leaf = w1[sh].clone().requires_grad_(True)

    def step():
        out = expert_parallel_ffn(x[sl], gv, assign, leaf, b1[sh], w2[sh], b2[sh], mesh, alpha=alpha)
        (g,) = torch.autograd.grad(out.float().pow(2).sum(), [leaf])
        return out, g

    out, g = step()
    ms = cuda_ms(run, step)
    cap = moe_capacity(k, e, t, alpha)
    dest = dispatch_slots(assign, e, cap)
    dropped = torch.tensor([float((dest == e * cap).sum()), float(dest.numel())], device=dev)
    dist.all_reduce(dropped)
    buf = dispatch(x[sl], dest, e, cap)
    exchange = {}
    for name in RANGES:
        ex_ms = cuda_ms(run, lambda: _exchange(buf, mesh.data_group(), name), reps=20)
        sent = buf.numel() * buf.element_size() * (n - 1) / n
        exchange[name] = {"ms": ex_ms, "bytes_per_rank": buf.numel() * buf.element_size(),
                          "gb_per_s": sent / ex_ms / 1e6 if isinstance(ex_ms, float) else ex_ms}
    outs = torch.empty((n * t, d), dtype=out.dtype, device=dev)
    dist.all_gather_into_tensor(outs, out.detach().contiguous())
    grads = torch.empty((e,) + tuple(g.shape[1:]), dtype=g.dtype, device=dev)
    dist.all_gather_into_tensor(grads, g.contiguous())
    res = {"experts": e, "dtype": str(dtype).replace("torch.", ""), "tokens_per_card": t, "capacity": cap,
           "dropped_share": float(dropped[0] / dropped[1]), "fwd_bwd_ms": ms, "all_to_all": exchange}
    if mesh.rank == 0:
        w1_all = w1.clone().requires_grad_(True)
        want = reference_moe_ffn(x, gv_all, assign_all, w1_all, b1, w2, b2, alpha=alpha, shards=n)
        (want_g,) = torch.autograd.grad(want.float().pow(2).sum(), [w1_all])
        tol = ep_tolerance(dtype)
        over = {}
        for key, got, ref_ in (("out", outs, want), ("grad", grads, want_g)):
            rtol, atol, scaled = tol[key]
            got, ref_ = got.detach().float(), ref_.detach().float()
            if scaled:
                atol = atol * float(ref_.abs().max())
            over[key] = float(((got - ref_).abs() - rtol * ref_.abs()).max() / atol)
        res.update({"max_abs_err_out": float((outs.float() - want.float()).abs().max()),
                    "max_abs_err_grad": float((grads - want_g).abs().max()),
                    "max_abs_out": float(want.float().abs().max()), "max_abs_grad": float(want_g.abs().max()),
                    "max_err_over_tol": over, "tolerance": tol})
        run.check(max(over.values()) <= 1.0, "expert_parallel_ffn against the oracle", res)
    del x, w1, w2, out, g, outs, grads, buf
    if run.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def cuda_ms(run: Run, fn, reps: int = EP_REPS, warmup: int = 2):
    """ms a call of fn over `reps` calls, by CUDA events after `warmup`
    (every rank calls it: fn may run collectives)."""
    if not run.cuda:
        for _ in range(warmup):
            fn()
        return "not measured (CPU)"
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(run.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ the strategy search
SEARCH_FIELDS = ("table_assignment", "table_split", "replicated_tables", "exchange", "chips_per_host",
                 "host_tail_rows", "hash_rows", "packed_pool")
SEARCH_REPLAYS = 20


def plan_digest(plan) -> str:
    import hashlib

    doc = json.dumps({k: getattr(plan, k) for k in SEARCH_FIELDS}, sort_keys=True, default=str)
    return hashlib.sha256(doc.encode()).hexdigest()[:16]


def replays_ms(run: Run, model, stack, labels) -> float:
    """ms a step of SEARCH_REPLAYS `train_chunk` steps (chunks of 4) after
    one capturing chunk."""
    model.train_chunk(stack, labels)
    run.sync()
    t0 = time.perf_counter()
    for _ in range(SEARCH_REPLAYS // 4):
        loss = model.train_chunk(stack, labels)
    float(loss)
    return (time.perf_counter() - t0) / SEARCH_REPLAYS * 1e3


def default_prediction(cfg, default, machine) -> float:
    """The cost model's step (us) for the default plan's decisions: the
    fused tables at the default layout's owners, the others replicated, no
    split, no tensor parallelism, the dense exchange, on the search's
    machine and the unfused graph the search scores."""
    from ..autotune import bindings
    from ..autotune.search import graph_to_cost_spec_v2

    graph = make_dlrm_model(cfg, FFConfig(batch_size=cfg.batch_size), device="cpu").graph
    half = default.config.compute_dtype in ("bfloat16", "float16")
    ops, names, _, nd, _, _, op_edges = graph_to_cost_spec_v2(
        graph, cfg.batch_size, 2.0 if half else 4.0, dense_costs=machine.dense_costs,
        host_tail_hot=default.config.host_tail_threshold or (1 << 20), op_costs=machine.op_costs,
        table_dtype_bytes=2.0 if default.config.table_dtype == "bfloat16" else 4.0)
    coll = default._op("embedding_collection")
    owner_of = dict(zip(coll.table_names, coll.layout.owner))
    owner = [owner_of.get(n, 0) for n in names]
    mode = [0 if n in owner_of else 1 for n in names]
    return bindings.simulate2(machine.to_native(), ops, owner, [1] * len(names), mode, [1] * nd, 0.0,
                              op_edges=op_edges)


def search_check(run: Run) -> dict:
    mesh, dev, args = run.mesh, run.device, run.args
    b = args.batch_size
    cfg = kaggle_config(batch_size=b)
    cfg.embedding_size = [min(v, args.vocab_cap) for v in cfg.embedding_size]
    box = [tempfile.mkdtemp(prefix="mesh_smoke_search_") if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    strategy = f"{box[0]}/strategy.json"
    try:
        t0 = time.perf_counter()
        searched = kaggle_model(run, cfg, "sgd", mesh, search_budget=args.search_budget,
                                export_strategy_file=strategy)
        compile_s = time.perf_counter() - t0
        default = kaggle_model(run, cfg, "sgd", mesh)
        digests = run.gather(plan_digest(searched.plan))
        report = searched._search_report
        res = {"global_batch": b, "budget": args.search_budget, "compile_s": compile_s,
               "plan": {k: getattr(searched.plan, k) for k in SEARCH_FIELDS}, "plan_digest_by_rank": digests,
               "default_plan": {k: getattr(default.plan, k) for k in SEARCH_FIELDS},
               "report": {k: report[k] for k in ("best_us", "round_robin_us", "improvement", "tp_ops", "exchange",
                                                  "breakdown")}}
        run.check(len(set(digests)) == 1 and bool(searched.plan.table_assignment), "one plan on every rank", res)
        # the searched model starts from the default one's weights
        coll = default._op("embedding_collection")
        for name in coll.table_names + [n for n in default.get_parameters() if n != coll.name]:
            searched.set_weights(name, default.get_weights(name))
        batches = staged_batches(cfg, b, dev, SEED + 21)
        losses = {"searched": [], "default": []}
        for i in range(4):
            for tag, m in (("searched", searched), ("default", default)):
                losses[tag].append(float(m.train_batch(*batches[i])))
        res["losses"] = losses
        res["max_loss_err"] = max(abs(x - y) for x, y in zip(losses["searched"], losses["default"]))
        res["loss_atol"] = LOSS_ATOL
        run.check(res["max_loss_err"] <= LOSS_ATOL and all(np.isfinite(losses["searched"])), "losses", res)
        stack, labels = stacks(batches)
        res["replays_ms_per_step"] = {"searched": replays_ms(run, searched, stack, labels),
                                      "default": replays_ms(run, default, stack, labels)}
        res["replays_ms_by_rank"] = run.gather(res["replays_ms_per_step"])
        if mesh.rank == 0:
            machine = searched._search_machine(mesh)
            one = kaggle_model(run, cfg, "sgd", None)
            feeds, lbl = random_batches(cfg, b, seed=SEED + 21, learnable=False)
            # on the card the machine file the search calibrated (in the
            # temporary directory); on the CPU its cpu_sim machine, unsaved
            residual, one_us, one_pred = one.calibrate_step_residual(
                feeds, lbl, steps=8, machine=None if run.cuda else machine.torus_for(1),
                cache_path=searched.config.machine_cache_path() if run.cuda else "")
            del one
            pred = {"searched": report["best_us"], "default": default_prediction(cfg, default, machine)}
            res["one_card"] = {"measured_us": one_us, "predicted_us": one_pred, "residual": residual}
            res["predicted_ms_per_step"] = {k: v * residual / 1e3 for k, v in pred.items()}
            res["model_us"] = pred
            res["predicted_over_measured"] = {k: res["predicted_ms_per_step"][k] / res["replays_ms_per_step"][k]
                                              for k in pred}
            if run.cuda:
                from ..autotune.machine import physical_limits

                bad = [r for r in physical_limits(machine, searched.graph) if not r["ok"]]
                res["constants_beyond_the_card"] = bad
                run.check(not bad, "calibrated constants", res)
        del searched, default, batches
        if run.cuda:
            torch.cuda.empty_cache()
        dist.barrier()
        return res
    finally:
        if mesh.rank == 0:
            shutil.rmtree(box[0], ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL), or cpu (gloo) for a rehearsal")
    ap.add_argument("--batch-size", type=int, default=65536, help="the global batch")
    ap.add_argument("--steps", type=int, default=10, help="timed kaggle steps a rule")
    ap.add_argument("--vocab-cap", type=int, default=1 << 40, help="cap on every vocab (rehearsals)")
    ap.add_argument("--out", default="", help="rank 0 also writes its lines to this file")
    ap.add_argument("--hot", type=int, default=1 << 20, help="[mesh-full]: the rows a host-tail table keeps on a card")
    ap.add_argument("--full-steps", type=int, default=5, help="[mesh-full]: timed steps a rule")
    ap.add_argument("--phases", default=",".join(PHASES), help=f"a comma list of {','.join(PHASES)}")
    ap.add_argument("--zoo-steps", type=int, default=8, help="[mesh-zoo]: timed eager steps a model")
    ap.add_argument("--search-budget", type=int, default=2000, help="[mesh-search]: config.search_budget")
    ap.add_argument("--zoo-small", action="store_true",
                    help="[mesh-zoo], [mesh-ep]: a rehearsal's sizes (mnist_cnn for resnet, nmt small, few tokens)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"--phases: {sorted(set(phases) - set(PHASES))} not among {PHASES}")
    initialize(args.device)
    try:
        mesh = make_mesh(device=args.device)
        run = Run(args, mesh)
        if run.cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            if mesh.rank == 0:
                from .. import _build

                _build.build(_build.kernel_names())
            dist.barrier()
        run.log("[mesh-cards]", run.gather(card_line(run)))
        vocabs = kaggle_fused(args.vocab_cap)
        plan = dlrm_hybrid_plan()
        plan.packed_pool = run.cuda
        lay = plan.make_layout(vocabs, 16, mesh.size)
        run.log("[mesh-layout]", {"tables": vocabs, "owner": lay.owner, "t_max": lay.t_max, "r_pad": lay.r_pad,
                                  "pool_bytes_per_card_bf16": lay.hbm_bytes_per_shard(2),
                                  "step_exchange_bytes_bf16": lay.step_exchange_bytes(args.batch_size,
                                                                                      dtype_bytes=2)})
        if "exchange" in phases:
            for hierarchical in (False, True):
                run.log("[mesh-exchange]", exchange_check(run, vocabs, hierarchical))
        if "train" in phases:
            for rule in ("sgd", "adam"):
                run.log("[mesh-train]", train_check(run, rule))
        if "routed" in phases:
            run.log("[mesh-routed]", routed_check(run))
        if "checkpoint" in phases:
            run.log("[mesh-checkpoint]", checkpoint_check(run))
        if "mlperf-lite" in phases:
            run.log("[mesh-mlperf-lite]", mlperf_lite_check(run))
        if "dp" in phases:
            for rule in ("sgd", "adam"):
                run.log("[mesh-dp]", dp_check(run, rule))
        if "full" in phases:
            for rule in ("sgd", "adagrad"):
                run.log("[mesh-full]", full_check(run, rule))
        if "2d" in phases:
            if mesh.size != 4:
                raise SystemExit(f"--phases 2d runs on 4 ranks (a (2, 2) and a (1, 4) mesh), not {mesh.size}")
            mesh2 = make_mesh((2, 2), ("data", "model"), device=args.device)
            probe = run.gather(scatter_order_probe(run, args.batch_size // 2))
            run.log("[mesh-2d-scatter-order]", probe)
            run.check(all(p["index_add_rows_distinct"] == 1 for p in probe), "index_add_rows in one order", probe)
            for rule in ("sgd", "adam"):
                run.log("[mesh-2d]", twod_check(run, rule, mesh2, mesh))
            for rule in ("sgd", "adam"):
                run.log("[mesh-2d-dp]", dp_check(run, rule, mesh2, enable_parameter_parallel=True))
            for shape in ((2, 2), (1, 4)):
                m = mesh2 if shape == (2, 2) else make_mesh(shape, ("data", "model"), device=args.device)
                run.log("[mesh-2d-mlperf-lite]", mlperf_lite_check(run, m, enable_parameter_parallel=True))
        if "zoo" in phases:
            for name in ZOO_BATCH:
                run.log("[mesh-zoo]", zoo_check(run, name))
        if "ep" in phases:
            for e in (4, 8):
                for dtype in (torch.float32, torch.bfloat16):
                    run.log("[mesh-ep]", ep_check(run, e, dtype))
        if "search" in phases:
            run.log("[mesh-search]", search_check(run))
        run.log("", {"ok": True, "devices": mesh.size, "device": str(mesh.device.type), "phases": phases})
    except Exception:
        # a failed rank exits at once: the group's teardown would wait for
        # peers that wait on this rank in their next collective (the
        # launcher then stops them)
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
