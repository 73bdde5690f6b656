"""The hybrid-parallel path on several cards, held against one card.

    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m dlrm_flexflow_tpu_torch.tools.mesh_smoke
    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m dlrm_flexflow_tpu_torch.tools.mesh_smoke \\
        --device cpu --batch-size 256 --vocab-cap 20000 --steps 2      # a rehearsal on gloo, small

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
  [mesh-train]    `--steps` kaggle steps (after 2 warm-up steps) under SGD
                  and Adam: the losses of every step against one card's
                  model trained on the same batches from the same weights
                  (rank 0, the single-table row-update route), examples/s
                  global and a card, row-update launches a rank and step,
                  the exchange's GB/s, peak memory a rank, kernel ms and
                  busy share a rank from torch.profiler;
  [mesh-mlperf-lite] `predict` of 4 global batches and a ragged one, then 3
                  train steps, K3 (dot_interaction) and K1 launches a rank.

The weights are random, from seeds; the indices uniform, the labels noise.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import AdamOptimizer, FFConfig, LossType, MetricsType, SGDOptimizer
from ..data.synthetic import random_batches
from ..ffconst import AggrMode
from ..launch import initialize
from ..models.dlrm import kaggle_config, make_dlrm_model, mlperf_lite_config
from ..ops.embedding import embedding_bag
from ..ops.kernels.dot_interaction import dot_interaction
from ..ops.kernels.row_update import row_update, row_update_adam
from ..parallel import embedding_collection as pec
from ..parallel.mesh import make_mesh
from ..parallel.plan import dlrm_hybrid_plan

SEED = 0
WARMUP, PROFILED = 2, 3
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

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
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
    got = torch.empty((b,) + tuple(out.shape[1:]), dtype=out.dtype, device=dev)
    dist.all_gather_into_tensor(got, out.contiguous())
    opt = SGDOptimizer(lr=0.01)
    row_update.launches = 0
    pec.sharded_embedding_sparse_update(lay, pool, None, idx[sl], g[sl], mesh, opt)
    launches = run.gather(row_update.launches)
    shards = torch.empty((n * lay.r_pad, d), dtype=dtype, device=dev)
    dist.all_gather_into_tensor(shards, pool.contiguous())
    res = {"hierarchical": lay.hierarchical, "owner": lay.owner, "t_max": lay.t_max, "r_pad": lay.r_pad,
           "row_update_launches_by_rank": launches}
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


def kaggle_model(run: Run, cfg, rule: str, mesh):
    model = make_dlrm_model(cfg, FFConfig(batch_size=cfg.batch_size, seed=SEED, compute_dtype="bfloat16",
                                          table_dtype="bfloat16"), device=run.device)
    opt = AdamOptimizer(alpha=0.001) if rule == "adam" else SGDOptimizer(lr=0.01)
    model.compile(opt, LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY], mesh=mesh,
                  plan=dlrm_hybrid_plan() if mesh is not None else None)
    return model


def profile_steps(run: Run, model, batches, ms_per_step: float) -> dict:
    """Kernel ms a step and the busy share of the unprofiled step, from
    torch.profiler over a few steps. The NCCL kernels are summed apart:
    a collective's kernel runs from its launch until the slowest rank
    joins, so its time holds the wait for the peers; the profiler's
    "nccl:*" rows repeat their time and are left out."""
    if not run.cuda:
        return {"kernel_ms_per_step": "not measured (CPU)"}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED):
            model.train_batch(*batches[i % len(batches)])
        torch.cuda.synchronize(run.device)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset", "step:", "nccl:"))]
    per_step = {e.key: e.self_device_time_total / 1e3 / PROFILED for e in kernels}
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
    feeds, labels = random_batches(cfg, 4 * b, seed=SEED + 1, learnable=False)
    batches = [({k: torch.as_tensor(v[j * b:(j + 1) * b]).to(dev) for k, v in feeds.items()},
                torch.as_tensor(labels[j * b:(j + 1) * b]).to(dev)) for j in range(4)]
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
    prof = profile_steps(run, model, batches, ms)
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
    del model, one, batches
    if run.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def mlperf_lite_check(run: Run) -> dict:
    mesh, dev, args = run.mesh, run.device, run.args
    b = args.batch_size
    cfg = mlperf_lite_config(batch_size=b, vocab_cap=min(2_000_000, args.vocab_cap))
    model = make_dlrm_model(cfg, FFConfig(batch_size=b, seed=SEED, compute_dtype="bfloat16",
                                          table_dtype="bfloat16"), device=dev)
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
    losses = [float(model.train_batch({k: v[i * b:(i + 1) * b] for k, v in feeds.items()},
                                      labels[i * b:(i + 1) * b])) for i in range(3)]
    mine = {"rank": mesh.rank, "k3_predict": k3_predict, "k3_train": dot_interaction.launches,
            "row_update_train": row_update.launches, "predict_s": predict_s}
    by_rank = run.gather(mine)
    res = {"fused_tables": len(coll.table_names), "t_max": coll.layout.t_max, "r_pad": coll.layout.r_pad,
           "pool_dtype": str(model.get_parameters()[coll.name]["pool"].dtype), "predicted": list(y.shape),
           "predict_in_0_1": bool(np.all((y > 0) & (y < 1))), "losses": losses, "by_rank": by_rank}
    want = (5, 3, 3) if run.cuda else (0, 0, 0)
    run.check(res["predict_in_0_1"] and y.shape == (4 * b + 1000, 1) and all(np.isfinite(losses))
              and all((r["k3_predict"], r["k3_train"], r["row_update_train"]) == want for r in by_rank),
              "mlperf-lite", res)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL), or cpu (gloo) for a rehearsal")
    ap.add_argument("--batch-size", type=int, default=65536, help="the global batch")
    ap.add_argument("--steps", type=int, default=10, help="timed kaggle steps a rule")
    ap.add_argument("--vocab-cap", type=int, default=1 << 40, help="cap on every vocab (rehearsals)")
    ap.add_argument("--out", default="", help="rank 0 also writes its lines to this file")
    args = ap.parse_args(argv)
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
        for hierarchical in (False, True):
            run.log("[mesh-exchange]", exchange_check(run, vocabs, hierarchical))
        for rule in ("sgd", "adam"):
            run.log("[mesh-train]", train_check(run, rule))
        run.log("[mesh-mlperf-lite]", mlperf_lite_check(run))
        run.log("", {"ok": True, "devices": mesh.size, "device": str(mesh.device.type)})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
