"""Whole embedding tables in host RAM (the port's counterpart of
examples/host_offload_dlrm.py, on `training/host_offload.py`):
"terabyte-lite", an mlperf-style D=128 dot-interaction DLRM whose two
largest tables (40,790,948 + 3,067,956 rows, 22.5 GB in f32) live on the
host; the rest train on the device.

    python -m dlrm_flexflow_tpu_torch.examples.host_offload_dlrm [--device cpu] [--batch-size B]
        [--steps N] [--vocab-cap C] [--offload-threshold T]

Runs on the card unless `--device cpu` is given. `--vocab-cap` caps every
vocab and `--offload-threshold` is the vocab above which a table goes to
the host (1,000,000, as in the JAX package's example).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig
from dlrm_flexflow_tpu_torch.training.host_offload import HostOffloadTrainer, build_host_offload_dlrm

VOCAB = [40_790_948, 3_067_956, 405_282, 590_152, 12_973, 108, 36, 7_424]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch-size", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--vocab-cap", type=int, default=None)
    parser.add_argument("--offload-threshold", type=int, default=1_000_000)
    args = parser.parse_args(argv)
    bs = args.batch_size
    vocab = [min(v, args.vocab_cap) if args.vocab_cap else v for v in VOCAB]
    f = len(vocab) + 1
    cfg = DLRMConfig(sparse_feature_size=128, embedding_size=vocab, embedding_bag_size=1,
                     mlp_bot=[13, 512, 256, 128], mlp_top=[f * (f - 1) // 2 + 128, 1024, 512, 256, 1],
                     arch_interaction_op="dot", batch_size=bs)
    t0 = time.time()
    model, host_map = build_host_offload_dlrm(cfg, FFConfig(batch_size=bs, compute_dtype="bfloat16"),
                                              offload_threshold=args.offload_threshold, device=args.device)
    host_gb = sum(t.table.nbytes for t, _ in host_map.values()) / 1e9
    print(f"hosted tables: {len(host_map)} ({host_gb:.1f} GB in host RAM), init {time.time() - t0:.1f}s",
          flush=True)
    trainer = HostOffloadTrainer(model, host_map, lr=0.01).compile(
        SGDOptimizer(lr=0.01), LossType.LOSS_BINARY_CROSSENTROPY, [MetricsType.METRICS_ACCURACY])
    feeds, labels = random_batches(cfg, bs * 6, seed=0)
    t0 = time.time()
    loss0 = trainer.train_batch({k: v[:bs] for k, v in feeds.items()}, labels[:bs])
    print(f"first step: {time.time() - t0:.1f}s loss={loss0:.4f}", flush=True)
    t0 = time.time()
    loss = loss0
    for i in range(args.steps):
        sl = slice((i % 6) * bs, (i % 6 + 1) * bs)
        loss = trainer.train_batch({k: v[sl] for k, v in feeds.items()}, labels[sl])
    dt = time.time() - t0
    print(f"{args.steps} steps: {dt / args.steps * 1e3:.0f} ms/step, {bs * args.steps / dt:,.0f} examples/s, "
          f"loss={loss:.4f}", flush=True)
    return {"first_loss": loss0, "loss": loss, "examples_per_s": bs * args.steps / dt}


if __name__ == "__main__":
    main()
