"""DLRM training entry point (the port's counterpart of examples/dlrm.py,
reference: examples/cpp/DLRM/dlrm.cc:77-260), in the reference's flag
spelling:

    python -m dlrm_flexflow_tpu_torch.examples.dlrm -e 1 -b 8192 --arch-embedding-size 1396-550-...
        --arch-mlp-bot 13-512-256-64-16 --arch-mlp-top 224-512-256-1 --arch-sparse-feature-size 16
        [--dataset data.h5 | --data-size N] [--device cpu]
    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m dlrm_flexflow_tpu_torch.examples.dlrm
        --mesh 4 --budget 1000 --export strategy.json ...    # search, export the strategy
        ... --import strategy.json                            # start from an exported strategy

Runs on the card unless `--device cpu` is given (a gloo group under the
launcher). With more than one rank, or `--mesh`, it joins the group
(`launch.initialize`), makes the mesh of `--mesh` and `--mesh-axes`
(`make_mesh`) and compiles under `dlrm_hybrid_plan()`; `--budget` runs the
strategy search there, `--export` writes the plan (rank 0), `--import`
reads one. `--dataset` reads a Criteo .h5 or .npz (`data/criteo.py`), else
`--data-size` examples are made from the seed. Prints the reference's
`THROUGHPUT = ...` line.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

from dlrm_flexflow_tpu_torch import FFConfig, LossType, MetricsType, SGDOptimizer
from dlrm_flexflow_tpu_torch.data.synthetic import random_batches
from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, make_dlrm_model


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    cfg = FFConfig()
    rest = cfg.update_from_args(argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--data-size", type=int, default=None, help="default: 64 batches")
    args, rest = parser.parse_known_args(rest)
    dlrm_cfg = DLRMConfig.parse_args(rest)
    dlrm_cfg.batch_size = cfg.batch_size

    mesh = plan = None
    if cfg.mesh_shape is not None or int(os.environ.get("WORLD_SIZE", 1)) > 1:
        from dlrm_flexflow_tpu_torch.launch import initialize
        from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
        from dlrm_flexflow_tpu_torch.parallel.plan import dlrm_hybrid_plan

        initialize(args.device)
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        plan = dlrm_hybrid_plan()
    model = make_dlrm_model(dlrm_cfg, cfg, device=args.device)
    model.compile(SGDOptimizer(lr=cfg.learning_rate, weight_decay=cfg.weight_decay),
                  LossType.LOSS_BINARY_CROSSENTROPY,
                  [MetricsType.METRICS_ACCURACY, MetricsType.METRICS_AUC_ROC], mesh=mesh, plan=plan)
    if cfg.dataset_path:
        from dlrm_flexflow_tpu_torch.data.criteo import load_criteo

        feeds, labels, _ = load_criteo(cfg.dataset_path, dlrm_cfg.num_tables)
    else:
        feeds, labels = random_batches(dlrm_cfg, args.data_size or cfg.batch_size * 64, seed=cfg.seed)
    hist = model.fit(feeds, labels, epochs=cfg.epochs, verbose=True)
    print(f"THROUGHPUT = {hist['throughput']:.2f} samples/s "
          f"(first epoch {hist.get('first_epoch_time_s', 0):.1f}s)")
    return hist


if __name__ == "__main__":
    main()
