"""Time eager train steps of one checkout of the port.

    python dlrm_flexflow_tpu_torch/tools/eager_step_ab.py [--root DIR] [--label NAME]

Prints one JSON line: kaggle at batch 65536 (`chip_smoke.py`'s model and
its 4 staged batches, SGD), 5 warm-up `train_batch` steps, then 3 runs of
20 eager steps, ms a step by the host's clock (each run ends on a readback
of its last loss); and the host time of one `torch.profiler.record_function`
range with no profiler on, the cost of each phase range the eager step
opens. `--root` imports the port from another checkout, such as an
unpacked `git archive` of an earlier commit, so that two versions can be
timed in turns on one card, each in its own process.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
RANGES = 100_000


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--label", default="", help="a name printed with the result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("eager_step_ab: no CUDA device is available")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    sys.path.insert(0, str(args.root.resolve()))  # the port comes from --root
    from dlrm_flexflow_tpu_torch.models.dlrm import kaggle_config
    from torch.profiler import record_function

    cfg = kaggle_config(batch_size=smoke.TRAIN_BATCH)
    model = smoke.kaggle_model(cfg, smoke.TRAIN_BATCH, smoke.SEED)
    _, staged = smoke.kaggle_batches(model, cfg)
    for i in range(5):
        model.train_batch(*staged[i % 4])
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(20):
            loss = model.train_batch(*staged[i % 4])
        float(loss)
        runs.append((time.perf_counter() - t0) / 20 * 1e3)
    t0 = time.perf_counter()
    for _ in range(RANGES):
        with record_function("step:probe"):
            pass
    range_us = (time.perf_counter() - t0) / RANGES * 1e6
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "root": str(args.root), "card": smi,
                      "eager_ms_per_step": runs, "record_function_us": range_us}), flush=True)


if __name__ == "__main__":
    main()
