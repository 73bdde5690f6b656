"""A copy of the benchmark with tiny cells added from new files alone, for
tests on the CPU: the real configurations' families and mixes at a few
thousand rows and a batch of 256."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

TRAIN = "tiny-train-zipf"
SERVE = "tiny-serve-offline"
TRAIN4 = "tiny-train-zipf-4x"
TRAIN_LIMITS = {"grad_gap": 0.6, "grad_gap_median": 0.018, "change_gap_median": 0.024,
                "rounded_grad_gap_median": 0.1}
SERVE_LIMITS = {"prob_excess": 0.004}  # the tiny widths round otherwise than the real cell


def make(tmp: Path, extra_metric: str = "") -> Path:
    """`tmp` holding BENCHMARK.json and the benchmark's folder, plus a tiny
    training cell and a tiny serving cell (new config, traffic, limits
    files and new entries) and, if named, a new per-layer metric file that
    reads the traced stretch's length for the training cell."""
    root = Path(tmp)
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    vocabs = [100, 20000, 30, 9000, 5000, 12000]
    kag = json.loads((b / "configs" / "dlrm-kaggle.json").read_text())
    kag.update(vocab_sizes=vocabs, mlp_bot=[13, 64, 32, 16], mlp_top=[16 * 7, 64, 32, 1])
    dot = json.loads((b / "configs" / "dlrm-mlperf-lite.json").read_text())
    dot.update(vocab_sizes=vocabs, mlp_bot=[13, 64, 128], mlp_top=[21 + 128, 64, 1])
    (b / "configs" / "dlrm-tiny-cat.json").write_text(json.dumps(kag))
    (b / "configs" / "dlrm-tiny-dot.json").write_text(json.dumps(dot))
    mix = json.loads((b / "traffic" / "train-zipf.json").read_text())
    # on the CPU the row-update route engages only when forced
    mix.update(batch_size=256, distinct_batches=4, packed_tables="on")
    (b / "traffic" / "tiny-train.json").write_text(json.dumps(mix))
    hyb = json.loads((b / "traffic" / "train-zipf-hybrid.json").read_text())
    hyb.update(batch_size=256, distinct_batches=4, packed_tables="on")
    (b / "traffic" / "tiny-train-hybrid.json").write_text(json.dumps(hyb))
    srv = json.loads((b / "traffic" / "serve-offline.json").read_text())
    srv.update(batch_size=256, request_examples=256, pool_requests=3)
    (b / "traffic" / "tiny-serve.json").write_text(json.dumps(srv))
    (b / "limits" / f"{TRAIN}.json").write_text(json.dumps(TRAIN_LIMITS))
    (b / "limits" / f"{SERVE}.json").write_text(json.dumps(SERVE_LIMITS))
    (b / "limits" / f"{TRAIN4}.json").write_text(json.dumps(TRAIN_LIMITS))
    spec["configs"] += [
        {"name": "dlrm-tiny-cat", "source": "test", "file": "benchmark/configs/dlrm-tiny-cat.json",
         "reduced": ["vocab_sizes"], "why": "test"},
        {"name": "dlrm-tiny-dot", "source": "test", "file": "benchmark/configs/dlrm-tiny-dot.json",
         "reduced": ["vocab_sizes"], "why": "test"}]
    spec["workloads"] += [
        {"name": TRAIN, "config": "dlrm-tiny-cat", "traffic": "tiny-train", "chips": 1, "why": "test"},
        {"name": SERVE, "config": "dlrm-tiny-dot", "traffic": "tiny-serve", "chips": 1, "why": "test"},
        {"name": TRAIN4, "config": "dlrm-tiny-cat", "traffic": "tiny-train-hybrid", "chips": 4, "why": "test"}]
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [TRAIN] if "kaggle-train-zipf" in m["workloads"] else []
            m["workloads"] += [TRAIN4] if "kaggle-train-zipf-4x" in m["workloads"] else []
            m["workloads"] += [SERVE] if "mlperf-lite-serve-offline" in m["workloads"] else []
    if extra_metric:
        (b / "metrics" / f"{extra_metric}.py").write_text(
            '"""The traced stretch\'s length in ms."""\n\n\ndef read(t):\n'
            '    return 1e3 * t.window_s if t.window_s > 0 else None\n')
        spec["per_layer"].append({"name": extra_metric, "unit": "ms", "better": "lower",
                                  "source": "program_span", "layer": "test", "moves": "setup_s",
                                  "workloads": [TRAIN]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
