"""Run one cell of the benchmark once and print its result's line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` a `breakdown`, and last `checks`, each number that decided
`correct` beside its limit; the same numbers are the last lines of
standard error. The run exits non-zero and prints no result without CUDA,
with fewer cards than the cell asks for, or when a module of JAX or of the
JAX package was loaded. A cell on several cards starts one process a card
through the port's launcher; rank 0 prints.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, for setup_s; before any heavy import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dlrm_flexflow_tpu")
START_ENV = "PERFBENCH_T_START"  # the launching process's start, for a cell's ranks


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name, compared whole, is
    JAX's or the JAX package's."""
    return sorted({n for n in (sys.modules if names is None else names) if n.split(".")[0] in FORBIDDEN})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap


def _launch(chips: int, argv) -> int:
    """The cell's ranks, one process a card, through the port's launcher."""
    env = dict(os.environ, **{START_ENV: repr(T_START)})
    cmd = [sys.executable, "-m", "dlrm_flexflow_tpu_torch.launch", "--nproc-per-node", str(chips),
           "-m", "benchmark.run", *argv]
    return subprocess.run(cmd, env=env, check=False).returncode


def _chips(workload: str) -> int:
    """The cards the cell asks for, read without importing torch."""
    spec = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
    return int({w["name"]: w for w in spec["workloads"]}[workload]["chips"])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    chips = _chips(args.workload)
    if chips > 1 and "RANK" not in os.environ:
        return _launch(chips, argv)  # each rank checks the cards; this process never imports torch
    import torch

    from . import harness

    t_import = harness.clock()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    mesh, t_start = None, T_START
    if cell.chips > 1:
        t_start = float(os.environ.get(START_ENV, T_START))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))  # before any context
    torch.cuda.init()
    print(f"# start (s): python and torch imports {t_import - T_START}, CUDA context "
          f"{harness.clock() - t_import}", file=sys.stderr, flush=True)
    if cell.chips > 1:
        mesh = cell.program().join_mesh()
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, mesh)
    if mesh is not None:
        cell.program().leave_mesh(mesh)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    if not line:  # a rank other than 0
        return 0
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
