"""The harness: finds a cell's files by name, runs it, and makes its line.

A cell is an entry of `workloads` in `BENCHMARK.json`. Everything that
belongs to one configuration, traffic mix, per-layer metric or cell lives
in files of its own, found by name under the benchmark's folder:

- `configs/<config>.json` (the configuration entry's `file`): the sizes,
  dtypes and `family`, which names `reference/<family>.py` (the plain
  reference), `programs/<family>.py` (how the program is driven) and
  `counts/<family>.py` (operations and bytes);
- `traffic/<traffic>.json`: the mix, whose `mode` names the runner,
  `train.py` or `serve.py`, that the general generator feeds;
- `metrics/<metric>.py`: one per-layer metric, a `read(t)` that returns a
  number or None when its source holds nothing;
- `limits/<workload>.json`: the limits of the numbers that decide
  `correct`.

So a later cell, configuration, mix or metric is added as files and
entries, and no file here changes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List

import torch

from . import counts as counts_pkg

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def family(self) -> str:
        return self.cfg["family"]

    def reference(self):
        return importlib.import_module(f"benchmark.reference.{self.family}")

    def program(self):
        return importlib.import_module(f"benchmark.programs.{self.family}")

    def counts(self):
        return importlib.import_module(f"benchmark.counts.{self.family}")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json, with its files read."""
    root = Path(root)
    spec = load_spec(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / spec["paths"][0]
    return Cell(
        name=name, chips=int(w["chips"]),
        cfg=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        root=bench,
    )


def load_reader(cell: Cell, metric: str) -> Callable:
    path = cell.root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Device:
    """Synchronisation and memory on the run's device; on the CPU (tests
    only) each is a no-op or zero."""

    def __init__(self, device: str):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.phases = Phases()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def event(self):
        """A marker recorded on the current stream now, whose `wait()` blocks
        until the work before it is done."""
        if not self.cuda:
            return SimpleNamespace(wait=lambda: None)
        ev = torch.cuda.Event()
        ev.record()
        return SimpleNamespace(wait=ev.synchronize)

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def kind(self) -> str:
        return torch.cuda.get_device_name() if self.cuda else "cpu"

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def profiler(dev: Device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.cuda else [])
    return profile(activities=acts)


class SourceMissing(RuntimeError):
    """A per-layer metric of the cell found nothing to read on the card."""


def per_layer(cell: Cell, dev: Device, ranks: List[dict], facts: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell read from the traced stretch's
    summaries (one a rank). Every metric listed for the cell has to find
    its source on the card: one that finds nothing (a kernel renamed, a
    span gone) fails the run. On the CPU, where there is no device trace,
    such a metric is left out."""
    t = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, chips=cell.chips, counts=cell.counts(),
                        peaks=counts_pkg.peaks(dev.kind()), ranks=ranks, **facts)
    out, missing = {}, []
    for m in cell.per_layer:
        value = load_reader(cell, m["name"])(t)
        if value is None:
            missing.append(m["name"])
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if missing and dev.cuda:
        raise SourceMissing(f"per-layer metrics whose source held nothing in this traced run: {missing}")
    for name in missing:
        print(f"# per-layer metric {name}: no device trace on the CPU; left out", flush=True, file=sys.stderr)
    return out


def end_to_end(cell: Cell, values: Dict[str, float]) -> Dict[str, dict]:
    """The cell's end-to-end metrics from the runner's values. A metric
    named `<quantity>.<qualifier>` reports the runner's `<quantity>`: the
    qualifier gives one kind of cell a bound of its own."""
    return {m["name"]: {"value": float(values[m["name"].split(".")[0]]), "unit": m["unit"]}
            for m in cell.end_to_end}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        mesh=None) -> dict:
    """One run of the cell: its mode's runner, then the result's line
    (without the chip checks and the import check, which `run.py` adds)."""
    dev = Device(device)
    runner = importlib.import_module(f"benchmark.{cell.mix['mode']}")
    out = runner.run(cell, seed, seconds, trace, dev, t_start, mesh)
    if mesh is not None and mesh.rank != 0:
        return {}
    dev.phases.report()
    from .checks import judge

    correct, compared = judge(out["numbers"], cell.limits)
    line = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": out["per_layer"] if trace else end_to_end(cell, out["end_to_end"]),
        "device": {"platform": "gpu" if dev.cuda else "cpu", "kind": dev.kind(), "count": cell.chips,
                   "memory_peak_bytes": int(out["peak_bytes"])},
    }
    if trace:
        line["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    line["checks"] = compared
    return line


def clock() -> float:
    return time.perf_counter()


class Phases:
    """Seconds by phase of one run, printed on standard error at its end."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = clock()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + clock() - t

    def report(self) -> None:
        print("# phases (s): " + json.dumps(self.seconds), file=sys.stderr, flush=True)


def finite(x):
    """JSON-safe: a float that is not finite becomes its name."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def window_facts(summaries: List[dict]) -> dict:
    """busy_s and window_s averaged over the ranks."""
    n = len(summaries)
    return {"busy_s": sum(s["busy_s"] for s in summaries) / n,
            "window_s": sum(s["window_s"] for s in summaries) / n}
