"""The per-layer metrics that read the program's own spans and step phases
(`benchmark/spans.py`, `metrics/<name>.py`), run in tiny cells on the CPU.

Their entries, as `per_layer` would hold them, are in `span_metrics.json`
beside this file: `harness.per_layer` fails a traced run on the card when a
listed metric reads nothing, so a checkout without the spans cannot run a
cell that lists them. The tiny copy's BENCHMARK.json alone lists them, each
with the tiny cell of its real cell too. On the CPU the step phases are
timed by the host's clock at the same boundaries as the card's stamps."""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness, spans
from benchmark.tests import tinycell

REPO = harness.ROOT
ENTRIES = json.loads((Path(__file__).parent / "span_metrics.json").read_text())
TINY = {"kaggle-train-zipf": tinycell.TRAIN, "mlperf-lite-serve-offline": tinycell.SERVE,
        "kaggle-train-zipf-4x": tinycell.TRAIN4}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tinycell.make(tmp_path_factory.mktemp("bench"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"] += [dict(e, workloads=e["workloads"] + [TINY[w] for w in e["workloads"]])
                          for e in ENTRIES]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def _names(cell):
    return {e["name"] for e in ENTRIES if TINY[e["workloads"][0]] == cell}


def _traced(root, name):
    from dlrm_flexflow_tpu_torch.utils.profiling import reset_spans

    reset_spans()  # the registry is process-wide: earlier tests fill it
    return harness.run(harness.load_cell(name, root), 2**31 + 5, 0.5, True, "cpu", harness.clock())


def test_entries_are_well_formed():
    names = [e["name"] for e in ENTRIES]
    assert len(names) == len(set(names)) == 10
    for e in ENTRIES:
        assert set(e) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["source"] == "program_span" and e["unit"] == "ms" and e["better"] == "lower"
        assert (harness.HERE / "metrics" / f"{e['name']}.py").is_file()
        assert set(e["workloads"]) <= set(TINY)


@pytest.mark.parametrize("cell", [tinycell.TRAIN, tinycell.SERVE])
def test_a_traced_run_reads_each_span_metric(root, cell):
    line = _traced(root, cell)
    assert line["correct"] is True, line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    want = _names(cell)
    assert want <= set(got), (want, got)
    assert all(got[k] > 0 for k in want), got


def test_the_serving_split_adds_up_to_the_calls(root):
    """stage + execute + readback + predict's self time is the `predict`
    span's host time; a reader's ms a call leave out each span's first."""
    _traced(root, tinycell.SERVE)
    tot = spans.totals()
    parts = sum(tot[n]["host_s"] for n in ("forward:stage", "forward:execute", "predict:readback"))
    assert parts + tot["predict"]["self_s"] == pytest.approx(tot["predict"]["host_s"], rel=1e-9)
    assert tot["predict"]["count"] > 1
    first = sum(tot[n]["first_s"] for n in ("forward:stage", "forward:execute", "predict:readback"))
    steady = sum(spans.ms_per([n], "host_s", "predict") for n in
                 ("forward:stage", "forward:execute", "predict:readback"))
    assert steady == pytest.approx(1e3 * (parts - first) / (tot["predict"]["count"] - 1), rel=1e-9)


def test_four_ranks_read_rank_zeros_phases(root):
    out = subprocess.run([sys.executable, "-m", "dlrm_flexflow_tpu_torch.launch", "--nproc-per-node", "4",
                          "-m", "benchmark.tests.ranks_cpu_traced", str(root), tinycell.TRAIN4],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = _names(tinycell.TRAIN4)
    assert want <= set(line["metrics"]) and all(line["metrics"][k]["value"] > 0 for k in want)


def test_a_program_without_spans_gives_nothing_to_read(monkeypatch):
    """A checkout older than the spans: each reader returns None (the line
    leaves the metric out) and raises nothing."""
    monkeypatch.setitem(sys.modules, "dlrm_flexflow_tpu_torch.utils.profiling", None)
    assert spans.totals() is None
    cell = SimpleNamespace(root=harness.HERE)
    for e in ENTRIES:
        for mode in ("train", "serve"):
            assert harness.load_reader(cell, e["name"])(SimpleNamespace(mode=mode, chips=1)) is None
