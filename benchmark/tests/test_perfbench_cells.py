"""Whole runs of tiny cells on the CPU: the import checks, a cell made of
new files alone, the control and the faults that `correct` must catch."""
import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import tinycell

REPO = harness.ROOT


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycell.make(tmp_path_factory.mktemp("bench"), extra_metric="traced_ms.tiny")


def run(root, name, trace=False, seconds=0.5, seed=2**31 + 7):
    return harness.run(harness.load_cell(name, root), seed, seconds, trace, "cpu", harness.clock())


@pytest.mark.parametrize("name", [tinycell.TRAIN, tinycell.SERVE])
def test_command_path_loads_no_jax(root, name):
    """Each cell's command path, run in a fresh process, loads no module
    whose top-level name is jax, jaxlib, flax or the JAX package's."""
    code = (
        "import sys, json; from benchmark import harness, run as r; "
        f"c = harness.load_cell({name!r}, {str(root)!r}); "
        "line = harness.run(c, 3, 0.3, False, 'cpu', harness.clock()); "
        "print(json.dumps({'found': r.forbidden_modules(), 'correct': line['correct']}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(root)})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"found": [], "correct": True}


def test_forbidden_names_compare_whole():
    from benchmark.run import forbidden_modules

    names = ["dlrm_flexflow_tpu_torch", "dlrm_flexflow_tpu_torch.core", "jaxtyping", "flax_like",
             "jax.numpy", "jaxlib", "flax.linen", "dlrm_flexflow_tpu", "dlrm_flexflow_tpu.core"]
    assert forbidden_modules(names) == ["dlrm_flexflow_tpu", "dlrm_flexflow_tpu.core", "flax.linen",
                                        "jax.numpy", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.dlrm, benchmark.counts.dlrm, "
            "benchmark.traffic.generator, benchmark.checks; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'dlrm_flexflow_tpu_torch', 'dlrm_flexflow_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("dlrm_flexflow_tpu") for n in names), path


def test_a_cell_from_new_files_alone(root):
    """The tiny cells, their config, traffic and limits files and the
    `traced_ms.tiny` metric exist only in the copy: the harness finds them
    by name, and the traced run reports the new metric."""
    line = run(root, tinycell.TRAIN, trace=True)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"traced_ms.tiny"}  # the device metrics find no device trace here
    assert line["metrics"]["traced_ms.tiny"]["value"] > 0
    assert list(line)[-1] == "checks"
    plain = run(root, tinycell.TRAIN)
    assert set(plain["metrics"]) == {"setup_s", "train_examples_per_s", "peak_mem_gib"}
    served = run(root, tinycell.SERVE)
    assert served["correct"] is True, served["checks"]
    assert set(served["metrics"]) == {"setup_s", "serve_examples_per_s", "peak_mem_gib"}


def test_control_fails_the_limits(root):
    """The reference in float8 in the program's place, and each planted
    training fault, fail a limit of the cell; the program's own readings
    pass them; on three seeds."""
    for name, limits in ((tinycell.TRAIN, tinycell.TRAIN_LIMITS), (tinycell.SERVE, tinycell.SERVE_LIMITS)):
        cell = harness.load_cell(name, root)
        mode = calibrate.train_readings if cell.mix["mode"] == "train" else calibrate.serve_readings
        rows = [r for r in mode(cell, [1, 2, 3], harness.Device("cpu")) if r["side"] != "reference"]
        assert {r["side"] for r in rows} >= {"program", "control"}
        for r in rows:
            over = any(r[k] > limit for k, limit in limits.items())
            assert over is (r["side"] != "program"), r


@pytest.fixture
def broken(monkeypatch):
    """Plants a fault under the timed path of the port."""
    from dlrm_flexflow_tpu_torch.core import ffmodel

    def plant(kind):
        if kind in ("frozen", "frozen_rows"):  # a step that returns its state (or its rows) unchanged
            if kind == "frozen":
                monkeypatch.setattr(ffmodel.FFModel, "_dense_update", lambda self, g, state, p, s: state)
            monkeypatch.setattr(ffmodel, "apply_sparse_updates", lambda ops, p, xs, g, opt, st, ctx, **kw: st)
        elif kind == "half_batch":  # half of the batch left out, the mean over the rest
            real = ffmodel.losses_lib.compute_loss

            def half(loss_type, logits, labels):
                n = logits.shape[0] // 2
                return real(loss_type, logits[:n], labels[:n])

            monkeypatch.setattr(ffmodel.losses_lib, "compute_loss", half)
        elif kind == "altered":  # one answer altered where it is produced
            real_predict = ffmodel.FFModel.predict

            def predict(self, feeds, batch_size=None):
                out = real_predict(self, feeds, batch_size)
                out[0] = 1.0 - out[0]
                return out

            monkeypatch.setattr(ffmodel.FFModel, "predict", predict)
    return plant


@pytest.mark.parametrize("name,kind", [(tinycell.TRAIN, "frozen"), (tinycell.TRAIN, "frozen_rows"),
                                       (tinycell.TRAIN, "half_batch"), (tinycell.SERVE, "altered")])
def test_a_broken_timed_path_is_not_correct(root, broken, name, kind):
    broken(kind)
    line = run(root, name)
    assert line["correct"] is False, line["checks"]
    if kind == "frozen_rows":  # only the rows the storage rounds are left: the rounded leaves' number fails
        failing = {k for k, c in line["checks"].items() if not c["value"] <= c["limit"]}
        assert failing == {"rounded_grad_gap_median"}, line["checks"]


@pytest.mark.parametrize("fault", ["", "no_exchange"])
def test_four_ranks_on_the_cpu(root, fault):
    """The four-card cell's path (the launcher, one process a rank, the
    sharded tables, the exchange) at a tiny size over gloo: correct against
    the one-card reference, loading no JAX; with the exchange of the dense
    gradients left out, not correct."""
    out = subprocess.run([sys.executable, "-m", "dlrm_flexflow_tpu_torch.launch", "--nproc-per-node", "4",
                          "-m", "benchmark.tests.ranks_cpu", str(root), tinycell.TRAIN4, fault],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    found, line = [json.loads(x) for x in out.stdout.strip().splitlines()[-2:]]
    assert found == {"found": []}
    assert line["device"]["count"] == 4
    assert line["correct"] is (fault == ""), line["checks"]


@pytest.mark.cuda
def test_kaggle_cell_on_the_card():
    """The real training cell, briefly, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "kaggle-train-zipf",
                          "--seed", "12345", "--seconds", "2", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
