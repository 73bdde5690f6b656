"""The DLRM-DCNv2 family on the CPU: a tiny cell of its configuration and
multi-hot mix (`train_multihot.py`), made of new files in a copy of the
benchmark; its control and planted faults caught; its counts."""
import json

import pytest

from benchmark import calibrate_large, harness, train_multihot
from benchmark.counts import dcnv2 as counts
from benchmark.tests import tinycell
from benchmark.traffic import generator

CELL = "tiny-dcnv2-multihot"
# tiny widths round otherwise than the real cell: limits between the
# program's readings here (medians 0.0005-0.0036, 0.0013-0.0018) and the
# float8 control's (0.0096-0.017, 0.024-0.036)
LIMITS = {"grad_gap": 0.6, "grad_gap_median": 0.008, "change_gap_median": 0.012,
          "rounded_grad_gap_median": 0.1}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tinycell.make(tmp_path_factory.mktemp("bench"))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "dlrm-dcnv2.json").read_text())
    cfg.update(vocab_sizes=[50, 20000, 30, 9000], embedding_bag_size=[3, 1, 5, 2], sparse_feature_size=16,
               mlp_bot=[13, 32, 16], mlp_top=[80, 32, 1], dcn_num_layers=2, dcn_low_rank_dim=8)
    (b / "configs" / "dlrm-tiny-dcnv2.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "train-multihot-zipf.json").read_text())
    mix.update(batch_size=256, packed_tables="on")  # on the CPU the row-update route engages only when forced
    (b / "traffic" / "tiny-multihot.json").write_text(json.dumps(mix))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dlrm-tiny-dcnv2", "source": "test",
                            "file": "benchmark/configs/dlrm-tiny-dcnv2.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "dlrm-tiny-dcnv2", "traffic": "tiny-multihot",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "dcnv2-train-multihot" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def _run(root, trace=False):
    from dlrm_flexflow_tpu_torch.utils.profiling import reset_spans

    reset_spans()  # the registry is process-wide: earlier tests fill it
    return harness.run(harness.load_cell(CELL, root), 2**31 + 11, 0.5, trace, "cpu", harness.clock())


def test_the_tiny_cell_is_correct_and_reads_its_span_metrics(root):
    line = _run(root, trace=True)
    assert line["correct"] is True, line["checks"]
    # the device metrics find no device trace here; the phase stamps run on the host's clock
    assert set(line["metrics"]) == {"cross_ms.train", "step_sparse_update_ms.train"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    plain = _run(root)
    assert set(plain["metrics"]) == {"setup_s", "train_examples_per_s", "peak_mem_gib"}


def test_control_and_faults_fail_the_limits(root):
    """The reference in float8 in the program's place, and each planted
    fault, fail a limit of the cell; the program's readings pass them; on
    three seeds."""
    cell = harness.load_cell(CELL, root)
    rows = [r for r in calibrate_large.readings(cell, [1, 2, 2**40 + 3], harness.Device("cpu"))
            if r["side"] != "reference"]
    assert {r["side"] for r in rows} == {"program", "control", "half_batch", "frozen", "frozen_rows"}
    for r in rows:
        over = any(r[k] > limit for k, limit in LIMITS.items())
        assert over is (r["side"] != "program"), r


@pytest.mark.parametrize("kind", ["frozen", "frozen_rows", "half_batch"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, kind):
    from dlrm_flexflow_tpu_torch.core import ffmodel

    if kind in ("frozen", "frozen_rows"):
        if kind == "frozen":
            monkeypatch.setattr(ffmodel.FFModel, "_dense_update", lambda self, g, state, p, s: state)
        monkeypatch.setattr(ffmodel, "apply_sparse_updates", lambda ops, p, xs, g, opt, st, ctx, **kw: st)
    else:
        real = ffmodel.losses_lib.compute_loss
        monkeypatch.setattr(ffmodel.losses_lib, "compute_loss",
                            lambda t, logits, labels: real(t, logits[:logits.shape[0] // 2],
                                                           labels[:labels.shape[0] // 2]))
    line = _run(root)
    assert line["correct"] is False, line["checks"]


def test_one_bag_size_draws_the_generators_inputs(root):
    """Where every table has one bag size, the multi-hot runner's inputs are
    `generator.batches`' bit for bit (so calibrate_large reads a
    one-size cell as train.py runs it)."""
    cell = harness.load_cell(tinycell.TRAIN, root)
    dev = harness.Device("cpu")
    cfg, mix = cell.cfg, cell.mix
    want = generator.batches(cfg["vocab_sizes"], cfg["mlp_bot"][0], cfg["embedding_bag_size"],
                             mix["distinct_batches"], mix["batch_size"], mix, 77, dev.device)
    got = train_multihot._inputs(cell, 77, dev)
    assert set(got) == set(want) and all(got[k].equal(want[k]) for k in want)
    multi = train_multihot._inputs(harness.load_cell(CELL, root), 77, dev)
    assert [multi[f"sparse_{i}"].shape[-1] for i in range(4)] == [3, 1, 5, 2]


def test_counts_at_the_published_shape():
    cfg = json.loads((harness.HERE / "configs" / "dlrm-dcnv2.json").read_text())
    assert counts.forward_flop_per_example(cfg) == 32_060_928
    assert counts.cross_forward_flop_per_example(cfg) == 21_233_664
    assert counts.train_flop_per_example(cfg) == 3 * 32_060_928 - 2 * 13 * 512
    peaks = {"bf16_flop_per_s": 989e12, "hbm_byte_per_s": 3.35e12}
    b, d, r = 65536, 3456, 512
    flop = 2 * b * d * r / 989e12
    # W (V x_l) writes [B, d] in f32: its bytes bound it; the other five by their operations
    w_forward = (2 * (b * r + r * d) + 4 * b * d) / 3.35e12
    epilogue = 10 * b * d * 4 / 3.35e12
    assert w_forward > flop
    assert counts.cross_least_seconds(cfg, b, peaks) == pytest.approx(3 * (5 * flop + w_forward + epilogue),
                                                                      rel=1e-12)


def test_weights_loaded_in_place_equal_load_weights(root):
    cell = harness.load_cell(CELL, root)
    prog, leaves = cell.program(), cell.reference().leaves(cell.cfg)
    a, b = (prog.build(cell.cfg, cell.mix, "cpu") for _ in range(2))
    prog.load_weights(a, leaves, 2**35 + 9, "cpu")
    calibrate_large._load_in_place(prog.state_reader(b), leaves, 2**35 + 9, "cpu")
    for leaf in leaves:
        assert prog.state_reader(a)(leaf).equal(prog.state_reader(b)(leaf)), (leaf.op, leaf.key)
