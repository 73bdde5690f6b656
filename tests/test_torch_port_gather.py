"""The port's row-gather kernel (K7) and forward-gather probe, on the CPU.

K7's plain version against the JAX probe's Pallas kernel `dma_gather`
(scripts/bench_gather_probe.py, imported by path), run under
`pltpu.force_tpu_interpret_mode()` as the CPU runs a TPU kernel: the same
numpy inputs, exact equality. The port's wrapper takes its plain version
because the tensors lie on the CPU; the CUDA kernel is held against that
plain version on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dlrm_flexflow_tpu_torch.ops.kernels.row_gather import DEPTHS, row_gather, row_gather_reference
from dlrm_flexflow_tpu_torch.tools import bench_gather_probe as probe

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_gather_probe", REPO / "scripts" / "bench_gather_probe.py")
jax_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_probe)


def _table(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_gather_plain_version_equals_the_tpu_kernel_interpreted(dtype, k):
    """dma_gather at tile 16, depth 4 on a [64, 128] table: row copies, the
    bits of the table's dtype (bf16 compared through its exact f32 widening)."""
    table = _table((64, 128), 1)
    rows = np.random.default_rng(2).integers(0, 64, k).astype(np.int32)
    rows[:3] = [63, 0, 63]  # the ends, and a repeat
    jt = jnp.asarray(table, dtype=getattr(jnp, dtype))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_probe.dma_gather(jt, jnp.asarray(rows), tile=16, depth=4)).astype(np.float32)
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = row_gather(tt, torch.from_numpy(rows), depth=4)
    assert got.dtype == tt.dtype and got.shape == (k, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_gives_nan_rows_outside_the_table(dtype):
    table = torch.from_numpy(_table((10, 16), 3)).to(dtype)
    rows = torch.tensor([0, -1, 9, 10, -7, 3, 2**31 - 1], dtype=torch.int32)
    got = row_gather(table, rows)
    bad = torch.tensor([False, True, False, True, True, False, True])
    assert torch.isnan(got[bad].float()).all() and torch.isfinite(got[~bad].float()).all()
    torch.testing.assert_close(got[~bad], table[rows[~bad].long()], rtol=0, atol=0)
    # one NaN bit pattern, the canonical one of the dtype
    assert len(set(got[bad].float().view(torch.int32).reshape(-1).tolist())) == 1


@pytest.mark.parametrize("w, dtype", [(16, torch.float32), (16, torch.bfloat16), (24, torch.float32),
                                      (40, torch.bfloat16)])
def test_row_gather_takes_narrow_and_odd_width_tables(w, dtype):
    """The probe's narrow [V, 16] tables, and rows of 96 or 80 bytes."""
    table = torch.from_numpy(_table((1000, w), 4)).to(dtype)
    rows = torch.from_numpy(np.random.default_rng(5).integers(0, 1000, 333).astype(np.int32))
    for depth in DEPTHS:
        torch.testing.assert_close(row_gather(table, rows, depth), table[rows.long()], rtol=0, atol=0)


def test_row_gather_refuses_what_the_kernel_cannot_take():
    rows = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="16 bytes"):
        row_gather(torch.zeros((8, 6)), rows)  # 24-byte rows
    with pytest.raises(ValueError, match="aligned"):
        row_gather(torch.zeros(8 * 8 + 1, dtype=torch.bfloat16)[1:].view(8, 8), rows)
    with pytest.raises(TypeError):
        row_gather(torch.zeros((8, 4)), rows.long())
    with pytest.raises(TypeError):
        row_gather(torch.zeros((8, 4), dtype=torch.float16), rows)
    with pytest.raises(ValueError, match="depth"):
        row_gather(torch.zeros((8, 4)), rows, depth=3)
    assert row_gather(torch.zeros((8, 4)), rows[:0]).shape == (0, 4)
    assert torch.equal(row_gather_reference(torch.ones((2, 4)), rows[:1]), torch.ones((1, 4)))


def test_probe_packs_as_the_jax_probe_does():
    """8 rows of 16 a 128-wide pack, rounded up to 1024 packs (the JAX
    probe's main, scripts/bench_gather_probe.py:147-149)."""
    for vocab, dim in ((1_000_000, 16), (1000, 16), (5000, 32)):
        rpp = jax_probe.LANES // dim
        pp = -(-vocab // rpp)
        assert probe.packed_rows(vocab, dim) == -(-pp // 1024) * 1024
    assert probe.packed_rows(1_000_000, 16) == 125952


def test_probe_runs_every_variant_on_the_cpu():
    """The probe's body at a tiny size through the plain versions: the 13
    variants, one f32 sum per step that A, D-f32 and E share bit for bit,
    another that B and D-bf16 share."""
    out = probe.run(tables=2, vocab=1000, dim=16, batch=128, steps=2, device="cpu", log=None)
    res = out["results"]
    assert len(res) == 13 and out["shapes"]["packs"] == 1024
    f32 = {k: r["sum"] for k, r in res.items()
           if k in ("packed_f32", "k4_h1_f32") or (k.startswith("k7_") and k.endswith("_f32"))}
    bf16 = {k: r["sum"] for k, r in res.items()
            if k == "packed_bf16" or (k.startswith("k7_") and k.endswith("_bf16"))}
    assert len(f32) == 6 and len(set(f32.values())) == 1
    assert len(bf16) == 5 and len(set(bf16.values())) == 1
    assert all(np.isfinite(r["ns_per_row"]) and r["steps_issued"] == 2 for r in res.values())


def test_probe_command_line_filters_and_prints_one_json_line(capsys):
    probe.main(["--device", "cpu", "--tables", "1", "--vocab", "500", "--batch", "64", "--steps", "1",
                "--only", "k7_d2"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert sorted(out["results"]) == ["k7_d2_bf16", "k7_d2_f32"]
    assert any("us/step" in line for line in lines[:-1])
