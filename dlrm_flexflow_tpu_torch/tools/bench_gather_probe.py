"""Forward-gather probe on one CUDA card: the port of scripts/bench_gather_probe.py.

    python -m dlrm_flexflow_tpu_torch.tools.bench_gather_probe            # on a machine with an H100
    python -m dlrm_flexflow_tpu_torch.tools.bench_gather_probe --only k7 --steps 5

Times ways to gather the rows of the multi-table embedding forward at the
kaggle dims of the probe (10 tables, V = 1,000,000, D = 16, so packed
tables of [125952, 128]: 8 rows a 128-wide pack, rounded up to 1024 packs;
65536 lookups a table and step):

  A. packed_f32      the packed gather tb[idx // 8] from f32 tables
  B. packed_bf16     the same from bf16 tables
  C. narrow_f32/bf16 the narrow gather tb[idx] from [V, 16] tables
  D. k7_d{1,2,4,8}_{f32,bf16}
                     the row-gather kernel (K7, ops/kernels/row_gather.py),
                     the port of the probe's Pallas row-DMA kernel, at each
                     depth on the packed tables
  E. k4_h1_f32       the embedding-bag kernel (K4) at H = 1 on the packed
                     f32 tables, the same function

Each step sums every table's gathered rows to one f32 scalar, as the probe
does. Tables are made on the card from a seeded torch.Generator, the
indices from a seeded numpy generator. On CUDA one eager step warms a
variant up, its steps are captured in one CUDA graph, and the timed window
runs from a synchronize through one replay to the host readback of the
sum (us_per_step, the JAX probe's window); CUDA events around the replay
give the device's time (device_us_per_step), which ns/row is taken from,
as a host hiccup inside a window of a few steps shows in the first. Prints
us/step and ns/row per variant, like the probe, and one JSON line. A, D-f32 and E sum the same rows, as do B and D-bf16: their sums
must agree bit for bit. With --device cpu (for tests) the steps run
eagerly through the plain versions.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ffconst import AggrMode
from ..ops.kernels.embedding_bag import embedding_bag
from ..ops.kernels.row_gather import DEPTHS, row_gather

LANES = 128


def packed_rows(vocab: int, dim: int) -> int:
    """Packs of a [vocab, dim] table: 128 // dim rows a 128-wide pack,
    rounded up to a multiple of 1024 packs, as the JAX probe packs them."""
    pp = -(-vocab // (LANES // dim))
    return -(-pp // 1024) * 1024


def _summed(gathers: Callable[[torch.Tensor], List[torch.Tensor]]):
    """A step body: the f32 sum of every table's gathered rows."""
    def body(idx: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32, device=idx.device)
        for g in gathers(idx):
            acc = acc + g.sum(dtype=torch.float32)
        return acc
    return body


def variants(packed_f32, packed_bf16, narrow_f32, narrow_bf16, rpp: int) -> Dict[str, tuple]:
    """name -> (label, step body, the kernel wrapper it launches or None)."""
    n = len(packed_f32)
    out = {
        "packed_f32": (f"A torch packed f32 x{n}", _summed(lambda i: [t[i // rpp] for t in packed_f32]), None),
        "packed_bf16": (f"B torch packed bf16 x{n}", _summed(lambda i: [t[i // rpp] for t in packed_bf16]), None),
        "narrow_f32": (f"C torch narrow f32 x{n}", _summed(lambda i: [t[i] for t in narrow_f32]), None),
        "narrow_bf16": (f"C torch narrow bf16 x{n}", _summed(lambda i: [t[i] for t in narrow_bf16]), None),
    }
    for dt, tabs in (("f32", packed_f32), ("bf16", packed_bf16)):
        for depth in DEPTHS:
            out[f"k7_d{depth}_{dt}"] = (
                f"D K7 row gather depth={depth} {dt} x{n}",
                _summed(lambda i, tabs=tabs, depth=depth: [row_gather(t, i // rpp, depth) for t in tabs]),
                row_gather,
            )
    sum_mode = AggrMode.AGGR_MODE_SUM
    out["k4_h1_f32"] = (
        f"E K4 embedding bag H=1 f32 x{n}",
        _summed(lambda i: [embedding_bag(t, (i // rpp)[:, None], sum_mode) for t in packed_f32]),
        embedding_bag,
    )
    return out


def timed(body, idx_steps: torch.Tensor) -> Dict[str, float]:
    """us/step of body over the steps of idx_steps, and the sum it gave."""
    steps = idx_steps.shape[0]
    if idx_steps.device.type != "cuda":
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float32)
        for s in range(steps):
            acc = acc + body(idx_steps[s])
        value = float(acc)
        return {"us_per_step": (time.perf_counter() - t0) / steps * 1e6, "sum": value,
                "steps_issued": steps}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(idx_steps[0])  # builds, loads and allocates outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        acc = torch.zeros((), dtype=torch.float32, device=idx_steps.device)
        for s in range(steps):
            acc = acc + body(idx_steps[s])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    graph.replay()
    end.record()
    value = float(acc)
    dt = time.perf_counter() - t0
    return {"us_per_step": dt / steps * 1e6, "device_us_per_step": start.elapsed_time(end) / steps * 1e3,
            "sum": value, "steps_issued": steps + 1}


@torch.no_grad()
def run(tables: int = 10, vocab: int = 1_000_000, dim: int = 16, batch: int = 65536, steps: int = 20,
        only: str = "", device: str = "cuda", log: Optional[Callable[[str], None]] = print) -> dict:
    """Run the probe; returns {"shapes": ..., "results": {variant: {...}}}.
    Each result holds us_per_step, ns_per_row, the sum, the steps issued
    (the captured steps and the warm-up) and the launches of its kernel."""
    log = log or (lambda _: None)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_gather_probe: no CUDA device is available; pass --device cpu")
    rpp, pp = LANES // dim, packed_rows(vocab, dim)
    gen = torch.Generator(device=dev).manual_seed(0)
    packed_f32 = [0.01 * torch.randn((pp, LANES), generator=gen, device=dev) for _ in range(tables)]
    narrow_f32 = [0.01 * torch.randn((vocab, dim), generator=gen, device=dev) for _ in range(tables)]
    packed_bf16 = [t.to(torch.bfloat16) for t in packed_f32]
    narrow_bf16 = [t.to(torch.bfloat16) for t in narrow_f32]
    rng = np.random.default_rng(0)
    idx_steps = torch.from_numpy(rng.integers(0, vocab, (steps, batch)).astype(np.int32)).to(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}; packed tables {tables} x [{pp}, {LANES}], narrow {tables} x [{vocab}, {dim}], "
        f"{batch} lookups a table, {steps} steps")
    per_row = 1e3 / (batch * tables)  # us/step -> ns/row
    results: Dict[str, dict] = {}
    for key, (label, body, wrapper) in variants(packed_f32, packed_bf16, narrow_f32, narrow_bf16,
                                                rpp).items():
        if only and only not in key:
            continue
        before = wrapper.launches if wrapper is not None else 0
        res = timed(body, idx_steps)
        res["launches"] = (wrapper.launches - before) if wrapper is not None else 0
        res["ns_per_row"] = res.get("device_us_per_step", res["us_per_step"]) * per_row
        results[key] = res
        on_dev = f" ({res['device_us_per_step']:.1f} on the device)" if "device_us_per_step" in res else ""
        log(f"{label:55s} {res['us_per_step']:10.1f} us/step{on_dev}   (chk {res['sum']:.3e})")
    log("\nns/row (aggregate over all tables; device time on CUDA):")
    for key, res in results.items():
        log(f"  {key:25s} {res['ns_per_row']:8.2f} ns/row")
    return {"device": name, "shapes": {"tables": tables, "vocab": vocab, "dim": dim, "packs": pp,
                                       "batch": batch, "steps": steps}, "results": results}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (plain versions, for tests)")
    args = ap.parse_args(argv)
    out = run(args.tables, args.vocab, args.dim, args.batch, args.steps, args.only, args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
