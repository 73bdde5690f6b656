"""Readings that the limits of `correct` are set from, at a cell's own size.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... [--out file.jsonl]

In one process, for each seed: the program's numbers on the timed path
(training: the first three `train_chunk` steps of one model, given each
seed's weights and batches in turn; serving: one `predict` of each pool
request), and the same numbers of the control and of the planted faults
put in the program's place, each against the float32 reference:

- control: the reference with every product's operands in float8 e4m3
  (scaled per tensor), the precision below the configurations' bfloat16;
- training faults: half of the batch left out (the loss the mean over the
  rest), a step that leaves the state unchanged, and one that leaves the
  rows of the large tables unchanged (the row update writing nothing).

One JSON line a seed and reading goes to standard output (and to `--out`).
The benchmark's own runs never run this. Needs a CUDA card unless
`--device cpu` is given (for tests at a tiny size). A cell on several cards
runs under the port's launcher (`python3 -m dlrm_flexflow_tpu_torch.launch
--nproc-per-node N -m benchmark.calibrate ...`); its faults add the
exchange between the cards left out: each card's dense gradient alone.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

from . import checks, harness, serve, train


def train_readings(cell, seeds, dev, mesh=None):
    """Rank 0 yields; under a mesh every rank steps the model alike."""
    leaves = cell.reference().leaves(cell.cfg)
    lr = float(cell.mix["optimizer"]["lr"])
    prog = cell.program()
    model = prog.build(cell.cfg, cell.mix, dev.device, mesh)
    if prog.storage_dtypes(model, leaves):
        raise RuntimeError(f"storage dtypes: {prog.storage_dtypes(model, leaves)}")
    read = prog.state_reader(model, mesh)
    for seed in seeds:
        prog.load_weights(model, leaves, seed, dev.device)
        data = train._inputs(cell, seed, dev)
        labels = data.pop("labels")
        feeds = dict(data)
        if cell.mix.get("host_routing"):
            feeds.update(prog.routes(model, {k: v for k, v in data.items() if k.startswith("sparse_")}))
        port = train.port_steps(model, feeds, labels, read, leaves, seed, lr)
        del feeds
        if mesh is not None and mesh.rank != 0:
            continue
        ref = train.reference_steps(cell, seed, data, labels, dev)
        faults = ["half_batch", "frozen", "frozen_rows"] + ([f"no_exchange_{cell.chips}"] if cell.chips > 1 else [])
        sides = {"program": port,
                 "control": train.reference_steps(cell, seed, data, labels, dev, compute="float8"),
                 **{f: train.reference_steps(cell, seed, data, labels, dev, fault=f) for f in faults}}
        yield {"seed": seed, "side": "reference", **ref}
        for name, side in sides.items():
            yield {"seed": seed, "side": name, **checks.train_numbers(side, ref), **checks.readings(side, ref),
                   "losses": side["losses"], "grad": side["grad"], "change": side["change"]}
        del data, labels
        dev.free()


def serve_readings(cell, seeds, dev):
    """The program's answers for every seed first (one model, given each
    seed's weights in turn), then, with the model freed, the reference's
    and the control's: the tables of a large cell fit the card once."""
    leaves = cell.reference().leaves(cell.cfg)
    prog = cell.program()
    model = prog.build(cell.cfg, cell.mix, dev.device)
    served = {}
    for seed in seeds:
        prog.load_weights(model, leaves, seed, dev.device)
        served[seed] = [model.predict(req) for req in serve._pool(cell, seed, dev)]
    del model
    dev.free()
    for seed in seeds:
        pool, answers = serve._pool(cell, seed, dev), served.pop(seed)
        expect = serve.reference_answers(cell, seed, pool, dev)
        control = serve.reference_answers(cell, seed, pool, dev, compute="float8")
        dtype = cell.cfg["compute_dtype"]
        for name, got in (("program", answers), ("control", control)):
            excess = [checks.answer_excess(g, e, dtype) for g, e in zip(got, expect)]
            yield {"seed": seed, "side": name, **checks.serve_numbers(excess),
                   "max_gap": max(float(np.max(np.abs(g.reshape(-1) - e.reshape(-1)))) for g, e in zip(got, expect)),
                   "max_steps": max(float(np.max(np.abs(g.reshape(-1) - e.reshape(-1))
                                                 / (2 * checks.half_step(e.reshape(-1), dtype))))
                                    for g, e in zip(got, expect))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(harness.ROOT))
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, Path(args.root))
    dev = harness.Device(args.device)
    mesh = None
    if cell.chips > 1:  # run under the port's launcher, one process a card
        if args.device == "cuda":
            import torch

            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        mesh = cell.program().join_mesh(args.device)
        readings = train_readings(cell, args.seeds, dev, mesh)
    else:
        readings = (train_readings if cell.mix["mode"] == "train" else serve_readings)(cell, args.seeds, dev)
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings:
            line = json.dumps(harness.finite(r))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    if mesh is not None:
        cell.program().leave_mesh(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
