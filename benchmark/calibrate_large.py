"""`calibrate.py`'s training readings for cells whose model and reference do
not fit one card together (tables of tens of GB), or whose mix takes a bag
size a table.

    python3 -m benchmark.calibrate_large --workload <name> --seeds 1 2 3 ... \\
        [--sides program control faults] [--out file.jsonl]

One model, given each seed's weights and batches in turn, runs its first
three `train_chunk` steps for every seed first and keeps only their norms
(each seed's weights are drawn block by block into the model's own
tensors, so that no whole leaf is drawn beside a captured step's memory);
the model is then freed, and for each seed the float32 reference runs, and
with it the sides asked for: the float8 control and the planted faults
(half of the batch left out, a step that leaves the state unchanged, one
that leaves the large tables' rows unchanged), each against the reference.
The inputs are `train_multihot.py`'s, which are `train.py`'s where every
bag has one size. The lines are those of `calibrate.py`. One card; the
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import checks, harness, train
from .train_multihot import _inputs
from .weights import blocks, draw_block

FAULTS = ("half_batch", "frozen", "frozen_rows")


@torch.no_grad()
def _load_in_place(read, leaves, seed: int, device) -> None:
    """Each leaf's weights from the seed, block by block, into the model's
    tensor (`read(leaf)`, one card's), as `load_weights` would set them."""
    for i, leaf in enumerate(leaves):
        t = read(leaf)
        for b, (s, e) in enumerate(blocks(leaf)):
            t[s:e].copy_(draw_block(leaf, i, b, s, e, seed, device))


def readings(cell, seeds, dev, sides=("program", "control", "faults")):
    leaves = cell.reference().leaves(cell.cfg)
    lr = float(cell.mix["optimizer"]["lr"])
    prog = cell.program()
    ports = {}
    if "program" in sides:
        model = prog.build(cell.cfg, cell.mix, dev.device)
        if prog.storage_dtypes(model, leaves):
            raise RuntimeError(f"storage dtypes: {prog.storage_dtypes(model, leaves)}")
        read = prog.state_reader(model)
        for seed in seeds:
            _load_in_place(read, leaves, seed, dev.device)
            data = _inputs(cell, seed, dev)
            labels = data.pop("labels")
            feeds = dict(data)
            if cell.mix.get("host_routing"):
                feeds.update(prog.routes(model, {k: v for k, v in data.items() if k.startswith("sparse_")}))
            ports[seed] = train.port_steps(model, feeds, labels, read, leaves, seed, lr)
            del data, labels, feeds
        del model, read
        dev.free()
    for seed in seeds:
        data = _inputs(cell, seed, dev)
        labels = data.pop("labels")
        ref = train.reference_steps(cell, seed, data, labels, dev)
        yield {"seed": seed, "side": "reference", **ref}
        others = {}
        if "program" in sides:
            others["program"] = ports.pop(seed)
        if "control" in sides:
            others["control"] = train.reference_steps(cell, seed, data, labels, dev, compute="float8")
        if "faults" in sides:
            others.update({f: train.reference_steps(cell, seed, data, labels, dev, fault=f) for f in FAULTS})
        for name, side in others.items():
            yield {"seed": seed, "side": name, **checks.train_numbers(side, ref), **checks.readings(side, ref),
                   "losses": side["losses"], "grad": side["grad"], "change": side["change"]}
        del data, labels
        dev.free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "control", "faults"],
                    choices=["program", "control", "faults"])
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(harness.ROOT))
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, Path(args.root))
    if cell.chips != 1 or cell.mix["mode"] not in ("train", "train_multihot"):
        raise SystemExit(f"{args.workload}: one-card training cells only")
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(cell, args.seeds, harness.Device(args.device), tuple(args.sides)):
            line = json.dumps(harness.finite(r))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
