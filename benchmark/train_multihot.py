"""The training runner of mixes whose tables each take their own bag size.

`train.py` draws one bag size for every table (`generator.batches`). This
runner is `train.py`'s, step for step (set-up, the checked first steps,
the window, the reference; its `port_steps`, `reference_steps`, `_loop` and
the checks), with the inputs drawn table by table at the bag sizes the
configuration lists (`embedding_bag_size`, an int or one a table), by the
generator's `ids`, from the same stream and in the same order as
`generator.batches`: where every bag has one size the two give the same
inputs.
"""
from __future__ import annotations

import json
import sys
from typing import Dict

import torch

from . import checks
from .harness import GIB, clock, per_layer, profiler, window_facts
from .tracing import WINDOW, breakdown, summarize
from .traffic import generator
from .train import _loop, port_steps, reference_steps
from .weights import stream_seed

TRACE_SECONDS = 2.0


def bag_sizes(cfg: dict):
    b = cfg["embedding_bag_size"]
    return [int(b)] * len(cfg["vocab_sizes"]) if isinstance(b, int) else [int(x) for x in b]


def _inputs(cell, seed: int, dev) -> Dict[str, torch.Tensor]:
    """Stacks [K, B, ...] under the DLRM input names, `sparse_<i>` [K, B,
    bag_i] int64: `generator.batches`' draws with a bag size a table."""
    cfg, mix = cell.cfg, cell.mix
    gen = torch.Generator(device=dev.device)
    gen.manual_seed(stream_seed(seed, generator.TRAFFIC_TAG, 0))
    shape = (mix["distinct_batches"], mix["batch_size"])
    out = {"dense_features": torch.randn(shape + (cfg["mlp_bot"][0],), generator=gen, device=dev.device)}
    for i, (v, bag) in enumerate(zip(cfg["vocab_sizes"], bag_sizes(cfg))):
        out[f"sparse_{i}"] = generator.ids(gen, int(v), shape + (bag,), mix["ids"], dev.device)
    if mix.get("labels", "noise") != "noise":
        raise ValueError(f"unknown labels {mix['labels']!r}")
    out["labels"] = torch.randint(0, 2, shape + (1,), generator=gen, device=dev.device).float()
    return out


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, mesh=None) -> dict:
    if mesh is not None:
        raise ValueError("this runner drives one card")
    mix = cell.mix
    prog = cell.program()
    leaves = cell.reference().leaves(cell.cfg)
    lr = float(mix["optimizer"]["lr"])
    with dev.phases("import_build_compile"):
        model = prog.build(cell.cfg, mix, dev.device)
    wrong = prog.storage_dtypes(model, leaves)
    if wrong:
        raise RuntimeError(f"the program does not store the tables as the configuration states: {wrong}")
    with dev.phases("weights"):
        prog.load_weights(model, leaves, seed, dev.device)
    with dev.phases("inputs"):
        data = _inputs(cell, seed, dev)
        labels = data.pop("labels")
        feeds = dict(data)
    with dev.phases("routes"):
        if mix.get("host_routing"):
            feeds.update(prog.routes(model, {k: v for k, v in data.items() if k.startswith("sparse_")}))
    with dev.phases("first_steps"):
        port = port_steps(model, feeds, labels, prog.state_reader(model), leaves, seed, lr)
    check_s = port.pop("check_s")
    dev.phases.seconds["first_steps_state_reads"] = check_s
    with dev.phases("warm_call"):
        model.train_chunk(feeds, labels)  # the window's call, warm
        dev.sync()
    batch = mix["batch_size"]
    steps_per_call = int(labels.shape[0])

    t0 = clock()
    setup_s = t0 - t_start - check_s
    dev.phases.seconds["setup_s"] = setup_s
    traced_calls, prof = 0, None
    if trace:
        with profiler(dev) as prof:
            with torch.profiler.record_function(WINDOW):
                traced_calls = _loop(model, feeds, labels, dev, clock() + min(TRACE_SECONDS, seconds), None)
    calls = traced_calls + _loop(model, feeds, labels, dev, t0 + seconds, None)
    t1 = clock()
    steps = calls * steps_per_call
    peak = dev.peak_bytes()
    del model, feeds
    dev.free()
    if trace:
        with dev.phases("trace_reduction"):
            summaries = [summarize(prof)]
            del prof
    with dev.phases("reference"):
        ref_out = reference_steps(cell, seed, data, labels, dev)
    numbers = checks.train_numbers(port, ref_out)
    print(f"# not compared: {json.dumps(checks.readings(port, ref_out))}", file=sys.stderr, flush=True)
    out = {"numbers": numbers, "attempted": steps, "failed": 0, "peak_bytes": peak,
           "end_to_end": {"setup_s": setup_s, "train_examples_per_s": steps * batch / (t1 - t0),
                          "peak_mem_gib": peak / GIB}}
    if trace:
        facts = window_facts(summaries)
        out["per_layer"] = per_layer(cell, dev, summaries, dict(
            mode="train", latencies_s=[], examples=traced_calls * steps_per_call * batch,
            steps=traced_calls * steps_per_call, batch=batch, **facts))
        out.update(facts, breakdown=breakdown(summaries[0]))
    return out
