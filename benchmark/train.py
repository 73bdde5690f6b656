"""The training runner: set-up, the checked first steps, the window, the
reference.

Set-up builds one model, gives it the weights drawn from the seed, makes
the mix's distinct batches on the device (and, under host routing, their
routes with `compute_routes` / `stage_routes`), then drives that same
model through its first three steps, one `train_chunk` call each on the
window's own stacks (batches 0, 1, 2), reading each step's loss, the state
after step 1 and the state after step 3; then one warm-up call of the
window's whole stack. The window calls `train_chunk` on the whole stack
(each call one step a batch, round robin) with one call in flight, until
`seconds` have passed, and ends on a synchronisation: the rate is every
example of every step over the whole window. After the window the peak
memory is read, the model is freed, and the reference runs the same three
steps from the same weights on the same batches.
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
from .weights import change_norm, draw

CHECK_STEPS = 3
TRACE_SECONDS = 2.0


def _inputs(cell, seed: int, dev) -> Dict[str, torch.Tensor]:
    cfg, mix = cell.cfg, cell.mix
    return generator.batches(cfg["vocab_sizes"], cfg["mlp_bot"][0], cfg["embedding_bag_size"],
                             mix["distinct_batches"], mix["batch_size"], mix, seed, dev.device)


def _state_norms(leaves, seed: int, tensors, scale: float = 1.0) -> Dict[str, float]:
    """Each leaf's change from its initial value (the L2 norm), over `scale`."""
    return {f"{leaf.op}/{leaf.key}": change_norm(leaf, i, seed, tensors(leaf)) / scale
            for i, leaf in enumerate(leaves)}


def _loop(model, feeds, labels, dev, until: float, mesh) -> int:
    """`train_chunk` calls on the whole stacks, one in flight, until the
    clock passes `until` (under a mesh, rank 0's clock decides for all);
    returns the calls made. Ends with the device idle."""
    calls, prev = 0, None
    while True:
        model.train_chunk(feeds, labels)
        ev = dev.event()
        if prev is not None:
            prev.wait()
        prev, calls = ev, calls + 1
        if not _go_on(clock() < until, mesh):
            break
    dev.sync()
    return calls


def _go_on(flag: bool, mesh) -> bool:
    if mesh is None:
        return flag
    import torch.distributed as dist

    box = [flag]
    dist.broadcast_object_list(box, src=0, group=mesh.control)
    return bool(box[0])


def port_steps(model, feeds, labels, read, leaves, seed: int, lr: float) -> dict:
    """The model's first CHECK_STEPS steps, one `train_chunk` call each on
    batch i of the stacks: each step's loss, each leaf's first gradient as
    (W0 - W1) / lr and its change W3 - W0 (norms), and the seconds spent
    reading the state."""
    losses, check_s = [], 0.0
    for i in range(CHECK_STEPS):
        losses.append(float(model.train_chunk({k: v[i:i + 1] for k, v in feeds.items()}, labels[i:i + 1])))
        if i == 0:
            t = clock()
            grad = _state_norms(leaves, seed, read, lr)
            check_s += clock() - t
    t = clock()
    change = _state_norms(leaves, seed, read)
    return {"losses": losses, "grad": grad, "change": change, "check_s": check_s + clock() - t}


def reference_steps(cell, seed: int, data, labels, dev, compute: str = "float32", fault: str = "") -> dict:
    """The plain reference's first CHECK_STEPS steps from the weights drawn
    from the seed, on batches 0, 1, 2 of the same stacks, read as
    `port_steps` reads the model ("frozen" needs no run: its change is 0)."""
    ref, cfg = cell.reference(), cell.cfg
    leaves = ref.leaves(cfg)
    lr = float(cell.mix["optimizer"]["lr"])
    params = {(leaf.op, leaf.key): draw(leaf, i, seed, dev.device) for i, leaf in enumerate(leaves)}
    losses, true_grad = [], {}
    with ref.plain_matmuls():
        for i in range(CHECK_STEPS):
            sparse = [data[f"sparse_{j}"][i] for j in range(len(cfg["vocab_sizes"]))]
            losses.append(ref.sgd_step(cfg, params, data["dense_features"][i], sparse, labels[i], lr,
                                       compute=compute, fault=fault, grad_norms=true_grad if i == 0 else None))
            if i == 0:
                grad = _state_norms(leaves, seed, lambda leaf: params[(leaf.op, leaf.key)], lr)
    change = _state_norms(leaves, seed, lambda leaf: params[(leaf.op, leaf.key)])
    del params
    dev.free()
    return {"losses": losses, "grad": grad, "change": change, "true_grad": true_grad}


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, mesh=None) -> dict:
    cfg, mix = cell.cfg, cell.mix
    prog = cell.program()
    leaves = cell.reference().leaves(cfg)
    lr = float(mix["optimizer"]["lr"])
    with dev.phases("import_build_compile"):
        model = prog.build(cfg, mix, dev.device, mesh)
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
        port = port_steps(model, feeds, labels, prog.state_reader(model, mesh), leaves, seed, lr)
    check_s = port.pop("check_s")
    dev.phases.seconds["first_steps_state_reads"] = check_s
    with dev.phases("warm_call"):
        model.train_chunk(feeds, labels)  # the window's call, warm
        dev.sync()
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.control)
    batch = mix["batch_size"]
    steps_per_call = int(labels.shape[0])

    t0 = clock()
    setup_s = t0 - t_start - check_s
    dev.phases.seconds["setup_s"] = setup_s
    summaries, traced_calls, prof = [], 0, None
    if trace:
        with profiler(dev) as prof:
            with torch.profiler.record_function(WINDOW):
                traced_calls = _loop(model, feeds, labels, dev, clock() + min(TRACE_SECONDS, seconds), mesh)
    calls = traced_calls + _loop(model, feeds, labels, dev, t0 + seconds, mesh)
    t1 = clock()
    steps = calls * steps_per_call
    peak = dev.peak_bytes()
    del model, feeds
    dev.free()
    if trace:
        with dev.phases("trace_reduction"):
            summaries = [summarize(prof)]
            del prof
    if mesh is not None:
        summaries, peak = prog.gather(mesh, summaries, peak)
        if mesh.rank != 0:
            return {}
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
