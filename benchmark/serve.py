"""The serving runner: a closed loop of one client over a pool of requests.

Set-up builds the model, gives it the weights drawn from the seed, and
makes the mix's pool of requests on the device from the seed, then copies
each to host arrays, as a client holds them; one `predict` of the first
request warms every shape. The window sends the pool's requests in turn,
each one `predict` call timed on the host from the call to its return,
until `seconds` have passed: the rate is every example returned over the
whole window, the tail the 95th percentile of every request's latency.
After the window the peak memory is read, the model is freed, and the
reference computes each pool request; every answer of the window is
compared with it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import checks
from .harness import GIB, clock, per_layer, profiler, window_facts
from .tracing import REQUEST, WINDOW, breakdown, summarize
from .traffic import generator
from .weights import draw

TRACE_SECONDS = 2.0
REF_ROWS = 16384  # rows the reference computes at a time


def _pool(cell, seed: int, dev) -> List[Dict[str, np.ndarray]]:
    cfg, mix = cell.cfg, cell.mix
    data = generator.batches(cfg["vocab_sizes"], cfg["mlp_bot"][0], cfg["embedding_bag_size"],
                             mix["pool_requests"], mix["request_examples"], mix, seed, dev.device,
                             stream=1)
    data.pop("labels")
    host = {k: v.cpu().numpy() for k, v in data.items()}
    return [{k: np.ascontiguousarray(v[j]) for k, v in host.items()} for j in range(mix["pool_requests"])]


def _serve(model, pool, n0: int, until: float, answers: list, latencies: list) -> int:
    """Requests n0, n0 + 1, ... of the pool in turn, each timed and kept,
    until the clock passes `until`; returns the next request's number."""
    n = n0
    while True:
        j = n % len(pool)
        with torch.profiler.record_function(REQUEST):
            t = clock()
            out = model.predict(pool[j])
            latencies.append(clock() - t)
        answers.append((j, out))
        n += 1
        if clock() >= until:
            return n


def reference_answers(cell, seed: int, pool, dev, compute: str = "float32") -> List[np.ndarray]:
    """The reference's probability of every example of every pool request."""
    ref = cell.reference()
    cfg = cell.cfg
    params = {(leaf.op, leaf.key): draw(leaf, i, seed, dev.device) for i, leaf in enumerate(ref.leaves(cfg))}
    n_tab = len(cfg["vocab_sizes"])
    out = []
    with ref.plain_matmuls(), torch.no_grad():
        for req in pool:
            parts = []
            for s in range(0, req["dense_features"].shape[0], REF_ROWS):
                rows = slice(s, s + REF_ROWS)
                dense = torch.as_tensor(req["dense_features"][rows], device=dev.device)
                emb = [ref.lookup(cfg, params[(f"table_{i}", "weight")],
                                  torch.as_tensor(req[f"sparse_{i}"][rows], device=dev.device), compute)
                       for i in range(n_tab)]
                parts.append(ref.forward(cfg, params, dense, emb, compute).float().cpu().numpy())
            out.append(np.concatenate(parts))
    del params
    dev.free()
    return out


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, mesh=None) -> dict:
    if mesh is not None:
        raise NotImplementedError("the serving runner runs on one card")
    cfg, mix = cell.cfg, cell.mix
    prog = cell.program()
    leaves = cell.reference().leaves(cfg)
    with dev.phases("import_build_compile"):
        model = prog.build(cfg, mix, dev.device)
    wrong = prog.storage_dtypes(model, leaves)
    if wrong:
        raise RuntimeError(f"the program does not store the tables as the configuration states: {wrong}")
    with dev.phases("weights"):
        prog.load_weights(model, leaves, seed, dev.device)
    with dev.phases("inputs"):
        pool = _pool(cell, seed, dev)
    with dev.phases("warm_call"):
        model.predict(pool[0])  # warms every shape: one batch size

    answers, latencies = [], []
    t0 = clock()
    setup_s = t0 - t_start
    dev.phases.seconds["setup_s"] = setup_s
    prof, n = None, 0
    if trace:
        with profiler(dev) as prof:
            with torch.profiler.record_function(WINDOW):
                n = _serve(model, pool, 0, clock() + min(TRACE_SECONDS, seconds), answers, latencies)
    traced = n
    n = _serve(model, pool, n, t0 + seconds, answers, latencies)
    t1 = clock()
    peak = dev.peak_bytes()
    del model
    dev.free()
    if trace:
        with dev.phases("trace_reduction"):
            summaries = [summarize(prof)]
            del prof

    examples = mix["request_examples"]
    with dev.phases("reference"):
        expect = reference_answers(cell, seed, pool, dev)
    excess = [checks.answer_excess(out, expect[j], cfg["compute_dtype"]) for j, out in answers]
    out = {"numbers": checks.serve_numbers(excess), "attempted": n, "failed": 0, "peak_bytes": peak,
           "end_to_end": {"setup_s": setup_s, "serve_examples_per_s": n * examples / (t1 - t0),
                          "peak_mem_gib": peak / GIB}}
    if trace:
        facts = window_facts(summaries)
        out["per_layer"] = per_layer(cell, dev, summaries, dict(
            mode="serve", examples=traced * examples, steps=traced, batch=mix["batch_size"],
            latencies_s=latencies, **facts))
        out.update(facts, breakdown=breakdown(summaries[0]))
    return out
