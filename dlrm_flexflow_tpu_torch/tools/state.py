"""A model's whole state as tensors by path, and the paths where two differ.

    from dlrm_flexflow_tpu_torch.tools.state import state_diff, state_tensors
    assert not state_diff(eager, replayed)  # bit for bit

Used by the checks that hold two runs of one model bit for bit (graph
replays against eager steps, a restored checkpoint against the saved
model), on one device and under a mesh (each rank's own shard).
"""
from __future__ import annotations

import torch


def state_tensors(model) -> dict:
    """Every tensor of a model's state by path: parameters, optimizer
    state, metric totals."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, torch.Tensor):
            out[path] = tree

    for name, tree in (("params", model.get_parameters()), ("opt", model._opt_state),
                       ("metrics", model._metrics_total)):
        walk(tree, name)
    return out


def state_diff(a, b) -> dict:
    """{path: max abs difference} of the tensors of a and b that differ
    (empty when the two are equal bit for bit)."""
    ta, tb = state_tensors(a), state_tensors(b)
    if ta.keys() != tb.keys():
        raise AssertionError(f"two models of one config hold different state: {sorted(ta.keys() ^ tb.keys())}")
    return {k: (ta[k].double() - tb[k].double()).abs().max().item()
            for k in ta if not torch.equal(ta[k], tb[k])}
