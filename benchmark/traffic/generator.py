"""The one traffic generator: seeded batches of DLRM inputs, on the device.

A traffic mix is a data file beside this module (`<mix>.json`) that the
harness reads; this module turns its parameters and a seed into inputs.
It rewrites the program's `data/synthetic.py` (`random_batches`,
`zipf_indices`) so that a change to the program cannot move the yardstick:

- dense features: standard normal, float32;
- ids: uniform over each table's rows, or truncated Zipf(s) ranks by the
  inverse of the continuous approximation's CDF (rank 0 the hottest row),
  drawn in float64;
- labels: fair coin flips (noise), float32 in {0, 1}.

Every array comes from a `torch.Generator` on the device, one large call a
table, so making a cell's inputs costs a few launches. The same seed gives
the same inputs on every run on one kind of card; another seed gives other
values of the same sizes and distribution.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..weights import stream_seed

TRAFFIC_TAG = 0x5452


def ids(gen: torch.Generator, vocab: int, shape, dist: dict, device) -> torch.Tensor:
    """int64 ids in [0, vocab) of `shape`, by `dist`: {"dist": "uniform"}
    or {"dist": "zipf", "s": s}."""
    if dist["dist"] == "uniform":
        return torch.randint(0, vocab, shape, generator=gen, device=device, dtype=torch.int64)
    if dist["dist"] != "zipf":
        raise ValueError(f"unknown id distribution {dist['dist']!r}")
    s = float(dist["s"])
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    if abs(s - 1.0) < 1e-9:
        r = torch.exp(u * torch.log(torch.tensor(float(vocab), dtype=torch.float64, device=device)))
    else:
        r = (1.0 + u * (float(vocab) ** (1.0 - s) - 1.0)) ** (1.0 / (1.0 - s))
    return (r.to(torch.int64) - 1).clamp(0, vocab - 1)


def batches(vocabs: Sequence[int], n_dense: int, bag: int, n_batches: int, batch: int, mix: dict,
            seed: int, device, stream: int = 0) -> Dict[str, torch.Tensor]:
    """Stacks [n_batches, batch, ...] under the DLRM input names:
    `dense_features` [K, B, n_dense] f32, `sparse_<i>` [K, B, bag] int64,
    and `labels` [K, B, 1] f32. `stream` picks an independent set of inputs
    for one seed (the serving pool uses one, training another)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, TRAFFIC_TAG, stream))
    shape = (n_batches, batch)
    out = {"dense_features": torch.randn(shape + (n_dense,), generator=gen, device=device)}
    for i, v in enumerate(vocabs):
        out[f"sparse_{i}"] = ids(gen, int(v), shape + (bag,), mix["ids"], device)
    if mix.get("labels", "noise") != "noise":
        raise ValueError(f"unknown labels {mix['labels']!r}")
    out["labels"] = torch.randint(0, 2, shape + (1,), generator=gen, device=device).float()
    return out
