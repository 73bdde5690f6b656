"""The numbers that decide `correct`, each against its limit.

Training: the first three steps of the window's own call, against the
plain reference from the same weights and batches. A leaf's first gradient
is read as the optimizer got it, from the state after one step, (W0 - W1)
/ lr, on both sides alike; its change is W3 - W0. A leaf counts where its
storage holds a step: where the reference's state readout of its first
gradient lies within STATE_HOLDS of the gradient as computed. (A bfloat16
table rounds most of an SGD step at this rate away, so its state shows
rounding, not the step.) Over the leaves that count, the gap of a leaf is
|norm(program) - norm(reference)| over the larger of the reference's norm
of that leaf and of the median leaf:
- `grad_gap`: the largest gap of the first gradient;
- `grad_gap_median`: the median leaf's gap of the first gradient;
- `change_gap_median`: the median leaf's gap of the change after three
  steps (the largest swings with one small leaf's late steps: PERF.md).
Over the leaves that do not count (their storage rounds most of a step
away, as SGD's small steps on bfloat16 tables), the same gap of the state
after step 1, whose flips are what the row update wrote:
- `rounded_grad_gap_median`: the median of those leaves' gaps (0 where
  every leaf counts). A row update that writes nothing reads 0.7 and
  more; the largest leaf swings by single rounding flips (PERF.md).
Serving: every answer of the window against the reference's:
- `prob_excess`: the largest gap between a served probability and the
  reference's beyond half a step of the compute dtype at the reference's
  value (the served answer is a number of that dtype, so the nearest it
  can come is within half a step).

A number that is not finite fails. The limits are the cell's file under
`limits/`, set from the readings `PERF.md` gives.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import numpy as np

STATE_HOLDS = 0.1


def _gaps(port: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    keys = [k for k in ref if k in keep]
    if not keys:
        return {}
    median = statistics.median([ref[k] for k in keys])
    out = {}
    for k in keys:
        gap = abs(port[k] - ref[k]) / max(ref[k], median, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def counted_leaves(ref_state_grad: Dict[str, float], ref_true_grad: Dict[str, float]) -> set:
    return {k for k, v in ref_state_grad.items()
            if abs(v - ref_true_grad[k]) <= STATE_HOLDS * ref_true_grad[k]}


def _median(gaps: Dict[str, float]) -> float:
    return statistics.median(gaps.values()) if gaps else 0.0


def train_numbers(port: dict, ref: dict) -> Dict[str, float]:
    """`port` and `ref` as `train.port_steps` / `train.reference_steps`
    give them (the reference's with `true_grad`)."""
    keep = counted_leaves(ref["grad"], ref["true_grad"])
    grad = _gaps(port["grad"], ref["grad"], keep)
    change = _gaps(port["change"], ref["change"], keep)
    rounded = _gaps(port["grad"], ref["grad"], set(ref["grad"]) - keep)
    return {"grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values()),
            "rounded_grad_gap_median": _median(rounded)}


def readings(port: dict, ref: dict) -> Dict[str, float]:
    """Numbers that are printed and not compared (PERF.md says why): the
    largest relative gap of a step's loss, the largest leaf's gap of the
    change after three steps, and over the leaves that do not count, the
    largest leaf's gap of the state after step 1 and the median leaf's of
    the change after three steps."""
    keep = counted_leaves(ref["grad"], ref["true_grad"])
    rest = set(ref["grad"]) - keep
    loss = max(abs(p - r) / abs(r) for p, r in zip(port["losses"], ref["losses"]))
    rounded = _gaps(port["grad"], ref["grad"], rest)
    return {"loss_gap": loss, "change_gap": max(_gaps(port["change"], ref["change"], keep).values()),
            "rounded_grad_gap": max(rounded.values(), default=0.0),
            "rounded_change_gap_median": _median(_gaps(port["change"], ref["change"], rest))}


def half_step(x: np.ndarray, dtype: str) -> np.ndarray:
    """Half the spacing of `dtype`'s numbers at |x|."""
    bits = {"bfloat16": 8, "float16": 11, "float32": 24}[dtype]  # significand bits
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(0.5, e - bits)


def answer_excess(got: np.ndarray, want: np.ndarray, dtype: str) -> float:
    """The largest gap of one answer beyond half a step of `dtype`."""
    got, want = got.reshape(-1).astype(np.float64), want.reshape(-1).astype(np.float64)
    excess = np.abs(got - want) - half_step(want, dtype)
    worst = float(np.max(excess, initial=0.0))
    return worst if math.isfinite(worst) and not np.isnan(excess).any() else math.inf


def serve_numbers(excess: Sequence[float]) -> Dict[str, float]:
    worst = max(excess) if excess else math.inf
    return {"prob_excess": max(0.0, worst) if math.isfinite(worst) else math.inf}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    out = {}
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name, math.inf), limits.get(name, -math.inf)
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
