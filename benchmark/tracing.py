"""Reduction of a `torch.profiler` trace to what the per-layer metrics read.

The harness profiles a bounded stretch of its window with CPU and CUDA
activities and marks it with one host range, `bench:window`; each served
request is marked `bench:request`. `summarize` turns one process's trace
into a small dict:

- `window_s`: the length of the marked stretch;
- `busy_s`: the length of the union of every device interval (kernels,
  copies, fills) inside it, so overlapping work counts once;
- `device_s`: device seconds by operation name, clipped to the stretch;
- `gaps`: the longest idle stretches of the device, each named by what the
  host was doing at its middle (the innermost host range that holds it);
- `requests`: for each request, its host seconds and the device-busy
  seconds inside it.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

WINDOW = "bench:window"
REQUEST = "bench:request"
TOP = 10
PROFILER_OWN = ("Activity Buffer",)  # the profiler's own bookkeeping
NAME_CHARS = 160


def _events(prof):
    """(device intervals, host intervals) in nanoseconds, from the
    profiler's raw events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = int(e.start_ns()), int(e.duration_ns())
        if dur <= 0 or e.name().startswith(PROFILER_OWN):
            continue
        item = (start, start + dur, e.name())
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or e.name() in (WINDOW, REQUEST)):
                dev.append(item)  # the harness's own ranges are mirrored on the device: not work
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    return dev, host


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) that the merged intervals cover."""
    i = max(0, bisect.bisect_right(merged, (lo, lo)) - 1)
    total = 0
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        total += max(0, min(e, hi) - max(s, lo))
        i += 1
    return total


def summarize(prof) -> dict:
    dev, host = _events(prof)
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    lo, hi = windows[0]
    clipped = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
    merged = union([(s, e) for s, e, _ in clipped])
    by_name: Dict[str, float] = {}
    for s, e, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    gaps = []
    edge = lo
    for s, e in merged + [(hi, hi)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    inner = [(s, e, n) for s, e, n in host if n != WINDOW]
    named = []
    for a, b in gaps[:TOP]:
        mid = (a + b) // 2
        around = [(e - s, n) for s, e, n in inner if s <= mid < e]
        name = min(around)[1] if around else "none"
        named.append([f"host:{name}"[:NAME_CHARS], (b - a) / 1e9])
    requests = [((e - s) / 1e9, covered(merged, s, e) / 1e9) for s, e, n in host if n == REQUEST]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(e - s for s, e in merged) / 1e9,
        "device_s": by_name,
        "gaps": named,
        "requests": requests,
    }


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["device_s"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops], "idle_gaps": summary["gaps"]}
