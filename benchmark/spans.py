"""The program's own spans and step phases, as the per-layer metrics read
them.

The port keeps a process-wide registry (`dlrm_flexflow_tpu_torch/utils/
profiling.py`): each host span's count and host seconds, and each train step
phase's count and device seconds, stamped on the card inside the step (in a
captured step at every replay). It covers the whole run of the process: the
set-up, the traced stretch and the rest of the window, so a metric divides
a total by the matching count. On four cards it is rank 0's, where the
per-layer metrics are read. A program without the registry (a checkout
older than its spans) gives nothing to read.
"""
from __future__ import annotations

from typing import Optional, Sequence


def totals() -> Optional[dict]:
    """The program's `span_totals()`, or None where it keeps none."""
    try:
        from dlrm_flexflow_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    return span_totals()


def ms_per(names: Sequence[str], key: str, per: Optional[str] = None) -> Optional[float]:
    """The `key` seconds ("host_s", "self_s" or "device_s") of the named
    spans or phases, in ms a call of span `per` (None: each over its own
    count), summed; None where the registry, a name or a count is missing.
    A host span's first call is left out ("host_s" less "first_s", one call
    fewer): it holds the process's one-time set-up, such as the kernels'
    build in the serving cell's warm call. The step phases have no such
    call: the warm-up before the capture is not stamped."""
    tot = totals()
    if tot is None or any(name not in tot for name in names) or (per is not None and per not in tot):
        return None
    out = 0.0
    for name in names:
        entry, count = tot[name], tot[per if per is not None else name]["count"]
        if key not in entry:
            return None
        seconds = entry[key]
        if key == "host_s":
            seconds, count = seconds - entry["first_s"], count - 1
        if count <= 0:
            return None
        out += 1e3 * seconds / count
    return out
