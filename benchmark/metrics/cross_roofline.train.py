"""cross_roofline.train: the cross network's least time a step over its device time a
step (`cross_ms.train`), in %. The least time (`counts/<family>.py`
`cross_least_seconds`) is the cross layers' forward and backward products at the bf16
peak, each bounded by its bytes at the HBM peak, plus the elementwise epilogue's bytes
at the HBM peak, at the cell's batch; so the same work is counted whatever implements
it. Nothing where the family counts no cross network or the program stamps no cross
phases."""
from benchmark.spans import ms_per


def read(t):
    if t.mode != "train" or t.peaks is None or not hasattr(t.counts, "cross_least_seconds"):
        return None
    ms = ms_per(["phase:cross_forward", "phase:cross_backward"], "device_s")
    if ms is None or ms <= 0:
        return None
    return 100.0 * 1e3 * t.counts.cross_least_seconds(t.cfg, t.batch // t.chips, t.peaks) / ms
