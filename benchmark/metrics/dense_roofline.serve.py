"""dense_roofline.serve: the Dense layers' least forward time at the
request's batch (`counts/dlrm.py`), times the requests traced, over the
time of the port's fused dense kernel (K6: its wgmma and f32 kernels and
its rounding pass), in %. No such kernel: nothing to read."""
import re

PATTERN = re.compile(r"dense_wgmma_kernel|dense_f32_kernel|round_pad_kernel")


def read(t):
    if t.mode != "serve" or t.peaks is None or t.steps <= 0:
        return None
    least = t.counts.mlp_least_seconds(t.cfg, t.batch, False, t.peaks) * t.steps
    spent = sum(s for name, s in t.ranks[0]["device_s"].items() if PATTERN.search(name))
    return 100.0 * least / spent if spent > 0 else None
