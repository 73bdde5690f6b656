"""mlp_gemm_roofline.train: the MLPs' least time over the time of the
kernels that compute them, in %, the mean over the ranks.

The least time is the forward products and the input and weight gradients
of every Dense layer at a card's batch (`counts/dlrm.py`), times the steps
traced. The kernels are matched by name: cuBLAS and CUTLASS products and
their split-K reductions, and the port's fused dense kernels, so the same
work is counted whatever implements it. No matching kernel: nothing to
read."""
import re

PATTERN = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce|dense_wgmma|dense_f32|round_pad", re.I)


def read(t):
    if t.mode != "train" or t.peaks is None or t.steps <= 0:
        return None
    least = t.counts.mlp_least_seconds(t.cfg, t.batch // t.chips, True, t.peaks) * t.steps
    shares = []
    for rank in t.ranks:
        spent = sum(s for name, s in rank["device_s"].items() if PATTERN.search(name))
        if spent <= 0:
            return None
        shares.append(100.0 * least / spent)
    return sum(shares) / len(shares)
