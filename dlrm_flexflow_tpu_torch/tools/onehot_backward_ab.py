"""Time the one-hot lookup's gradient (K5b) of one checkout of the port.

    python dlrm_flexflow_tpu_torch/tools/onehot_backward_ab.py [--root DIR] [--label NAME]

Prints one JSON line: the whole call `onehot_embedding_backward(idx, g, v,
SUM, bf16)` replayed in a CUDA graph at each of mlperf-lite's 13
vocabularies of at most 8192 rows (B = 16384, H = 1, D = 128, int64 idx,
f32 g), beside its byte bound and `index_add_`, and the onehot-grad pass
(the 13 tables' lookup and gradient through torch.autograd) by the host's
clock, by CUDA events and as its kernels' device time. The inputs and the
yardsticks are `chip_smoke.py`'s, from this checkout; `--root` imports the
port from another checkout, such as an unpacked `git archive` of an earlier
commit, so that two versions can be timed in turns on one card, each in its
own process.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--label", default="", help="a name printed with the result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("onehot_backward_ab: no CUDA device is available")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    sys.path.insert(0, str(args.root.resolve()))  # the port comes from --root
    tables, idx, g = smoke.onehot_grad_inputs()
    calls = {t.shape[0]: smoke.time_onehot_backward(t.shape[0], ix, g) for t, ix in zip(tables, idx)}
    grad_pass = lambda: smoke.onehot_grad_pass(tables, idx, g)  # noqa: E731
    grad_pass()
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "root": str(args.root), "card": smi,
                      "onehot_grad": smoke.onehot_grad_times(grad_pass), "calls": calls}), flush=True)


if __name__ == "__main__":
    main()
