"""One rank of a tiny multi-card cell on the CPU over gloo, traced, for
tests:

    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m benchmark.tests.ranks_cpu_traced \
        ROOT WORKLOAD

Rank 0 prints the result's line of a `--trace 1` run."""
import json
import sys

from benchmark import harness
from benchmark.programs import dlrm


def main(root: str, name: str) -> None:
    cell = harness.load_cell(name, root)
    mesh = dlrm.join_mesh("cpu")
    line = harness.run(cell, 2**31 + 11, 0.5, True, "cpu", harness.clock(), mesh)
    dlrm.leave_mesh(mesh)
    if line:
        print(json.dumps(harness.finite(line)), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
