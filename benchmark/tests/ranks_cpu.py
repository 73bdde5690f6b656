"""One rank of a tiny multi-card cell on the CPU over gloo, for tests:

    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node 4 -m benchmark.tests.ranks_cpu \
        ROOT WORKLOAD [FAULT]

FAULT "no_exchange" leaves out the dense gradients' all-reduce between the
ranks. Rank 0 prints the modules of JAX or the JAX package it loaded, then
the result's line."""
import json
import sys

from benchmark import harness
from benchmark.programs import dlrm
from benchmark.run import forbidden_modules


def main(root: str, name: str, fault: str = "") -> None:
    if fault == "no_exchange":
        from dlrm_flexflow_tpu_torch.core import ffmodel

        ffmodel.FFModel._reduce_dense_grads = lambda self, g: None
    cell = harness.load_cell(name, root)
    mesh = dlrm.join_mesh("cpu")
    line = harness.run(cell, 2**31 + 9, 0.5, False, "cpu", harness.clock(), mesh)
    dlrm.leave_mesh(mesh)
    if line:
        print(json.dumps({"found": forbidden_modules()}))
        print(json.dumps(harness.finite(line)), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
