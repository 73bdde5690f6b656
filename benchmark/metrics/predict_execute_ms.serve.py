"""predict_execute_ms.serve: the program's `forward:execute` span (`Graph.execute`: the
eager op loop, launching every kernel of the forward) in host ms a `predict` call, over
every call but the first, which holds the set-up (the kernels' build and first loads;
`benchmark/spans.py`). Nothing where the program keeps no such span."""
from benchmark.spans import ms_per


def read(t):
    return ms_per(["forward:execute"], "host_s", "predict") if t.mode == "serve" else None
