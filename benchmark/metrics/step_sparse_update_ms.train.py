"""step_sparse_update_ms.train: the train step's `phase:sparse_update` (the row
updates, K1/K2, and the other tables' scatter rule) in device ms a step, stamped on the
card inside the step, over the whole run (`benchmark/spans.py`). Nothing where the program
stamps no phases."""
from benchmark.spans import ms_per


def read(t):
    return ms_per(["phase:sparse_update"], "device_s") if t.mode == "train" else None
