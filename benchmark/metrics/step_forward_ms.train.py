"""step_forward_ms.train: the train step's `phase:lookup`, `phase:forward` and
`phase:loss` in device ms a step, stamped on the card inside the step (a captured step at
every replay; the warm-up before the capture is not stamped), over the whole run
(`benchmark/spans.py`). Nothing where the program stamps no phases."""
from benchmark.spans import ms_per


def read(t):
    if t.mode != "train":
        return None
    return ms_per(["phase:lookup", "phase:forward", "phase:loss"], "device_s")
