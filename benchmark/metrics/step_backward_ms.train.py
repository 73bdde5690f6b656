"""step_backward_ms.train: the train step's `phase:backward` (`torch.autograd.grad`)
in device ms a step, stamped on the card inside the step, over the whole run
(`benchmark/spans.py`). Nothing where the program stamps no phases."""
from benchmark.spans import ms_per


def read(t):
    return ms_per(["phase:backward"], "device_s") if t.mode == "train" else None
