"""cross_ms.train: the cross network's device ms a step, forward and backward: the train
step's sub-phases `phase:cross_forward` and `phase:cross_backward`, stamped on the card
inside the step (a captured step at every replay) around `ops/cross.py`'s forward and
around its backward, over the whole run (`benchmark/spans.py`). Nothing where the program
has no cross network or stamps no such phases."""
from benchmark.spans import ms_per


def read(t):
    if t.mode != "train":
        return None
    return ms_per(["phase:cross_forward", "phase:cross_backward"], "device_s")
