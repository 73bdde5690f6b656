"""step_forward_ms.train.4cards: as `step_forward_ms.train`, in a cell of four cards
(it moves train_examples_per_s.4cards), on rank 0, where the per-layer metrics are read:
`phase:lookup` (with the exchange's forward all-to-all), `phase:forward` and `phase:loss`
(with its all-reduce) in device ms a step (`benchmark/spans.py`). Nothing where the program
stamps no phases."""
from benchmark.spans import ms_per


def read(t):
    if t.mode != "train":
        return None
    return ms_per(["phase:lookup", "phase:forward", "phase:loss"], "device_s")
