"""step_sparse_update_ms.train.4cards: as `step_sparse_update_ms.train`, in a cell of
four cards (it moves train_examples_per_s.4cards), on rank 0, where the per-layer metrics
are read: `phase:sparse_update`, which there holds the exchange's backward all-to-all and
the shard update on K1, in device ms a step (`benchmark/spans.py`). Nothing where the
program stamps no phases."""
from benchmark.spans import ms_per


def read(t):
    return ms_per(["phase:sparse_update"], "device_s") if t.mode == "train" else None
