"""routes_ms.train: the program's `routes` span (`FFModel.compute_routes` of one batch:
the row-update streams sorted on the host) in host ms a call, over every call but the
first, which loads the sorting library (`benchmark/spans.py`); the training runner calls
it in set-up under host routing. Nothing where the program keeps no such span or the cell
routes nothing on the host."""
from benchmark.spans import ms_per


def read(t):
    return ms_per(["routes"], "host_s", "routes") if t.mode == "train" else None
