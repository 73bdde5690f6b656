"""predict_stage_ms.serve: the program's `forward:stage` span (`FFModel._stage`: a
request's host arrays to the card, pageable copies) in host ms a `predict` call, over
every call but the first, which holds the set-up (`benchmark/spans.py`). Nothing where
the program keeps no such span."""
from benchmark.spans import ms_per


def read(t):
    return ms_per(["forward:stage"], "host_s", "predict") if t.mode == "serve" else None
