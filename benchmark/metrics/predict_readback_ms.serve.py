"""predict_readback_ms.serve: the program's `predict:readback` span (the answers'
`.float().cpu().numpy()`, which waits for the card) in host ms a `predict` call, over
every call but the first, which holds the set-up (`benchmark/spans.py`). Nothing where
the program keeps no such span."""
from benchmark.spans import ms_per


def read(t):
    return ms_per(["predict:readback"], "host_s", "predict") if t.mode == "serve" else None
