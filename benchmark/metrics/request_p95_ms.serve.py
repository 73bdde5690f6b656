"""request_p95_ms.serve: the 95th percentile of every request's latency
in the run's window, each timed on the host from the `predict` call to
its return, in ms. A per-layer metric of the serving cell: the card is
idle for more than half of its window, so the tail moves with the host."""
import numpy as np


def read(t):
    lat = getattr(t, "latencies_s", None)
    if t.mode != "serve" or not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95.0))
