"""predict_host_ms.serve: a request's host time, the mean over the traced
requests: the harness's range around each `predict` call, less the time
inside it in which the card was busy, in ms."""


def read(t):
    if t.mode != "serve" or not t.ranks or t.ranks[0]["busy_s"] <= 0:
        return None
    reqs = t.ranks[0]["requests"]
    if not reqs:
        return None
    return 1e3 * sum(span - busy for span, busy in reqs) / len(reqs)
