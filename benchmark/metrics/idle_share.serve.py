"""idle_share.serve: the share of the traced serving stretch in which no
operation ran on the card (one minus the union of kernel, copy and fill
intervals over the stretch), in %."""


def read(t):
    if t.mode != "serve" or not t.ranks or t.ranks[0]["busy_s"] <= 0:
        return None
    r = t.ranks[0]
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
