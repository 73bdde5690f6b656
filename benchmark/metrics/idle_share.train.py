"""idle_share.train: the share of the traced training stretch in which no
operation ran on the device (one minus the union of kernel, copy and fill
intervals over the stretch), in %, the mean over the ranks."""


def read(t):
    if t.mode != "train" or not t.ranks or any(r["busy_s"] <= 0 for r in t.ranks):
        return None
    return 100.0 * sum(1.0 - r["busy_s"] / r["window_s"] for r in t.ranks) / len(t.ranks)
