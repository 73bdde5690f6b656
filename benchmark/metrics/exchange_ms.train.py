"""exchange_ms.train: NCCL kernel time a step on a card, the mean over
the ranks, in ms: the all-to-alls of the sharded tables and the
all-reduces of the gradients, losses and metrics. No NCCL kernel (one
card): nothing to read."""


def read(t):
    if t.mode != "train" or t.chips < 2 or t.steps <= 0:
        return None
    per_rank = [sum(s for name, s in r["device_s"].items() if "nccl" in name.lower()) for r in t.ranks]
    if any(s <= 0 for s in per_rank):
        return None
    return 1e3 * sum(per_rank) / len(per_rank) / t.steps
