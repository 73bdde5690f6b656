"""mfu.serve: the traced stretch's served examples/s times the model's
forward matrix-product operations an example (counted from the
configuration), over the card's bf16 dense peak, in %."""


def read(t):
    if t.mode != "serve" or t.peaks is None or t.window_s <= 0 or t.examples <= 0:
        return None
    rate = t.examples / t.window_s
    return 100.0 * rate * t.counts.forward_flop_per_example(t.cfg) / (t.chips * t.peaks["bf16_flop_per_s"])
