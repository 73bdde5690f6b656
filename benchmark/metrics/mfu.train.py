"""mfu.train: the traced stretch's training examples/s times the model's
matrix-product operations an example (forward and backward, counted from
the configuration), over the cards' bf16 dense peak, in %."""


def read(t):
    if t.mode != "train" or t.peaks is None or t.window_s <= 0 or t.examples <= 0:
        return None
    rate = t.examples / t.window_s
    return 100.0 * rate * t.counts.train_flop_per_example(t.cfg) / (t.chips * t.peaks["bf16_flop_per_s"])
