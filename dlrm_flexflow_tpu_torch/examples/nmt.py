"""Encoder-decoder LSTM NMT (the port's counterpart of examples/nmt.py,
reference: the legacy nmt/ stand-alone, nmt/nmt.cc:33-47 config,
nmt/rnn.cu:298-327 graph): src and dst token embeddings, a 2-layer
encoder-decoder LSTM with each encoder layer's final state threaded into
the decoder layer, a vocab linear and a softmax, trained by SGD on the
synthetic copy task (predict the dst tokens under teacher forcing, sparse
categorical CE over [B, T] labels), the reference's benchmark protocol.
The reference's widths are cut so the example runs anywhere: hidden and
embed 256, vocab 4096, length 20 (`zoo.nmt` defaults to the reference's
2048 / 20480).

    python -m dlrm_flexflow_tpu_torch.examples.nmt [--device cpu] [--examples N] [FFConfig flags]

Runs on the card unless `--device cpu` is given; FFConfig's flags
(`--batch-size`, `--epochs`, `--lr`, `--seed`, ...) are read as the
reference spells them.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from dlrm_flexflow_tpu_torch import FFConfig, LossType, SGDOptimizer
from dlrm_flexflow_tpu_torch.models import zoo

LENGTH, HIDDEN, VOCAB = 20, 256, 4096


def copy_task(n: int, seed: int):
    """Random src and dst token sequences [n, LENGTH]; the labels are the
    dst tokens."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, VOCAB, (n, LENGTH)).astype(np.int32)
    dst = rng.randint(0, VOCAB, (n, LENGTH)).astype(np.int32)
    return {"src_tokens": src, "dst_tokens": dst}, dst


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    cfg = FFConfig(batch_size=64)
    rest = cfg.update_from_args(argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--examples", type=int, default=None, help="default: 8 batches")
    args = parser.parse_args(rest)
    model = zoo.nmt(batch_size=cfg.batch_size, src_len=LENGTH, dst_len=LENGTH, hidden_size=HIDDEN,
                    embed_size=HIDDEN, vocab_size=VOCAB, num_layers=2, config=cfg, device=args.device)
    model.compile(SGDOptimizer(lr=cfg.learning_rate), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
    feeds, labels = copy_task(args.examples or cfg.batch_size * 8, cfg.seed)
    hist = model.fit(feeds, labels, epochs=cfg.epochs, verbose=True)
    print(hist)
    return hist


if __name__ == "__main__":
    main()
