"""Datasets and preprocessing for the Keras facade (numpy only).

Counterpart of `dlrm_flexflow_tpu/frontends/datasets.py` (reference:
python/flexflow/keras/datasets/{mnist,cifar10,reuters}.py and
preprocessing/{sequence,text}.py): the same loaders, the same draws in the
same order and the same dtypes, so one set of arguments gives bit-identical
arrays in both packages. Loaders read from a local `path` when it exists
and otherwise return a deterministic synthetic surrogate with the same
shapes, dtypes and class structure (linearly separable class blobs, enough
for the accuracy gates these datasets serve, tests/accuracy_tests.sh in the
reference); nothing is downloaded.
"""
from __future__ import annotations

import gzip
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _synthetic_classification(
    n: int, shape: Tuple[int, ...], num_classes: int, seed: int, scale: float = 2.0
):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, n).astype(np.int64)
    dim = int(np.prod(shape))
    centers = rng.randn(num_classes, dim).astype(np.float32) * scale
    x = centers[y] + rng.randn(n, dim).astype(np.float32)
    return x.reshape((n,) + shape), y


def _read_idx(path: str) -> np.ndarray:
    """Read an IDX-format file (the canonical MNIST distribution:
    train-images-idx3-ubyte[.gz] etc. — magic, dims, big-endian)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = int.from_bytes(f.read(4), "big")
        ndim = magic & 0xFF
        dtype = {
            0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
            0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
        }[(magic >> 8) & 0xFF]
        shape = tuple(
            int.from_bytes(f.read(4), "big") for _ in range(ndim)
        )
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(shape).astype(dtype)


def load_mnist(path: Optional[str] = None, synthetic_n: int = 10000):
    """reference: keras/datasets/mnist.py load_data(). `path` may be a
    keras-style 'mnist.npz' OR a directory holding the canonical IDX files
    (train-images-idx3-ubyte[.gz], train-labels-idx1-ubyte[.gz],
    t10k-images-idx3-ubyte[.gz], t10k-labels-idx1-ubyte[.gz]); without a
    path a deterministic synthetic surrogate is produced.
    Returns ((x_train, y_train), (x_test, y_test)) with x uint8 [N, 28, 28]."""
    if path and os.path.isdir(path):
        def find(stem):
            for suffix in ("", ".gz"):
                p = os.path.join(path, stem + suffix)
                if os.path.exists(p):
                    return p
            raise FileNotFoundError(f"{stem}[.gz] not in {path}")

        return (
            (_read_idx(find("train-images-idx3-ubyte")),
             _read_idx(find("train-labels-idx1-ubyte")).astype(np.int64)),
            (_read_idx(find("t10k-images-idx3-ubyte")),
             _read_idx(find("t10k-labels-idx1-ubyte")).astype(np.int64)),
        )
    if path and os.path.exists(path):
        with np.load(path, allow_pickle=True) as f:
            return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
    xtr, ytr = _synthetic_classification(synthetic_n, (28, 28), 10, seed=0)
    xte, yte = _synthetic_classification(synthetic_n // 5, (28, 28), 10, seed=1)
    to_u8 = lambda x: np.clip((x - x.min()) / (np.ptp(x) + 1e-6) * 255, 0, 255).astype(np.uint8)
    return (to_u8(xtr), ytr), (to_u8(xte), yte)


def load_cifar10(path: Optional[str] = None, synthetic_n: int = 10000):
    """reference: keras/datasets/cifar10.py (python-pickle batches). Local
    pickle dir or synthetic surrogate. x uint8 [N, 3, 32, 32] (channels
    first, like the reference loader)."""
    if path and os.path.isdir(path):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(path, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"]).reshape(-1, 3, 32, 32))
            ys.append(np.asarray(d[b"labels"]))
        with open(os.path.join(path, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xte = np.asarray(d[b"data"]).reshape(-1, 3, 32, 32)
        yte = np.asarray(d[b"labels"])
        return (np.concatenate(xs), np.concatenate(ys)), (xte, yte)
    xtr, ytr = _synthetic_classification(synthetic_n, (3, 32, 32), 10, seed=2)
    xte, yte = _synthetic_classification(synthetic_n // 5, (3, 32, 32), 10, seed=3)
    to_u8 = lambda x: np.clip((x - x.min()) / (np.ptp(x) + 1e-6) * 255, 0, 255).astype(np.uint8)
    return (to_u8(xtr), ytr), (to_u8(xte), yte)


def load_reuters(
    path: Optional[str] = None,
    num_words: Optional[int] = 1000,
    synthetic_n: int = 2000,
    num_classes: int = 46,
):
    """reference: keras/datasets/reuters.py — variable-length int sequences.
    Synthetic surrogate: class-dependent token distributions."""
    if path and os.path.exists(path):
        with np.load(path, allow_pickle=True) as f:
            return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
    vocab = num_words or 1000

    def make(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, num_classes, n)
        xs = []
        for c in y:
            length = r.randint(10, 200)
            base = (c * 17) % vocab
            toks = (base + r.zipf(1.6, size=length)) % vocab
            xs.append(toks.astype(np.int64).tolist())
        return np.asarray(xs, dtype=object), y

    return make(synthetic_n, 5), make(synthetic_n // 5, 6)


# --- preprocessing (reference: keras/preprocessing/sequence.py, text.py) -----

def pad_sequences(
    sequences: Sequence[Sequence[int]],
    maxlen: Optional[int] = None,
    dtype=np.int64,
    padding: str = "pre",
    truncating: str = "pre",
    value: int = 0,
) -> np.ndarray:
    """reference: keras/preprocessing/sequence.py pad_sequences (same
    semantics: pre/post padding and truncation)."""
    lengths = [len(s) for s in sequences]
    maxlen = maxlen or max(lengths) if lengths else 0
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, s in enumerate(sequences):
        if not len(s):
            continue
        s = list(s)
        if len(s) > maxlen:
            s = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "pre":
            out[i, -len(s):] = s
        else:
            out[i, : len(s)] = s
    return out


class Tokenizer:
    """reference: keras/preprocessing/text.py Tokenizer (word-frequency
    vocabulary; texts_to_sequences / texts_to_matrix binary mode)."""

    def __init__(self, num_words: Optional[int] = None, lower: bool = True,
                 split: str = " "):
        self.num_words = num_words
        self.lower = lower
        self.split = split
        self.word_counts: Dict[str, int] = {}
        self.word_index: Dict[str, int] = {}

    def _words(self, text: str) -> List[str]:
        if self.lower:
            text = text.lower()
        return [w for w in text.split(self.split) if w]

    def fit_on_texts(self, texts: Sequence[str]) -> None:
        for t in texts:
            for w in self._words(t):
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        ranked = sorted(self.word_counts.items(), key=lambda kv: (-kv[1], kv[0]))
        # index 0 reserved (padding), like keras
        self.word_index = {w: i + 1 for i, (w, _) in enumerate(ranked)}

    def texts_to_sequences(self, texts: Sequence[str]) -> List[List[int]]:
        cap = self.num_words
        out = []
        for t in texts:
            seq = []
            for w in self._words(t):
                idx = self.word_index.get(w)
                if idx is not None and (cap is None or idx < cap):
                    seq.append(idx)
            out.append(seq)
        return out

    def texts_to_matrix(self, texts: Sequence[str], mode: str = "binary") -> np.ndarray:
        n_cols = self.num_words or (len(self.word_index) + 1)
        m = np.zeros((len(texts), n_cols), np.float32)
        for i, seq in enumerate(self.texts_to_sequences(texts)):
            for idx in seq:
                if mode == "binary":
                    m[i, idx] = 1.0
                elif mode == "count":
                    m[i, idx] += 1.0
        return m


def to_categorical(y: np.ndarray, num_classes: Optional[int] = None) -> np.ndarray:
    """keras.utils.to_categorical equivalent (used by reference examples)."""
    y = np.asarray(y, np.int64).ravel()
    n = num_classes or int(y.max()) + 1
    return np.eye(n, dtype=np.float32)[y]
