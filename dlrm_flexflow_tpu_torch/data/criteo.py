"""Criteo click-logs dataset IO (Kaggle / Terabyte schema).

PyTorch port's copy of `dlrm_flexflow_tpu/data/criteo.py` (numpy only):
the reference's HDF5 loading (examples/cpp/DLRM/dlrm.cc:281-325; X_int
[N, 13] float, X_cat [N, 26] int64, y [N]) and its preprocessing
(examples/cpp/DLRM/preprocess_hdf.py: log(x + 1) of the integer features,
categoricals hashed modulo a vocab). Reads .npz with the same keys, and
.h5 where h5py is installed (an optional import).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

try:  # optional: the .h5 schema only
    import h5py  # type: ignore

    HAS_H5PY = True
except ImportError:
    HAS_H5PY = False


def load_criteo(
    path: str,
    num_tables: Optional[int] = None,
    max_samples: int = -1,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, List[int]]:
    """Load X_int/X_cat/y from .h5 or .npz into the DLRM graph's feeds.

    Returns (feeds, labels, vocab_sizes): feeds has dense_features [N, 13]
    f32 and sparse_i [N, 1] int64 per table, labels [N, 1] f32, and
    vocab_sizes[i] = max index + 1 per table."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            x_int = np.asarray(z["X_int"], np.float32)
            x_cat = np.asarray(z["X_cat"], np.int64)
            y = np.asarray(z["y"], np.float32)
    else:
        if not HAS_H5PY:
            raise ImportError(f"h5py is not installed; convert {path} to .npz")
        with h5py.File(path, "r") as f:
            x_int = np.asarray(f["X_int"], np.float32)
            x_cat = np.asarray(f["X_cat"], np.int64)
            y = np.asarray(f["y"], np.float32)
    if max_samples > 0:
        x_int, x_cat, y = x_int[:max_samples], x_cat[:max_samples], y[:max_samples]
    t = x_cat.shape[1] if num_tables is None else num_tables
    feeds: Dict[str, np.ndarray] = {"dense_features": x_int}
    vocab_sizes = []
    for i in range(t):
        col = x_cat[:, i : i + 1]
        feeds[f"sparse_{i}"] = col
        vocab_sizes.append(int(col.max()) + 1)
    return feeds, y.reshape(-1, 1), vocab_sizes


def preprocess_raw_tsv(
    in_path: str,
    out_path: str,
    vocab_mod: int = 10_000_000,
    max_rows: int = -1,
) -> Tuple[int, List[int]]:
    """Raw Criteo TSV (label, 13 ints, 26 hex categoricals, tab-separated)
    -> the X_int/X_cat/y .npz schema: ints -> log(x + 1), missing or
    negative -> 0; categoricals -> int(hex) % vocab_mod, missing -> 0.
    Returns (rows written, vocab_sizes)."""
    ys, ints, cats = [], [], []
    with open(in_path) as f:
        for n, line in enumerate(f):
            if 0 < max_rows <= n:
                break
            parts = line.rstrip("\n").split("\t")
            ys.append(float(parts[0]))
            ints.append([
                np.log(float(v) + 1.0) if v not in ("", None) and float(v) >= 0 else 0.0
                for v in (parts[1:14] + [""] * (13 - len(parts[1:14])))
            ])
            cats.append([
                int(v, 16) % vocab_mod if v else 0
                for v in (parts[14:40] + [""] * (26 - len(parts[14:40])))
            ])
    x_int = np.asarray(ints, np.float32)
    x_cat = np.asarray(cats, np.int64)
    y = np.asarray(ys, np.float32)
    np.savez_compressed(out_path, X_int=x_int, X_cat=x_cat, y=y)
    vocab_sizes = [int(x_cat[:, i].max()) + 1 for i in range(x_cat.shape[1])]
    return len(y), vocab_sizes


def save_synthetic_criteo(
    out_path: str,
    num_samples: int,
    vocab_sizes: List[int],
    num_dense: int = 13,
    seed: int = 0,
) -> None:
    """A synthetic dataset in the Criteo .npz schema, from `seed` (the
    reference's random dataset branch, dlrm.cc:330-377)."""
    rng = np.random.default_rng(seed)
    x_int = rng.normal(size=(num_samples, num_dense)).astype(np.float32)
    x_cat = np.stack(
        [rng.integers(0, v, size=num_samples) for v in vocab_sizes], axis=1
    ).astype(np.int64)
    y = rng.integers(0, 2, size=num_samples).astype(np.float32)
    np.savez_compressed(out_path, X_int=x_int, X_cat=x_cat, y=y)
