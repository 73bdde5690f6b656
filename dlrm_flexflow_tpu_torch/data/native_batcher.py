"""ctypes binding to the native host data library (native/ffdata).

PyTorch-side counterpart of `dlrm_flexflow_tpu/data/native_batcher.py`,
with the same functions over the same C entry points
(`native/ffdata/ffdata.cc`): the threaded row gather of a shuffled batch
(`gather_batch`), a duplicate-safe threaded scatter-add (`scatter_add_f32`)
and the batched stable radix argsort that host routing sorts the row-update
streams with (`argsort_i64_batch`, `argsort_i64`).

The port builds the shared source unchanged, with the flags of
`native/Makefile`, into its own directory `build/host/` beside the
package (listed in `.gitignore`; `native/build/` belongs to the JAX
package), at first use, under a name that carries a hash of the source and
flags, as `_build.py` names the CUDA kernels. Nothing falls back: if the
library cannot be built or loaded, every function raises RuntimeError with
the compiler's output. Indices and sizes are checked here, before any
pointer reaches the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ffdata" / "ffdata.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]  # native/Makefile

_loaded: Dict[str, ctypes.CDLL] = {}

_I32, _I64, _F32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P, _I64P, _F32P = ctypes.POINTER(_I32), ctypes.POINTER(_I64), ctypes.POINTER(_F32)


def library_path() -> Path:
    if not SOURCE.is_file():
        raise RuntimeError(f"ffdata: its source {SOURCE} is missing from this checkout")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libffdata-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("ffdata: g++ not found on PATH; the port's host data library needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ffdata: g++ failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if need be; raises RuntimeError if it
    cannot be built or loaded."""
    path = library_path()
    if str(path) not in _loaded:
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"ffdata: cannot load {path}: {e}") from e
        lib.ffdata_gather_batch.argtypes = [_I32, ctypes.POINTER(_U8P), _I64P, _I64P, _I64P,
                                            _I64, ctypes.POINTER(_U8P), _I32]
        lib.ffdata_scatter_add_f32.argtypes = [_F32P, _I64, _I64, _I64P, _I64, _F32P, _F32, _I32]
        lib.ffdata_argsort_i64_batch.argtypes = [_I64P, _I32, _I64, _I32P, _I32]
        for fn in (lib.ffdata_gather_batch, lib.ffdata_scatter_add_f32,
                   lib.ffdata_argsort_i64_batch):
            fn.restype = None
        _loaded[str(path)] = lib
    return _loaded[str(path)]


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(os.cpu_count() or 1, 16)


def gather_batch(
    arrays: Sequence[np.ndarray],
    idx: np.ndarray,
    outs: Optional[Sequence[np.ndarray]] = None,
    num_threads: int = 0,
) -> List[np.ndarray]:
    """outs[a][i] = arrays[a][idx[i]] for every array, multi-threaded.
    Every index must lie in [0, rows) of every array (IndexError otherwise;
    the library itself would clamp). Returns the out list (allocated if
    None; given outs must be C-contiguous [len(idx), ...] of the array's
    dtype)."""
    lib = get_lib()
    idx64 = np.ascontiguousarray(idx, np.int64).reshape(-1)
    n = int(idx64.shape[0])
    srcs = [np.ascontiguousarray(a) for a in arrays]  # contiguous temps outlive the call
    if outs is None:
        outs = [np.empty((n,) + a.shape[1:], a.dtype) for a in srcs]
    if len(outs) != len(srcs):
        raise ValueError(f"gather_batch: {len(srcs)} arrays but {len(outs)} outs")
    lo, hi = (int(idx64.min()), int(idx64.max())) if n else (0, -1)
    for a, o in zip(srcs, outs):
        if lo < 0 or hi >= a.shape[0]:
            raise IndexError(f"gather_batch: an index lies outside [0, {a.shape[0]})")
        if not o.flags["C_CONTIGUOUS"] or o.dtype != a.dtype or o.shape != (n,) + a.shape[1:]:
            raise ValueError(f"gather_batch: out {o.shape} {o.dtype} must be a C-contiguous "
                             f"{(n,) + a.shape[1:]} {a.dtype}")
    k = len(srcs)
    src_p, dst_p = (_U8P * k)(), (_U8P * k)()
    src_rows, row_bytes = (_I64 * k)(), (_I64 * k)()
    for i, (a, o) in enumerate(zip(srcs, outs)):
        src_p[i] = a.ctypes.data_as(_U8P)
        dst_p[i] = o.ctypes.data_as(_U8P)
        src_rows[i] = a.shape[0]
        row_bytes[i] = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    lib.ffdata_gather_batch(k, src_p, src_rows, row_bytes, idx64.ctypes.data_as(_I64P), n, dst_p,
                            _threads(num_threads))
    return list(outs)


def scatter_add_f32(table: np.ndarray, idx: np.ndarray, grads: np.ndarray,
                    scale: float = 1.0, num_threads: int = 0) -> None:
    """table[idx[i]] += scale * grads[i], in place, duplicate-safe and
    multi-threaded; rows < 0 or >= len(table) are dropped."""
    lib = get_lib()
    idx64 = np.ascontiguousarray(idx, np.int64).reshape(-1)
    g = np.ascontiguousarray(grads, np.float32)
    if table.dtype != np.float32 or table.ndim != 2 or not table.flags["C_CONTIGUOUS"]:
        raise ValueError("scatter_add_f32 takes a C-contiguous float32 [V, D] table")
    if g.shape != (idx64.shape[0], table.shape[1]):
        raise ValueError(f"scatter_add_f32: grads {g.shape} != {(idx64.shape[0], table.shape[1])}")
    lib.ffdata_scatter_add_f32(table.ctypes.data_as(_F32P), table.shape[0], table.shape[1],
                               idx64.ctypes.data_as(_I64P), idx64.shape[0],
                               g.ctypes.data_as(_F32P), float(scale), _threads(num_threads))


def argsort_i64_batch(keys: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """Stable argsort of each row of an int64 [T, K] array of keys >= 0 (an
    LSD radix sort, one thread per row): [T, K] int32."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, np.int64)
    if keys.ndim != 2 or keys.shape[1] >= 2**31 or keys.shape[0] >= 2**31:
        raise ValueError(f"argsort_i64_batch takes [T, K] keys with K < 2^31, got {keys.shape}")
    if keys.size and int(keys.min()) < 0:
        raise ValueError("argsort_i64_batch: the radix sort takes keys >= 0")
    t, k = keys.shape
    out = np.empty((t, k), np.int32)
    if keys.size:
        lib.ffdata_argsort_i64_batch(keys.ctypes.data_as(_I64P), t, k, out.ctypes.data_as(_I32P),
                                     _threads(num_threads))
    return out


def argsort_i64(keys: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """Stable argsort of [K] int64 keys >= 0: [K] int32."""
    return argsort_i64_batch(np.asarray(keys, np.int64).reshape(1, -1), num_threads)[0]
