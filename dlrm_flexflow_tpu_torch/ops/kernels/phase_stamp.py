"""The train step's device phase stamp: CUDA kernel wrapper.

Not a port of a TPU kernel: the step's phase totals (`utils/profiling.py`
`step_phases`) are stamped on the card so that a step captured in a CUDA
graph times its phases at every replay. One thread reads %globaltimer and
adds the time since the last stamp to a slot of an int64 accumulator
([2 * phases + 1]: each phase's ns, each phase's count, the last stamp's
time), counting it or not; `csrc/phase_stamp.cu` has the rule. On the CPU the same boundaries
read `time.perf_counter_ns` in `utils/profiling.py`, so there is no plain
version here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ... import _build


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("phase_stamp")
    lib.phase_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.phase_stamp.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def stamper(acc: torch.Tensor, phases: int) -> Callable[..., None]:
    """`stamp(slot, counted=True)`: stamp phase `slot` (-1: the step's start)
    into `acc`, a CUDA int64 [2 * phases + 1] tensor, on the current stream;
    with `counted` false the time is added and the count left. The
    accumulator is checked, the kernel built and its arguments bound here,
    once: a stamp is one library call, with a device switch only where the
    current device is not the accumulator's (a train step stamps 8 times,
    eager or captured)."""
    if acc.device.type != "cuda" or acc.dtype != torch.int64 or acc.numel() != 2 * phases + 1:
        raise ValueError(f"phase_stamp takes a CUDA int64 [{2 * phases + 1}] accumulator, got "
                         f"{acc.dtype} {tuple(acc.shape)} on {acc.device}")
    lib = _kernel_lib()
    launch, ptr, index = lib.phase_stamp, acc.data_ptr(), acc.device.index
    current_device, raw_stream = torch.cuda.current_device, torch._C._cuda_getCurrentRawStream

    def stamp(slot: int, counted: bool = True) -> None:
        if not -1 <= slot < phases:
            raise ValueError(f"phase_stamp: slot {slot} outside [-1, {phases})")
        if current_device() == index:
            err = launch(ptr, slot, phases, int(counted), raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = launch(ptr, slot, phases, int(counted), raw_stream(index))
        if err != 0:
            raise RuntimeError(f"phase_stamp kernel failed: {lib.cuda_error_string(err).decode()} (cudaError {err})")

    return stamp
