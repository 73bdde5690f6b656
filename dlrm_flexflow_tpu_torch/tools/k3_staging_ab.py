"""A/B of staging variants of the dot-interaction kernel (K3) on one CUDA card.

    python -m dlrm_flexflow_tpu_torch.tools.k3_staging_ab      # on a machine with an H100

Every variant is made by a text edit of `csrc/dot_interaction.cu` as it
stands, built with the package's nvcc flags, checked bit for bit against the
plain version on seven shapes, and timed at the serving shape
[16384, 27, 128] f32 with CUDA events, in one call, forward then reverse
order. The variants differ only in how a block stages x into shared memory:

  cp.async         - the source as it is: f32 lines copied by cp.async
  registers        - every line loaded into registers and stored, line by line
  registers-8      - 8 lines per warp loaded into registers before any store
  registers-8-sync - the same with __syncwarp() between loads and stores
  registers+carve  - `registers` with the maximum shared-memory carveout
  registers+u4     - `registers` with the d loop unrolled by 4
and two splits of each of `registers` and `cp.async`: `loads-only` (the d
loop skipped) and `compute-only` (no global loads). The last lines print
the occupancy of the source's kernel, a `clone` of x as a bandwidth
yardstick, and one JSON object with every time.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from .. import _build
from ..ops.kernels.dot_interaction import dot_interaction_reference

STAGE_CP = """        if constexpr (std::is_same<T, float>::value) {
          __pipeline_memcpy_async(dst + d, src + d, sizeof(float));
        } else {
          dst[d] = to_f32(src[d]);
        }
"""
STAGE_LOOP_START = "    for (int q = warp; q < n_lines; q += n_warps) {\n      const T* src"
STAGE_LOOP_END = "    __pipeline_commit();\n"
COMPUTE = "    if (active) {\n      for (int d = 0; d < dc; ++d) {"
LAUNCH = "  dot_interaction_kernel<T><<<"
BATCHED = """    for (int q0 = warp; q0 < n_lines; q0 += n_warps * 8) {
      float vals[8][kChunkD / 32];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u * n_warps;
        const T* src = xb + (long long)q * D + d0;
#pragma unroll
        for (int s = 0; s < kChunkD / 32; ++s) {
          const int d = lane + 32 * s;
          vals[u][s] = (q < n_lines && d < dc) ? to_f32(src[d]) : 0.f;
        }
      }
SYNC#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u * n_warps;
#pragma unroll
        for (int s = 0; s < kChunkD / 32; ++s) {
          const int d = lane + 32 * s;
          if (q < n_lines && d < dc) smem[q * stride + d] = vals[u][s];
        }
      }
    }
"""
OCCUPANCY = """
extern "C" int occupancy_blocks(int threads, int smem) {
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dot_interaction_kernel<float>, threads, smem);
  return n;
}
"""


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"variant edit does not apply: {old[:50]!r}")
    return text.replace(old, new)


def variants() -> dict:
    source = (_build.CSRC_DIR / "dot_interaction.cu").read_text()
    registers = _edit(source, STAGE_CP, "        dst[d] = to_f32(src[d]);\n")
    start, end = source.index(STAGE_LOOP_START), source.index(STAGE_LOOP_END)
    carve = (
        "  cudaFuncSetAttribute(dot_interaction_kernel<T>,\n"
        "                       cudaFuncAttributePreferredSharedMemoryCarveout,\n"
        "                       cudaSharedmemCarveoutMaxShared);\n" + LAUNCH
    )
    out = {
        "cp.async": source,
        "registers": registers,
        "registers-8": source[:start] + BATCHED.replace("SYNC", "") + source[end:],
        "registers-8-sync": source[:start] + BATCHED.replace("SYNC", "      __syncwarp();\n") + source[end:],
        "registers+carve": _edit(registers, LAUNCH, carve),
        "registers+u4": _edit(registers, COMPUTE, COMPUTE.replace("    if (active) {\n", "    if (active) {\n#pragma unroll 4\n")),
    }
    for base in ("registers", "cp.async"):
        text = out[base]
        out[f"{base}/loads-only"] = _edit(text, COMPUTE, COMPUTE.replace("(active)", "(active && D < 0)"))
        no_load = STAGE_CP if base == "cp.async" else "        dst[d] = to_f32(src[d]);\n"
        out[f"{base}/compute-only"] = _edit(text, no_load, "        dst[d] = (float)(d & 7);\n")
    return out


def build_all(srcs: dict, workdir: Path) -> dict:
    """One nvcc per variant, all started together; returns the loaded libraries."""
    procs = {}
    for i, (tag, text) in enumerate(srcs.items()):
        src = workdir / f"v{i}.cu"
        src.write_text(text + OCCUPANCY)
        lib = workdir / f"libv{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {tag}:\n{log}")
        regs = sorted({line.split("Used")[1].split(",")[0].strip() for line in log.splitlines() if "Used" in line})
        print(f"[build] {tag}: {regs}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        cdll.dot_interaction_forward.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        cdll.dot_interaction_forward.restype = ctypes.c_int
        cdll.occupancy_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        cdll.occupancy_blocks.restype = ctypes.c_int
        libs[tag] = cdll
    return libs


def run(lib, x: torch.Tensor, self_interaction: bool) -> torch.Tensor:
    b, f, d = x.shape
    p = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    out = torch.empty((b, p), device=x.device)
    err = lib.dot_interaction_forward(
        x.data_ptr(), out.data_ptr(), b, f, d, int(self_interaction),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k3_staging_ab: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    srcs = variants()
    workdir = _build.BUILD_DIR.parent / "k3_staging_ab"  # gitignored, like the kernel builds
    workdir.mkdir(parents=True, exist_ok=True)
    libs = build_all(srcs, workdir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [
        ((16384, 27, 128), False, torch.float32), ((16384, 27, 128), True, torch.float32),
        ((1000, 5, 16), False, torch.float32), ((16384, 27, 128), False, torch.bfloat16),
        ((7, 64, 300), True, torch.float32), ((33, 64, 1000), False, torch.bfloat16),
        ((5, 3, 7), True, torch.float32),
    ]
    for shape, si, dtype in shapes:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        ref = dot_interaction_reference(x, si)
        for tag, lib in libs.items():
            if "-only" in tag:
                continue
            got = run(lib, x, si)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"variant {tag} differs from the plain version at {shape}")
    print("[check] every full variant is bit-identical to the plain version", flush=True)
    x = torch.randn((16384, 27, 128), generator=gen, device="cuda")
    print(f"[occupancy] blocks per SM at 96 threads, 41796 B: "
          f"{libs['cp.async'].occupancy_blocks(96, 41796)}", flush=True)
    order = list(libs) + list(reversed(libs))
    times = [(tag, cuda_ms(lambda: run(libs[tag], x, False))) for tag in order]
    clone_ms = cuda_ms(lambda: x.clone())
    print(f"[yardstick] x.clone() ms {clone_ms}")
    print(json.dumps({"shape": [16384, 27, 128], "ms": times, "clone_ms": clone_ms}))


if __name__ == "__main__":
    main()
