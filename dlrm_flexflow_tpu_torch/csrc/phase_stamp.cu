// The train step's device phase stamp: one thread reads the card's
// %globaltimer (nanoseconds) and adds the time since the previous stamp to
// one phase's total, in the stream's order, so a step captured in a CUDA
// graph times its phases at every replay with no host read.
//
// acc: int64 [2 * phases + 1] = each phase's nanoseconds, each phase's
// count, the last stamp's time. slot < 0 (a step's first stamp) only sets
// the time. A stamp starts when the stream's previous kernel has ended, so a
// phase's total runs from the end of the last stamp before it to the start
// of the stamp after it: its kernels, the gaps between them, and one stamp.
#include <cuda_runtime.h>

namespace {

__global__ void phase_stamp_kernel(long long* acc, int slot, int phases, int counted) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  if (slot >= 0) {
    acc[slot] += t - acc[2 * phases];
    acc[phases + slot] += counted;
  }
  acc[2 * phases] = t;
}

}  // namespace

extern "C" int phase_stamp(void* acc, int slot, int phases, int counted, void* stream) {
  phase_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(acc), slot,
                                                                    phases, counted);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
