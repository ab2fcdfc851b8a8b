// The device clock between a program's stages: one thread writes the
// global timer (%globaltimer, nanoseconds) into buf[i].
//
// Launched on the stream that runs the program, the kernel starts once the
// work queued before it has finished, so the difference of two stamps is
// the device time of the work between them. Inside a CUDA graph the kernel
// is a node like any other and reads the clock anew at every replay, which
// CUDA events recorded at capture do not give a caller who reads them after
// the next replay was queued. No TPU counterpart.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* buf, int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[i] = static_cast<long long>(t);
}

}  // namespace

// buf: int64 device memory with at least i + 1 elements. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ft_stamp(void* buf, int i, void* stream) {
  if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), i);
  return static_cast<int>(cudaGetLastError());
}
