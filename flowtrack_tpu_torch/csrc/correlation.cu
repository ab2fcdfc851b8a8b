// K2: the FlowNetC cost volume (correlation forward), for Hopper (sm_90a).
//
// Replaces the TPU kernel flowtrack_tpu/ops/correlation.py::_corr_kernel
// (entry correlation_pallas) and its XLA twin correlation_xla.
//
// What it computes: kernel size 1, stride1 1, displacements
// {-md, -md + s2, ..., md} on both axes (D per axis, D*D channels, dy-major
// and dx-minor as the lineage's top_channel = y_shift * D + x_shift):
//   out[n, dy*D + dx, y, x] = (sum_c f1[n, c, y, x] * f2[n, c, y + dy, x + dx]) * (1 / C)
// with f2 read as 0 outside the map, products summed in float32 and scaled
// by 1/C after the sum (as correlation_xla does). Inputs are NCHW in the
// model dtype (bfloat16 or float32); the output is float32 (N, D*D, H, W),
// the layout conv3_1 consumes.
//
// On the main path the volume is small: 384x640 frames give a 48x80x256
// map, and a 16-frame clip (15 pairs) needs 15*441*48*80*256 = 6.5 GMAC.
// It reads 2*15*48*80*256*2 B = 59 MB of bf16 features and writes
// 15*441*48*80*4 B = 102 MB of float32 volume. At 13 GFLOP on the float32
// pipes (67 TFLOP/s) against 161 MB at 3.35 TB/s, the floor is the float32
// arithmetic (about 0.2 ms), and in this simple form the load issue rate.
//
// Design: the TPU kernel walked the displacements in a sequential grid loop
// over a VMEM halo of f2. Here one thread owns one output row of D
// displacements, (n, dy, y, x) for all dx: it keeps the D sums in
// registers, loads f1[c, y, x] once per channel and reuses it D times, and
// reads f2[c, y + dy, x + dx] for the D shifts. Neighbouring threads take
// neighbouring x, so every load of a warp is one contiguous run of a
// channel plane, and the shifted f2 reads of one warp overlap in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 21;  // displacements per axis held in registers (md 20, s2 2)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void correlation_kernel(const T* __restrict__ f1,
                                   const T* __restrict__ f2,
                                   float* __restrict__ out, int n, int c,
                                   int h, int w, int md, int stride2, int d) {
  const long long hw = static_cast<long long>(h) * w;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(n) * d * hw) return;
  const int x = static_cast<int>(t % w);
  const int y = static_cast<int>((t / w) % h);
  const int iy = static_cast<int>((t / hw) % d);
  const int b = static_cast<int>(t / (hw * d));
  const int y2 = y - md + iy * stride2;

  float acc[kMaxD];
#pragma unroll
  for (int jx = 0; jx < kMaxD; ++jx) acc[jx] = 0.f;

  if (y2 >= 0 && y2 < h) {
    const T* a = f1 + static_cast<long long>(b) * c * hw + static_cast<long long>(y) * w + x;
    const T* row2 = f2 + static_cast<long long>(b) * c * hw + static_cast<long long>(y2) * w;
    for (int ch = 0; ch < c; ++ch) {
      const float va = to_f32(a[ch * hw]);
      const T* r = row2 + ch * hw;
#pragma unroll
      for (int jx = 0; jx < kMaxD; ++jx) {
        const int x2 = x - md + jx * stride2;
        if (jx < d && x2 >= 0 && x2 < w) acc[jx] += va * to_f32(r[x2]);
      }
    }
  }
  const float inv_c = 1.f / static_cast<float>(c);
  float* o = out + ((static_cast<long long>(b) * d + iy) * d) * hw +
             static_cast<long long>(y) * w + x;
#pragma unroll
  for (int jx = 0; jx < kMaxD; ++jx) {
    if (jx < d) o[jx * hw] = acc[jx] * inv_c;
  }
}

template <typename T>
cudaError_t launch(const void* f1, const void* f2, void* out, int n, int c,
                   int h, int w, int md, int stride2, int d,
                   cudaStream_t stream) {
  const long long threads_needed = static_cast<long long>(n) * d * h * w;
  const int threads = 128;
  const long long blocks = (threads_needed + threads - 1) / threads;
  correlation_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<float*>(out), n, c, h, w, md, stride2, d);
  return cudaGetLastError();
}

}  // namespace

// f1, f2: (n, c, h, w) contiguous, bfloat16 (is_bf16 = 1) or float32.
// out: (n, d*d, h, w) float32 with d = len({-md, -md + stride2, ..., md}) <= 21.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue when d is out of range.
extern "C" int ft_correlation_forward(const void* f1, const void* f2,
                                      void* out, int n, int c, int h, int w,
                                      int md, int stride2, int d, int is_bf16,
                                      void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(f1, f2, out, n, c, h, w, md, stride2, d, s)
              : launch<float>(f1, f2, out, n, c, h, w, md, stride2, d, s);
  return static_cast<int>(err);
}
