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
// What bounds it on the card: the bytes. On the main path 384x640 frames
// give a 48x80x256 map, and a clip's 15 pairs read 2*15*48*80*256*2 B =
// 59 MB of bf16 features and write 15*441*48*80*4 B = 102 MB of float32
// volume: 161 MB, 0.048 ms at 3.35 TB/s. The 6.5 GMAC are 13 GFLOP, 0.013 ms
// on the tensor cores. On the float32 pipes (67 TFLOP/s) the same sums take
// 0.2 ms: that was the limit of a CUDA-core design, not of the card.
//
// Design, bfloat16 features (correlation_mma_kernel): for one (n, y, dy) the
// D*W sums are the even diagonals of a plain product,
//   P[x, x2] = sum_c f1[n, c, y, x] * f2[n, c, y + dy, x2],  |x2 - x| <= md,
// so they run on the tensor cores. A block takes one (n, y), up to 256
// columns x, and a share of the D rows y2 = y + dy. It stages f1[n, :, y, :]
// (C x W, x contiguous, as NCHW has it) in shared memory once and each
// f2[n, :, y2, :] in turn (cp.async; two blocks per SM overlap one's loads
// with the other's products). Where two whole rows do not fit a block's
// shared memory (a 1080p video's 240-wide map of 256 channels takes 254 KB)
// the channels go through in chunks of kc, both rows staged anew per chunk
// while the accumulators stay in registers, so any C and any W up to a few
// thousand run here. Two warps share 16 values of x, each with half of the band:
// per 16 channels a warp reads its A fragment (f1 transposed,
// ldmatrix.trans: the channel is the slow index) and the B fragments of the
// band x2 in [x0 - md, x0 + 15 + md] rounded outward to 8, at most eight n8
// tiles (four a warp), and runs mma.sync m16n8k16 with float32
// accumulators. Tiles wholly off the map are skipped and stay zero; columns
// between W and its round-up to 16 are zeros in shared memory. Each
// thread then stores the accumulators whose x2 - x is a displacement: for one
// accumulator register a warp's stores are four runs of eight consecutive x,
// whole 32-byte sectors; where it goes does not depend on dy and is worked
// out once. The off-band half of the products is dropped (35 GFLOP computed
// for 13 kept). Rows y2 off the map are written as zeros.
//
// float32 features keep the CUDA-core kernel below (correlation_kernel): the
// contract is a float32 product, which neither bf16 nor TF32 operands give.
// One thread owns (n, dy, y, x) for all dx: D sums in registers, f1 loaded
// once per channel, f2 for the D shifts; it is bound by the rate of its loads.
// It is also the route of bfloat16 features whose max displacement is over
// 24 (a band wider than a warp pair's eight n8 tiles), up to its 21
// displacements per axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

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

// ---- bfloat16 features: the band of f1^T f2 on mma.sync ---------------------

// a band is round8(md) + 16 + md <= 64 columns, eight n8 tiles: four a warp
constexpr int kWarpTiles = 4;
constexpr int kMaxBandMd = 24;
constexpr int kGroupW = 256;  // columns of x per block: 32 warps of a 1024-thread block
constexpr int kSmemLimit = 232448;

// Stages row y of every channel plane of f (n, c, h, w) into dst[cp][ld]:
// channels past c and columns past w as zeros.
__device__ __forceinline__ void stage_row(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long plane, int c, int cp,
                                          int w, int wp, int ld, bool vec) {
  const int chunks = wp / 8;
  for (int i = threadIdx.x; i < cp * chunks; i += blockDim.x) {
    const int ch = i / chunks;
    const int x = (i % chunks) * 8;
    __nv_bfloat16* d = dst + ch * ld + x;
    if (vec) {
      const bool ok = ch < c && x < w;  // w is a multiple of 8 here
      ft::cp_async16(ft::smem_u32(d), ok ? src + ch * plane + x : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (ch < c && x + e < w) ? src[ch * plane + x + e]
                                     : __float2bfloat16(0.f);
    }
  }
}

// THREADS: the most a block may hold. Maps up to 128 columns wide (the
// paths') run in blocks of at most 512 threads, which leaves each thread the
// registers it wants; wider maps take blocks of up to 1024.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    correlation_mma_kernel(const __nv_bfloat16* __restrict__ f1,
                           const __nv_bfloat16* __restrict__ f2,
                           float* __restrict__ out, int c, int h, int w,
                           int md, int stride2, int d, int kc, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cp = (c + 15) / 16 * 16;
  const int wp = (w + 15) / 16 * 16;
  const int ld = wp + 8;  // 16 bytes past a multiple of 32: ldmatrix rows spread over the banks
  __nv_bfloat16* s1 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s2 = s1 + kc * ld;
  const bool whole = kc >= cp;  // both rows fit with every channel
  const long long hw = static_cast<long long>(h) * w;
  const int b = blockIdx.x / h;
  const int y = blockIdx.x - b * h;
  const int lane = threadIdx.x & 31;
  // the block's columns [xg, xg + kGroupW); two warps share 16 values of x:
  // each takes half of the band's n8 tiles
  const int xg = blockIdx.z * kGroupW;
  const int x0 = xg + (threadIdx.x >> 6) * 16;
  const bool works = x0 < wp;  // the last group of a wide map may be short
  const int start = x0 - (md + 7) / 8 * 8 +     // first column of its half
                    ((threadIdx.x >> 5) & 1) * kWarpTiles * 8;
  const float inv_c = 1.f / static_cast<float>(c);

  const long long image = static_cast<long long>(b) * c * hw;
  if (whole) {
    stage_row(s1, f1 + image + static_cast<long long>(y) * w, hw, c, cp, w, wp,
              ld, vec);
    ft::cp_async_commit();
  }

  // Where each accumulator goes does not depend on dy. Accumulator (j, e)
  // holds x = x0 + lane / 4 + 8 (e / 2), x2 = start + 8 j + 2 (lane % 4) +
  // e % 2; it is kept if x2 - x is a displacement, at channel offset
  // (x2 - x + md) / stride2 of the row's D, else dropped (-1).
  int where[kWarpTiles][4];
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = x0 + (lane >> 2) + (e >> 1) * 8;
      const int x2 = start + j * 8 + (lane & 3) * 2 + (e & 1);
      const int shift = x2 - x + md;
      const bool keep =
          x < w && shift >= 0 && shift <= 2 * md && shift % stride2 == 0;
      where[j][e] = keep ? (shift / stride2) * static_cast<int>(hw) + x : -1;
    }

  for (int iy = blockIdx.y; iy < d; iy += gridDim.y) {
    const int y2 = y - md + iy * stride2;
    float* o = out + (static_cast<long long>(b) * d + iy) * d * hw +
               static_cast<long long>(y) * w;
    if (y2 < 0 || y2 >= h) {
      const int gw = min(kGroupW, w - xg);
      for (int i = threadIdx.x; i < d * gw; i += blockDim.x)
        o[(i / gw) * hw + xg + i % gw] = 0.f;
      continue;
    }

    float acc[kWarpTiles][4];
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // A = f1^T (x by channel) from [channel][x]: matrices (x 0-7, k 0-7),
    // (x 8-15, k 0-7), (x 0-7, k 8-15), (x 8-15, k 8-15), each transposed
    const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8;
    const int a_col = x0 + ((lane >> 3) & 1) * 8;
    for (int c0 = 0; c0 < cp; c0 += kc) {
      __syncthreads();  // the last products are done with the staged rows
      const long long chunk = image + static_cast<long long>(c0) * hw;
      if (!whole)
        stage_row(s1, f1 + chunk + static_cast<long long>(y) * w, hw, c - c0,
                  kc, w, wp, ld, vec);
      stage_row(s2, f2 + chunk + static_cast<long long>(y2) * w, hw, c - c0,
                kc, w, wp, ld, vec);
      ft::cp_async_commit();
      ft::cp_async_wait<0>();
      __syncthreads();
      if (!works) continue;
      const int kend = min(kc, cp - c0);
      for (int k0 = 0; k0 < kend; k0 += 16) {
        uint32_t a[4];
        ft::ldmatrix_x4_trans(a, ft::smem_u32(s1 + (k0 + a_row) * ld + a_col));
#pragma unroll
        for (int j = 0; j < kWarpTiles; j += 2) {
          const int col = start + j * 8;
          const bool ok0 = col >= 0 && col < wp;
          const bool ok1 = col + 8 >= 0 && col + 8 < wp;
          if (!ok0 && !ok1) continue;
          // B = f2 (channel by x2): lanes 0-15 address tile j, 16-31 tile j + 1
          int bcol = col + (lane >> 4) * 8;
          if (bcol < 0 || bcol >= wp) bcol = 0;
          uint32_t r[4];
          ft::ldmatrix_x4_trans(
              r, ft::smem_u32(s2 + (k0 + (lane & 15)) * ld + bcol));
          if (ok0) ft::mma_bf16(acc[j], a, r[0], r[1]);
          if (ok1) ft::mma_bf16(acc[j + 1], a, r[2], r[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (where[j][e] >= 0) o[where[j][e]] = acc[j][e] * inv_c;
  }
}

}  // namespace

// The CUDA-core kernel, the route of float32 features (is_bf16 = 0) and of
// bfloat16 features (is_bf16 = 1) whose max displacement the kernel below
// does not take. f1, f2: (n, c, h, w) contiguous.
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

// The tensor-core kernel, the route of bfloat16 features. f1, f2: (n, c, h, w)
// contiguous bfloat16; out: (n, d*d, h, w) float32 with d = len({-md, -md +
// stride2, ..., md}). md <= 24. kc: the channels staged at a time, a multiple
// of 16 up to round16(c), with two staged rows of kc channels,
// 2 * kc * (round16(w) + 8) * 2 bytes, within a block's shared memory
// (ops/correlation.py::band_plan chooses it). Returns the cudaError_t of the
// launch (0 on success), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int ft_correlation_mma(const void* f1, const void* f2, void* out,
                                  int n, int c, int h, int w, int md,
                                  int stride2, int d, int kc, void* stream) {
  const int cp = (c + 15) / 16 * 16;
  const int wp = (w + 15) / 16 * 16;
  const long long smem = 2ll * kc * (wp + 8) * 2;
  const int groups = (wp + kGroupW - 1) / kGroupW;
  if (!f1 || !f2 || !out || n < 1 || c < 1 || h < 1 || w < 1 || md < 0 ||
      md > kMaxBandMd || stride2 < 1 || d != 2 * md / stride2 + 1 ||
      kc < 16 || kc % 16 != 0 || kc > cp || smem > kSmemLimit ||
      groups > 65535 || static_cast<long long>(n) * h > 2147483647ll ||
      static_cast<long long>(d) * h * w > 2147483647ll)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64 * ((wp < kGroupW ? wp : kGroupW) / 16);
  auto kernel = threads <= 512 ? correlation_mma_kernel<512>
                               : correlation_mma_kernel<1024>;
  static std::atomic<unsigned long long> attribute_set{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attribute_set.load(std::memory_order_acquire) & bit)) {
    for (auto k : {correlation_mma_kernel<512>, correlation_mma_kernel<1024>}) {
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    attribute_set.fetch_or(bit, std::memory_order_release);
  }
  // 16-byte copies need every row of a plane to start on 16 bytes
  const bool vec = w % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(f1) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(f2) & 15) == 0;
  const dim3 grid(n * h, d < 3 ? d : 3, groups);
  kernel<<<grid, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f1),
      static_cast<const __nv_bfloat16*>(f2), static_cast<float*>(out), c, h, w,
      md, stride2, d, kc, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
