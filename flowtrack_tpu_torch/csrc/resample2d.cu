// K3/K4: the dense bilinear warp resample2d of the FlowNet2 cascade, for
// Hopper (sm_90a).
//
// Replaces both TPU kernels of flowtrack_tpu/ops/warp.py: _warp_kernel_mm
// (K3, entry resample2d_pallas_mm, the cascade's `pallas_warp_impl: matmul`)
// and _warp_kernel (K4, entry resample2d_pallas, `shift`). The two exist only
// because a TPU has no gather: K3 builds one-hot interpolation matrices for
// the MXU, K4 shift-accumulates over each row block's displacement range.
// They compute one function, that of the XLA twin resample2d /
// _bilinear_sample_clamp, which on the GPU is a direct gather. This kernel is
// held to K4's contract, the stricter one: the value of the XLA path, with
// its rounding.
//
// What it computes, per image n, output pixel (y, x) and channel c:
//   sx = clip(x + u[n, y, x], 0, W-1),  sy = clip(y + v[n, y, x], 0, H-1)
//   x0 = min(floor(sx), W-2),  y0 = min(floor(sy), H-2)   (clamped anchor)
//   wx = T(sx - x0),  wy = T(sy - y0)                       (T = image dtype)
//   top = img[y0, x0] * (1 - wx) + img[y0, x0+1] * wx
//   bot = img[y0+1, x0] * (1 - wx) + img[y0+1, x0+1] * wx
//   out = top * (1 - wy) + bot * wy
// A 1-wide axis has one tap and no weight (the reference's h < 2 / w < 2
// branches). Every multiply, add and subtract rounds once in T, as the
// reference's elementwise ops do: float32 through the _rn intrinsics, which
// nvcc never contracts into an FMA; bfloat16 by rounding each float32 result
// back to bfloat16 (a product of two bfloat16 values is exact in float32).
// So at integer flows, where every weight is 0 or 1, the result is bitwise
// the tap.
//
// Layout: NCHW planar, the layout of the port's cascade. img (N, C, H, W)
// float32 or bfloat16, flow (N, 2, H, W) float32 or bfloat16 (u then v), out
// like img.
//
// What bounds it on the card: bytes. On the main path (FlowNet2 at 384x640,
// 15 pairs of a clip, 3 channels, float32 glue) one warp reads 29.5 MB of
// flow and writes 44.2 MB; the 4 taps of a pixel hit neighbouring pixels of
// the same plane, so the 44.2 MB image is read about once from device memory
// and the rest from L1/L2: ~118 MB, some 35 us at 3.35 TB/s. There are 12
// flops per output value, so arithmetic never binds. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W: 0.056 ms per such warp (about 2.1 TB/s), against
// 1.15 ms for resample2d_plain.
//
// Design: one thread per output pixel (n, y, x), x fastest, so the flow
// reads and the output writes of a warp are contiguous runs of a plane and
// the taps of smooth flow are nearly so. The thread reads its two flow
// values once, computes the anchor and weights once, and loops over the
// channels. No shared memory: a tile would have to cover the flow's whole
// displacement range, and the L1 already serves the overlapping taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a float32 result rounded to the image dtype, kept as float32
template <typename T> struct Round;
template <> struct Round<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
};
template <> struct Round<__nv_bfloat16> {
  static __device__ __forceinline__ float to(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // v is already a bfloat16 value: exact
}

// a * om + b * wt with om = 1 - wt, each operation rounded in T
template <typename T>
__device__ __forceinline__ float lerp(float a, float b, float om, float wt) {
  return Round<T>::to(__fadd_rn(Round<T>::to(__fmul_rn(a, om)),
                                Round<T>::to(__fmul_rn(b, wt))));
}

template <typename TI, typename TF>
__global__ void resample2d_kernel(const TI* __restrict__ img,
                                  const TF* __restrict__ flow,
                                  TI* __restrict__ out, int n, int c, int h,
                                  int w) {
  const long long hw = static_cast<long long>(h) * w;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(n) * hw) return;
  const int b = static_cast<int>(t / hw);
  const long long p = t % hw;
  const int y = static_cast<int>(p / w);
  const int x = static_cast<int>(p % w);

  const TF* fl = flow + static_cast<long long>(b) * 2 * hw + p;
  const float sx = fminf(fmaxf(__fadd_rn(static_cast<float>(x), to_f32(fl[0])), 0.f),
                         static_cast<float>(w - 1));
  const float sy = fminf(fmaxf(__fadd_rn(static_cast<float>(y), to_f32(fl[hw])), 0.f),
                         static_cast<float>(h - 1));
  // anchor clamped to (W-2, H-2), weights recomputed against it
  const float x0 = w > 1 ? fminf(floorf(sx), static_cast<float>(w - 2)) : 0.f;
  const float y0 = h > 1 ? fminf(floorf(sy), static_cast<float>(h - 2)) : 0.f;
  const float wx = Round<TI>::to(__fsub_rn(sx, x0));
  const float wy = Round<TI>::to(__fsub_rn(sy, y0));
  const float omx = Round<TI>::to(__fsub_rn(1.f, wx));
  const float omy = Round<TI>::to(__fsub_rn(1.f, wy));

  const long long plane0 = static_cast<long long>(b) * c * hw;
  const TI* src = img + plane0 + static_cast<long long>(y0) * w + static_cast<int>(x0);
  TI* dst = out + plane0 + p;
  for (int ch = 0; ch < c; ++ch) {
    const TI* s = src + ch * hw;
    float v;
    if (h > 1 && w > 1) {
      const float top = lerp<TI>(to_f32(s[0]), to_f32(s[1]), omx, wx);
      const float bot = lerp<TI>(to_f32(s[w]), to_f32(s[w + 1]), omx, wx);
      v = lerp<TI>(top, bot, omy, wy);
    } else if (w > 1) {  // one row: 1-D along x
      v = lerp<TI>(to_f32(s[0]), to_f32(s[1]), omx, wx);
    } else if (h > 1) {  // one column: 1-D along y
      v = lerp<TI>(to_f32(s[0]), to_f32(s[w]), omy, wy);
    } else {             // one pixel
      v = to_f32(s[0]);
    }
    store(dst + ch * hw, v);
  }
}

template <typename TI, typename TF>
cudaError_t launch(const void* img, const void* flow, void* out, int n, int c,
                   int h, int w, cudaStream_t stream) {
  const long long pixels = static_cast<long long>(n) * h * w;
  const int threads = 256;
  const long long blocks = (pixels + threads - 1) / threads;
  resample2d_kernel<TI, TF><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const TI*>(img), static_cast<const TF*>(flow),
      static_cast<TI*>(out), n, c, h, w);
  return cudaGetLastError();
}

}  // namespace

// img: (n, c, h, w) contiguous, bfloat16 (img_bf16 = 1) or float32.
// flow: (n, 2, h, w) contiguous, bfloat16 (flow_bf16 = 1) or float32.
// out: (n, c, h, w) in img's dtype. Returns the cudaError_t of the launch
// (0 on success), or cudaErrorInvalidValue for an empty or negative shape.
extern "C" int ft_resample2d_forward(const void* img, const void* flow,
                                     void* out, int n, int c, int h, int w,
                                     int img_bf16, int flow_bf16,
                                     void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (img_bf16) {
    err = flow_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(img, flow, out, n, c, h, w, s)
                    : launch<__nv_bfloat16, float>(img, flow, out, n, c, h, w, s);
  } else {
    err = flow_bf16 ? launch<float, __nv_bfloat16>(img, flow, out, n, c, h, w, s)
                    : launch<float, float>(img, flow, out, n, c, h, w, s);
  }
  return static_cast<int>(err);
}
