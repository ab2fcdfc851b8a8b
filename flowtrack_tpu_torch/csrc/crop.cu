// K1: fused person crop + bilinear resize + normalize, for Hopper (sm_90a).
//
// Replaces the TPU kernel flowtrack_tpu/ops/crop.py::_crop_kernel (entry
// crop_resize_normalize_pallas) and its XLA twin crop_resize_normalize.
//
// What it computes, per crop p, output pixel (i, j) and channel c:
//   src_y = sy * i + ty,  src_x = sx * j + tx
//   v     = sum over the 2x2 taps of weight * frame[f_p][y, x, c]
//   out   = (v / rgb_max - mean[c]) / std[c]
// with the bilinear weights relu(1 - |src - tap|) of _bilinear_matrix and
// taps outside the frame weighing 0 (cv2's constant border, no clamping).
//
// The TPU kernel turned the resize into two MXU matmuls Wy . img . Wx^T
// because a TPU has no fast gather. Each row of those matrices has at most
// two non-zero taps (no antialiasing), so on the GPU the same sum is a
// direct 2x2 gather: one thread per output pixel, all three channels, the
// normalize fused, written once in the output dtype. The y taps are summed
// first and the x taps second, the summation order of the einsum pair, so
// float32 stays within a few ulp of the reference.
//
// What bounds it on the card: memory. Per crop it writes 3*oh*ow outputs
// (256x192 crops: 295 KB in bf16) and reads at most 4 frame pixels per
// output from a frame that stays in L2 (one 384x640x3 float32 frame is
// 2.9 MB, a 16-frame clip 47 MB of the card's 50 MB L2). There is no reuse
// worth staging in shared memory: neighbouring threads read neighbouring
// pixels, which the L1 serves.
//
// The crop reads the whole clip's frames (F, H, W, 3) with a per-crop frame
// index, so the detector crops of a clip and the recovery crops are one
// launch each and no per-crop copy of a frame is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_px(const uint8_t* p) {
  return static_cast<float>(*p);
}
__device__ __forceinline__ float load_px(const float* p) { return *p; }

__device__ __forceinline__ void store_px(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_px(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Normalize {
  float rgb_max;
  float mean[3];
  float std[3];
};

template <typename TIn, typename TOut>
__global__ void crop_resize_normalize_kernel(
    const TIn* __restrict__ frames, int num_frames, int h, int w,
    const int* __restrict__ frame_idx, const float4* __restrict__ params,
    int num_crops, int out_h, int out_w, Normalize norm,
    TOut* __restrict__ out) {
  const long long plane = static_cast<long long>(out_h) * out_w;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= plane * num_crops) return;
  const int p = static_cast<int>(t / plane);
  const int oy = static_cast<int>((t % plane) / out_w);
  const int ox = static_cast<int>(t % out_w);
  TOut* dst = out + static_cast<long long>(p) * 3 * plane +
              static_cast<long long>(oy) * out_w + ox;

  const int f = frame_idx[p];
  if (f < 0 || f >= num_frames) {  // a bad index shows as NaN, never a stray read
    for (int c = 0; c < 3; ++c) store_px(dst + c * plane, __int_as_float(0x7fc00000));
    return;
  }
  const float4 prm = params[p];  // sx, tx, sy, ty
  // src = s * i + t, rounded as the reference rounds it (no fused multiply-add)
  const float src_y = __fadd_rn(__fmul_rn(prm.z, static_cast<float>(oy)), prm.w);
  const float src_x = __fadd_rn(__fmul_rn(prm.x, static_cast<float>(ox)), prm.y);
  const float fy = floorf(src_y);
  const float fx = floorf(src_x);
  // relu(1 - |src - tap|) for the two taps floor(src) and floor(src) + 1
  const float wy0 = 1.f - (src_y - fy), wy1 = 1.f - ((fy + 1.f) - src_y);
  const float wx0 = 1.f - (src_x - fx), wx1 = 1.f - ((fx + 1.f) - src_x);
  // clamp before the int conversion; a tap clamped off the frame weighs 0 anyway
  const int y0 = static_cast<int>(fminf(fmaxf(fy, -2.f), static_cast<float>(h)));
  const int x0 = static_cast<int>(fminf(fmaxf(fx, -2.f), static_cast<float>(w)));
  const bool iny0 = y0 >= 0 && y0 < h, iny1 = y0 + 1 >= 0 && y0 + 1 < h;
  const bool inx0 = x0 >= 0 && x0 < w, inx1 = x0 + 1 >= 0 && x0 + 1 < w;

  const TIn* img = frames + static_cast<long long>(f) * h * w * 3;
  const TIn* r0 = img + (static_cast<long long>(y0) * w + x0) * 3;
  const TIn* r1 = r0 + static_cast<long long>(w) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = (iny0 && inx0) ? load_px(r0 + c) : 0.f;
    const float v01 = (iny0 && inx1) ? load_px(r0 + 3 + c) : 0.f;
    const float v10 = (iny1 && inx0) ? load_px(r1 + c) : 0.f;
    const float v11 = (iny1 && inx1) ? load_px(r1 + 3 + c) : 0.f;
    const float col0 = wy0 * v00 + wy1 * v10;
    const float col1 = wy0 * v01 + wy1 * v11;
    const float v = col0 * wx0 + col1 * wx1;
    store_px(dst + c * plane, (v / norm.rgb_max - norm.mean[c]) / norm.std[c]);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* frames, int num_frames, int h, int w,
                   const void* frame_idx, const void* params, int num_crops,
                   int out_h, int out_w, const Normalize& norm, void* out,
                   cudaStream_t stream) {
  const long long n = static_cast<long long>(num_crops) * out_h * out_w;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  crop_resize_normalize_kernel<TIn, TOut><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const TIn*>(frames), num_frames, h, w,
      static_cast<const int*>(frame_idx), static_cast<const float4*>(params),
      num_crops, out_h, out_w, norm, static_cast<TOut*>(out));
  return cudaGetLastError();
}

}  // namespace

// frames: (num_frames, h, w, 3) uint8 (frames_u8 = 1) or float32, contiguous.
// frame_idx: (num_crops,) int32. params: (num_crops, 4) float32 [sx, tx, sy, ty].
// out: (num_crops, 3, out_h, out_w), bfloat16 (out_bf16 = 1) or float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ft_crop_resize_normalize(
    const void* frames, int frames_u8, int num_frames, int h, int w,
    const void* frame_idx, const void* params, int num_crops, int out_h,
    int out_w, float rgb_max, float mean0, float mean1, float mean2,
    float std0, float std1, float std2, void* out, int out_bf16,
    void* stream) {
  const Normalize norm{rgb_max, {mean0, mean1, mean2}, {std0, std1, std2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (frames_u8) {
    err = out_bf16 ? launch<uint8_t, __nv_bfloat16>(frames, num_frames, h, w, frame_idx, params, num_crops, out_h, out_w, norm, out, s)
                   : launch<uint8_t, float>(frames, num_frames, h, w, frame_idx, params, num_crops, out_h, out_w, norm, out, s);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(frames, num_frames, h, w, frame_idx, params, num_crops, out_h, out_w, norm, out, s)
                   : launch<float, float>(frames, num_frames, h, w, frame_idx, params, num_crops, out_h, out_w, norm, out, s);
  }
  return static_cast<int>(err);
}

// Message for a cudaError_t returned by any entry point of this library.
extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
