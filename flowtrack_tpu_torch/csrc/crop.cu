// K1: fused person crop + bilinear resize + normalize, for Hopper (sm_90a).
//
// Replaces the TPU kernel flowtrack_tpu/ops/crop.py::_crop_kernel (entry
// crop_resize_normalize_pallas) and its XLA twin crop_resize_normalize.
//
// What it computes, per crop p, output pixel (i, j) and channel c:
//   s     = (scale_x * pixel_std) / out_w        (crop_params, one s per crop)
//   tx    = cx - s * (out_w / 2),  ty = cy - s * (out_h / 2)
//   src_y = s * i + ty,  src_x = s * j + tx
//   v     = sum over the 2x2 taps of weight * frame[f_p][y, x, c]
//   out   = (v / rgb_max - mean[c]) / std[c]
// with the bilinear weights relu(1 - |src - tap|) of _bilinear_matrix and
// taps outside the frame weighing 0 (cv2's constant border, no clamping).
// The TPU kernel turned the resize into two MXU matmuls Wy . img . Wx^T
// because a TPU has no fast gather; each row of those matrices has at most
// two non-zero taps, so here the same sum is a 2x2 gather, the y taps summed
// first and the x taps second, the summation order of the einsum pair.
//
// The rounding of the parameters is written out (__fmul_rn, __fdiv_rn,
// __fsub_rn, __fadd_rn): s, tx, ty and every source coordinate must be the
// float32 values the reference computes, a true division and no fused
// multiply-add, or a coordinate that lies on a pixel boundary takes another
// tap than the plain version's. Working them out here also makes a pose pass
// one launch: the wrapper hands over centers, scales and the frame index as
// they arrive and launches nothing else.
//
// What bounds it: latency on the SM, not device memory and not the count of
// any one kind of instruction (measured on an NVIDIA H100 80GB HBM3 at
// 700.00 W; PERF.md's section on this kernel has each figure and its probe).
// For a clip's 128 crops (11.8 MB of uint8 frames in, 37.7 MB of bfloat16
// out; the card's bound is 0.0148 ms) this kernel takes 0.029 ms where the
// one-thread-per-pixel kernel it replaces took 0.087 ms. Of that time an
// empty kernel of the same grid is 0.003 ms, what every block works out
// before its gather 0.009 ms (parameters, spans, taps, the copy's addresses),
// the gather 0.016 ms and its stores 0.003 ms. Four other forms were built
// and timed first:
//   - a thread taking 8 neighbouring columns of one row, each plane written
//     with one 16-byte store: 0.042 ms. Its taps lie 24 * s bytes apart
//     across a warp's lanes (bank conflicts; up to 8-way for float32
//     frames), each thread works out 8 column taps for two rows of output,
//     and it needs 96 registers (18 warps an SM). Without its stores, or
//     without the copy into shared memory, it was 3% faster: there is reuse
//     worth staging for, but the gather was the cost;
//   - this form with two staging buffers and runs of two bands a block, the
//     next band's copy in flight during the gather: 0.045 ms against 0.042
//     with one band a block, so one buffer and 7 to 10 blocks an SM hide the
//     copy better than a pipeline inside the block;
//   - this form with the band's results collected in a shared-memory tile
//     and written as 16-byte vectors, a warp a row: 0.035 ms against 0.031:
//     the tile's way out costs 0.008 ms, the threads' own 2-byte stores
//     0.003 ms. A warp's lanes hold neighbouring columns, so its store
//     instruction writes 64 contiguous bytes (192 for float32);
//   - a staged pixel pair read as the 3 whole words that hold it: no change;
//     a block of 64 threads taking its columns in three passes: 0.034 ms.
//
// Design. One launch covers every crop of a pose pass. A block of TW threads
// (out_w rounded up to whole warps, at most 512; wider outputs in column
// tiles) owns TW output columns of one band of 8 output rows of one crop;
// block and place come from blockIdx alone (x: crop, y: band, z: tile).
//   - A thread owns one output column: its column tap (offset, two weights)
//     stays in registers; the band's 8 row taps are worked out by 8 threads
//     into shared memory while the copy is in flight. An off-frame tap gets
//     weight 0 and its address moves to the nearest in-frame pair, so the
//     gather has no branch on the data. A warp's lanes read neighbouring
//     pixels (3 * s bytes apart): no bank conflict up to s = 1.3, and a
//     direct read is coalesced.
//   - The thread walks down the band's rows and keeps the two source rows'
//     pixel pairs (12 values) in registers: a source row shared by
//     neighbouring output rows (s < 1) is read and converted once. The row
//     taps are the same for the whole block, so the walk's branches are
//     uniform. The walk stays a rolled loop (unrolled it was 20% slower).
//   - Staged path: the band's source rectangle (rows floor(src_y(i0)) ..
//     floor(src_y(i1)) + 1, the tile's column span, 3 bytes a pixel for uint8
//     frames, 12 for float32) is copied to shared memory with 16-byte
//     cp.async from addresses rounded down to 16 (16 KB, static: 10 blocks
//     an SM). Other blocks of the SM compute while the copy lands.
//   - Direct path, chosen per band by shape: when the rectangle exceeds the
//     buffer (kStageBytes: a box larger than the frame, s over about 1.7 for
//     uint8 frames at 192 columns, float32 frames at s over about 0.8), or
//     the frames' address is not 16-byte aligned, the same walk reads global
//     memory. At s over 2 the taps skip source pixels and the rectangle
//     holds more bytes than the taps touch, so this is no loss.
//   - normalize is one fused multiply-add, v * (1 / (rgb_max * std)) -
//     mean / std, the constants rounded once on the host in double and the
//     factor folded into the column's weights: with the reference's two IEEE
//     divisions the first form took 0.113 ms against 0.042 ms, more than the
//     kernel it replaced, for a difference of under 1e-6 in the normalized
//     value (tolerance 1e-4).
//   - uint8 frames are held to 32 registers a thread (10 blocks an SM): 5%
//     faster on the path's types, at 16 bytes of spills for float32 output.
//   - Stores are left to the default cache policy: marked streaming the
//     kernel alone is 4% faster, but the stem's convolution reads the crops
//     next and they fit the L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBandRows = 8;        // output rows of a band
constexpr int kStageBytes = 16384;  // one staging buffer
constexpr int kMaxThreads = 512;    // threads of a block at most

struct Normalize {
  float mul[3];  // 1 / (rgb_max * std)
  float add[3];  // -mean / std
};

struct RowTaps {  // of one output row: element offsets of the two tap rows
  int off0, off1;
  float w0, w1;
};

// floor(src) as an int clamped to [-2, size]; a NaN gives -2.
__device__ __forceinline__ int tap_floor(float src, int size) {
  return static_cast<int>(fminf(fmaxf(floorf(src), -2.f), static_cast<float>(size)));
}

// The two taps floor(src), floor(src) + 1 with weights relu(1 - |src - tap|),
// 0 for a tap off [0, size). Returns them as the pair (c, c + 1) inside
// [lo, hi] (0 <= lo < hi < size) that holds every in-frame tap: a tap outside
// the pair has weight 0 by then.
__device__ __forceinline__ void axis_taps(float src, int lo, int hi, int size,
                                          int& c, float& w0, float& w1) {
  const float f = floorf(src);
  float a = 1.f - (src - f), b = 1.f - ((f + 1.f) - src);
  const int t = tap_floor(src, size);
  if (t < 0 || t >= size) a = 0.f;
  if (t + 1 < 0 || t + 1 >= size) b = 0.f;
  c = min(max(t, lo), hi - 1);
  w0 = (c == t) ? a : (c == t + 1 ? b : 0.f);
  w1 = (c == t) ? b : (c + 1 == t ? a : 0.f);
  if (src != src) w0 = w1 = src;  // a NaN parameter shows as a NaN crop
}

__device__ __forceinline__ float src_coord(float s, int i, float t) {
  // s * i + t rounded as the reference rounds it (no fused multiply-add)
  return __fadd_rn(__fmul_rn(s, static_cast<float>(i)), t);
}

// [lo, hi] in [0, size): the in-frame taps of output indices i0..i1, at least
// two wide.
__device__ __forceinline__ void tap_span(float s, float t, int i0, int i1,
                                         int size, int& lo, int& hi) {
  const int a = tap_floor(src_coord(s, i0, t), size);
  const int b = tap_floor(src_coord(s, i1, t), size);
  lo = min(max(min(a, b), 0), size - 2);
  hi = min(max(max(a, b) + 1, lo + 1), size - 1);
}

__device__ __forceinline__ float to_float(uint8_t b) { return static_cast<float>(b); }
__device__ __forceinline__ float to_float(float v) { return v; }

// The two neighbouring pixels at p: tap 0's three channels, then tap 1's.
template <typename TIn>
__device__ __forceinline__ void load_pair(const TIn* p, float (&v)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = to_float(p[k]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *reinterpret_cast<unsigned short*>(dst) = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

// One band of one column: walks the band's rows with the two source rows'
// pixel pairs in registers; value (row q, channel c) goes to
// dst[c * plane + q * out_w]. `base` is the staging buffer or the frame, by
// address space. The loop stays rolled: unrolled, the walk was 20% slower.
template <typename TIn, typename TOut>
__device__ __forceinline__ void gather_band(
    const TIn* base, const RowTaps* rows, int nrows, const float (&a0)[3],
    const float (&a1)[3], const float (&add)[3], TOut* dst, size_t plane,
    int out_w) {
  float top[6], bottom[6];
  int have0 = -1, have1 = -1;  // the offsets of the rows in top and bottom
  TOut* d0 = dst;
  TOut* d1 = dst + plane;
  TOut* d2 = d1 + plane;
#pragma unroll 1
  for (int q = 0; q < nrows; ++q) {
    const RowTaps row = rows[q];
    if (row.off0 != have0) {
      if (row.off0 == have1) {
#pragma unroll
        for (int k = 0; k < 6; ++k) top[k] = bottom[k];
      } else {
        load_pair(base + row.off0, top);
      }
      load_pair(base + row.off1, bottom);
      have0 = row.off0;
      have1 = row.off1;
    }
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float col0 = row.w0 * top[c] + row.w1 * bottom[c];
      const float col1 = row.w0 * top[3 + c] + row.w1 * bottom[3 + c];
      v[c] = fmaf(col0, a0[c], fmaf(col1, a1[c], add[c]));
    }
    store1(d0, v[0]);
    store1(d1, v[1]);
    store1(d2, v[2]);
    d0 += out_w;
    d1 += out_w;
    d2 += out_w;
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kMaxThreads, sizeof(TIn) == 1 ? 4 : 2)
crop_band_kernel(
    const TIn* __restrict__ frames, int num_frames, int h, int w,
    const void* __restrict__ frame_idx, int idx64,
    const float* __restrict__ centers, const float* __restrict__ scales,
    int out_h, int out_w, float pixel_std, Normalize norm,
    TOut* __restrict__ out, int* __restrict__ band_counts) {
  __shared__ __align__(16) unsigned char stage[kStageBytes];
  __shared__ RowTaps row_taps[kBandRows];

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tw = blockDim.x, nwarps = tw >> 5;
  const int i0 = blockIdx.y * kBandRows;              // the band's first row
  const int nrows = min(kBandRows, out_h - i0);       // its rows
  const int j_tile = blockIdx.z * tw;                 // the tile's first column
  const int tile_w = min(tw, out_w - j_tile);         // its columns
  const int j = j_tile + tid;                         // this thread's
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  TOut* const band_out = out + static_cast<size_t>(p) * 3 * plane +
                         static_cast<size_t>(i0) * out_w;

  // the crop's three inputs in flight together, ahead of the index check
  const float scale_x = scales[2 * p], cx = centers[2 * p], cy = centers[2 * p + 1];
  const long long f = idx64 ? static_cast<const long long*>(frame_idx)[p]
                            : static_cast<const int*>(frame_idx)[p];
  if (f < 0 || f >= num_frames) {  // a bad index shows as NaN, never a stray read
    if (j < out_w)
      for (int q = 0; q < nrows; ++q)
        for (int c = 0; c < 3; ++c)
          store1(band_out + c * plane + q * out_w + j, __int_as_float(0x7fc00000));
    return;
  }

  // crop_params, rounded as the reference rounds them
  const float s = __fdiv_rn(__fmul_rn(scale_x, pixel_std), static_cast<float>(out_w));
  const float t_x = __fsub_rn(cx, __fmul_rn(s, 0.5f * out_w));
  const float t_y = __fsub_rn(cy, __fmul_rn(s, 0.5f * out_h));

  // the tile's column span and the band's row span
  int x_lo, x_hi, y_lo, y_hi;
  tap_span(s, t_x, j_tile, j_tile + tile_w - 1, w, x_lo, x_hi);
  tap_span(s, t_y, i0, i0 + nrows - 1, h, y_lo, y_hi);

  constexpr int kPx = 3 * sizeof(TIn);  // bytes of a pixel
  // a staged row: the span's bytes from a source address rounded down to 16
  const int stride = (((x_hi - x_lo + 1) * kPx + 15 + 15) / 16) * 16;
  const int src_rows = y_hi - y_lo + 1;
  const bool staged = (reinterpret_cast<uintptr_t>(frames) & 15) == 0 &&
                      src_rows * stride <= kStageBytes;
  // offsets below are bytes from this frame's start: 32 bits do (a frame has
  // under 2^31 bytes); `last` is where the last frame ends, and no copy reads
  // past it
  const int row_bytes = w * kPx;
  const unsigned char* const frame =
      reinterpret_cast<const unsigned char*>(frames) + static_cast<size_t>(f) * h * row_bytes;
  const int frame_low = static_cast<int>(reinterpret_cast<uintptr_t>(frame) & 15);
  const long long to_last = static_cast<long long>(num_frames - f) * h * row_bytes;
  const int last = to_last > 0x7fffffff ? 0x7fffffff : static_cast<int>(to_last);

  if (staged) {
    for (int r = warp; r < src_rows; r += nwarps) {
      const int first = (y_lo + r) * row_bytes + x_lo * kPx;
      const int at0 = first - ((frame_low + first) & 15);
      const uint32_t dst = ft::smem_u32(stage + r * stride);
      for (int ch = lane * 16; ch < stride; ch += 32 * 16) {
        const int n = min(max(last - (at0 + ch), 0), 16);
        ft::cp_async16_head(dst + ch, frame + (n ? at0 + ch : 0), n);
      }
    }
    ft::cp_async_commit();
  }
  // while the copy is in flight: the band's row taps
  if (tid < kBandRows) {
    int c;
    RowTaps taps;
    axis_taps(src_coord(s, min(i0 + tid, out_h - 1), t_y), y_lo, y_hi, h, c,
              taps.w0, taps.w1);
    if (staged) {
      const int first = c * row_bytes + x_lo * kPx;
      const int m0 = (frame_low + first) & 15, m1 = (frame_low + first + row_bytes) & 15;
      taps.off0 = ((c - y_lo) * stride + m0) / static_cast<int>(sizeof(TIn));
      taps.off1 = ((c + 1 - y_lo) * stride + m1) / static_cast<int>(sizeof(TIn));
    } else {
      taps.off0 = c * w * 3;
      taps.off1 = taps.off0 + w * 3;
    }
    row_taps[tid] = taps;
  }
  ft::cp_async_wait<0>();
  __syncthreads();  // the copy and the row taps are visible
  if (band_counts != nullptr && tid == 0) atomicAdd(band_counts + (staged ? 0 : 1), 1);

  // this thread's column tap, the normalize (v * mul + add) folded into its
  // weights
  if (j < out_w) {
    int xc;
    float cw0, cw1;
    axis_taps(src_coord(s, j, t_x), x_lo, x_hi, w, xc, cw0, cw1);
    const float a0[3] = {cw0 * norm.mul[0], cw0 * norm.mul[1], cw0 * norm.mul[2]};
    const float a1[3] = {cw1 * norm.mul[0], cw1 * norm.mul[1], cw1 * norm.mul[2]};
    const int coff = (xc - x_lo) * 3;
    if (staged)
      gather_band<TIn, TOut>(reinterpret_cast<const TIn*>(stage) + coff, row_taps, nrows, a0, a1, norm.add, band_out + j, plane, out_w);
    else
      gather_band<TIn, TOut>(reinterpret_cast<const TIn*>(frame) + x_lo * 3 + coff, row_taps, nrows, a0, a1, norm.add, band_out + j, plane, out_w);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* frames, int num_frames, int h, int w,
                   const void* frame_idx, int idx64, const void* centers,
                   const void* scales, int num_crops, int out_h, int out_w,
                   float pixel_std, const Normalize& norm, void* out,
                   int* band_counts, cudaStream_t stream) {
  // column tiles of equal width, a thread a column, whole warps
  const int tiles = (out_w + kMaxThreads - 1) / kMaxThreads;
  const int tw = ((out_w + tiles - 1) / tiles + 31) / 32 * 32;
  const dim3 grid(num_crops, (out_h + kBandRows - 1) / kBandRows, tiles);
  crop_band_kernel<TIn, TOut><<<grid, tw, 0, stream>>>(
      static_cast<const TIn*>(frames), num_frames, h, w, frame_idx, idx64,
      static_cast<const float*>(centers), static_cast<const float*>(scales),
      out_h, out_w, pixel_std, norm, static_cast<TOut*>(out), band_counts);
  return cudaGetLastError();
}

}  // namespace

// frames: (num_frames, h, w, 3) uint8 (frames_u8 = 1) or float32, contiguous,
// h and w at least 2. frame_idx: (num_crops,) int64 (idx64 = 1) or int32.
// centers, scales: (num_crops, 2) float32, contiguous. out: (num_crops, 3,
// out_h, out_w), bfloat16 (out_bf16 = 1) or float32.
// band_counts: null, or two int32 on the device to which each block adds the
// bands it took staged ([0]) and direct ([1]). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ft_crop_resize_normalize(
    const void* frames, int frames_u8, int num_frames, int h, int w,
    const void* frame_idx, int idx64, const void* centers, const void* scales,
    int num_crops, int out_h, int out_w, float pixel_std, float rgb_max,
    float mean0, float mean1, float mean2, float std0, float std1, float std2,
    void* out, int out_bf16, void* band_counts, void* stream) {
  Normalize norm;
  const float mean[3] = {mean0, mean1, mean2}, std[3] = {std0, std1, std2};
  for (int c = 0; c < 3; ++c) {
    norm.mul[c] = static_cast<float>(1.0 / (static_cast<double>(rgb_max) * std[c]));
    norm.add[c] = static_cast<float>(-static_cast<double>(mean[c]) / std[c]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(band_counts);
#define FT_CROP_LAUNCH(TIN, TOUT)                                              \
  launch<TIN, TOUT>(frames, num_frames, h, w, frame_idx, idx64, centers,       \
                    scales, num_crops, out_h, out_w, pixel_std, norm, out,     \
                    counts, s)
  cudaError_t err;
  if (frames_u8)
    err = out_bf16 ? FT_CROP_LAUNCH(uint8_t, __nv_bfloat16)
                   : FT_CROP_LAUNCH(uint8_t, float);
  else
    err = out_bf16 ? FT_CROP_LAUNCH(float, __nv_bfloat16)
                   : FT_CROP_LAUNCH(float, float);
#undef FT_CROP_LAUNCH
  return static_cast<int>(err);
}

// Message for a cudaError_t returned by any entry point of this library.
extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
