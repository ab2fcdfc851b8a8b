// K5: the BN-folded bottleneck chain of a ResNet stage, for Hopper (sm_90a),
// on wgmma.
//
// Replaces the TPU kernel flowtrack_tpu/ops/fused_resnet.py::_stage_kernel
// (entry fused_stage_pallas, via _chunk_pallas). Per stride-1 block, on NHWC
// bfloat16 activations (row-major (M, C), M = B*H*W pixels):
//   conv1  y1 = bf16(relu(x  @ w1 + b1))                      1x1, K = Cin
//   conv2  y2 = bf16(relu(im2col3x3(y1) @ w2 + b2))           3x3 pad 1, K = 9F
//   conv3  out = bf16(relu((y2 @ w3 + b3) + res))             1x1, K = F
// with res = float(x) (identity) or (x @ wd + bd) (projection, in its own
// float32 accumulator as the reference does). Operands bfloat16, sums
// float32 on the tensor cores, biases float32, one rounding to bfloat16
// (nearest even) after each conv.
//
// Weights arrive transposed, (N, K) row-major with K contiguous
// (ops/fused_resnet.py::transposed_weights): w1t (F, Cin), w2t (F, 9F) with
// K index ((a*3 + b)*F + c) for kernel row a, column b, channel c, w3t
// (4F, F), wdt (4F, Cin). Both wgmma operands are then K-major tiles of 64
// bf16 (128 bytes) per row, which a TMA load leaves in shared memory under
// the 128-byte swizzle exactly as wgmma's descriptor reads them.
//
// What bounds it on the card. The four stride-1 chunks of R50 at 256 crops
// are 1.43 TFLOP: 1.45 ms at the H100's 989 TFLOP/s bf16, and only wgmma
// reaches that rate. One launch per conv moves every y1, y2 and block output
// through device memory: 4.2 GB at layer1 and 2.4 GB at layer2 (1.26 and
// 0.72 ms at 3.35 TB/s against 0.34 and 0.33 ms of tensor-core time), so
// there the bytes bind, not the products; layers 3 and 4 (K >= 256 in every
// GEMM, most K >= 1024) are bound by the products.
//
// Design, two kernels with one main loop shape: a ring of four shared-memory
// stages (five in the block kernel at F = 64, where they fit) with a full and
// an empty mbarrier each, one producer warp whose
// first lane starts the TMA loads, three consumer warpgroups that run
// wgmma.mma_async m64nNk16 with float32 accumulators in registers. Both are
// persistent: one block per SM walks over the output tiles, so the ring
// already holds the next tile's first K tiles while this tile's epilogue
// runs. Results leave as they came: each thread writes its bf16 pairs into a
// swizzled TMA box in shared memory (over the identity residual, which a TMA
// load put there, read where the accumulator's element lies), and each
// warpgroup's 64 rows go out by one TMA store per 64 channels, whole rows of
// 128 bytes; the store clips the rows past M, so any batch works. The
// epilogue reads eight residual words before it writes the first result, so
// that the reads are in flight together.
//
// What is left, measured (the same launches with their stores, their
// activations' loads and the residual's load left out): with no activation
// traffic at all the four chunks still take three quarters of their time, so
// most of it is spent on the SM, not waiting for device memory. Two things hold it there. A 192 x 128 tile of m64n128k16 products
// reads 6 KB of shared memory per 64 tensor-core cycles while the TMA writes
// the next stage: about 150 bytes a cycle against the SM's 128, so the main
// loop cannot pass ~85% of the peak; only a 256-wide tile (128 accumulator
// registers a thread, two consumer warpgroups) lowers that. And a tile's
// epilogue runs on the warps that start its products, so the tensor cores
// idle through it: at K = 256 or 512 (every conv3) it is over half a tile's
// time; two consumer groups on alternate tiles would hide it.
//
// conv_wgmma_kernel, one conv per launch (layers 3 and 4, and any shape the
// block kernel does not take). A 192 x BN output tile (BN 128, or 64), one
// m64 slice per warpgroup, K tiles of 64. A 1x1's activations are a 2-D box
// of the (M, C) matrix (rows past M read as zeros). A 3x3's are a 4-D box of
// (B, H, W, C) at (y + dy, x + dx) for the tap, whose out-of-image part the
// TMA fills with zeros: the tile is `rows` image rows of one image, or `nb`
// whole images, at most 192 pixels. Any image up to 192 pixels wide tiles so:
// where the tile's pixels are no multiple of 64, the rows of the stage past
// them hold stale values, whose products land in accumulator rows that never
// leave (the tile's last warpgroup stores through a box of just its rows).
// A stage is released one K tile late, when wgmma.wait_group 1 has shown its
// products done.
//
// block_wgmma_kernel, a whole block per launch (layers 1 and 2, F = 64 and
// 128). A tile is `rows` image rows of one image (192 pixels at R50's
// shapes). conv1 runs over the tile and one halo row above and below (two
// passes of three m64 slices; the halo's conv1 is computed twice across
// tiles), writes y1 to shared memory (zeros for halo rows off the image) and
// nowhere else. conv2 takes its A operand from registers: ldmatrix reads each
// warp's 16 pixels of y1 shifted by the tap, a zero row where x + dx leaves
// the image, so no shifted copy of y1 is ever stored; w2t streams through
// the ring. y2 never leaves registers: the float32 accumulator layout of
// wgmma is its A-fragment layout, so bf16(relu(acc2 + b2)) is packed in place
// and feeds conv3, four chunks of F output channels, each with its epilogue:
// the projection x @ wd in a second accumulator, or the identity residual,
// which the TMA brings as a box of x into the stage that carries the chunk's
// weights. Device memory sees x once for conv1, once more for the residual,
// and the output once. Here a stage goes back the moment its products are
// done: measured, the loads' latency is what this kernel waits for, and
// every later release cost more than the overlap it bought.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <array>
#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>

#include "hopper.cuh"

namespace {

using namespace ft;

constexpr int kTM = 192;                      // pixels per tile: three m64 slices
constexpr int kBK = 64;                       // K per stage: one swizzled 128-byte row
constexpr int kConsumers = 3;                 // warpgroups, one m64 slice each
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kATile = kTM * kBK * 2;         // bytes of a stage's activations
constexpr int kSlice = 64 * kBK * 2;          // bytes of one m64 slice
constexpr int kSmemLimit = 232448;            // a block's shared memory on sm_90

// ---------------------------------------------------------------------------
// TMA descriptors (host)
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that the library links
// against nothing but cudart.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A descriptor depends only on the pointer, the shape and the box, so it is
// made once per such key and kept (weights keep their pointers; PyTorch's
// allocator hands the activations' back again).
using MapKey = std::array<uint64_t, 8>;

bool cached_map(const MapKey& key, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMap* out) {
  static std::mutex mutex;
  static std::map<MapKey, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      reinterpret_cast<void*>(key[0]), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return true;
}

// Row-major (rows, cols) bf16 matrix, boxes of box_rows x 64 columns.
bool matrix_map(const void* ptr, int rows, int cols, int box_rows,
                CUtensorMap* out) {
  const MapKey key{reinterpret_cast<uint64_t>(ptr), 2,
                   static_cast<uint64_t>(rows), static_cast<uint64_t>(cols),
                   static_cast<uint64_t>(box_rows), 0, 0, 0};
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  return cached_map(key, 2, dims, strides, box, out);
}

// NHWC (b, h, w, c) bf16 images, boxes of box_b images x box_h rows x the
// whole width x 64 channels.
bool image_map(const void* ptr, int b, int h, int w, int c, int box_h,
               int box_b, CUtensorMap* out) {
  const MapKey key{reinterpret_cast<uint64_t>(ptr), 4,
                   static_cast<uint64_t>(b), static_cast<uint64_t>(h),
                   static_cast<uint64_t>(w), static_cast<uint64_t>(c),
                   static_cast<uint64_t>(box_h), static_cast<uint64_t>(box_b)};
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(w) * c * 2,
                                 static_cast<cuuint64_t>(h) * w * c * 2};
  const cuuint32_t box[4] = {kBK, static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(box_h),
                             static_cast<cuuint32_t>(box_b)};
  return cached_map(key, 4, dims, strides, box, out);
}

// ---------------------------------------------------------------------------
// The ring
// ---------------------------------------------------------------------------

// Stage s of a ring of `stages`: its full barrier (one arrival, the
// producer's, plus the TMA's bytes) and its empty barrier (every consumer
// thread arrives).
struct Ring {
  uint32_t base, bars;
  int stage_bytes, stages;
  __device__ uint32_t data(int s) const { return base + s * stage_bytes; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  __device__ void init() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    mbar_fence_init();
  }
};

// A position in the ring: the consumer starts at parity 0 (waits for the
// first fill), the producer at parity 1 (a fresh stage is empty).
struct Cursor {
  int stage;
  uint32_t parity;
  __device__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// Named barriers: 1 for the three consumer warpgroups together, 2 + wg for
// one of them (0 is __syncthreads').
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// ---------------------------------------------------------------------------
// One conv per launch
// ---------------------------------------------------------------------------

struct ConvParams {
  const float* bias;   // (n)
  const float* bias2;  // (n) projection bias
  const bf16* res;     // (m, n) identity residual, or null
  int m, n;
  int ktiles, ktiles2;  // K tiles of 64: the conv's, the projection's
  int taps;             // 1 or 9
  int ctiles;           // K tiles per tap (3x3)
  int tm;               // pixels per tile
  int rows, tiles_y, nb, w, hw;  // 3x3 tile: image rows, tiles per image, images
  int tiles;                     // output tiles: those of M times N / BN
};

constexpr int kConvStages = 4;

// the ring, the output tile (BN / 64 boxes of 192 rows x 64 columns), the
// ring's barriers and the output tile's
template <int BN>
constexpr int conv_smem_bytes() {
  return 1024 + kConvStages * (kATile + BN * kBK * 2) + (BN / kBK) * kATile +
         16 * kConvStages + 16;
}

template <int BN, bool PROJ>
__global__ void __launch_bounds__(kThreads)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_a2,
                      const __grid_constant__ CUtensorMap map_w2,
                      // the identity residual; a 3x3 has none, and gets here
                      // the output again with a box of the tile's last
                      // tm % 64 rows
                      const __grid_constant__ CUtensorMap map_res,
                      const __grid_constant__ CUtensorMap map_out,
                      const ConvParams p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kStage = kATile + BN * kBK * 2;
  constexpr int kBoxes = BN / kBK;  // the output tile's boxes of 64 columns
  Ring ring;
  ring.base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ctile = ring.base + kConvStages * kStage;
  ring.bars = ctile + kBoxes * kATile;
  ring.stage_bytes = kStage;
  ring.stages = kConvStages;
  // the output tile: filled with the residual (the producer's arrival and
  // the TMA's bytes), free again once each warpgroup's store has read it
  const uint32_t res_full = ring.bars + 16 * kConvStages;
  const uint32_t out_free = res_full + 8;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    mbar_init(out_free, kConsumers);
    ring.init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int total = p.ktiles + (PROJ ? p.ktiles2 : 0);
  const int ntiles = p.n / BN;

  // Where output tile `tile` lies: BN columns from n0; tm rows from m0, for a
  // 3x3 the image rows from y0 of image img, or whole images from img.
  struct Where {
    int n0, m0, img, y0;
  };
  auto where = [&](int tile) {
    const int mt = tile / ntiles;
    Where t{(tile - mt * ntiles) * BN, mt * kTM, 0, 0};
    if (p.taps == 9) {
      if (p.nb == 1) {
        t.img = mt / p.tiles_y;
        t.y0 = (mt - t.img * p.tiles_y) * p.rows;
      } else {
        t.img = mt * p.nb;
      }
      t.m0 = t.img * p.hw + t.y0 * p.w;
    }
    return t;
  };

  // Persistent: a block walks over output tiles, so that the loads of the
  // next tile are in flight while this one's epilogue runs.
  if (warp == kConsumers * 4) {
    // ---- producer: one lane keeps the ring full ----
    if (lane == 0) {
      Cursor c{0, 1};
      uint32_t out_parity = 1;  // a fresh output tile is free
      const uint32_t tx = static_cast<uint32_t>(p.tm * kBK * 2 + BN * kBK * 2);
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Where t = where(tile);
        if (p.res != nullptr) {
          // the identity residual, into the output tile it will become
          mbar_wait(out_free, out_parity);
          out_parity ^= 1;
          mbar_expect_tx(res_full, kBoxes * kATile);
#pragma unroll
          for (int b = 0; b < kBoxes; ++b)
            tma_load_2d(ctile + b * kATile, &map_res, res_full,
                        t.n0 + b * kBK, t.m0);
        }
        for (int it = 0; it < total; ++it) {
          mbar_wait(ring.empty(c.stage), c.parity);
          const uint32_t full = ring.full(c.stage);
          const uint32_t dst_a = ring.data(c.stage);
          const uint32_t dst_b = dst_a + kATile;
          if (!PROJ || it < p.ktiles) {
            mbar_expect_tx(full, tx);
            if (p.taps == 9) {
              const int tap = it / p.ctiles;
              const int c0 = (it - tap * p.ctiles) * kBK;
              tma_load_4d(dst_a, &map_a, full, c0, tap % 3 - 1,
                          t.y0 + tap / 3 - 1, t.img);
            } else {
              tma_load_2d(dst_a, &map_a, full, it * kBK, t.m0);
            }
            tma_load_2d(dst_b, &map_w, full, it * kBK, t.n0);
          } else {
            mbar_expect_tx(full, static_cast<uint32_t>(kATile + BN * kBK * 2));
            const int k0 = (it - p.ktiles) * kBK;
            tma_load_2d(dst_a, &map_a2, full, k0, t.m0);
            tma_load_2d(dst_b, &map_w2, full, k0, t.n0);
          }
          c.advance(kConvStages);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile ----
  const int wg = warp >> 2;
  const bool active = wg * 64 < p.tm;
  const bool elected = (threadIdx.x & 127) == 0;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  Cursor c{0, 0};
  uint32_t res_parity = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Where t = where(tile);
    float acc[BN / 2];
    float acc2[PROJ ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (PROJ ? BN / 2 : 1); ++i) acc2[i] = 0.f;

    int prev = -1;
    for (int it = 0; it < total; ++it) {
      mbar_wait(ring.full(c.stage), c.parity);
      if (active) {
        const uint64_t da = wgmma_desc(ring.data(c.stage) + wg * kSlice);
        const uint64_t db = wgmma_desc(ring.data(c.stage) + kATile);
        wgmma_fence();
        if (PROJ && it >= p.ktiles) {
          if constexpr (PROJ) {
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
              wgmma_ss<BN>(acc2, da + 2 * kk, db + 2 * kk);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_ss<BN>(acc, da + 2 * kk, db + 2 * kk);
        }
        wgmma_commit();
        // the K tile before is done: its stage may be refilled
        wgmma_wait<1>();
      }
      if (prev >= 0) mbar_arrive(ring.empty(prev));
      prev = c.stage;
      c.advance(kConvStages);
    }
    if (active) wgmma_wait<0>();
    mbar_arrive(ring.empty(prev));
    if (p.res != nullptr) {
      mbar_wait(res_full, res_parity);
      res_parity ^= 1;
    }

    // Accumulator layout of wgmma m64nN: warp q of the warpgroup holds rows
    // 16 q + lane / 4 (elements 0, 1) and eight rows below (2, 3), columns
    // 8 j + 2 (lane % 4) + {0, 1} for element group j. The output tile lies
    // in shared memory as TMA boxes of 64 columns, rows of 128 bytes swizzled
    // by the row: the residual arrives there, each thread writes its bf16
    // results over it, and each warpgroup's 64 rows leave by a TMA store,
    // which clips the rows past M. The warpgroup goes on once the store has
    // read its rows.
    if (active) {
      // Without a residual nothing waits for the output tile but this
      // warpgroup's next results: the store of the tile before reads its rows
      // while this tile's products run, and only now must have read them.
      if (p.res == nullptr) {
        if (elected) tma_store_wait_read();
        warpgroup_sync(wg);
      }
      // four column groups at a time: their eight residual words are read
      // before the first result is written, so the reads are in flight
      // together
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 4) {
        uint32_t addr[8], raw[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + (q >> 1);
          addr[q] = ctile + (j / 8) * kATile + (r0 + (q & 1) * 8) * 128 +
                    (((j & 7) ^ g) << 4) + tq * 4;
          raw[q] = (!PROJ && p.res != nullptr) ? ld_shared_u32(addr[q]) : 0u;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + (q >> 1);
          const int e = 4 * j + 2 * (q & 1);
          const int col = t.n0 + j * 8 + tq * 2;
          float v0 = acc[e] + p.bias[col];
          float v1 = acc[e + 1] + p.bias[col + 1];
          if constexpr (PROJ) {
            v0 = v0 + (acc2[e] + p.bias2[col]);
            v1 = v1 + (acc2[e + 1] + p.bias2[col + 1]);
          } else if (p.res != nullptr) {
            const __nv_bfloat162 res =
                *reinterpret_cast<const __nv_bfloat162*>(&raw[q]);
            v0 = v0 + __low2float(res);
            v1 = v1 + __high2float(res);
          }
          st_shared_u32(addr[q], pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f)));
        }
      }
      fence_proxy_async();
      warpgroup_sync(wg);
      if (elected) {
        // a 3x3 tile may end inside this warpgroup's 64 rows
        const CUtensorMap* box = p.tm - wg * 64 < 64 ? &map_res : &map_out;
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tma_store_2d(box, ctile + b * kATile + wg * kSlice, t.n0 + b * kBK,
                       t.m0 + wg * 64);
        tma_store_commit();
        // with a residual the producer refills the tile: it is free once read
        if (p.res != nullptr) tma_store_wait_read();
      }
    }
    if (elected) mbar_arrive(out_free);
  }
  if (elected) tma_store_wait_read();
}

// ---------------------------------------------------------------------------
// A whole block per launch
// ---------------------------------------------------------------------------

struct BlockParams {
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;
  int m, cin, h, w;
  int rows, tiles_y, tiles;  // image rows per tile, tiles per image, tiles
};

template <int F>
struct BlockTile {
  // what fits beside y1: 206,560 bytes at F = 64, 230,480 at F = 128
  static constexpr int kStages = F == 64 ? 5 : 4;
  static constexpr int kStage = kATile + F * kBK * 2;
  static constexpr int kLdY = F * 2 + 16;  // bytes of a y1 row: ldmatrix without bank conflicts
  // ring, y1 over the tile and its halo rows, one row of zeros, barriers
  static int smem_bytes(int rows, int w) {
    return 1024 + kStages * kStage + ((rows + 2) * w + 1) * kLdY +
           16 * kStages;
  }
};

template <int F, bool PROJ>
__global__ void __launch_bounds__(kThreads)
    block_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2,
                       const __grid_constant__ CUtensorMap map_w3,
                       const __grid_constant__ CUtensorMap map_wd,
                       const __grid_constant__ CUtensorMap map_out,
                       const BlockParams p) {
  using T = BlockTile<F>;
  extern __shared__ unsigned char smem_raw[];
  const int tm = p.rows * p.w;           // the tile's pixels
  const int halo = (p.rows + 2) * p.w;   // with one image row above and below
  Ring ring;
  ring.base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  ring.stage_bytes = T::kStage;
  ring.stages = T::kStages;
  const uint32_t y1 = ring.base + T::kStages * T::kStage;
  const uint32_t zero_row = y1 + halo * T::kLdY;
  ring.bars = zero_row + T::kLdY;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int passes = (halo + kTM - 1) / kTM;
  const int ctiles = p.cin / kBK;
  constexpr int kFTiles = F / kBK;
  constexpr uint32_t kWBytes = F * kBK * 2;

  if (warp == kConsumers * 4) {
    // ---- producer ----
    if (lane == 0) {
      Cursor c{0, 1};
      auto stage = [&](bool with_a) {
        mbar_wait(ring.empty(c.stage), c.parity);
        mbar_expect_tx(ring.full(c.stage), kWBytes + (with_a ? kATile : 0));
      };
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int img = tile / p.tiles_y;
        const int y0 = (tile - img * p.tiles_y) * p.rows;
        const int p0 = (img * p.h + y0) * p.w;  // the tile's first pixel
        // conv1: x over the halo'd tile (rows before the tensor read as zeros)
        for (int pass = 0; pass < passes; ++pass)
          for (int kt = 0; kt < ctiles; ++kt) {
            stage(true);
            tma_load_2d(ring.data(c.stage), &map_x, ring.full(c.stage),
                        kt * kBK, p0 - p.w + pass * kTM);
            tma_load_2d(ring.data(c.stage) + kATile, &map_w1,
                        ring.full(c.stage), kt * kBK, 0);
            c.advance(T::kStages);
          }
        // conv2: w2t, tap-major
        for (int kt = 0; kt < 9 * kFTiles; ++kt) {
          stage(false);
          tma_load_2d(ring.data(c.stage) + kATile, &map_w2, ring.full(c.stage),
                      kt * kBK, 0);
          c.advance(T::kStages);
        }
        // conv3: four chunks of F output channels
        for (int nc = 0; nc < 4; ++nc) {
          for (int kt = 0; kt < kFTiles; ++kt) {
            // with the weights, the identity residual of the 64 output
            // channels this K tile's number names: a box of x
            stage(!PROJ);
            if (!PROJ)
              tma_load_2d(ring.data(c.stage), &map_x, ring.full(c.stage),
                          nc * F + kt * kBK, p0);
            tma_load_2d(ring.data(c.stage) + kATile, &map_w3,
                        ring.full(c.stage), kt * kBK, nc * F);
            c.advance(T::kStages);
          }
          if (PROJ)
            for (int kt = 0; kt < ctiles; ++kt) {
              stage(true);
              tma_load_2d(ring.data(c.stage), &map_x, ring.full(c.stage),
                          kt * kBK, p0);
              tma_load_2d(ring.data(c.stage) + kATile, &map_wd,
                          ring.full(c.stage), kt * kBK, nc * F);
              c.advance(T::kStages);
            }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp >> 2;
  const int tid = threadIdx.x;  // 0 .. 383
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row_in_wg = (warp & 3) * 16 + g;  // accumulator rows: this and + 8
  Cursor c{0, 0};

  for (int i = tid; i < T::kLdY / 4; i += kConsumerThreads)
    st_shared_u32(zero_row + 4 * i, 0u);

  // Persistent: this block walks over tiles, so that the producer's loads
  // for the next tile are in flight while this one's conv3 finishes.
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int img = tile / p.tiles_y;
    const int y0 = (tile - img * p.tiles_y) * p.rows;
    const int p0 = (img * p.h + y0) * p.w;  // the tile's first pixel
    consumers_sync();  // the last tile's conv2 is done with y1
    // conv1 over the halo'd tile, pass by pass: warpgroup wg takes slice
    // 3 pass + wg; y1 goes to shared memory, zeros where the halo row is off
    // the image.
    for (int pass = 0; pass < passes; ++pass) {
      const int slice = pass * kConsumers + wg;
      const bool active = slice * 64 < halo;
      float acc[F / 2];
#pragma unroll
      for (int i = 0; i < F / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < ctiles; ++kt) {
        mbar_wait(ring.full(c.stage), c.parity);
        if (active) {
          const uint64_t da = wgmma_desc(ring.data(c.stage) + wg * kSlice);
          const uint64_t db = wgmma_desc(ring.data(c.stage) + kATile);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_ss<F>(acc, da + 2 * kk, db + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
        }
        mbar_arrive(ring.empty(c.stage));
        c.advance(T::kStages);
      }
      if (active) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = slice * 64 + row_in_wg + half * 8;
          if (r >= halo) continue;
          const int yy = y0 - 1 + r / p.w;
          const bool inside = yy >= 0 && yy < p.h;
#pragma unroll
          for (int j = 0; j < F / 8; ++j) {
            const int col = j * 8 + tq * 2;
            const float v0 = fmaxf(acc[4 * j + 2 * half] + p.b1[col], 0.f);
            const float v1 = fmaxf(acc[4 * j + 2 * half + 1] + p.b1[col + 1], 0.f);
            const uint32_t packed = inside ? pack_bf16(v0, v1) : 0u;
            st_shared_u32(y1 + r * T::kLdY + col * 2, packed);
          }
        }
      }
    }
    consumers_sync();

    // conv2: the A operand from registers. Lane l of a warp gives ldmatrix the
    // address of pixel (l % 16) of the warp's 16, at K offset 8 (l / 16); the
    // tap shifts the pixel inside the halo'd y1, and a tap column off the image
    // reads the zero row.
    const bool active = wg * 64 < tm;
    uint32_t y2f[F / 16][4];
    {
      const int pix = wg * 64 + (warp & 3) * 16 + (lane & 15);
      const int ty = pix / p.w;
      const int tx = pix - ty * p.w;
      const uint32_t koff = (lane >> 4) * 16;  // bytes
      float acc[F / 2];
#pragma unroll
      for (int i = 0; i < F / 2; ++i) acc[i] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1;
        const int dx = tap % 3 - 1;
        const bool valid = tx + dx >= 0 && tx + dx < p.w;
        const uint32_t src =
            (valid ? y1 + ((ty + 1 + dy) * p.w + tx + dx) * T::kLdY : zero_row) +
            koff;
#pragma unroll
        for (int kt = 0; kt < kFTiles; ++kt) {
          mbar_wait(ring.full(c.stage), c.parity);
          if (active) {
            uint32_t a[kBK / 16][4];
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
              ldmatrix_x4(a[kk], src + (kt * kBK + kk * 16) * 2);
            const uint64_t db = wgmma_desc(ring.data(c.stage) + kATile);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
              wgmma_rs<F>(acc, a[kk], db + 2 * kk);
            wgmma_commit();
            wgmma_wait<0>();
          }
          mbar_arrive(ring.empty(c.stage));
          c.advance(T::kStages);
        }
      }
      // y2 = bf16(relu(acc + b2)), packed where it lies: accumulator groups
      // 2 k and 2 k + 1 are the A fragment of K columns [16 k, 16 k + 16).
#pragma unroll
      for (int k = 0; k < F / 16; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = k * 16 + (q >> 1) * 8 + tq * 2;
          const int e = 8 * k + 4 * (q >> 1) + 2 * (q & 1);
          y2f[k][q] = pack_bf16(fmaxf(acc[e] + p.b2[col], 0.f),
                                fmaxf(acc[e + 1] + p.b2[col + 1], 0.f));
        }
      }
    }

    // conv3, four chunks of F output channels. A chunk's K tile kt also names
    // 64 of its output channels: that stage's activation area arrives holding
    // their identity residual (a box of x, swizzled as every TMA box here) and
    // is kept through the epilogue, which reads the residual where the
    // accumulator's element lies, writes the bf16 result over it, and hands
    // each warpgroup's 64 rows to a TMA store.
    for (int nc = 0; nc < 4; ++nc) {
      float acc[F / 2];
      float accd[PROJ ? F / 2 : 1];
#pragma unroll
      for (int i = 0; i < F / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (PROJ ? F / 2 : 1); ++i) accd[i] = 0.f;
      int held[kFTiles];
#pragma unroll
      for (int kt = 0; kt < kFTiles; ++kt) {
        mbar_wait(ring.full(c.stage), c.parity);
        held[kt] = c.stage;
        if (active) {
          const uint64_t db = wgmma_desc(ring.data(c.stage) + kATile);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_rs<F>(acc, y2f[kt * (kBK / 16) + kk], db + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
        }
        c.advance(T::kStages);
      }
      if constexpr (PROJ) {
        for (int kt = 0; kt < ctiles; ++kt) {
          mbar_wait(ring.full(c.stage), c.parity);
          if (active) {
            const uint64_t da = wgmma_desc(ring.data(c.stage) + wg * kSlice);
            const uint64_t db = wgmma_desc(ring.data(c.stage) + kATile);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
              wgmma_ss<F>(accd, da + 2 * kk, db + 2 * kk);
            wgmma_commit();
            wgmma_wait<0>();
          }
          mbar_arrive(ring.empty(c.stage));
          c.advance(T::kStages);
        }
      }
      if (active) {
        // four column groups at a time, the residual words read before the
        // first result is written: row r of the tile, 16-byte chunk j % 8 of
        // its 128-byte row, swizzled by r % 8 = g
#pragma unroll
        for (int j0 = 0; j0 < F / 8; j0 += 4) {
          uint32_t addr[8], raw[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = j0 + (q >> 1);
            const int r = wg * 64 + row_in_wg + (q & 1) * 8;
            addr[q] = ring.data(held[j / 8]) + r * 128 + (((j & 7) ^ g) << 4) +
                      tq * 4;
            if constexpr (!PROJ) raw[q] = ld_shared_u32(addr[q]);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = j0 + (q >> 1);
            const int e = 4 * j + 2 * (q & 1);
            const int col = nc * F + j * 8 + tq * 2;
            float v0 = acc[e] + p.b3[col];
            float v1 = acc[e + 1] + p.b3[col + 1];
            if constexpr (PROJ) {
              v0 = v0 + (accd[e] + p.bd[col]);
              v1 = v1 + (accd[e + 1] + p.bd[col + 1]);
            } else {
              const __nv_bfloat162 res =
                  *reinterpret_cast<const __nv_bfloat162*>(&raw[q]);
              v0 = v0 + __low2float(res);
              v1 = v1 + __high2float(res);
            }
            st_shared_u32(addr[q], pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f)));
          }
        }
        fence_proxy_async();
        warpgroup_sync(wg);
        if ((tid & 127) == 0) {
#pragma unroll
          for (int kt = 0; kt < kFTiles; ++kt)
            tma_store_2d(&map_out, ring.data(held[kt]) + wg * kSlice,
                         nc * F + kt * kBK, p0 + wg * 64);
          tma_store_commit();
          tma_store_wait_read();
        }
      }
#pragma unroll
      for (int kt = 0; kt < kFTiles; ++kt) mbar_arrive(ring.empty(held[kt]));
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// Sets a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(done.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int BN, bool PROJ>
cudaError_t launch_conv(const CUtensorMap (&maps)[6], const ConvParams& p,
                        int mtiles, cudaStream_t stream) {
  auto kernel = conv_wgmma_kernel<BN, PROJ>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  ConvParams q = p;
  q.tiles = mtiles * (p.n / BN);
  kernel<<<q.tiles < sms ? q.tiles : sms, kThreads, conv_smem_bytes<BN>(),
           stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], q);
  return cudaGetLastError();
}

template <int F, bool PROJ>
cudaError_t launch_block(const CUtensorMap& mx, const CUtensorMap& m1,
                         const CUtensorMap& m2, const CUtensorMap& m3,
                         const CUtensorMap& md, const CUtensorMap& mo,
                         const BlockParams& p, cudaStream_t stream) {
  auto kernel = block_wgmma_kernel<F, PROJ>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  kernel<<<p.tiles < sms ? p.tiles : sms, kThreads,
           BlockTile<F>::smem_bytes(p.rows, p.w), stream>>>(mx, m1, m2, m3, md,
                                                            mo, p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

bool tile_pixels_ok(int pixels) {
  return pixels == 64 || pixels == 128 || pixels == 192;
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// One convolution of a folded bottleneck block on wgmma (see the note at the
// top). a (m, lda), wt (n, k) the transposed weights, bias (n), out (m, n):
// bf16 / float32 bias, contiguous. taps 1: a 1x1 conv, k == lda. taps 9: a
// 3x3 pad-1 conv over images of h x w pixels (m a multiple of h * w),
// k == 9 * lda, no residual, tiled by `rows` image rows of one image
// (nb == 1, rows divides h) or by nb whole images (rows == h); either way
// at most 192 pixels. res (m, n), or null: the identity residual.
// a2 (m, k2), w2t (n, k2) and bias2 (n), or null: the projection. n, lda and
// k2 multiples of 64. Returns the launch's cudaError_t (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take, or
// cudaErrorNotSupported when cuTensorMapEncodeTiled gives no TMA descriptor.
extern "C" int ft_fused_conv_wgmma(const void* a, const void* wt,
                                   const void* bias, const void* res,
                                   const void* a2, const void* w2t,
                                   const void* bias2, void* out, int m, int n,
                                   int k, int lda, int k2, int h, int wd,
                                   int taps, int rows, int nb, void* stream) {
  const bool proj = a2 != nullptr;
  bool ok = a && wt && bias && out && m > 0 && n > 0 && n % 64 == 0 &&
            lda > 0 && lda % kBK == 0 && h > 0 && wd > 0;
  ok = ok && (taps == 1 ? k == lda
                        : (taps == 9 && k == 9 * lda && !res && !proj &&
                           m % (h * wd) == 0 && wd <= 256 && rows > 0 &&
                           rows <= 256 && nb > 0 && nb <= 256 &&
                           (nb == 1 ? h % rows == 0 : rows == h) &&
                           nb * rows * wd <= kTM));
  ok = ok && (!proj || (w2t && bias2 && k2 > 0 && k2 % kBK == 0 && !res));
  ok = ok && aligned16(a) && aligned16(wt) && aligned16(out) &&
       (!res || aligned16(res)) && (!proj || (aligned16(a2) && aligned16(w2t)));
  if (!ok) return kInvalid;

  const int bn = (proj || n % 128 != 0) ? 64 : 128;
  ConvParams p{};
  p.bias = static_cast<const float*>(bias);
  p.bias2 = static_cast<const float*>(bias2);
  p.res = static_cast<const bf16*>(res);
  p.m = m;
  p.n = n;
  p.ktiles = k / kBK;
  p.ktiles2 = proj ? k2 / kBK : 0;
  p.taps = taps;
  p.ctiles = lda / kBK;
  p.tm = kTM;
  p.rows = rows;
  p.nb = nb;
  p.w = wd;
  p.hw = h * wd;
  p.tiles_y = 1;
  int mtiles = (m + kTM - 1) / kTM;
  // activations, weights, the projection's two, the residual, the output
  CUtensorMap maps[6];
  bool made = matrix_map(wt, n, k, bn, &maps[1]) &&
              matrix_map(out, m, n, 64, &maps[5]);
  if (taps == 9) {
    const int images = m / (h * wd);
    p.tm = nb * rows * wd;
    p.tiles_y = h / rows;
    mtiles = nb == 1 ? images * p.tiles_y : (images + nb - 1) / nb;
    made = made && image_map(a, images, h, wd, lda, rows, nb, &maps[0]);
  } else {
    made = made && matrix_map(a, m, lda, kTM, &maps[0]);
  }
  maps[2] = maps[0];
  maps[3] = maps[1];
  maps[4] = maps[5];
  if (proj)
    made = made && matrix_map(a2, m, k2, kTM, &maps[2]) &&
           matrix_map(w2t, n, k2, bn, &maps[3]);
  if (res) made = made && matrix_map(res, m, n, kTM, &maps[4]);
  // a 3x3 has no residual: its slot carries the box of a tile's last rows
  if (p.tm % 64) made = made && matrix_map(out, m, n, p.tm % 64, &maps[4]);
  if (!made) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      proj ? launch_conv<64, true>(maps, p, mtiles, s)
           : (bn == 128 ? launch_conv<128, false>(maps, p, mtiles, s)
                        : launch_conv<64, false>(maps, p, mtiles, s));
  return static_cast<int>(err);
}

// A whole folded bottleneck block in one launch (see the note at the top).
// x (m, cin) bf16 over images of h x w pixels, m a multiple of h * w; w1t
// (f, cin), w2t (f, 9 f), w3t (4 f, f), and wdt (4 f, cin) with bd or both
// null (then cin == 4 f): the transposed weights, bf16; b1, b2 (f), b3, bd
// (4 f) float32; out (m, 4 f) bf16. A tile is `rows` image rows of one image:
// rows divides h and rows * w is 64, 128 or 192. Takes f == 64 (with or
// without the projection) and f == 128 (without); cin a multiple of 64.
// Returns as ft_fused_conv_wgmma does.
extern "C" int ft_fused_block(const void* x, const void* w1t, const void* b1,
                              const void* w2t, const void* b2,
                              const void* w3t, const void* b3,
                              const void* wdt, const void* bd, void* out,
                              int m, int cin, int f, int h, int wd, int rows,
                              void* stream) {
  const bool proj = wdt != nullptr;
  bool ok = x && w1t && b1 && w2t && b2 && w3t && b3 && out && m > 0 &&
            cin > 0 && cin % kBK == 0 && h > 0 && wd > 0 && rows > 0 &&
            m % (h * wd) == 0 && h % rows == 0 && tile_pixels_ok(rows * wd);
  ok = ok && ((f == 64) || (f == 128 && !proj));
  ok = ok && (proj ? bd != nullptr : cin == 4 * f);
  ok = ok && aligned16(x) && aligned16(w1t) && aligned16(w2t) &&
       aligned16(w3t) && aligned16(out) && (!proj || aligned16(wdt));
  if (!ok) return kInvalid;
  const int smem = f == 64 ? BlockTile<64>::smem_bytes(rows, wd)
                           : BlockTile<128>::smem_bytes(rows, wd);
  if (smem > kSmemLimit) return kInvalid;

  CUtensorMap mx, m1, m2, m3, md, mo;
  bool made = matrix_map(x, m, cin, kTM, &mx) &&
              matrix_map(out, m, 4 * f, 64, &mo) &&
              matrix_map(w1t, f, cin, f, &m1) &&
              matrix_map(w2t, f, 9 * f, f, &m2) &&
              matrix_map(w3t, 4 * f, f, f, &m3);
  md = m3;
  if (proj) made = made && matrix_map(wdt, 4 * f, cin, f, &md);
  if (!made) return static_cast<int>(cudaErrorNotSupported);
  BlockParams p{};
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bd = static_cast<const float*>(bd);
  p.m = m;
  p.cin = cin;
  p.h = h;
  p.w = wd;
  p.rows = rows;
  p.tiles_y = h / rows;
  p.tiles = m / (h * wd) * p.tiles_y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f == 128 ? launch_block<128, false>(mx, m1, m2, m3, md, mo, p, s)
               : (proj ? launch_block<64, true>(mx, m1, m2, m3, md, mo, p, s)
                       : launch_block<64, false>(mx, m1, m2, m3, md, mo, p, s));
  return static_cast<int>(err);
}
