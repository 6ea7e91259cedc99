// The tensor-core window-MIPS body for Hopper (sm_90a), shared by
// window_mips.cu (bf16 rows, f32 sums) and window_mips_i8.cu (int8 rows,
// int32 sums, per-row scales). See each file's note for what bounds it.
//
// A persistent grid, one block per SM. Each block keeps 256 queries
// resident in shared memory; one thread of a producer warpgroup streams
// 128-row corpus tiles by TMA into a ring of stages guarded by full/empty
// mbarriers; two consumer warpgroups run wgmma (queries as A, corpus rows as
// B, both K-major) and take the window max/argmax straight from the
// accumulator registers.
//
// The two element types share every byte of the geometry: a wgmma k-step
// is 32 bytes (16 bf16 or 32 int8 columns), a TMA box row 128 bytes with
// the 128-byte swizzle (64 or 128 columns), the K tail at most 32 bytes
// with the 32-byte swizzle (16 or 32 columns). The int8 body adds the
// tile's 128 item scales: one 512-byte TMA box on the stage's full barrier,
// applied to the int32 sums (exactly converted) before the window max.
//
// <cuda.h> is read for the tensor-map types only: cuTensorMapEncodeTiled is
// looked up in libcuda at run time, so nothing links against it.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace tc {

constexpr int kBQ = 256;              // queries per block, resident
constexpr int kBR = 128;              // corpus rows per stage (wgmma N)
constexpr int kBoxBytes = 128;        // bytes of a box row: 128-byte swizzle
constexpr int kTailBytes = 32;        // a K tail of <= 32 bytes: 32-byte swizzle
constexpr int kStepBytes = 32;        // K of one wgmma
constexpr int kConsumerWarps = 8;     // two warpgroups of 128 queries each
constexpr int kThreads = 32 * (kConsumerWarps + 4);   // + the producer warpgroup
constexpr int kQBoxBytes = kBQ * kBoxBytes;           // 32 KB
constexpr int kRBoxBytes = kBR * kBoxBytes;           // 16 KB
constexpr int kQTailBytes = kBQ * kTailBytes;         // 8 KB
constexpr int kRTailBytes = kBR * kTailBytes;         // 4 KB
constexpr int kScaleBytes = kBR * 4;  // int8: a tile's f32 item scales
constexpr int kMaxRowBytes = 384;     // the query tile of 256 such rows: 96 KB
constexpr int kAlign = 1024;          // the 128-byte swizzle repeats every 8 rows
constexpr int kSmemLimit = 232448;    // what one block may use on sm_90
constexpr float kMasked = -3e38f;
// TMA ring stages: all that fit beside the bf16 query tile at d = 136. The
// int8 stages are half the bytes, but 2, 4 and 8 of them time alike at
// d = 144 (the corpus tiles come from L2; tools/window_i8_breakdown.py), so
// both types take this depth.
constexpr int kMaxStages = 4;

// 384 threads launch with 168 registers each; the producer warpgroup gives
// back all but 40 (setmaxnreg), so the consumers, with two 64-word
// accumulators each, can hold 232.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "register budget");

// What differs by element type.
template <bool kInt8>
struct Kind {
  using Acc = float;
  static constexpr int kElemBytes = 2;
};

template <>
struct Kind<true> {
  using Acc = uint32_t;   // int32 sums
  static constexpr int kElemBytes = 1;
};

struct Shape {
  int n_q, n_items, n_valid;
  long long n_cand;
  int ksteps, boxes, tail, stages;   // tail: one 32-byte box after the 128-byte ones
  int q_bytes, stage_bytes;          // shared memory of the query tile, of a stage's rows
  long long span, n_spans;       // rows of whole windows per block step
  int tiles_per_span;
  int n_qtiles, per_qtile;       // grid = n_qtiles x per_qtile blocks
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            int x, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle (rows of 128 bytes) or the 32-byte one (rows of 32
// bytes, the K tail): 8-row atoms 8 rows apart (SBO), the leading offset
// unused for these layouts. A k-step of 32 bytes moves the start address by
// 32 bytes inside a 128-byte row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : 3;   // B128 : B32
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * row_bytes >> 4) << 32) | (layout << 62);
}

#define TC_D8(C, b)                                                          \
  C(d[b]), C(d[b + 1]), C(d[b + 2]), C(d[b + 3]), C(d[b + 4]), C(d[b + 5]), \
      C(d[b + 6]), C(d[b + 7])
#define TC_D64(C)                                                             \
  TC_D8(C, 0), TC_D8(C, 8), TC_D8(C, 16), TC_D8(C, 24), TC_D8(C, 32),         \
      TC_D8(C, 40), TC_D8(C, 48), TC_D8(C, 56)
#define TC_F32(x) "+f"(x)
#define TC_S32(x) "+r"(x)
#define TC_REGS64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128) += A (64 queries x 32 bytes) * B (128 corpus rows x 32
// bytes)^T; scale_d == 0 overwrites d. Accumulator register i of thread
// (warp w, lane l) holds query row 16w + l/4 + 8*((i>>1)&1), corpus column
// 8*(i>>2) + 2*(l%4) + (i&1) -- the same for both types.
// bf16 x bf16 -> f32, k16:
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TC_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : TC_D64(TC_F32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// s8 x s8 -> s32, k32 (integer wgmma takes no operand scales or transposes):
__device__ __forceinline__ void wgmma(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " TC_REGS64
      ", %64, %65, p;\n\t}"
      : TC_D64(TC_S32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma and its wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The int8 scores in place: each int32 sum becomes the f32 bits of
// float(sum) * scale[its row], one rounding as in the twin (float(sum) is
// exact: |sum| <= 128^2 * 1024 = 2^24 at any width the kernel takes).
// `scale` holds the tile's 128 scales; c = lane % 4.
__device__ __forceinline__ void dequantize(uint32_t (&acc)[64], const float* scale,
                                           int c) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(scale + 8 * j + 2 * c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      acc[i] = __float_as_uint(__fmul_rn(__int2float_rn((int)acc[i]), s.x));
      acc[i + 1] = __float_as_uint(__fmul_rn(__int2float_rn((int)acc[i + 1]), s.y));
    }
  }
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(uint32_t x) { return __uint_as_float(x); }

// (v, c) of the lane `m` away replaces ours if it is larger, or equal at an
// earlier row: a total order, so both lanes end with the same pair.
__device__ __forceinline__ void quad_best(float& v, int& c, int m) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, m);
  const int oc = __shfl_xor_sync(0xffffffffu, c, m);
  if (ov > v || (ov == v && oc < c)) {
    v = ov;
    c = oc;
  }
}

template <bool kQueriesMajor>
__device__ __forceinline__ void store(float* vals, int32_t* args, const Shape& s,
                                      long long win, long long q, float v,
                                      int arg) {
  if (win < s.n_cand && q < s.n_q) {
    const long long at = kQueriesMajor ? q * s.n_cand + win : win * s.n_q + q;
    vals[at] = v;
    args[at] = arg;
  }
}

// The window max/argmax of one m-block's 64 x 128 scores (corpus rows
// r0.. r0+127; f32, or the f32 bits of the int8 scores) for this thread's
// two query rows q_row and q_row + 8. kLW = log2 of the window's share of
// the tile (7: the tile is one window or part of a wider one, carried in
// cv/cc across the window's tiles, of which this is tile t of tpw). Columns
// >= lim are rows >= n_valid; kMask is false for tiles wholly below
// n_valid, which skip the compare.
template <int kLW, bool kQueriesMajor, bool kMask, typename Acc>
__device__ __forceinline__ void epilogue(const Acc (&acc)[64], int mb,
                                         long long q_row, int lane, int lim,
                                         long long r0, long long win_wide,
                                         int t, int tpw, float (&cv)[2],
                                         int (&cc)[2], const Shape& s,
                                         float* vals, int32_t* args) {
  constexpr int kW = 1 << kLW;
  const int c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long q = q_row + 8 * h;
    if constexpr (kLW >= 3) {
      constexpr int kJ = 1 << (kLW - 3);   // 8-column chunks per window
      constexpr int kNW = 16 / kJ;         // windows per tile
#pragma unroll
      for (int g = 0; g < kNW; ++g) {
        float bv = -CUDART_INF_F;
        int bc = 0;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = g * kJ + jj;
            const int col = 8 * j + 2 * c + e;
            const float v =
                !kMask || col < lim ? as_float(acc[4 * j + 2 * h + e]) : kMasked;
            if (v > bv) {  // ascending columns: the first occurrence wins
              bv = v;
              bc = col;
            }
          }
        }
        quad_best(bv, bc, 1);
        quad_best(bv, bc, 2);
        if constexpr (kLW == 7) {
          if (bv > cv[h]) {  // strictly: an earlier tile keeps a tie
            cv[h] = bv;
            cc[h] = t * kBR + bc;
          }
          if (t == tpw - 1) {
            if (c == ((2 * mb + h) & 3))
              store<kQueriesMajor>(vals, args, s, win_wide, q, cv[h], cc[h]);
            cv[h] = -CUDART_INF_F;
          }
        } else {
          if (c == ((h * kNW + g) & 3))
            store<kQueriesMajor>(vals, args, s, (r0 >> kLW) + g, q, bv,
                                 bc & (kW - 1));
        }
      }
    } else {
      // windows of 1, 2 or 4 columns: within a lane's pair or a lane pair
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e0 = 0; e0 < 2; e0 += (kLW >= 1 ? 2 : 1)) {
          float bv = -CUDART_INF_F;
          int bc = 0;
#pragma unroll
          for (int e = e0; e < (kLW >= 1 ? 2 : e0 + 1); ++e) {
            const int col = 8 * j + 2 * c + e;
            const float v =
                !kMask || col < lim ? as_float(acc[4 * j + 2 * h + e]) : kMasked;
            if (v > bv) {
              bv = v;
              bc = col;
            }
          }
          if constexpr (kLW == 2) quad_best(bv, bc, 1);
          if (kLW < 2 || ((j ^ c) & 1) == 0)
            store<kQueriesMajor>(vals, args, s, (r0 >> kLW) + (bc >> kLW), q,
                                 bv, bc & (kW - 1));
        }
      }
    }
  }
}

// Block b: query tile b % n_qtiles, then spans p, p + per_qtile, ... with
// p = b / n_qtiles, so the n_qtiles blocks that share a span are launched
// together. Warps 0-7: two consumer warpgroups (queries 0-127 and 128-255
// of the tile, each as two m64 blocks against every 128-row corpus tile);
// warps 8-11: the producer warpgroup, of which one thread starts the TMA
// copies. kInt8: s_map is the item scales (rank 1, 128-element boxes),
// written after the ring, one box per stage; otherwise it is unused.
template <int kLW, bool kQueriesMajor, bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
window_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap r_map,
                 const __grid_constant__ CUtensorMap q_tail_map,
                 const __grid_constant__ CUtensorMap r_tail_map,
                 const __grid_constant__ CUtensorMap s_map,
                 float* __restrict__ vals, int32_t* __restrict__ args,
                 const Shape s) {
  using Acc = typename Kind<kInt8>::Acc;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages + 1];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  // queries: boxes x 256 rows x 128 B, then the tail, 256 x 32 B; each
  // stage the same for 128 corpus rows; then (int8) a scale box per stage
  const uint32_t q_s = base;
  const uint32_t r_s = base + s.q_bytes;
  const uint32_t sc_s = r_s + s.stages * s.stage_bytes;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kMaxStages]);
  const uint32_t q_full = smem_u32(&bars[2 * kMaxStages]);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qt = blockIdx.x % s.n_qtiles;
  const long long p = blockIdx.x / s.n_qtiles;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if/else for the whole kernel: ptxas applies setmaxnreg only to
  // paths that never join again
  if (warp >= kConsumerWarps) {
    // producer: the query tile once, then every corpus tile of the block's
    // spans that holds a row of the corpus (the consumers skip the same)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      constexpr int kBoxCols = kBoxBytes / Kind<kInt8>::kElemBytes;
      mbar_expect_tx(q_full, s.q_bytes);
      for (int b = 0; b < s.boxes; ++b)
        tma_load_2d(q_s + b * kQBoxBytes, &q_map, b * kBoxCols, qt * kBQ, q_full);
      if (s.tail)
        tma_load_2d(q_s + s.boxes * kQBoxBytes, &q_tail_map, s.boxes * kBoxCols,
                    qt * kBQ, q_full);
      int stage = 0;
      uint32_t phase = 0;
      for (long long sp = p; sp < s.n_spans; sp += s.per_qtile) {
        for (int t = 0; t < s.tiles_per_span; ++t) {
          const long long r0 = sp * s.span + (long long)t * kBR;
          if (r0 >= s.n_items) break;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t dst = r_s + stage * s.stage_bytes;
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, s.stage_bytes + (kInt8 ? kScaleBytes : 0));
          for (int b = 0; b < s.boxes; ++b)
            tma_load_2d(dst + b * kRBoxBytes, &r_map, b * kBoxCols, (int)r0, full);
          if (s.tail)
            tma_load_2d(dst + s.boxes * kRBoxBytes, &r_tail_map,
                        s.boxes * kBoxCols, (int)r0, full);
          if constexpr (kInt8)
            tma_load_1d(sc_s + stage * kScaleBytes, &s_map, (int)r0, full);
          if (++stage == s.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const long long q_row = (long long)qt * kBQ + wg * 128 + (warp % 4) * 16 + lane / 4;
    const uint32_t a0 = q_s + wg * 128 * 128;   // m-block 0: 64 rows of 128 B
    const uint32_t a1 = a0 + 64 * 128;          // m-block 1
    const uint32_t a0_tail = q_s + s.boxes * kQBoxBytes + wg * 128 * 32;
    const uint32_t a1_tail = a0_tail + 64 * 32;
    const int k_full = s.ksteps - s.tail;       // k-steps in 128-byte boxes
    const float* scales = reinterpret_cast<const float*>(smem_raw + (sc_s - raw));
    Acc acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
    float cv0[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float cv1[2] = {-CUDART_INF_F, -CUDART_INF_F};
    int cc0[2] = {0, 0}, cc1[2] = {0, 0};

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (long long sp = p; sp < s.n_spans; sp += s.per_qtile) {
      for (int t = 0; t < s.tiles_per_span; ++t) {
        const long long r0 = sp * s.span + (long long)t * kBR;
        if (r0 < s.n_items) {
          mbar_wait(full0 + 8 * stage, phase);
          fence_acc(acc0);
          fence_acc(acc1);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          const uint32_t b_s = r_s + stage * s.stage_bytes;
          for (int k = 0; k < k_full; ++k) {
            const uint32_t off = (k >> 2) * kQBoxBytes + (k & 3) * kStepBytes;
            const uint64_t db =
                smem_desc(b_s + (k >> 2) * kRBoxBytes + (k & 3) * kStepBytes, 128);
            wgmma(acc0, smem_desc(a0 + off, 128), db, k);
            wgmma(acc1, smem_desc(a1 + off, 128), db, k);
          }
          if (s.tail) {
            const uint64_t db = smem_desc(b_s + s.boxes * kRBoxBytes, 32);
            wgmma(acc0, smem_desc(a0_tail, 32), db, k_full);
            wgmma(acc1, smem_desc(a1_tail, 32), db, k_full);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_acc(acc0);
          fence_acc(acc1);
          if constexpr (kInt8) {
            // the stage's scales are read here, so the stage is released
            // after all 32 lanes have read them
            dequantize(acc0, scales + stage * kBR, lane & 3);
            dequantize(acc1, scales + stage * kBR, lane & 3);
            __syncwarp();
          }
          if (lane == 0) mbar_arrive(empty0 + 8 * stage);
          if (++stage == s.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        // a tile past the corpus is all rows >= n_valid: lim = 0 masks it
        const long long left = (long long)s.n_valid - r0;
        const int lim = left <= 0 ? 0 : (left >= kBR ? kBR : (int)left);
        if (lim == kBR) {
          epilogue<kLW, kQueriesMajor, false>(acc0, 0, q_row, lane, lim, r0, sp, t,
                                              s.tiles_per_span, cv0, cc0, s, vals, args);
          epilogue<kLW, kQueriesMajor, false>(acc1, 1, q_row + 64, lane, lim, r0, sp,
                                              t, s.tiles_per_span, cv1, cc1, s, vals,
                                              args);
        } else {
          epilogue<kLW, kQueriesMajor, true>(acc0, 0, q_row, lane, lim, r0, sp, t,
                                             s.tiles_per_span, cv0, cc0, s, vals, args);
          epilogue<kLW, kQueriesMajor, true>(acc1, 1, q_row + 64, lane, lim, r0, sp,
                                             t, s.tiles_per_span, cv1, cc1, s, vals,
                                             args);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled resolve_encode_tiled() {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                       cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(ptr);
}

// Resolved once per library: a function-local static is initialised exactly
// once even when several host threads launch at the same time (C++11).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = resolve_encode_tiled();
  return fn;
}

// A (rows, row_bytes) row-major tensor of `type` cut into boxes of
// box_rows x box_bytes, 128-byte swizzled for 128-byte box rows, 32-byte
// for the 32-byte tail; bytes past a row and rows past `rows` read as zeros.
inline bool tile_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
                     int elem_bytes, const void* ptr, int rows, int row_bytes,
                     int box_rows, int box_bytes) {
  const cuuint64_t dims[2] = {(cuuint64_t)(row_bytes / elem_bytes), (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_bytes == kBoxBytes ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (n,) f32 scales in boxes of one tile's 128; past n they read as 0.
inline bool scale_map(CUtensorMap* map, EncodeTiled encode, const float* ptr, int n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};   // none at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)kBR};
  const cuuint32_t steps[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr),
                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory of a launch with rows of row_bytes: 128-byte boxes, and a
// 32-byte tail box where the last <= 32 bytes would otherwise take a
// 128-byte one (bf16 d = 136: 272 bytes, 2 boxes and a tail, so 288 bytes
// are multiplied and stored; int8 d = 144: 1 box and a tail). Returns the
// dynamic bytes: the alignment slack and the resident query tile, then as
// many ring stages as fit beside them and the barriers, at most kMaxStages,
// each with its scale box for int8.
template <bool kInt8>
int smem_plan(int row_bytes, Shape* s) {
  const int rem = row_bytes % kBoxBytes;
  s->tail = rem > 0 && rem <= kTailBytes;
  s->boxes = row_bytes / kBoxBytes + (rem > kTailBytes ? 1 : 0);
  s->q_bytes = s->boxes * kQBoxBytes + s->tail * kQTailBytes;
  s->stage_bytes = s->boxes * kRBoxBytes + s->tail * kRTailBytes;
  const int per_stage = s->stage_bytes + (kInt8 ? kScaleBytes : 0);
  const int fixed = kAlign + s->q_bytes;
  const int room = kSmemLimit - (2 * kMaxStages + 1) * 8 - fixed;
  s->stages = room / per_stage;
  if (s->stages > kMaxStages) s->stages = kMaxStages;
  return fixed + s->stages * per_stage;
}

template <int kLW, bool kQueriesMajor, bool kInt8>
int launch_lw(unsigned grid, int smem, cudaStream_t stream, const CUtensorMap (&maps)[5],
              float* vals, int32_t* args, const Shape& s) {
  auto kernel = window_tc_kernel<kLW, kQueriesMajor, kInt8>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left behind for the next launch's check
    return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                           vals, args, s);
  return (int)cudaGetLastError();
}

// q (n_q, d) and items (n_items, d) of the kind's type, both 16-byte
// aligned with rows of a 16-byte multiple and at most kMaxRowBytes, window a
// power of two; int8: scales (n_items,) f32, 16-byte aligned.
template <bool kInt8, bool kQueriesMajor>
int launch(const void* q, const void* items, const float* scales, float* vals,
           int32_t* args, int n_q, int n_items, int d, int n_valid, int window,
           void* stream) {
  constexpr int kElem = Kind<kInt8>::kElemBytes;
  const int row_bytes = d * kElem;
  if (n_q <= 0 || n_items <= 0 || d <= 0 || row_bytes % 16 != 0 ||
      row_bytes > kMaxRowBytes || window <= 0 || (window & (window - 1)) ||
      n_valid <= 0 || n_valid > n_items ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(items)) % 16 ||
      (kInt8 && (scales == nullptr || reinterpret_cast<uintptr_t>(scales) % 16)))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  Shape s;
  const int smem = smem_plan<kInt8>(row_bytes, &s);
  // queries, corpus, their tails (left zero when there is none), the scales
  const CUtensorMapDataType type =
      kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[5] = {};
  if (!tile_map(&maps[0], encode, type, kElem, q, n_q, row_bytes, kBQ, kBoxBytes) ||
      !tile_map(&maps[1], encode, type, kElem, items, n_items, row_bytes, kBR,
                kBoxBytes) ||
      (s.tail && (!tile_map(&maps[2], encode, type, kElem, q, n_q, row_bytes, kBQ,
                            kTailBytes) ||
                  !tile_map(&maps[3], encode, type, kElem, items, n_items, row_bytes,
                            kBR, kTailBytes))) ||
      (kInt8 && !scale_map(&maps[4], encode, scales, n_items)))
    return (int)cudaErrorInvalidValue;

  s.n_q = n_q;
  s.n_items = n_items;
  s.n_valid = n_valid;
  s.n_cand = ((long long)n_items + window - 1) / window;
  s.ksteps = (row_bytes + kStepBytes - 1) / kStepBytes;
  s.span = window > kBR ? window : kBR;
  s.tiles_per_span = (int)(s.span / kBR);
  s.n_spans = (s.n_cand * window + s.span - 1) / s.span;
  s.n_qtiles = (n_q + kBQ - 1) / kBQ;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long per = sms / s.n_qtiles;
  if (per > s.n_spans) per = s.n_spans;
  s.per_qtile = per < 1 ? 1 : (int)per;
  const long long grid = (long long)s.n_qtiles * s.per_qtile;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  int log_w = 0;
  while ((1 << log_w) < window) ++log_w;
  switch (log_w < 7 ? log_w : 7) {
    case 0: return launch_lw<0, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
    case 1: return launch_lw<1, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
    case 2: return launch_lw<2, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
    case 3: return launch_lw<3, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
    case 4: return launch_lw<4, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
    case 5: return launch_lw<5, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
    case 6: return launch_lw<6, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
    default: return launch_lw<7, kQueriesMajor, kInt8>(g, smem, st, maps, vals, args, s);
  }
}

}  // namespace tc
