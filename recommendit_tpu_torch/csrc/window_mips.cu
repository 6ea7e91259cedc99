// Window-segment MIPS for Hopper (sm_90a): for every window of `window`
// consecutive corpus rows and every query, the window's largest score and
// the first position inside the window that attains it.
//
// Replaces two Pallas TPU kernels of recommendit_tpu/ops/pallas_mips.py:
// ::_window_kernel_im (wrapper mips_topk_window_im; items-major outputs
// (n_cand, n_q)) and ::_window_kernel (wrapper mips_topk_window; queries-major
// outputs (n_q, n_cand)). The two differ only in the layout they store, so
// one template serves both and each entry writes its own layout. Same
// contract as JAX: scores accumulate in f32; rows >= n_valid score -3e38;
// argmax ties go to the earliest row, so a fully masked window gives 0. The
// exact top-k over the window maxima runs outside the kernel (torch.topk).
//
// What bounds it on an H100: at the serve shape (Q=1024 queries, N=1M rows,
// 129 columns: the embedding and the bias) one call is 2*Q*N*129 = 2.6e11
// bf16 operations against 0.26 GB of corpus -- about 1,000 operations per
// byte, far above the card's ridge point, so it is compute-bound: 0.27 ms at
// the 989 TFLOP/s dense bf16 tensor-core peak.
//
// Two bodies:
//
// * Tensor cores (window_mips_bf16_launch / window_mips_bf16_qm_launch): a
//   bf16 corpus with bf16 queries -- the wrapper's "default" precision, where
//   the queries are rounded to bf16 first, so every bf16 x bf16 product is
//   exact and the f32 sums differ from the plain twin's only in order. What
//   the CUDA-core body lacked, and what removes it:
//   1. no tensor cores -> wgmma.mma_async m64n128k16 bf16 -> f32, both
//      operands K-major in shared memory (the queries as A, the corpus rows
//      as B: a window of rows lies along the accumulator's N axis);
//   2. the corpus read once per 64-query tile (16 times at Q=1024) -> each
//      block keeps 256 queries resident and the grid is persistent, one block
//      per SM, with the query tile fastest: the blocks that share a corpus
//      tile run side by side and the HBM reads it about once (L2 serves the
//      rest);
//   3. synchronous staging -> one thread of a producer warpgroup streams
//      128-row corpus tiles by TMA (the swizzled layouts wgmma reads) into
//      a ring of stages guarded by full/empty mbarriers, while two consumer
//      warpgroups multiply; setmaxnreg moves the producer's registers to the
//      consumers (232 each; no spills for windows of 4 rows or more);
//   4. the serial epilogue through a shared-memory score tile -> the window
//      max/argmax straight from the accumulator registers: a thread holds 32
//      columns (rows of the corpus) of each of its 4 query rows, reduces a
//      window's share in its registers, then across the 4 lanes of a quad
//      with two shuffles, ordered (value desc, row asc). Only tiles that
//      reach past n_valid pay for the mask. Windows wider than a tile carry
//      (max, row) across tiles in registers.
//   The K tail: rows are 129 columns zero-padded to 136, and a wgmma step
//   takes 16. Columns 0-127 come in two 64-column boxes (128-byte swizzle),
//   columns 128-143 in one 16-column box (32-byte swizzle) whose columns
//   136-143 TMA fills with zeros, as the tensor map is 136 wide: no padded
//   corpus is stored, a stage is 36 KB, and 4 stages fit at d = 136.
//   The queries-major entry changes only the stores, never the tiles or the
//   order of the sums, so its output is the items-major one transposed, bit
//   for bit. Left: each consumer warpgroup multiplies, then reduces, so the
//   tensor cores wait during the reduction (tried on the card without a
//   gain: the two warpgroups taking turns, a ping-pong; reducing one
//   m-block while the other multiplies, which makes ptxas serialize the
//   wgmmas; a tree-shaped in-thread reduction); each m64n128k16
//   reads both operands from shared memory; every corpus tile is read from
//   L2 by each of the blocks that share it (a cluster multicast would read
//   it once); a 256-query tile wastes its empty rows when Q is not a
//   multiple of 256; the resident query tile limits d to 192.
// * CUDA cores (window_mips_launch / window_mips_qm_launch): f32 queries
//   over an f32 or bf16 corpus ("highest" precision, or an f32 corpus), f32
//   FMAs: each block stages a 64-row x 8-column corpus slice and a 64-query
//   slice in shared memory, each thread keeps a 4x4 register tile of scores,
//   and the 64x64 score tile goes to shared memory for the per-window
//   max/argmax. No user path runs it at the serve shape.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).
// <cuda.h> is read for the tensor-map types only: cuTensorMapEncodeTiled is
// looked up in libcuda at run time, so nothing links against it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;   // corpus rows per shared-memory tile
constexpr int kTileQ = 64;      // queries per block
constexpr int kTileK = 8;       // feature columns per step (D % 8 == 0)
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4x4 score tile
constexpr int kMicro = 4;
constexpr float kMasked = -3e38f;

static_assert(kTileRows == kTileQ, "the staging loop loads both tiles at once");
static_assert((kTileRows / kMicro) * (kTileQ / kMicro) == kThreads, "tile map");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Grid: x = groups of whole windows (max(window, 64) rows each), y = query
// tiles. A block walks its rows in 64-row tiles; a window wider than a tile
// carries its running max/argmax across tiles in registers, a narrower one
// is finished inside the tile. kQueriesMajor picks the output layout.
template <typename T, bool kQueriesMajor>
__global__ void __launch_bounds__(kThreads)
window_mips_kernel(const float* __restrict__ q, const T* __restrict__ items,
                   float* __restrict__ vals, int32_t* __restrict__ args,
                   int n_q, int n_items, int d, int n_valid, int window,
                   long long n_cand) {
  __shared__ __align__(16) float a_s[kTileK][kTileRows];  // corpus, k-major
  __shared__ __align__(16) float b_s[kTileK][kTileQ];     // queries, k-major
  __shared__ float s_s[kTileRows][kTileQ];                // score tile

  const int tid = threadIdx.x;
  const int tx = tid % (kTileQ / kMicro);   // query group of this thread
  const int ty = tid / (kTileQ / kMicro);   // row group of this thread
  const int q0 = blockIdx.y * kTileQ;
  const bool wide = window >= kTileRows;
  const int span = wide ? window : kTileRows;          // rows of this block
  const long long r0 = (long long)blockIdx.x * span;
  const int n_tiles = span / kTileRows;
  const int segs = wide ? 1 : kTileRows / window;      // windows per tile
  const int seg_rows = wide ? kTileRows : window;
  auto at = [&](long long win, int gq) {
    return kQueriesMajor ? (long long)gq * n_cand + win : win * n_q + gq;
  };

  float carry_best = -CUDART_INF_F;   // wide windows: running max, argmax
  int carry_arg = 0;

  for (int t = 0; t < n_tiles; ++t) {
    const long long tile_r0 = r0 + (long long)t * kTileRows;
    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kTileK) {
      for (int e = tid; e < kTileK * kTileRows; e += kThreads) {
        const int r = e / kTileK;
        const int kk = e % kTileK;
        const long long gr = tile_r0 + r;
        a_s[kk][r] = gr < n_items ? widen(items[gr * d + k0 + kk]) : 0.f;
        const int gq = q0 + r;
        b_s[kk][r] = gq < n_q ? q[(long long)gq * d + k0 + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * kMicro]);
        const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * kMicro]);
        const float av[kMicro] = {a.x, a.y, a.z, a.w};
        const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = ty * kMicro + i;
      const bool valid = tile_r0 + r < n_valid;
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        s_s[r][tx * kMicro + j] = valid ? acc[i][j] : kMasked;
    }
    __syncthreads();

    for (int p = tid; p < kTileQ * segs; p += kThreads) {
      const int qi = p % kTileQ;
      const int s = p / kTileQ;
      float best = -CUDART_INF_F;
      int arg = 0;
      for (int r = 0; r < seg_rows; ++r) {
        const float v = s_s[s * seg_rows + r][qi];
        if (v > best) {  // strictly greater: the first occurrence wins
          best = v;
          arg = r;
        }
      }
      if (wide) {
        if (best > carry_best) {
          carry_best = best;
          carry_arg = t * kTileRows + arg;
        }
      } else {
        const long long win = tile_r0 / window + s;
        const int gq = q0 + qi;
        if (win < n_cand && gq < n_q) {
          vals[at(win, gq)] = best;
          args[at(win, gq)] = arg;
        }
      }
    }
    __syncthreads();
  }

  if (wide && tid < kTileQ) {
    const long long win = blockIdx.x;
    const int gq = q0 + tid;
    if (win < n_cand && gq < n_q) {
      vals[at(win, gq)] = carry_best;
      args[at(win, gq)] = carry_arg;
    }
  }
}

template <bool kQueriesMajor>
int launch(const float* q, const void* items, int items_bf16, float* vals,
           int32_t* args, int n_q, int n_items, int d, int n_valid, int window,
           void* stream) {
  if (n_q <= 0 || n_items <= 0 || d <= 0 || d % kTileK != 0 || window <= 0 ||
      n_valid <= 0 || n_valid > n_items)
    return (int)cudaErrorInvalidValue;
  if (window < kTileRows ? kTileRows % window : window % kTileRows)
    return (int)cudaErrorInvalidValue;
  const long long n_cand = ((long long)n_items + window - 1) / window;
  const int span = window > kTileRows ? window : kTileRows;
  const long long rows = n_cand * window;
  const dim3 grid((unsigned)((rows + span - 1) / span),
                  (unsigned)((n_q + kTileQ - 1) / kTileQ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items_bf16) {
    window_mips_kernel<__nv_bfloat16, kQueriesMajor><<<grid, kThreads, 0, s>>>(
        q, static_cast<const __nv_bfloat16*>(items), vals, args, n_q, n_items,
        d, n_valid, window, n_cand);
  } else {
    window_mips_kernel<float, kQueriesMajor><<<grid, kThreads, 0, s>>>(
        q, static_cast<const float*>(items), vals, args, n_q, n_items, d,
        n_valid, window, n_cand);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Tensor-core body: TMA ring, wgmma, window max/argmax from the registers.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 256;              // queries per block, resident
constexpr int kBR = 128;              // corpus rows per stage (wgmma N)
constexpr int kBoxCols = 64;          // bf16 columns per TMA box: 128 bytes
constexpr int kMaxBoxes = 3;          // so d <= 192
constexpr int kMaxStages = 4;
constexpr int kConsumerWarps = 8;     // two warpgroups of 128 queries each
constexpr int kThreads = 32 * (kConsumerWarps + 4);   // + the producer warpgroup
constexpr int kQBoxBytes = kBQ * kBoxCols * 2;        // 32 KB
constexpr int kRBoxBytes = kBR * kBoxCols * 2;        // 16 KB
constexpr int kTailCols = 16;         // a K tail of <= 16 columns: 32-byte rows
constexpr int kQTailBytes = kBQ * kTailCols * 2;      // 8 KB
constexpr int kRTailBytes = kBR * kTailCols * 2;      // 4 KB
constexpr int kAlign = 1024;          // the 128-byte swizzle repeats every 8 rows
constexpr int kSmemLimit = 232448;    // what one block may use on sm_90
constexpr float kMasked = -3e38f;

// 384 threads launch with 168 registers each; the producer warpgroup gives
// back all but 40 (setmaxnreg), so the consumers, with two 64-float
// accumulators each, can hold 232.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "register budget");

struct Shape {
  int n_q, n_items, n_valid;
  long long n_cand;
  int ksteps, boxes, tail, stages;   // tail: one 16-column box after the 64-column ones
  int q_bytes, stage_bytes;          // shared memory of the query tile, of a stage
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

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle (rows of 128 bytes) or the 32-byte one (rows of 32
// bytes, the K tail): 8-row atoms 8 rows apart (SBO), the leading offset
// unused for these layouts. A k-step of 16 bf16 columns moves the start
// address by 32 bytes inside a 128-byte row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : 3;   // B128 : B32
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * row_bytes >> 4) << 32) | (layout << 62);
}

// d (64 x 128, f32) += A (64 x 16 queries) * B (128 corpus rows x 16)^T;
// scale_d == 0 overwrites d. Accumulator register i of thread (warp w, lane
// l) holds query row 16w + l/4 + 8*((i>>1)&1), corpus column
// 8*(i>>2) + 2*(l%4) + (i&1).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma and its wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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
// r0.. r0+127) for this thread's two query rows q_row and q_row + 8.
// kLW = log2 of the window's share of the tile (7: the tile is one window
// or part of a wider one, carried in cv/cc across the window's tiles, of
// which this is tile t of tpw). Columns >= lim are rows >= n_valid; kMask
// is false for tiles wholly below n_valid, which skip the compare.
template <int kLW, bool kQueriesMajor, bool kMask>
__device__ __forceinline__ void epilogue(const float (&acc)[64], int mb,
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
            const float v = !kMask || col < lim ? acc[4 * j + 2 * h + e] : kMasked;
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
            const float v = !kMask || col < lim ? acc[4 * j + 2 * h + e] : kMasked;
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
// copies.
template <int kLW, bool kQueriesMajor>
__global__ void __launch_bounds__(kThreads, 1)
window_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap r_map,
                 const __grid_constant__ CUtensorMap q_tail_map,
                 const __grid_constant__ CUtensorMap r_tail_map,
                 float* __restrict__ vals, int32_t* __restrict__ args,
                 const Shape s) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages + 1];

  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~uint32_t(kAlign - 1);
  // queries: boxes x 256 rows x 128 B, then the tail, 256 x 32 B; each
  // stage the same for 128 corpus rows
  const uint32_t q_s = base;
  const uint32_t r_s = base + s.q_bytes;
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
          mbar_expect_tx(full0 + 8 * stage, s.stage_bytes);
          for (int b = 0; b < s.boxes; ++b)
            tma_load_2d(dst + b * kRBoxBytes, &r_map, b * kBoxCols, (int)r0,
                        full0 + 8 * stage);
          if (s.tail)
            tma_load_2d(dst + s.boxes * kRBoxBytes, &r_tail_map,
                        s.boxes * kBoxCols, (int)r0, full0 + 8 * stage);
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
    const int k_full = s.ksteps - s.tail;       // k-steps in 64-column boxes
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
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
            const uint32_t off = (k >> 2) * kQBoxBytes + (k & 3) * 32;
            const uint64_t db = smem_desc(b_s + (k >> 2) * kRBoxBytes + (k & 3) * 32, 128);
            wgmma_m64n128k16(acc0, smem_desc(a0 + off, 128), db, k);
            wgmma_m64n128k16(acc1, smem_desc(a1 + off, 128), db, k);
          }
          if (s.tail) {
            const uint64_t db = smem_desc(b_s + s.boxes * kRBoxBytes, 32);
            wgmma_m64n128k16(acc0, smem_desc(a0_tail, 32), db, k_full);
            wgmma_m64n128k16(acc1, smem_desc(a1_tail, 32), db, k_full);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_acc(acc0);
          fence_acc(acc1);
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

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (rows, d) row-major bf16 tensor cut into (box_rows, box_cols) boxes,
// 128-byte swizzled for 64 columns, 32-byte for the 16-column tail; columns
// >= d and rows >= rows read as zeros.
bool bf16_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int rows,
              int d, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == kBoxCols ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory of a launch at width d: 64-column boxes, and a 16-column
// tail box where the last <= 16 columns would otherwise take a 64-column
// one (d = 136: 2 boxes and a tail, so 144 columns are multiplied and
// stored). Returns the dynamic bytes: the alignment slack and the resident
// query tile, then as many ring stages as fit beside them and the barriers.
int smem_plan(int d, Shape* s) {
  const int rem = d % kBoxCols;
  s->tail = rem > 0 && rem <= kTailCols;
  s->boxes = d / kBoxCols + (rem > kTailCols ? 1 : 0);
  s->q_bytes = s->boxes * kQBoxBytes + s->tail * kQTailBytes;
  s->stage_bytes = s->boxes * kRBoxBytes + s->tail * kRTailBytes;
  const int fixed = kAlign + s->q_bytes;
  const int room = kSmemLimit - (2 * kMaxStages + 1) * 8 - fixed;
  s->stages = room / s->stage_bytes;
  if (s->stages > kMaxStages) s->stages = kMaxStages;
  return fixed + s->stages * s->stage_bytes;
}

template <int kLW, bool kQueriesMajor>
int launch_lw(unsigned grid, int smem, cudaStream_t stream, const CUtensorMap (&maps)[4],
              float* vals, int32_t* args, const Shape& s) {
  auto kernel = window_tc_kernel<kLW, kQueriesMajor>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left behind for the next launch's check
    return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], vals,
                                           args, s);
  return (int)cudaGetLastError();
}

template <bool kQueriesMajor>
int launch(const void* q, const void* items, float* vals, int32_t* args, int n_q,
           int n_items, int d, int n_valid, int window, void* stream) {
  if (n_q <= 0 || n_items <= 0 || d <= 0 || d % 8 != 0 ||
      d > kMaxBoxes * kBoxCols || window <= 0 || (window & (window - 1)) ||
      n_valid <= 0 || n_valid > n_items ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(items)) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  Shape s;
  const int smem = smem_plan(d, &s);
  // queries, corpus, then their tails (left zero when there is none)
  CUtensorMap maps[4] = {};
  if (!bf16_map(&maps[0], encode, q, n_q, d, kBQ, kBoxCols) ||
      !bf16_map(&maps[1], encode, items, n_items, d, kBR, kBoxCols) ||
      (s.tail && (!bf16_map(&maps[2], encode, q, n_q, d, kBQ, kTailCols) ||
                  !bf16_map(&maps[3], encode, items, n_items, d, kBR, kTailCols))))
    return (int)cudaErrorInvalidValue;

  s.n_q = n_q;
  s.n_items = n_items;
  s.n_valid = n_valid;
  s.n_cand = ((long long)n_items + window - 1) / window;
  s.ksteps = (d + 15) / 16;
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
    case 0: return launch_lw<0, kQueriesMajor>(g, smem, st, maps, vals, args, s);
    case 1: return launch_lw<1, kQueriesMajor>(g, smem, st, maps, vals, args, s);
    case 2: return launch_lw<2, kQueriesMajor>(g, smem, st, maps, vals, args, s);
    case 3: return launch_lw<3, kQueriesMajor>(g, smem, st, maps, vals, args, s);
    case 4: return launch_lw<4, kQueriesMajor>(g, smem, st, maps, vals, args, s);
    case 5: return launch_lw<5, kQueriesMajor>(g, smem, st, maps, vals, args, s);
    case 6: return launch_lw<6, kQueriesMajor>(g, smem, st, maps, vals, args, s);
    default: return launch_lw<7, kQueriesMajor>(g, smem, st, maps, vals, args, s);
  }
}

}  // namespace tc

// C entries, bound with ctypes. vals/args: (n_cand, n_q) for the items-major
// entries and (n_q, n_cand) for the queries-major (_qm_) ones, with n_cand =
// ceil(n_items / window). All contiguous, on the device of `stream`. Each
// launches on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
//
// CUDA cores: q (n_q, d) f32; items (n_items, d) f32 or bf16 (items_bf16).
extern "C" int window_mips_launch(const float* q, const void* items,
                                  int items_bf16, float* vals, int32_t* args,
                                  int n_q, int n_items, int d, int n_valid,
                                  int window, void* stream) {
  return launch<false>(q, items, items_bf16, vals, args, n_q, n_items, d,
                       n_valid, window, stream);
}

extern "C" int window_mips_qm_launch(const float* q, const void* items,
                                     int items_bf16, float* vals,
                                     int32_t* args, int n_q, int n_items,
                                     int d, int n_valid, int window,
                                     void* stream) {
  return launch<true>(q, items, items_bf16, vals, args, n_q, n_items, d,
                      n_valid, window, stream);
}

// Tensor cores: q (n_q, d) and items (n_items, d) bf16, both 16-byte aligned,
// d a multiple of 8 and at most 192, window a power of two.
extern "C" int window_mips_bf16_launch(const void* q, const void* items,
                                       float* vals, int32_t* args, int n_q,
                                       int n_items, int d, int n_valid,
                                       int window, void* stream) {
  return tc::launch<false>(q, items, vals, args, n_q, n_items, d, n_valid,
                           window, stream);
}

// The tensor-core body's dynamic shared memory per block at width d (d a
// multiple of 8, at most 192), and its ring stages in *stages.
extern "C" int window_mips_bf16_smem(int d, int* stages) {
  tc::Shape s;
  const int bytes = tc::smem_plan(d, &s);
  *stages = s.stages;
  return bytes;
}

extern "C" int window_mips_bf16_qm_launch(const void* q, const void* items,
                                          float* vals, int32_t* args, int n_q,
                                          int n_items, int d, int n_valid,
                                          int window, void* stream) {
  return tc::launch<true>(q, items, vals, args, n_q, n_items, d, n_valid,
                          window, stream);
}
