// Int8 window-segment MIPS for Hopper (sm_90a): for every window of `window`
// consecutive corpus rows and every query, the largest dequantised score
// (q_i8 . e_i8) * item_scale[row] and the first position inside the window
// that attains it.
//
// Replaces the Pallas TPU kernel recommendit_tpu/ops/pallas_mips.py
// ::_window_kernel_im_i8 (wrapper mips_topk_window_im_int8). Same contract:
// the int8 x int8 products accumulate exactly in int32; the epilogue is, in
// this order, float(acc) (exact: |acc| <= 128^2 * 1024 = 2^24), times the
// row's scale, then rows >= n_valid set to -3e38 -- the mask comes AFTER the
// scale because padded rows carry scale 0 and -3e38 * 0 = -0 would beat every
// negative real score. Argmax ties go to the earliest row; outputs are
// items-major (n_cand, n_q). The per-query scale, uniform and positive along
// a query's scores, is applied by the wrapper after the selection, and the
// exact top-k over the window maxima runs outside the kernel, as in JAX.
//
// What bounds it on an H100: at the serve shape (Q=1024 queries, N=1M rows,
// 129 columns: the embedding and the bias, zero-padded to 144 on the card)
// one call is 2*Q*N*129 = 2.6e11 int8 operations against 0.13 GB of corpus
// and scales -- about 2,000 operations per byte, far above the card's ridge
// point, so it is compute-bound: 0.1335 ms at the 1,979 TOPS dense int8
// tensor-core peak. The (Q, N) score matrix never reaches device memory;
// only the (N/W, Q) maxima and positions do.
//
// Two bodies:
//
// * Tensor cores (window_mips_i8_tc_launch, d <= 384): the template of
//   window_tc.cuh, which window_mips.cu's bf16 body shares. What the dp4a
//   body lacked, and what does it:
//   1. four int8 MACs per instruction on the CUDA cores -> wgmma.mma_async
//      m64n128k32 s8 x s8 -> s32, both operands K-major in shared memory
//      (queries as A, corpus rows as B); a k32 step of int8 is 32 bytes, as
//      a k16 step of bf16 is, so the descriptors and swizzles are the bf16
//      body's;
//   2. the corpus read once per 64-query tile -> 256 queries resident per
//      block, a persistent grid, the blocks that share a corpus tile side
//      by side (L2 serves the repeats);
//   3. synchronous staging -> a producer warpgroup streams 128-row tiles by
//      TMA into a ring of 4 stages (20 KB each at d = 144: one
//      128-column box and one 32-column tail box whose columns 144-159 TMA
//      fills with zeros) while two consumer warpgroups multiply;
//   4. the item scales -> one 512-byte TMA box per tile on the stage's full
//      barrier (rows past the corpus read scale 0, so no guard); each
//      thread applies its 32 columns' scales to the int32 sums in its
//      registers, in place, before it releases the stage;
//   5. the score tile in shared memory -> the window max/argmax straight
//      from the registers, as the bf16 body takes it (the mask only on
//      tiles that reach past n_valid, wide windows carried across tiles).
//   float(acc) is one cvt.rn.f32.s32 per score, exact at any width (|acc|
//   <= 128^2 * 1024 = 2^24). The integer trick that avoids the conversion
//   (the bits 0x4B400000 + acc, less 1.5 * 2^23: an integer add and an f32
//   subtract) measured slower on the card (tools/window_i8_breakdown.py),
//   likely because the conversion unit works beside the f32 and integer
//   pipes the window max keeps busy, while the trick adds to them. The
//   width limit is the query tile's:
//   256 rows of at most 384 bytes, as for bf16. Left: the epilogue (the
//   scale step, then the window max) takes more of the time than the
//   products and the ring together, since it touches Q*N scores with a
//   convert, a multiply, a compare and two selects each; the consumers
//   multiply, then reduce, so the tensor cores wait during the reduction
//   (the two warpgroups interleave only by the scheduler); every corpus
//   tile is read from L2 by each block that shares it.
// * CUDA cores (window_mips_i8_launch, d up to 1024; the wrapper takes it for
//   d > 384):
//   __dp4a, four int8 MACs into an int32 per instruction. Each block stages
//   a 64-row x 16-byte corpus slice and a 64-query slice in shared memory
//   (one 16-byte load per row per thread), each thread keeps a 4x4 register
//   tile of int32 sums, and the dequantised 64x64 score tile goes to shared
//   memory for the per-window max/argmax.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;   // corpus rows per shared-memory tile
constexpr int kTileQ = 64;      // queries per block
// kStepBytes and kMaxDim are ops/topk.py's INT8_ROW_ALIGN and INT8_MAX_DIM,
// which the Python wrapper checks before the launch.
constexpr int kStepBytes = 16;  // bytes of each row staged per step
constexpr int kStepWords = kStepBytes / 4;
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4x4 score tile
constexpr int kMicro = 4;
constexpr int kMaxDim = 1024;   // keeps every int32 sum exact in f32
constexpr float kMasked = -3e38f;

static_assert(kTileRows == kTileQ, "the staging loop loads both tiles at once");
static_assert((kTileRows / kMicro) * (kTileQ / kMicro) == kThreads, "tile map");
static_assert(kTileRows + kTileQ <= kThreads, "one 16-byte load per thread");

// Grid: x = groups of whole windows (max(window, 64) rows each), y = query
// tiles. A block walks its rows in 64-row tiles; a window wider than a tile
// carries its running max/argmax across tiles in registers, a narrower one
// is finished inside the tile.
__global__ void __launch_bounds__(kThreads)
window_mips_i8_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ items,
                      const float* __restrict__ scales,
                      float* __restrict__ vals, int32_t* __restrict__ args,
                      int n_q, int n_items, int d, int n_valid, int window,
                      long long n_cand) {
  __shared__ __align__(16) int a_s[kStepWords][kTileRows];  // corpus, k-major
  __shared__ __align__(16) int b_s[kStepWords][kTileQ];     // queries, k-major
  __shared__ float s_s[kTileRows][kTileQ];                  // score tile

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

  float carry_best = -CUDART_INF_F;   // wide windows: running max, argmax
  int carry_arg = 0;

  for (int t = 0; t < n_tiles; ++t) {
    const long long tile_r0 = r0 + (long long)t * kTileRows;
    int acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < d; k0 += kStepBytes) {
      // threads 0-63 load a corpus row's 16 bytes, 64-127 a query row's
      if (tid < kTileRows + kTileQ) {
        const bool is_row = tid < kTileRows;
        const int r = is_row ? tid : tid - kTileRows;
        int4 v = make_int4(0, 0, 0, 0);
        if (is_row) {
          const long long gr = tile_r0 + r;
          if (gr < n_items)
            v = *reinterpret_cast<const int4*>(items + gr * d + k0);
        } else {
          const int gq = q0 + r;
          if (gq < n_q)
            v = *reinterpret_cast<const int4*>(q + (long long)gq * d + k0);
        }
        int(*dst)[kTileRows] = is_row ? a_s : b_s;
        dst[0][r] = v.x;
        dst[1][r] = v.y;
        dst[2][r] = v.z;
        dst[3][r] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kStepWords; ++w) {
        const int4 a = *reinterpret_cast<const int4*>(&a_s[w][ty * kMicro]);
        const int4 b = *reinterpret_cast<const int4*>(&b_s[w][tx * kMicro]);
        const int av[kMicro] = {a.x, a.y, a.z, a.w};
        const int bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: exact float, times the row's scale, then the pad mask
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = ty * kMicro + i;
      const long long gr = tile_r0 + r;
      const float sc = gr < n_items ? scales[gr] : 0.f;
      const bool valid = gr < n_valid;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const float s = __fmul_rn(__int2float_rn(acc[i][j]), sc);
        s_s[r][tx * kMicro + j] = valid ? s : kMasked;
      }
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
          vals[win * n_q + gq] = best;
          args[win * n_q + gq] = arg;
        }
      }
    }
    __syncthreads();
  }

  if (wide && tid < kTileQ) {
    const long long win = blockIdx.x;
    const int gq = q0 + tid;
    if (win < n_cand && gq < n_q) {
      vals[win * n_q + gq] = carry_best;
      args[win * n_q + gq] = carry_arg;
    }
  }
}

}  // namespace

#include "window_tc.cuh"

// C entries, bound with ctypes. q: (n_q, d) int8; items: (n_items, d) int8;
// scales: (n_items,) f32; vals/args: (n_cand, n_q) with
// n_cand = ceil(n_items / window). All contiguous and 16-byte aligned, on the
// device of `stream`; d a multiple of 16. Each launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// after the launch (0 = launched).
//
// CUDA cores (dp4a): d at most 1024.
extern "C" int window_mips_i8_launch(const int8_t* q, const int8_t* items,
                                     const float* scales, float* vals,
                                     int32_t* args, int n_q, int n_items, int d,
                                     int n_valid, int window, void* stream) {
  if (n_q <= 0 || n_items <= 0 || d <= 0 || d % kStepBytes != 0 ||
      d > kMaxDim || window <= 0 || n_valid <= 0 || n_valid > n_items)
    return (int)cudaErrorInvalidValue;
  if (window < kTileRows ? kTileRows % window : window % kTileRows)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)items) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n_cand = ((long long)n_items + window - 1) / window;
  const int span = window > kTileRows ? window : kTileRows;
  const long long rows = n_cand * window;
  const dim3 grid((unsigned)((rows + span - 1) / span),
                  (unsigned)((n_q + kTileQ - 1) / kTileQ));
  window_mips_i8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, items, scales, vals, args, n_q, n_items, d, n_valid, window, n_cand);
  return (int)cudaGetLastError();
}

// Tensor cores: d at most 384, window a power of two.
extern "C" int window_mips_i8_tc_launch(const int8_t* q, const int8_t* items,
                                        const float* scales, float* vals,
                                        int32_t* args, int n_q, int n_items, int d,
                                        int n_valid, int window, void* stream) {
  return tc::launch<true, false>(q, items, scales, vals, args, n_q, n_items, d,
                                 n_valid, window, stream);
}

// The tensor-core body's dynamic shared memory per block at width d (a
// multiple of 16, at most 384), and its ring stages in *stages.
extern "C" int window_mips_i8_tc_smem(int d, int* stages) {
  tc::Shape s;
  const int bytes = tc::smem_plan<true>(d, &s);
  *stages = s.stages;
  return bytes;
}
