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
// * Tensor cores (window_mips_bf16_launch / window_mips_bf16_qm_launch; the
//   template in window_tc.cuh, shared with window_mips_i8.cu): a
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

// The tensor-core body (TMA ring, wgmma, window max/argmax from the
// registers), shared with window_mips_i8.cu.
#include "window_tc.cuh"

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
  return tc::launch<false, false>(q, items, nullptr, vals, args, n_q, n_items, d,
                                  n_valid, window, stream);
}

// The tensor-core body's dynamic shared memory per block at width d (d a
// multiple of 8, at most 192), and its ring stages in *stages.
extern "C" int window_mips_bf16_smem(int d, int* stages) {
  tc::Shape s;
  const int bytes = tc::smem_plan<false>(2 * d, &s);
  *stages = s.stages;
  return bytes;
}

extern "C" int window_mips_bf16_qm_launch(const void* q, const void* items,
                                          float* vals, int32_t* args, int n_q,
                                          int n_items, int d, int n_valid,
                                          int window, void* stream) {
  return tc::launch<false, true>(q, items, nullptr, vals, args, n_q, n_items, d,
                                 n_valid, window, stream);
}
