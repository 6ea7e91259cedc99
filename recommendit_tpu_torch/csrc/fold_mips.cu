// Fold MIPS for Hopper (sm_90a): per block of bn corpus rows and per query,
// the block's scores folded by halving down to bn/R bins, each bin keeping its
// largest score and the row it came from.
//
// Replaces the Pallas TPU kernel recommendit_tpu/ops/pallas_mips.py
// ::_fold_kernel (wrapper mips_topk_fused). What it computes, exactly as the
// TPU kernel does:
//   * scores are f32 sums of f32 products of the f32 queries (never rounded
//     to the corpus dtype, unlike the window kernels) and the corpus widened
//     to f32;
//   * bin p of a block collects rows p + j*(bn/R), j < R (strided, not
//     contiguous);
//   * the TPU kernel halves the score row log2(R) times with
//     `take_left = left >= right`, a tournament. Among tied maxima it keeps
//     the j with the smallest bit-reversed j (log2(R) bits; compared here as
//     __brev of the 32-bit j, which orders the same). This kernel streams
//     over j and keeps (max, j), replacing on s > max, or s == max with a
//     smaller bit-reversed j, so it keeps the same row;
//   * rows past the corpus in its last block (when N % bn != 0) score
//     `pad_score`: the TPU wrapper appends a bias coordinate (query 1, real
//     rows 0, pad rows -3e38 in the corpus dtype), so a pad row scores
//     exactly that number and a real row its plain dot product. Bins that
//     hold only pad rows are outputs too, as in JAX.
// Outputs are queries-major (n_q, n_blocks * bn/R): the bin's value and the
// global row id (int32; the TPU kernel returns an f32 offset instead).
//
// What bounds it on an H100: 2*Q*N*D multiply-adds of f32 products, e.g.
// 2.6e11 at Q=1024, N=1M, D=128, with ~1,000 operations per corpus byte:
// compute-bound. The queries stay f32, so bf16 tensor cores cannot take them
// as they are; the bound is the f32 rate. The design is the window kernel's:
// a block owns one 64-query tile and up to 64 bins of one corpus block, and
// walks the block's rows in 64-row tiles staged in shared memory; each thread
// keeps a 4x4 register tile of scores and a running (max, j) per entry in
// registers, so no score leaves the SM. Bins narrower than a tile (bn/R < 64)
// are finished by one tie-aware reduction in shared memory at the end.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;   // corpus row slots per shared-memory tile
constexpr int kTileQ = 64;      // queries per block
constexpr int kTileK = 8;       // feature columns per step
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4x4 score tile
constexpr int kMicro = 4;

static_assert(kTileRows == kTileQ, "the staging loop loads both tiles at once");
static_assert((kTileRows / kMicro) * (kTileQ / kMicro) == kThreads, "tile map");
static_assert(2 * kThreads == kTileK * kTileRows, "two staged rows a thread");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// True when (s, j) displaces (best, best_j) in the tournament's order.
__device__ __forceinline__ bool wins(float s, int j, float best, int best_j) {
  return best_j < 0 || s > best ||
         (s == best && __brev((unsigned)j) < __brev((unsigned)best_j));
}

// Grid: x = corpus block b (bn rows) x bin tile t (bins_t bins each),
// y = query tile. Slot r of row tile u is the block's f-th row of this bin
// tile, f = u*64 + r: j = f / bins_t, bin p = f % bins_t, global row
// b*bn + j*out + t*bins_t + p. Since 64 % bins_t == 0, a thread's slots keep
// their bin across tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_mips_kernel(const float* __restrict__ q, const T* __restrict__ items,
                 float* __restrict__ vals, int32_t* __restrict__ ids, int n_q,
                 int n_items, int d, int bn, int out, int bins_t,
                 float pad_score, long long n_cand) {
  __shared__ __align__(16) float a_s[kTileK][kTileRows];  // corpus, k-major
  __shared__ __align__(16) float b_s[kTileK][kTileQ];     // queries, k-major
  __shared__ float v_s[kTileRows][kTileQ];                // per-slot maxima
  __shared__ int j_s[kTileRows][kTileQ];                  // their j

  const int tid = threadIdx.x;
  const int tx = tid % (kTileQ / kMicro);   // query group of this thread
  const int ty = tid / (kTileQ / kMicro);   // slot group of this thread
  const int q0 = blockIdx.y * kTileQ;
  const int tiles_per_block = out / bins_t;
  const int b = blockIdx.x / tiles_per_block;
  const int t = blockIdx.x % tiles_per_block;
  const int reduction = bn / out;
  const int n_slots = reduction * bins_t;              // rows of this block
  const long long base = (long long)b * bn + (long long)t * bins_t;

  // staging: this thread loads column kk of slots / queries sr and sr + 32
  const int kk_ld = tid % kTileK;
  const int sr = tid / kTileK;
  const float* q_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q0 + sr + h * (kTileRows / 2);
    q_row[h] = gq < n_q ? q + (long long)gq * d : nullptr;
  }

  float best[kMicro][kMicro];
  int best_j[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) {
      best[i][jj] = 0.f;
      best_j[i][jj] = -1;
    }

  for (int f0 = 0; f0 < n_slots; f0 += kTileRows) {
    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) acc[i][jj] = 0.f;

    const T* i_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + sr + h * (kTileRows / 2);
      const long long gr = base + (long long)(f / bins_t) * out + f % bins_t;
      i_row[h] = (f < n_slots && gr < n_items) ? items + gr * d : nullptr;
    }
    for (int k0 = 0; k0 < d; k0 += kTileK) {
      const int k = k0 + kk_ld;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = sr + h * (kTileRows / 2);
        a_s[kk_ld][r] = (i_row[h] && k < d) ? widen(i_row[h][k]) : 0.f;
        b_s[kk_ld][r] = (q_row[h] && k < d) ? q_row[h][k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * kMicro]);
        const float4 bq = *reinterpret_cast<const float4*>(&b_s[kk][tx * kMicro]);
        const float av[kMicro] = {a.x, a.y, a.z, a.w};
        const float bv[kMicro] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int jj = 0; jj < kMicro; ++jj)
            acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int f = f0 + ty * kMicro + i;
      if (f >= n_slots) continue;
      const int j = f / bins_t;
      const long long gr = base + (long long)j * out + f % bins_t;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const float s = gr < n_items ? acc[i][jj] : pad_score;
        if (wins(s, j, best[i][jj], best_j[i][jj])) {
          best[i][jj] = s;
          best_j[i][jj] = j;
        }
      }
    }
  }

  // slots r and r + bins_t, r + 2*bins_t, ... hold the same bin
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) {
      v_s[ty * kMicro + i][tx * kMicro + jj] = best[i][jj];
      j_s[ty * kMicro + i][tx * kMicro + jj] = best_j[i][jj];
    }
  __syncthreads();

  const int per_bin = kTileRows / bins_t;
  for (int e = tid; e < bins_t * kTileQ; e += kThreads) {
    const int p = e % bins_t;
    const int qi = e / bins_t;
    const int gq = q0 + qi;
    if (gq >= n_q) continue;
    float v = 0.f;
    int bj = -1;
    for (int m = 0; m < per_bin; ++m) {
      const int r = p + m * bins_t;
      const int j = j_s[r][qi];
      if (j >= 0 && wins(v_s[r][qi], j, v, bj)) {
        v = v_s[r][qi];
        bj = j;
      }
    }
    const long long c = (long long)b * out + (long long)t * bins_t + p;
    vals[(long long)gq * n_cand + c] = v;
    ids[(long long)gq * n_cand + c] = (int32_t)(base + (long long)bj * out + p);
  }
}

}  // namespace

// C entry, bound with ctypes. q: (n_q, d) f32; items: (n_items, d) f32 or
// bf16 (items_bf16 != 0); bn: rows per corpus block and out = bn / R bins per
// block, both powers of two with out <= bn; rows in [n_items, n_blocks*bn)
// score pad_score. vals (f32) and ids (int32): (n_q, n_blocks * out). All
// contiguous, on the device of `stream`. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int fold_mips_launch(const float* q, const void* items,
                                int items_bf16, float* vals, int32_t* ids,
                                int n_q, int n_items, int d, int bn, int out,
                                float pad_score, void* stream) {
  if (n_q <= 0 || n_items <= 0 || d <= 0 || bn <= 0 || out <= 0 || out > bn ||
      (bn & (bn - 1)) || (out & (out - 1)))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = ((long long)n_items + bn - 1) / bn;
  if (n_blocks * bn >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int bins_t = out < kTileRows ? out : kTileRows;
  const long long n_cand = n_blocks * out;
  const dim3 grid((unsigned)(n_blocks * (out / bins_t)),
                  (unsigned)((n_q + kTileQ - 1) / kTileQ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items_bf16) {
    fold_mips_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        q, static_cast<const __nv_bfloat16*>(items), vals, ids, n_q, n_items,
        d, bn, out, bins_t, pad_score, n_cand);
  } else {
    fold_mips_kernel<float><<<grid, kThreads, 0, s>>>(
        q, static_cast<const float*>(items), vals, ids, n_q, n_items, d, bn,
        out, bins_t, pad_score, n_cand);
  }
  return (int)cudaGetLastError();
}
