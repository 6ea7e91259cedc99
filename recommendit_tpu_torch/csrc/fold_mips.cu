// Fold MIPS for Hopper (sm_90a): per block of bn corpus rows and per query,
// the block's scores folded by halving down to bn/R bins, each bin keeping its
// largest score and the row it came from.
//
// Replaces the Pallas TPU kernel recommendit_tpu/ops/pallas_mips.py:57
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
//     __brev of the 32-bit j, which orders the same). Both bodies keep a
//     running (max, j), replacing on s > max, or s == max with a smaller
//     bit-reversed j: a total order, so they keep the same row in any order;
//   * rows past the corpus in its last block (when N % bn != 0) score
//     `pad_score`: the TPU wrapper appends a bias coordinate (query 1, real
//     rows 0, pad rows -3e38 in the corpus dtype), so a pad row scores
//     exactly that number and a real row its plain dot product. Bins that
//     hold only pad rows are outputs too, as in JAX.
// Outputs are queries-major (n_q, n_blocks * bn/R): the bin's value and the
// global row id (int32; the TPU kernel returns an f32 offset instead).
//
// Two bodies:
//
// * Tensor cores (fold_split_launch, then fold_mips_bf16_launch): a bf16
//   corpus of rows up to 144 columns, bn >= 128 and bn/R in {8, 16, 32, 64}.
//   The corpus is exact in bf16, and an f32 query splits exactly into three
//   bf16 pieces: hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid)
//   (each difference is exact in f32, and three 8-bit significands cover
//   f32's 24). Every piece x row product is exact in f32, so three wgmma
//   passes into one f32 accumulator give the f32 scores up to the order of
//   the f32 additions, which is all the CUDA-core body differs in too. Two
//   pieces would leave 16 of the 24 bits: an error of up to 2^-17 of each
//   term, far from f32's 2^-24 (chip_smoke.py's fold check reads it). What bounds it: 3 x 2*Q*N*D bf16
//   operations, 0.80 ms at the fold phase's shape (Q=1024, N=1M, D=129) at
//   the 989 TFLOP/s dense bf16 peak, against ~0.26 GB of corpus: compute.
//   The design is the window kernels' (window_tc.cuh, whose helpers it
//   uses): a persistent grid with the query tile fastest; each block holds
//   128 queries (the three pieces, 108 KB at D=136) resident in shared
//   memory, one producer thread streams 128-row corpus tiles by TMA into a
//   ring (3 stages at D=136, 4 at D=128), and two consumer warpgroups (64
//   queries each) issue per k-step three m64n128k16 wgmma, hi, mid and lo
//   against the same corpus tile, into one accumulator. A block walks whole
//   corpus blocks, so each bin's running (max, j) lives in the registers of
//   one thread: accumulator register i holds tile column 8(i>>2) + 2(l%4) +
//   (i&1), and with bn/R a multiple of 8 every column of one bin has the
//   same column mod 8, so the fold needs no shuffle; a thread carries bn/R
//   registers of bins across the block's tiles and stores them, two
//   neighbouring bins per 8-byte store, at the block's end. Tiles past the
//   corpus get no load and no wgmma, only the pad score. The tie-aware
//   compare is 5 instructions a score. Left: every corpus tile is read from
//   L2 once per query tile (8 times at Q=1024, twice as often as the window
//   kernels, whose blocks hold 256 queries); at 64 bins the fold no longer
//   hides behind the other warpgroup's products (tools/fold_breakdown.py
//   times the parts).
// * CUDA cores (fold_mips_launch): everything else (an f32 corpus, wider
//   rows, small blocks, bn/R of 1-4 or 128 and more), f32 FMAs. Bound:
//   2*Q*N*D f32 multiply-adds at the f32 rate. A block owns one 64-query
//   tile and up to 64 bins of one corpus block, and walks the block's rows
//   in 64-row tiles staged in shared memory; each thread keeps a 4x4
//   register tile of scores and a running (max, j) per entry in registers,
//   so no score leaves the SM. Bins narrower than a tile (bn/R < 64) are
//   finished by one tie-aware reduction in shared memory at the end.
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

// The tensor-core body: the TMA, mbarrier and wgmma helpers of the window
// kernels' template.
#include "window_tc.cuh"

namespace fold_tc {

constexpr int kBQ = 128;        // queries per block, resident: 2 x m64
constexpr int kPieces = 3;      // hi, mid, lo
constexpr int kMaxStages = 4;   // ring stages: 4 fit at D = 128, 3 at D = 144
constexpr int kMinStages = 2;
constexpr int kBarriers = 2 * kMaxStages + 1;

struct Shape {
  int n_q, n_items, bn;
  long long n_blocks, n_cand;
  int tiles;                    // 128-row corpus tiles per block: bn / 128
  int ksteps, boxes, tail, stages;
  int tile_bytes;               // shared memory of 128 rows: a piece's tile, a stage
  int n_qtiles, per_qtile;      // grid = n_qtiles x per_qtile blocks
  float pad;
};

// Dynamic shared memory of rows of row_bytes: the alignment slack, the three
// resident query pieces (128 rows each) and as many ring stages of 128
// corpus rows as fit, at most kMaxStages. The rows are cut as in the window
// kernels (tc::smem_plan): 128-byte boxes and a 32-byte tail box.
inline int smem_plan(int row_bytes, Shape* s) {
  const int rem = row_bytes % tc::kBoxBytes;
  s->tail = rem > 0 && rem <= tc::kTailBytes;
  s->boxes = row_bytes / tc::kBoxBytes + (rem > tc::kTailBytes ? 1 : 0);
  s->tile_bytes = s->boxes * tc::kRBoxBytes + s->tail * tc::kRTailBytes;
  const int fixed = tc::kAlign + kPieces * s->tile_bytes;
  const int room = tc::kSmemLimit - kBarriers * 8 - fixed;
  s->stages = room < 0 ? 0 : room / s->tile_bytes;
  if (s->stages > kMaxStages) s->stages = kMaxStages;
  return fixed + s->stages * s->tile_bytes;
}

// (s, rj) displaces the bin's (v, vr) if larger, or equal with a smaller
// bit-reversed slab: the tournament's order. Written with & and |: the
// short-circuit form compiles to ~190 more register moves per kernel
// (tools/fold_breakdown.py's logical_take variant).
__device__ __forceinline__ void take(float s, uint32_t rj, float& v, uint32_t& vr) {
  const bool w = (s > v) | ((s == v) & (rj < vr));
  v = w ? s : v;
  vr = w ? rj : vr;
}

// Folds one m64 block's 64 x 128 scores (tile t of the corpus block) into
// this thread's bins. Register i holds query row h = (i>>1)&1 (of the
// thread's two) and tile column col = 8*jj + 2*c + e (jj = i>>2, e = i&1),
// block row f = 128*t + col: slab j = f / kOut = t*kM + jj/kG and bin
// f % kOut = 8*(jj%kG) + 2*c + e, kept at v[h][2*(jj%kG) + e]. Columns >= lim
// are rows past the corpus; kMask is false for tiles wholly inside it.
template <int kOut, bool kMask>
__device__ __forceinline__ void fold_tile(const float (&acc)[64], int c, int t, int lim,
                                          float pad, float (&v)[2][kOut / 4],
                                          uint32_t (&vr)[2][kOut / 4]) {
  constexpr int kG = kOut / 8;         // 8-column chunks in kOut columns
  constexpr int kM = tc::kBR / kOut;   // slabs of the block in one tile
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const uint32_t rj = __brev((unsigned)(t * kM + jj / kG));
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + 2 * c + e;
        const float s = !kMask || col < lim ? acc[4 * jj + 2 * h + e] : pad;
        take(s, rj, v[h][2 * (jj % kG) + e], vr[h][2 * (jj % kG) + e]);
      }
  }
}

// Grid: block x takes query tile x % n_qtiles and corpus blocks p, p +
// per_qtile, ... with p = x / n_qtiles, so the blocks that share a corpus
// block run side by side. Warps 0-7: two consumer warpgroups (queries 0-63
// and 64-127 of the tile); warps 8-11: the producer warpgroup, of which one
// thread starts the TMA copies. q_map reads the (3, n_q, d) pieces as 3*n_q
// rows.
template <int kOut>
__global__ void __launch_bounds__(tc::kThreads, 1)
fold_tc_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap r_map,
               const __grid_constant__ CUtensorMap q_tail_map,
               const __grid_constant__ CUtensorMap r_tail_map,
               float* __restrict__ vals, int32_t* __restrict__ ids, const Shape s) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kBarriers];

  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + tc::kAlign - 1) & ~uint32_t(tc::kAlign - 1);
  // piece p's 128 rows at q_s + p * tile_bytes (boxes, then the tail), then
  // the ring's stages in the same layout
  const uint32_t q_s = base;
  const uint32_t r_s = base + kPieces * s.tile_bytes;
  const uint32_t full0 = tc::smem_u32(&bars[0]);
  const uint32_t empty0 = tc::smem_u32(&bars[kMaxStages]);
  const uint32_t q_full = tc::smem_u32(&bars[2 * kMaxStages]);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qt = blockIdx.x % s.n_qtiles;
  const long long p = blockIdx.x / s.n_qtiles;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      tc::mbar_init(full0 + 8 * i, 1);
      tc::mbar_init(empty0 + 8 * i, tc::kConsumerWarps);
    }
    tc::mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if/else for the whole kernel: ptxas applies setmaxnreg only to
  // paths that never join again
  if (warp >= tc::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(tc::kProducerRegs));
    if (warp == tc::kConsumerWarps && lane == 0) {
      constexpr int kBoxCols = tc::kBoxBytes / 2;
      tc::mbar_expect_tx(q_full, kPieces * s.tile_bytes);
      for (int pc = 0; pc < kPieces; ++pc) {
        const uint32_t dst = q_s + pc * s.tile_bytes;
        const int row = pc * s.n_q + qt * kBQ;
        for (int b = 0; b < s.boxes; ++b)
          tc::tma_load_2d(dst + b * tc::kRBoxBytes, &q_map, b * kBoxCols, row, q_full);
        if (s.tail)
          tc::tma_load_2d(dst + s.boxes * tc::kRBoxBytes, &q_tail_map,
                          s.boxes * kBoxCols, row, q_full);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (long long blk = p; blk < s.n_blocks; blk += s.per_qtile) {
        for (int t = 0; t < s.tiles; ++t) {
          const long long r0 = blk * s.bn + (long long)t * tc::kBR;
          if (r0 >= s.n_items) break;
          tc::mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t dst = r_s + stage * s.tile_bytes;
          const uint32_t full = full0 + 8 * stage;
          tc::mbar_expect_tx(full, s.tile_bytes);
          for (int b = 0; b < s.boxes; ++b)
            tc::tma_load_2d(dst + b * tc::kRBoxBytes, &r_map, b * kBoxCols, (int)r0, full);
          if (s.tail)
            tc::tma_load_2d(dst + s.boxes * tc::kRBoxBytes, &r_tail_map,
                            s.boxes * kBoxCols, (int)r0, full);
          if (++stage == s.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(tc::kConsumerRegs));
    const int wg = warp / 4;
    const long long q_row = (long long)qt * kBQ + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c = lane & 3;
    const uint32_t a0 = q_s + wg * 64 * tc::kBoxBytes;   // this warpgroup's 64 rows
    const uint32_t a0_tail = q_s + s.boxes * tc::kRBoxBytes + wg * 64 * tc::kTailBytes;
    const int k_full = s.ksteps - s.tail;                 // k-steps in 128-byte boxes
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float v[2][kOut / 4];
    uint32_t vr[2][kOut / 4];

    tc::mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (long long blk = p; blk < s.n_blocks; blk += s.per_qtile) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < kOut / 4; ++b) {
          v[h][b] = -CUDART_INF_F;
          vr[h][b] = 0xffffffffu;
        }
      for (int t = 0; t < s.tiles; ++t) {
        const long long r0 = blk * s.bn + (long long)t * tc::kBR;
        if (r0 < s.n_items) {
          tc::mbar_wait(full0 + 8 * stage, phase);
          tc::fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          const uint32_t b_s = r_s + stage * s.tile_bytes;
          for (int k = 0; k < k_full; ++k) {
            const uint32_t off = (k >> 2) * tc::kRBoxBytes + (k & 3) * tc::kStepBytes;
            const uint64_t db = tc::smem_desc(b_s + off, 128);
#pragma unroll
            for (int pc = 0; pc < kPieces; ++pc)
              tc::wgmma(acc, tc::smem_desc(a0 + pc * s.tile_bytes + off, 128), db,
                        k | pc);
          }
          if (s.tail) {
            const uint64_t db = tc::smem_desc(b_s + s.boxes * tc::kRBoxBytes, 32);
#pragma unroll
            for (int pc = 0; pc < kPieces; ++pc)
              tc::wgmma(acc, tc::smem_desc(a0_tail + pc * s.tile_bytes, 32), db,
                        k_full | pc);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          tc::fence_acc(acc);
          if (lane == 0) tc::mbar_arrive(empty0 + 8 * stage);
          if (++stage == s.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        // a tile past the corpus is all pad rows: lim = 0
        const long long left = (long long)s.n_items - r0;
        const int lim = left <= 0 ? 0 : (left >= tc::kBR ? tc::kBR : (int)left);
        if (lim == tc::kBR)
          fold_tile<kOut, false>(acc, c, t, lim, s.pad, v, vr);
        else
          fold_tile<kOut, true>(acc, c, t, lim, s.pad, v, vr);
      }
      // bins 8g + 2c and 8g + 2c + 1 of each row: one 8-byte store each
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long q = q_row + 8 * h;
        if (q >= s.n_q) continue;
#pragma unroll
        for (int g = 0; g < kOut / 8; ++g) {
          const int bin = 8 * g + 2 * c;
          const long long at = q * s.n_cand + blk * kOut + bin;
          const int row = (int)(blk * s.bn) + bin;
          *reinterpret_cast<float2*>(vals + at) = make_float2(v[h][2 * g], v[h][2 * g + 1]);
          *reinterpret_cast<int2*>(ids + at) =
              make_int2(row + (int)__brev(vr[h][2 * g]) * kOut,
                        row + 1 + (int)__brev(vr[h][2 * g + 1]) * kOut);
        }
      }
    }
  }
}

// hi, mid and lo of n f32 values into pieces[0..n), [n..2n), [2n..3n).
__global__ void split_kernel(const float* __restrict__ q,
                             __nv_bfloat16* __restrict__ pieces, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float x = q[i];
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r = x - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    pieces[i] = hi;
    pieces[n + i] = mid;
    pieces[2 * n + i] = __float2bfloat16_rn(r - __bfloat162float(mid));
  }
}

template <int kOut>
int launch_out(unsigned grid, int smem, cudaStream_t stream, const CUtensorMap (&maps)[4],
               float* vals, int32_t* ids, const Shape& s) {
  auto kernel = fold_tc_kernel<kOut>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left behind for the next launch's check
    return (int)err;
  }
  kernel<<<grid, tc::kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], vals,
                                                ids, s);
  return (int)cudaGetLastError();
}

}  // namespace fold_tc

// Tensor cores, step 1: q (n, contiguous f32) into pieces (3, n) bf16 with
// hi + mid + lo == q exactly (the wrapper's scratch).
extern "C" int fold_split_launch(const float* q, void* pieces, long long n,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  fold_tc::split_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<__nv_bfloat16*>(pieces), n);
  return (int)cudaGetLastError();
}

// Tensor cores, step 2: pieces (3, n_q, d) and items (n_items, d) bf16, both
// 16-byte aligned, d a multiple of 8 whose rows leave room for
// fold_tc::kMinStages ring stages (d <= 144); bn a power of two >= 128, out
// in {8, 16, 32, 64}. Outputs and return value as fold_mips_launch's.
extern "C" int fold_mips_bf16_launch(const void* pieces, const void* items, float* vals,
                                     int32_t* ids, int n_q, int n_items, int d, int bn,
                                     int out, float pad_score, void* stream) {
  const int row_bytes = 2 * d;
  if (n_q <= 0 || n_items <= 0 || d <= 0 || d % 8 || bn < tc::kBR || (bn & (bn - 1)) ||
      out < 8 || out > 64 || (out & (out - 1)) || 3LL * n_q >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(pieces) | reinterpret_cast<uintptr_t>(items)) % 16)
    return (int)cudaErrorInvalidValue;
  fold_tc::Shape s;
  s.n_blocks = ((long long)n_items + bn - 1) / bn;
  if (s.n_blocks * bn >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int smem = fold_tc::smem_plan(row_bytes, &s);
  if (s.stages < fold_tc::kMinStages) return (int)cudaErrorInvalidValue;
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // queries (the three pieces as 3 * n_q rows), corpus, their tails
  CUtensorMap maps[4] = {};
  if (!tc::tile_map(&maps[0], encode, type, 2, pieces, 3 * n_q, row_bytes,
                    fold_tc::kBQ, tc::kBoxBytes) ||
      !tc::tile_map(&maps[1], encode, type, 2, items, n_items, row_bytes, tc::kBR,
                    tc::kBoxBytes) ||
      (s.tail && (!tc::tile_map(&maps[2], encode, type, 2, pieces, 3 * n_q, row_bytes,
                                fold_tc::kBQ, tc::kTailBytes) ||
                  !tc::tile_map(&maps[3], encode, type, 2, items, n_items, row_bytes,
                                tc::kBR, tc::kTailBytes))))
    return (int)cudaErrorInvalidValue;

  s.n_q = n_q;
  s.n_items = n_items;
  s.bn = bn;
  s.n_cand = s.n_blocks * out;
  s.tiles = bn / tc::kBR;
  s.ksteps = (row_bytes + tc::kStepBytes - 1) / tc::kStepBytes;
  s.pad = pad_score;
  s.n_qtiles = (n_q + fold_tc::kBQ - 1) / fold_tc::kBQ;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long per = sms / s.n_qtiles;
  if (per > s.n_blocks) per = s.n_blocks;
  s.per_qtile = per < 1 ? 1 : (int)per;
  const long long grid = (long long)s.n_qtiles * s.per_qtile;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  switch (out) {
    case 8: return fold_tc::launch_out<8>(g, smem, st, maps, vals, ids, s);
    case 16: return fold_tc::launch_out<16>(g, smem, st, maps, vals, ids, s);
    case 32: return fold_tc::launch_out<32>(g, smem, st, maps, vals, ids, s);
    default: return fold_tc::launch_out<64>(g, smem, st, maps, vals, ids, s);
  }
}
