// In-batch BPR loss for Hopper (sm_90a): the forward row losses and the
// closed-form backward, with s = U V^T computed inside the kernels.
//
// Replaces the Pallas TPU kernels recommendit_tpu/ops/bpr.py
// ::_bpr_row_loss_kernel (forward) and ::_bpr_bwd_kernel (backward), joined
// there by the custom VJP in_batch_bpr_pallas. With s_ij = u_i . v_j and
// the diagonal as the positives:
//
//   forward   row_loss_i = sum_{j != i} softplus(s_ij - s_ii) / (B - 1)
//   backward  w_ij = sigmoid(s_ij - s_ii) for j != i, 0 on the diagonal,
//             r_i  = sum_j w_ij
//             du_i = (sum_j w_ij v_j - r_i v_i) * g / (B (B - 1))
//             dv_j = (sum_i w_ij u_i - r_j u_j) * g / (B (B - 1))
//
// The mean over the rows runs outside, as in JAX. The (B, B) score matrix
// never reaches device memory.
//
// What bounds it on an H100: at the trainer's shape (B=1024, D=64, f32) a
// score pass is 2*B*B*D = 134 MFLOP against 0.5 MB of operands that stay in
// L2; the backward adds W V and W^T U, 268 MFLOP more. At the f32 rate of
// the CUDA cores (67 TFLOP/s) that is 2 and 6 us; nothing in device memory
// is large. So the time goes to how much of the card is busy and to latency:
// the first port ran one block of 128 threads per 16 rows (64 blocks on 132
// SMs), scalar FMAs, and in the backward the scores twice (a row pass for
// du and a column pass for dv).
//
// This design:
// * A 2-D grid of 64 x 64 tiles of (U rows i) x (V rows j): 256 blocks of 4
//   warps at B=1024. A block stages both tiles in shared memory with
//   cp.async (the K tail of d, a multiple of 4, zero-filled up to 8); for a
//   large B each block walks several tiles, so the scratch stays bounded
//   (at most kMaxSlices partials per row).
// * The products run on the tensor cores: mma.sync m16n8k8 TF32 with the
//   3xTF32 split (x = hi + lo, both TF32; a.b = a_hi b_hi + a_hi b_lo +
//   a_lo b_hi, f32 accumulation), which keeps f32's accuracy. Plain TF32
//   keeps about three digits: too few for the loss (1e-5 relative of the
//   f32 twin) and the gradients (1e-4 of their largest entry).
// * Each warp owns 16 rows of S. The epilogue runs in registers: softplus
//   (forward) or W = sigmoid(S - s_ii) (backward), masked on the diagonal
//   and past B; per-row partial sums go to a (slices, B) scratch.
// * The backward computes S once per tile. W V runs from the accumulator
//   fragments as the A operand (a permutation of k inside each k8 step maps
//   the C layout onto the A layout); W^T U runs from W transposed through
//   shared memory. Both partials go to scratch.
// * A finishing launch sums the partials in a fixed order, subtracts r_i v_i
//   and r_j u_j and scales by g / (B (B - 1)) (g stays on the device); the
//   forward's sums the row partials and divides by B - 1. No float atomics:
//   the same inputs give bit-identical outputs on every call.
// * s_ii, each row's own dot, is taken in f32 FMAs from device memory while
//   the tiles load; the diagonal entry of S itself is masked.
//
// What bounds this design is latency: with two blocks of 4 warps on an SM,
// each block's chain (the tile loads, s_ii, the products, the softplus or
// sigmoid epilogue, the partial stores) is exposed, and the finishing
// launch adds its own; the tensor pipe is far from full.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // U rows and V rows of a tile
constexpr int kWarps = 4;                 // each owns 16 rows of the tile
constexpr int kThreads = 32 * kWarps;
constexpr int kNt = kTile / 8;            // 8-wide n-tiles across a tile
constexpr int kWs = kTile + 4;            // row stride of the W tile
constexpr int kMaxSlices = 16;            // partials per row, at most
constexpr int kMaxDim = 256;
constexpr int kFinishThreads = 256;

static_assert(kWarps * 16 == kTile, "a warp owns 16 rows");

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // jax.nn.softplus
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// x = hi + lo, hi rounded to TF32 (half an ulp up, then truncated: two
// integer operations instead of cvt.rna's conversion pipe) and lo = x - hi,
// exact in f32, whose low 13 bits the TF32 mma ignores (a truncation of lo:
// each product keeps about 20 bits, CUTLASS's 3xTF32 rounding)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b at f32 accuracy: the two small cross terms, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;                      // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(n));
}

struct Layout {
  int n_t;      // tiles along B
  int slices;   // partials per row: the grid is slices x slices blocks
  int bp;       // B padded to whole tiles: the rows of each partial
};

__host__ __device__ inline Layout layout_of(int b) {
  Layout l;
  l.n_t = (b + kTile - 1) / kTile;
  l.slices = l.n_t < kMaxSlices ? l.n_t : kMaxSlices;
  l.bp = l.n_t * kTile;
  return l;
}

__host__ __device__ inline int padded_dim(int d) { return (d + 7) & ~7; }

// Bytes of dynamic shared memory: the U and V tiles, the W tile
// (backward), the diagonal.
inline size_t smem_bytes(int d, bool bwd) {
  const int ld = padded_dim(d) + 4;
  return sizeof(float) * ((size_t)2 * kTile * ld + (bwd ? kTile * kWs : 0) + kTile);
}

// acc[nf] += A B for the 8 feature n-tiles from column f0: A's k-step kk
// in (ah, al), B's rows t and t+4 the staged rows kk*8 + 2t and + 1 of `bs`
// (the k order within a step is free, so A's columns follow the same map)
__device__ __forceinline__ void mma_rows(float (&acc)[kNt][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* bs,
                                         int ld, int kk, int f0, int d8, int gr,
                                         int tg) {
#pragma unroll
  for (int nf = 0; nf < kNt; ++nf) {
    if (f0 + nf * 8 < d8) {
      const float* pb = bs + (kk * 8 + 2 * tg) * ld + f0 + nf * 8 + gr;
      uint32_t bh[2], bl[2];
      split(pb[0], bh[0], bl[0]);
      split(pb[ld], bh[1], bl[1]);
      mma_3xtf32(acc[nf], ah, al, bh, bl);
    }
  }
}

// rows[r][f] (+)= acc for this warp's 16 rows and the columns from f0 below
// d: written on a block's first tile of the slot, added to afterwards
__device__ __forceinline__ void add_partial(float* rows, const float (&acc)[kNt][4],
                                            int row0, int gr, int tg, int f0,
                                            int d, bool first) {
#pragma unroll
  for (int nf = 0; nf < kNt; ++nf) {
    const int f = f0 + nf * 8 + 2 * tg;
    if (f >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* p = reinterpret_cast<float2*>(rows + (size_t)(row0 + gr + 8 * h) * d + f);
      float2 x = make_float2(acc[nf][2 * h], acc[nf][2 * h + 1]);
      if (!first) {
        const float2 old = *p;
        x = make_float2(old.x + x.x, old.y + x.y);
      }
      *p = x;
    }
  }
}

// Block (x, y) takes the tiles (it, jt) with it = y mod slices, jt = x mod
// slices. Per tile: the row-sum partials into rs_part[x] (and, backward,
// W V into du_part[x] and W^T U into dv_part[y]), added to what the block
// wrote there for its earlier tiles.
template <bool kBwd>
__device__ __forceinline__ void tiles(const float* __restrict__ u,
                                      const float* __restrict__ v, int b, int d,
                                      float* __restrict__ rs_part,
                                      float* __restrict__ du_part,
                                      float* __restrict__ dv_part) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout_of(b);
  const int d8 = padded_dim(d);
  const int ld = d8 + 4;                    // ld/4 odd: conflict-free fragments
  float* us = smem;                         // [kTile][ld]
  float* vs = us + kTile * ld;              // [kTile][ld]
  float* ws = vs + kTile * ld;              // [kTile][kWs], backward
  float* diag = ws + (kBwd ? kTile * kWs : 0);   // [kTile]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;                  // mma groupID
  const int tg = lane % 4;                  // mma threadID_in_group
  const int row0 = warp * 16;               // this warp's rows of the tile
  const int c4 = d8 / 4;                    // 16-byte chunks of a staged row

  for (int it = blockIdx.y; it < lay.n_t; it += gridDim.y) {
    const int i0 = it * kTile;
    for (int jt = blockIdx.x; jt < lay.n_t; jt += gridDim.x) {
      const int j0 = jt * kTile;
      const bool first_j = jt == (int)blockIdx.x;   // first tile of rs/du slots
      __syncthreads();                              // the last tile is read

      for (int e = tid; e < kTile * c4; e += kThreads) {
        const int r = e / c4;
        const int c = e % c4;
        const bool in_k = 4 * c < d;
        const bool ok_u = in_k && i0 + r < b;
        const bool ok_v = in_k && j0 + r < b;
        cp_async16(us + r * ld + 4 * c, ok_u ? u + (size_t)(i0 + r) * d + 4 * c : u, ok_u);
        cp_async16(vs + r * ld + 4 * c, ok_v ? v + (size_t)(j0 + r) * d + 4 * c : v, ok_v);
      }
      asm volatile("cp.async.commit_group;\n" ::);

      {  // s_ii while the tiles load: two threads a row, f32 FMAs
        const int r = tid / 2;
        const int h = tid % 2;
        float acc = 0.f;
        if (i0 + r < b) {
          const float4* ur = reinterpret_cast<const float4*>(u + (size_t)(i0 + r) * d);
          const float4* vr = reinterpret_cast<const float4*>(v + (size_t)(i0 + r) * d);
#pragma unroll 4
          for (int k4 = h; k4 < d / 4; k4 += 2) {
            const float4 a = ur[k4];
            const float4 c = vr[k4];
            acc = fmaf(a.x, c.x, acc);
            acc = fmaf(a.y, c.y, acc);
            acc = fmaf(a.z, c.z, acc);
            acc = fmaf(a.w, c.w, acc);
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (h == 0) diag[r] = acc;
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();

      // S = U_i V_j^T: this warp's 16 rows x 64 columns, kNt n-tiles
      float s[kNt][4] = {};
      for (int k0 = 0; k0 < d8; k0 += 8) {
        const float* pa = us + (row0 + gr) * ld + k0 + tg;
        uint32_t ah[4], al[4];
        split(pa[0], ah[0], al[0]);
        split(pa[8 * ld], ah[1], al[1]);
        split(pa[4], ah[2], al[2]);
        split(pa[8 * ld + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const float* pb = vs + (nt * 8 + gr) * ld + k0 + tg;
          uint32_t bh[2], bl[2];
          split(pb[0], bh[0], bl[0]);
          split(pb[4], bh[1], bl[1]);
          mma_3xtf32(s[nt], ah, al, bh, bl);
        }
      }

      // the epilogue: element e of n-tile nt is (row0 + gr + 8 (e / 2),
      // nt * 8 + 2 tg + e % 2)
      const float pos[2] = {diag[row0 + gr], diag[row0 + gr + 8]};
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gi = i0 + row0 + gr + 8 * (e / 2);
          const int gj = j0 + nt * 8 + 2 * tg + e % 2;
          const bool valid = gi < b && gj < b && gi != gj;
          const float x = s[nt][e] - pos[e / 2];
          const float y = valid ? (kBwd ? sigmoid(x) : softplus(x)) : 0.f;
          rs[e / 2] += y;
          s[nt][e] = y;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // the 4 threads of a row: lanes 4gr..4gr+3
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      }
      if (tg == 0) {
        float* p = rs_part + (size_t)blockIdx.x * lay.bp + i0 + row0 + gr;
        p[0] = first_j ? rs[0] : p[0] + rs[0];
        p[8] = first_j ? rs[1] : p[8] + rs[1];
      }
      if constexpr (kBwd) {
        // W to shared memory for W^T U: ws[i][j]
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = nt * 8 + 2 * tg;
          *reinterpret_cast<float2*>(ws + (row0 + gr) * kWs + col) =
              make_float2(s[nt][0], s[nt][1]);
          *reinterpret_cast<float2*>(ws + (row0 + gr + 8) * kWs + col) =
              make_float2(s[nt][2], s[nt][3]);
        }

        // W V from the accumulators. In k-step kk the A operand's column t
        // is j = kk*8 + 2t and column t+4 is j = kk*8 + 2t + 1 (the C
        // layout), so B's row t is V_j for j = kk*8 + 2t, row t+4 for 2t + 1.
        float* du_rows = du_part + ((size_t)blockIdx.x * lay.bp + i0) * d;
        for (int f0 = 0; f0 < d8; f0 += kTile) {
          float acc[kNt][4] = {};
#pragma unroll
          for (int kk = 0; kk < kNt; ++kk) {
            uint32_t ah[4], al[4];
            split(s[kk][0], ah[0], al[0]);
            split(s[kk][2], ah[1], al[1]);
            split(s[kk][1], ah[2], al[2]);
            split(s[kk][3], ah[3], al[3]);
            mma_rows(acc, ah, al, vs, ld, kk, f0, d8, gr, tg);
          }
          add_partial(du_rows, acc, row0, gr, tg, f0, d, first_j);
        }
        __syncthreads();   // the W tile is whole

        // W^T U: this warp's 16 rows are j = row0 .. row0 + 15; in k-step kk
        // column t is i = kk*8 + 2t, column t+4 is i = kk*8 + 2t + 1; the
        // block's first i-tile writes the dv slots
        float* dv_rows = dv_part + ((size_t)blockIdx.y * lay.bp + j0) * d;
        for (int f0 = 0; f0 < d8; f0 += kTile) {
          float acc[kNt][4] = {};
#pragma unroll
          for (int kk = 0; kk < kNt; ++kk) {
            const float* pa = ws + (kk * 8 + 2 * tg) * kWs + row0 + gr;
            uint32_t ah[4], al[4];
            split(pa[0], ah[0], al[0]);
            split(pa[8], ah[1], al[1]);
            split(pa[kWs], ah[2], al[2]);
            split(pa[kWs + 8], ah[3], al[3]);
            mma_rows(acc, ah, al, us, ld, kk, f0, d8, gr, tg);
          }
          add_partial(dv_rows, acc, row0, gr, tg, f0, d, it == (int)blockIdx.y);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bpr_fwd_tile_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    int b, int d, float* __restrict__ rs_part) {
  tiles<false>(u, v, b, d, rs_part, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads)
bpr_bwd_tile_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    int b, int d, float* __restrict__ rs_part,
                    float* __restrict__ du_part, float* __restrict__ dv_part) {
  tiles<true>(u, v, b, d, rs_part, du_part, dv_part);
}

// row_loss_i = sum over the slices of rs_part[., i], in slice order, / (B-1)
__global__ void __launch_bounds__(kFinishThreads)
bpr_fwd_finish_kernel(const float* __restrict__ rs_part, int b,
                      float* __restrict__ row_loss) {
  const Layout lay = layout_of(b);
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= b) return;
  float acc = 0.f;
  for (int k = 0; k < lay.slices; ++k) acc += rs_part[(size_t)k * lay.bp + i];
  row_loss[i] = acc / (float)(b - 1);
}

// du (the first b*d/4 float4s) and dv (the rest): the slices' partials in
// slice order, minus r times the row's own item (du) or user (dv) row,
// times g / (B (B - 1))
__global__ void __launch_bounds__(kFinishThreads)
bpr_bwd_finish_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ g,
                      const float* __restrict__ rs_part,
                      const float* __restrict__ du_part,
                      const float* __restrict__ dv_part, int b, int d,
                      float* __restrict__ du, float* __restrict__ dv) {
  const Layout lay = layout_of(b);
  const int d4 = d / 4;
  const size_t n = (size_t)b * d4;
  const float scale = g[0] / (float)((double)b * (double)(b - 1));
  for (size_t e = (size_t)blockIdx.x * kFinishThreads + threadIdx.x; e < 2 * n;
       e += (size_t)gridDim.x * kFinishThreads) {
    const bool is_dv = e >= n;
    const size_t e2 = is_dv ? e - n : e;
    const int r = (int)(e2 / d4);
    const int c = (int)(e2 % d4);
    const float* part = is_dv ? dv_part : du_part;
    float r_sum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < lay.slices; ++k) {
      r_sum += rs_part[(size_t)k * lay.bp + r];
      const float4 p = *reinterpret_cast<const float4*>(
          part + ((size_t)k * lay.bp + r) * d + 4 * c);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    const float4 own = *reinterpret_cast<const float4*>(
        (is_dv ? u : v) + (size_t)r * d + 4 * c);
    float4 o;
    o.x = (acc.x - r_sum * own.x) * scale;
    o.y = (acc.y - r_sum * own.y) * scale;
    o.z = (acc.z - r_sum * own.z) * scale;
    o.w = (acc.w - r_sum * own.w) * scale;
    *reinterpret_cast<float4*>((is_dv ? dv : du) + (size_t)r * d + 4 * c) = o;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_shape(int b, int d) {
  return b < 2 || d <= 0 || d % 4 != 0 || d > kMaxDim;
}

}  // namespace

// C entries, bound with ctypes. All pointers are contiguous f32 device
// memory on the device of `stream`, 16-byte aligned; u, v are (b, d) with
// 2 <= b, 4 | d, d <= 256. They launch on `stream`, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launches (0 =
// launched).

// Floats of the scratch that bpr_forward_launch (backward = 0) or
// bpr_backward_launch (backward = 1) needs at (b, d); -1 for a bad shape.
extern "C" long long bpr_scratch_floats(int b, int d, int backward) {
  if (bad_shape(b, d)) return -1;
  const Layout lay = layout_of(b);
  const long long part = (long long)lay.slices * lay.bp;
  return part + (backward ? 2 * part * d : 0);
}

// row_loss (b,): sum_{j != i} softplus(s_ij - s_ii) / (b - 1).
extern "C" int bpr_forward_launch(const float* u, const float* v,
                                  float* row_loss, float* scratch, int b, int d,
                                  void* stream) {
  if (bad_shape(b, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(b);
  const size_t bytes = smem_bytes(d, false);
  cudaError_t err = allow_smem(bpr_fwd_tile_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  bpr_fwd_tile_kernel<<<dim3(lay.slices, lay.slices), kThreads, bytes, s>>>(
      u, v, b, d, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bpr_fwd_finish_kernel<<<(b + kFinishThreads - 1) / kFinishThreads,
                          kFinishThreads, 0, s>>>(scratch, b, row_loss);
  return (int)cudaGetLastError();
}

// du, dv (b, d) for the upstream gradient g (one float on the device);
// scratch holds bpr_scratch_floats(b, d, 1) floats: the row-sum, W V and
// W^T U partials.
extern "C" int bpr_backward_launch(const float* u, const float* v,
                                   const float* g, float* du, float* dv,
                                   float* scratch, int b, int d, void* stream) {
  if (bad_shape(b, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(b);
  const size_t part = (size_t)lay.slices * lay.bp;
  float* rs_part = scratch;
  float* du_part = rs_part + part;
  float* dv_part = du_part + part * d;
  const size_t bytes = smem_bytes(d, true);
  cudaError_t err = allow_smem(bpr_bwd_tile_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  bpr_bwd_tile_kernel<<<dim3(lay.slices, lay.slices), kThreads, bytes, s>>>(
      u, v, b, d, rs_part, du_part, dv_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = 2 * (size_t)b * (d / 4);
  const size_t blocks = (n + kFinishThreads - 1) / kFinishThreads;
  bpr_bwd_finish_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                          kFinishThreads, 0, s>>>(u, v, g, rs_part, du_part,
                                                  dv_part, b, d, du, dv);
  return (int)cudaGetLastError();
}
