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
// What bounds it on an H100: at the trainer's shape (B=1024, D=64, f32)
// each pass is 2*B*B*D = 134 MFLOP of score products (the backward passes
// twice that, with the weighted sums) against 0.5 MB of operands that stay
// in L2, so the work is compute and latency, not bytes; one exp (and a log1p
// in the forward) per score is the other cost. This first version runs the
// products on the CUDA cores in f32 FMAs, in the same order for every
// score, so the diagonal s_ii (a separate row dot u_i . v_i taken first)
// equals the tile's s_ii bit for bit and the forward and both backward
// passes see the same s_ij. Tensor cores, TMA and wgmma are later work.
//
// Design, against the TPU kernels:
// * A block owns kRows rows of one operand and streams the other in tiles
//   of kCols rows through shared memory (the Pallas kernels keep all of V
//   in VMEM: 256 KB at B=1024, D=64, more than a block's 227 KB). Each
//   row's running sum stays in registers; the 16 threads of a row reduce
//   it with warp shuffles at the end.
// * The TPU backward accumulates dv across a sequential grid. A GPU grid has
//   no order, so the backward is two deterministic passes and no atomics:
//   the row pass gives du, the diagonal and the row sums r_i; the column
//   pass, launched after it on the same stream, gives dv from them.
// * Any B >= 2: out-of-range rows load as zeros and out-of-range columns are
//   masked (JAX falls back to XLA when B is not a block multiple).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;             // block-operand rows per block
constexpr int kCols = 64;             // streamed rows per tile
constexpr int kTy = 8;                // threads along the block's rows
constexpr int kTx = 16;               // threads along a tile / the features
constexpr int kThreads = kTy * kTx;   // 128
constexpr int kMr = kRows / kTy;      // 2 rows per thread
constexpr int kMc = kCols / kTx;      // 4 tile columns per thread
constexpr int kGroup = 4 * kTx;       // 64 features per group, a float4 each
constexpr int kMaxGroups = 4;         // D <= 256
constexpr int kWStride = kRows + 1;   // padded row of the weight tile

static_assert(kMr == 2, "the score loop reads the block rows as a float2");
static_assert(kMc == 4, "the score loop reads the tile columns as a float4");

enum Pass { kForward = 0, kRowPass = 1, kColPass = 2 };

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // jax.nn.softplus
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Floats of dynamic shared memory a pass needs at feature width d.
__host__ __device__ inline int smem_floats(int pass, int d, int groups) {
  int n = d * kRows + d * kCols + kRows + kCols;
  if (pass != kForward) n += kCols * (groups * kGroup + 4) + kCols * kWStride;
  return n;
}

// One kernel for the three passes. `a` is the block operand (its rows are
// the output rows), `s` the streamed one:
//   kForward: a = U, s = V; out = row losses (B,)
//   kRowPass: a = U, s = V; out = du (B, D); writes diag (B,), rowsum (B,)
//   kColPass: a = V, s = U; out = dv (B, D); reads diag, rowsum
template <int kPass, int kGroups>
__global__ void __launch_bounds__(kThreads)
bpr_kernel(const float* __restrict__ a, const float* __restrict__ s, int b,
           int d, float* __restrict__ out, float* __restrict__ diag,
           float* __restrict__ rowsum, const float* __restrict__ g) {
  constexpr bool kBwd = kPass != kForward;
  constexpr int kDg = kGroups * kGroup;      // padded width of s_r
  constexpr int kSr = kDg + 4;               // s_r row stride (bank skew)
  extern __shared__ __align__(16) float smem[];
  float* a_t = smem;                         // [d][kRows], k-major
  float* s_t = a_t + d * kRows;              // [d][kCols], k-major
  float* s_r = s_t + d * kCols;              // [kCols][kSr], row-major
  float* w_t = s_r + (kBwd ? kCols * kSr : 0);       // [kCols][kWStride]
  float* diag_r = w_t + (kBwd ? kCols * kWStride : 0);  // [kRows]
  float* diag_c = diag_r + kRows;                        // [kCols]

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int r0 = blockIdx.x * kRows;
  const int d4 = d / 4;

  // the block's rows, k-major; rows past B are zeros
  for (int e = tid; e < kRows * d4; e += kThreads) {
    const int r = e % kRows;
    const int k4 = e / kRows;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < b)
      x = *reinterpret_cast<const float4*>(a + (size_t)(r0 + r) * d + 4 * k4);
    a_t[(4 * k4 + 0) * kRows + r] = x.x;
    a_t[(4 * k4 + 1) * kRows + r] = x.y;
    a_t[(4 * k4 + 2) * kRows + r] = x.z;
    a_t[(4 * k4 + 3) * kRows + r] = x.w;
  }
  if (kBwd) {  // the feature padding of s_r is read but never stored: zero it
    for (int e = tid; e < kCols * (kSr - d); e += kThreads)
      s_r[(e / (kSr - d)) * kSr + d + e % (kSr - d)] = 0.f;
  }
  __syncthreads();
  if (kPass != kColPass && tid < kRows) {
    // s_ii in the tile's order: one FMA chain over k = 0 .. d-1
    const int r = r0 + tid;
    float acc = 0.f;
    if (r < b)
      for (int k = 0; k < d; ++k)
        acc = fmaf(a_t[k * kRows + tid], s[(size_t)r * d + k], acc);
    diag_r[tid] = acc;
    if (kPass == kRowPass && r < b) diag[r] = acc;
  }

  float rs[kMr] = {0.f, 0.f};                 // row sums (forward, row pass)
  float acc2[kGroups][kMr][4];                // weighted sums (backward)
  if (kBwd) {
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int i = 0; i < kMr; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[gi][i][j] = 0.f;
  }

  for (int c0 = 0; c0 < b; c0 += kCols) {
    // the streamed tile: k-major for the scores, row-major for the sums
    for (int e = tid; e < kCols * d4; e += kThreads) {
      const int c = e % kCols;
      const int k4 = e / kCols;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < b)
        x = *reinterpret_cast<const float4*>(s + (size_t)(c0 + c) * d + 4 * k4);
      s_t[(4 * k4 + 0) * kCols + c] = x.x;
      s_t[(4 * k4 + 1) * kCols + c] = x.y;
      s_t[(4 * k4 + 2) * kCols + c] = x.z;
      s_t[(4 * k4 + 3) * kCols + c] = x.w;
      if (kBwd) *reinterpret_cast<float4*>(&s_r[c * kSr + 4 * k4]) = x;
    }
    if (kPass == kColPass && tid < kCols)
      diag_c[tid] = c0 + tid < b ? diag[c0 + tid] : 0.f;
    __syncthreads();

    float acc[kMr][kMc];
#pragma unroll
    for (int i = 0; i < kMr; ++i)
#pragma unroll
      for (int j = 0; j < kMc; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float2 av = *reinterpret_cast<const float2*>(&a_t[k * kRows + ty * kMr]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_t[k * kCols + tx * kMc]);
      const float ai[kMr] = {av.x, av.y};
      const float bj[kMc] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kMr; ++i)
#pragma unroll
        for (int j = 0; j < kMc; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kMr; ++i) {
      const int lr = ty * kMr + i;
      const int gr = r0 + lr;
#pragma unroll
      for (int j = 0; j < kMc; ++j) {
        const int lc = tx * kMc + j;
        const int gc = c0 + lc;
        const bool valid = gc < b && gc != gr;
        if (kPass == kForward) {
          rs[i] += valid ? softplus(acc[i][j] - diag_r[lr]) : 0.f;
        } else {
          // row pass: w_{gr,gc}; column pass: w_{gc,gr} (gc is the row i)
          const float pos = kPass == kRowPass ? diag_r[lr] : diag_c[lc];
          const float w = valid ? sigmoid(acc[i][j] - pos) : 0.f;
          if (kPass == kRowPass) rs[i] += w;
          w_t[lc * kWStride + lr] = w;
        }
      }
    }

    if (kBwd) {
      __syncthreads();
      const int n_c = min(kCols, b - c0);
      for (int c = 0; c < n_c; ++c) {
        const float w0 = w_t[c * kWStride + ty * kMr];
        const float w1 = w_t[c * kWStride + ty * kMr + 1];
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          const float4 v = *reinterpret_cast<const float4*>(
              &s_r[c * kSr + gi * kGroup + tx * 4]);
          acc2[gi][0][0] = fmaf(w0, v.x, acc2[gi][0][0]);
          acc2[gi][0][1] = fmaf(w0, v.y, acc2[gi][0][1]);
          acc2[gi][0][2] = fmaf(w0, v.z, acc2[gi][0][2]);
          acc2[gi][0][3] = fmaf(w0, v.w, acc2[gi][0][3]);
          acc2[gi][1][0] = fmaf(w1, v.x, acc2[gi][1][0]);
          acc2[gi][1][1] = fmaf(w1, v.y, acc2[gi][1][1]);
          acc2[gi][1][2] = fmaf(w1, v.z, acc2[gi][1][2]);
          acc2[gi][1][3] = fmaf(w1, v.w, acc2[gi][1][3]);
        }
      }
    }
    __syncthreads();   // the next tile overwrites s_t, s_r, w_t
  }

  if (kPass != kColPass) {
    // the 16 threads of a row are 16 consecutive lanes: butterfly over them,
    // after which every one of them holds the row's total
#pragma unroll
    for (int i = 0; i < kMr; ++i)
#pragma unroll
      for (int off = kTx / 2; off > 0; off /= 2)
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
  }

  if (kPass == kForward) {
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < kMr; ++i) {
        const int gr = r0 + ty * kMr + i;
        if (gr < b) out[gr] = rs[i] / (float)(b - 1);
      }
    }
    return;
  }

  // out_r = (sum_c w_rc s_c - r_r s_r) * g / (B (B - 1)), s_r being the
  // streamed operand's row with the block row's index
  const float scale = g[0] / (float)((double)b * (double)(b - 1));
#pragma unroll
  for (int i = 0; i < kMr; ++i) {
    const int gr = r0 + ty * kMr + i;
    if (gr >= b) continue;
    float r_sum;
    if (kPass == kRowPass) {
      r_sum = rs[i];
      if (tx == 0) rowsum[gr] = r_sum;
    } else {
      r_sum = rowsum[gr];
    }
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int f = gi * kGroup + tx * 4;
      if (f >= d) continue;
      const float4 own = *reinterpret_cast<const float4*>(s + (size_t)gr * d + f);
      float4 o;
      o.x = (acc2[gi][i][0] - r_sum * own.x) * scale;
      o.y = (acc2[gi][i][1] - r_sum * own.y) * scale;
      o.z = (acc2[gi][i][2] - r_sum * own.z) * scale;
      o.w = (acc2[gi][i][3] - r_sum * own.w) * scale;
      *reinterpret_cast<float4*>(out + (size_t)gr * d + f) = o;
    }
  }
}

template <int kPass, int kGroups>
cudaError_t launch_pass(const float* a, const float* s, int b, int d,
                        float* out, float* diag, float* rowsum, const float* g,
                        cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(kPass, d, kGroups);
  auto kernel = bpr_kernel<kPass, kGroups>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b + kRows - 1) / kRows));
  kernel<<<grid, kThreads, bytes, stream>>>(a, s, b, d, out, diag, rowsum, g);
  return cudaGetLastError();
}

template <int kPass>
cudaError_t launch_groups(const float* a, const float* s, int b, int d,
                          float* out, float* diag, float* rowsum,
                          const float* g, cudaStream_t stream) {
  switch ((d + kGroup - 1) / kGroup) {
    case 1: return launch_pass<kPass, 1>(a, s, b, d, out, diag, rowsum, g, stream);
    case 2: return launch_pass<kPass, 2>(a, s, b, d, out, diag, rowsum, g, stream);
    case 3: return launch_pass<kPass, 3>(a, s, b, d, out, diag, rowsum, g, stream);
    case 4: return launch_pass<kPass, 4>(a, s, b, d, out, diag, rowsum, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int b, int d) {
  return b < 2 || d <= 0 || d % 4 != 0 || d > kMaxGroups * kGroup;
}

}  // namespace

// C entries, bound with ctypes. All pointers are contiguous f32 device
// memory on the device of `stream`, 16-byte aligned; u, v are (b, d) with
// 2 <= b, 4 | d, d <= 256. They launch on `stream`, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launches (0 =
// launched).

// row_loss (b,): sum_{j != i} softplus(s_ij - s_ii) / (b - 1).
extern "C" int bpr_forward_launch(const float* u, const float* v,
                                  float* row_loss, int b, int d,
                                  void* stream) {
  if (bad_shape(b, d)) return (int)cudaErrorInvalidValue;
  // the forward reads d-wide tiles only: its group count is irrelevant
  return (int)launch_pass<kForward, 1>(u, v, b, d, row_loss, nullptr, nullptr,
                                       nullptr, static_cast<cudaStream_t>(stream));
}

// du, dv (b, d) for the upstream gradient g (one float on the device);
// diag and rowsum are (b,) scratch written by the row pass and read by the
// column pass.
extern "C" int bpr_backward_launch(const float* u, const float* v,
                                   const float* g, float* du, float* dv,
                                   float* diag, float* rowsum, int b, int d,
                                   void* stream) {
  if (bad_shape(b, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_groups<kRowPass>(u, v, b, d, du, diag, rowsum, g, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_groups<kColPass>(v, u, b, d, dv, diag, rowsum, g, s);
}
