// Per-row int8 quantization with a counter-hash stochastic floor, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel recommendit_tpu/ops/quantize.py
// ::_quantize_kernel (wrapper quantize_int8_pallas), and computes what its
// code computes (not what its docstring says):
//   scale  = max(absmax(row), 1e-12) * float32(1/127)   (XLA folds the /127)
//   idx    = row * D + col, uint32 with wraparound, over the unpadded rows
//   h      = idx ^ (seed * 0x9E3779B9), then two xorshift-multiply rounds
//   u      = (h >> 8) * 2^-24
//   out    = int8(clip(floor(x / scale + u), -127, 127))
// with IEEE division and no contraction, so the result equals the JAX
// interpreter's bit for bit and does not depend on how rows are blocked.
//
// What bounds it on an H100: it reads 4 bytes and writes 1 per element
// (1M x 129: 0.52 GB in, 0.13 GB out) and does a few integer operations per
// element, so it is bound by device memory. One warp owns one row: its lanes
// stride the row (neighbouring lanes, neighbouring addresses), reduce the
// absmax by shuffles, then quantise the row from L1/L2 on the second pass.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t seed_mix) {
  uint32_t h = idx ^ seed_mix;
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

__global__ void __launch_bounds__(kThreads)
quantize_i8_kernel(const float* __restrict__ x, int8_t* __restrict__ out,
                   float* __restrict__ scales, int n, int d, uint32_t seed) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const float* xr = x + row * d;
  int8_t* orow = out + row * d;

  float amax = 0.f;
  for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(xr[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
  if (lane == 0) scales[row] = scale;

  const uint32_t seed_mix = seed * 0x9E3779B9u;
  const uint32_t base = (uint32_t)row * (uint32_t)d;
  for (int c = lane; c < d; c += 32) {
    const uint32_t h = hash_bits(base + (uint32_t)c, seed_mix);
    const float u = __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
    float v = floorf(__fadd_rn(__fdiv_rn(xr[c], scale), u));
    v = fminf(fmaxf(v, -127.f), 127.f);
    orow[c] = (int8_t)__float2int_rn(v);
  }
}

}  // namespace

// C entry, bound with ctypes. x: (n, d) f32; out: (n, d) int8; scales: (n,)
// f32; all contiguous on the device of `stream`. `seed` is the int32 seed's
// bits. Launches on `stream`, allocates nothing, does not synchronise;
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quantize_i8_launch(const float* x, int8_t* out, float* scales,
                                  int n, int d, uint32_t seed, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  quantize_i8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, scales, n, d, seed);
  return (int)cudaGetLastError();
}
