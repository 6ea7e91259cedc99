// AdamW's update with global-norm clipping's scale, in one pass over each
// element, for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX leaves optax's update to XLA, which fuses it
// into one loop over each (donated) buffer. The port's plain version is
// OptaxAdamW's foreach path (recommendit_tpu_torch/training/
// train_embeddings.py::_adamw_update, after clip_ of the same module): 16
// torch._foreach_* passes, plus two for the clip's scale, each reading and
// writing whole lists of tensors, about 176 bytes an element. This kernel
// computes the same numbers in one pass, per element:
//
//   g <- (g / d) * c                      the clip's two device scalars
//   m <- m * b1 + g * (1 - b1)
//   v <- v * b2 + (g * g) * (1 - b2)
//   u <- (m * (1 / bc1)) / (sqrt(v * (1 / bc2)) + eps)
//   u <- u + p * wd                        decayed params only
//   p <- p + u * (-lr)
//
// each operation rounded once in f32 as the foreach op rounds it on the
// card: the __f*_rn intrinsics forbid FMA contraction; the divisions by a
// tensor (the clip's d, the denominator) are true, correctly rounded
// divisions, as the foreach ops' std::divides is; a foreach division by a
// host scalar (the bias corrections bc1, bc2) is a multiply by its f32
// reciprocal on the card, and so it is here (1 / bc rounded to f32 on the
// host). tests/test_torch_adamw_fused.py pins each of these roundings. So
// the result is bit-equal to the foreach path. The gradients are read only;
// the clip's scale lives in registers.
//
// What bounds it on an H100: it does ~20 f32 operations an element against
// 28 bytes (p, g, m, v read; p, m, v written), so the bytes do: at one
// rank of web100m (3.53 G elements) 98.8 GB, 29.5 ms at 3.35 TB/s. The
// design streams: 16-byte vectors (float4) loaded and stored with the
// streaming cache hints (__ldcs / __stcs: no element is touched twice),
// two vectors of each of the four tensors in flight a thread, a grid of
// the card's resident blocks walking every segment grid-stride with 64-bit
// offsets (one table shard alone passes 2^31 elements). A segment whose
// four pointers sit at different offsets within 16 bytes goes element by
// element; otherwise only the few elements before p's first 16-byte
// boundary and after its last whole vector do.
//
// One launch takes a table of up to kMaxSegments (p, g, m, v, n, decay)
// segments by value (__grid_constant__: indexed in the parameter space,
// never copied to a thread's stack), so a step of the optimizer is one
// launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

// one param, its gradient and moments (outside the anonymous namespace: the
// C entry's argument type keeps the entry's external linkage)
struct AdamWSegment {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
  int decay;
};

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;          // float4s of each tensor in flight a thread
constexpr int kMaxSegments = 64;    // the table stays under 4 KB of parameters

using Segment = AdamWSegment;

struct Table {
  Segment seg[kMaxSegments];
  int n;
};

struct Scalars {
  float b1, omb1, b2, omb2, rbc1, rbc2, eps, wd, neg_lr;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Scalars& k, bool decay, float d,
                                       float c) {
  g = __fmul_rn(__fdiv_rn(g, d), c);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(g, k.omb1));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(g, g), k.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, k.rbc2)), k.eps);
  float u = __fdiv_rn(__fmul_rn(m, k.rbc1), den);
  if (decay) u = __fadd_rn(u, __fmul_rn(p, k.wd));
  p = __fadd_rn(p, __fmul_rn(u, k.neg_lr));
}

__device__ __forceinline__ void update_at(const Segment& s, long long i,
                                          const Scalars& k, float d, float c) {
  float p = s.p[i], m = s.m[i], v = s.v[i];
  update(p, s.g[i], m, v, k, s.decay, d, c);
  s.p[i] = p;
  s.m[i] = m;
  s.v[i] = v;
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m,
                                        float4& v, const Scalars& k, bool decay,
                                        float d, float c) {
  update(p.x, g.x, m.x, v.x, k, decay, d, c);
  update(p.y, g.y, m.y, v.y, k, decay, d, c);
  update(p.z, g.z, m.z, v.z, k, decay, d, c);
  update(p.w, g.w, m.w, v.w, k, decay, d, c);
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table t, const Scalars k,
             const float* __restrict__ clip_div, const float* __restrict__ clip_mul) {
  const float d = clip_div ? *clip_div : 1.0f;
  const float c = clip_mul ? *clip_mul : 1.0f;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (int si = 0; si < t.n; ++si) {
    const Segment s = t.seg[si];
    const bool decay = s.decay != 0;
    // elements before p's first 16-byte boundary; all of them where the
    // other three pointers do not share p's offset within 16 bytes
    const uintptr_t off = reinterpret_cast<uintptr_t>(s.p) & 15;
    const bool vec = (reinterpret_cast<uintptr_t>(s.g) & 15) == off &&
                     (reinterpret_cast<uintptr_t>(s.m) & 15) == off &&
                     (reinterpret_cast<uintptr_t>(s.v) & 15) == off;
    long long head = vec ? (long long)((16 - off) & 15) / 4 : s.n;
    if (head > s.n) head = s.n;
    const long long nvec = (s.n - head) / 4;
    const long long tail = head + 4 * nvec;
    for (long long i = tid; i < head; i += stride) update_at(s, i, k, d, c);
    for (long long i = tail + tid; i < s.n; i += stride) update_at(s, i, k, d, c);

    float4* p4 = reinterpret_cast<float4*>(s.p + head);
    const float4* g4 = reinterpret_cast<const float4*>(s.g + head);
    float4* m4 = reinterpret_cast<float4*>(s.m + head);
    float4* v4 = reinterpret_cast<float4*>(s.v + head);
    for (long long j = tid; j < nvec; j += stride * kUnroll) {
      float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long q = j + u * stride;
        if (q < nvec) {
          g[u] = __ldcs(g4 + q);
          p[u] = __ldcs(p4 + q);
          m[u] = __ldcs(m4 + q);
          v[u] = __ldcs(v4 + q);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long q = j + u * stride;
        if (q < nvec) {
          update4(p[u], g[u], m[u], v[u], k, decay, d, c);
          __stcs(p4 + q, p[u]);
          __stcs(m4 + q, m[u]);
          __stcs(v4 + q, v[u]);
        }
      }
    }
  }
}

}  // namespace

// The most segments one launch takes.
extern "C" int adamw_max_segments() { return kMaxSegments; }

// C entry, bound with ctypes. segs: n_segs (1 .. kMaxSegments) segments in
// host memory, each n f32 elements of a param p, its gradient g and its
// moments m, v in device memory (4-byte aligned; any offset within 16
// bytes), decay != 0 where weight decay applies. clip_div, clip_mul: the
// clip's two device scalars (f32), or both null for no clip. The other
// arguments are the step's f32 scalars, rbc1 and rbc2 the f32 reciprocals
// of the bias corrections. Launches one kernel on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int adamw_fused_launch(const AdamWSegment* segs, int n_segs,
                                  const float* clip_div, const float* clip_mul,
                                  float b1, float omb1, float b2, float omb2,
                                  float rbc1, float rbc2, float eps, float wd,
                                  float neg_lr, void* stream) {
  if (n_segs < 1 || n_segs > kMaxSegments || (clip_div == nullptr) != (clip_mul == nullptr))
    return (int)cudaErrorInvalidValue;
  Table t;
  t.n = n_segs;
  long long vectors = 0;
  for (int i = 0; i < n_segs; ++i) {
    if (segs[i].n < 0) return (int)cudaErrorInvalidValue;
    t.seg[i] = segs[i];
    vectors += (segs[i].n + 3) / 4;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (vectors + (long long)kThreads * kUnroll - 1) /
                     ((long long)kThreads * kUnroll);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const Scalars k{b1, omb1, b2, omb2, rbc1, rbc2, eps, wd, neg_lr};
  adamw_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, k, clip_div, clip_mul);
  return (int)cudaGetLastError();
}
