// Pooled multi-hot embedding lookups and the stacked table's exact Adagrad
// update, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's CTR model looks up one id a
// field (recommendit_tpu/models/ctr.py::embed_fields, one XLA gather) and
// updates the table row-wise in plain XLA (ops/sparse_embed.py). The port's
// DLRM-DCNv2 (models/ctr.py, the "dcn" arch) looks up a bag of ids a field
// and sums each bag, and trains the table with FBGEMM's exact Adagrad, one
// accumulator an element, on the rows a step touches. Without these kernels
// the step would write every looked-up row out (3.5 M x 128 f32 a step at
// the published bag sizes, 1.8 GB) and sum duplicates with index_add_.
//
// bag_fwd_kernel: out[b, f, :] = sum over the slots s of field f's bag of
// table[ids[b, s], :]. A warp a bag (one example's field), a lane 1-4 float4s
// of the row; the rows are added in slot order, starting from zeros, each
// add rounded once (ops/embedding_bag.py::pool_bags_plain is the same sum
// in the same order). Bound: the bytes of the distinct rows a step reads,
// the ids and the output; the design keeps eight rows' loads in flight a
// warp and never writes a looked-up row out.
//
// bag_update_kernel + bag_update_carry_kernel: the backward of the pooling
// fused with the update. The wrapper sorts the step's ids at their fixed
// size (torch.sort, stable: no unique, no nonzero, no host read), then a
// warp walks a chunk of kChunk sorted positions, summing the pooled
// gradient rows (b, field of slot s) of each run of equal ids in sorted
// order. A run that starts and ends inside the chunk is complete: the warp
// applies the update to its row at once,
//
//   a <- acc + g * g;   w <- w - lr * (g / (sqrt(a) + eps))
//
// each operation rounded once (__f*_rn: no FMA contraction), as the plain
// version's torch ops round. A run that crosses a chunk's end leaves its
// first chunk's part in `tail`, each later chunk's part in `head`; the
// carry kernel adds them in chunk order and applies the update. So a row
// hit 140,000 times in a step is summed by ~550 warps in parallel, and one
// warp adds their ~550 parts. Each row is updated by exactly one warp: no
// atomics on the table, and the result does not change from run to run.
// The sum's order differs from a plain sequential sum only by where the
// chunks cut it. Bound: the pooled gradient and the ids read once, each
// distinct row's w and acc read and written once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;     // sorted positions a warp of the update walks
constexpr int kAhead = 8;       // rows in flight a warp in both sums
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float adagrad(float& w, float a, float g, float lr,
                                         float eps) {
  const float an = __fadd_rn(a, __fmul_rn(g, g));
  const float den = __fadd_rn(__fsqrt_rn(an), eps);
  w = __fsub_rn(w, __fmul_rn(lr, __fdiv_rn(g, den)));
  return an;
}

// the exact Adagrad update of row r from its summed gradient (lane's part)
template <int V>
__device__ __forceinline__ void apply_row(float* __restrict__ table, float* __restrict__ acc,
                                          long long r, int nvec, int lane,
                                          const float4 (&g)[V], float lr, float eps) {
  float4* w4 = reinterpret_cast<float4*>(table + r * (long long)(nvec * 4));
  float4* a4 = reinterpret_cast<float4*>(acc + r * (long long)(nvec * 4));
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int v = lane + 32 * c;
    if (v < nvec) {
      float4 w = w4[v], a = a4[v];
      a.x = adagrad(w.x, a.x, g[c].x, lr, eps);
      a.y = adagrad(w.y, a.y, g[c].y, lr, eps);
      a.z = adagrad(w.z, a.z, g[c].z, lr, eps);
      a.w = adagrad(w.w, a.w, g[c].w, lr, eps);
      w4[v] = w;
      a4[v] = a;
    }
  }
}

template <int V>
__device__ __forceinline__ void zero(float4 (&g)[V]) {
#pragma unroll
  for (int c = 0; c < V; ++c) g[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ base, long long row,
                                         int nvec, int lane, float4 (&r)[V]) {
  const float4* p = reinterpret_cast<const float4*>(base + row * (long long)(nvec * 4));
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int v = lane + 32 * c;
    if (v < nvec) r[c] = __ldg(p + v);
  }
}

template <int V>
__device__ __forceinline__ void load_at(const float* __restrict__ p, int nvec, int lane,
                                        float4 (&r)[V]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int v = lane + 32 * c;
    if (v < nvec) r[c] = __ldg(p4 + v);
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ base, long long row, int nvec,
                                          int lane, const float4 (&r)[V]) {
  float4* p = reinterpret_cast<float4*>(base + row * (long long)(nvec * 4));
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int v = lane + 32 * c;
    if (v < nvec) p[v] = r[c];
  }
}

template <int V>
__device__ __forceinline__ void add_row(float4 (&g)[V], const float4 (&r)[V], int nvec,
                                        int lane) {
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (lane + 32 * c < nvec) g[c] = add4(g[c], r[c]);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bag_fwd_kernel(const float* __restrict__ table, const int* __restrict__ ids,
               const int* __restrict__ bag_start, int n_fields, int slots,
               long long n_bags, int nvec, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long bag = warp; bag < n_bags; bag += n_warps) {
    const long long b = bag / n_fields;
    const int f = (int)(bag - b * n_fields);
    const int s0 = __ldg(bag_start + f), s1 = __ldg(bag_start + f + 1);
    const int* id = ids + b * slots;
    float4 sum[V];
    zero(sum);
    for (int s = s0; s < s1; s += kAhead) {
      float4 r[kAhead][V];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (s + u < s1) load_row(table, (long long)__ldg(id + s + u), nvec, lane, r[u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (s + u < s1) add_row(sum, r[u], nvec, lane);
    }
    store_row(out, bag, nvec, lane, sum);
  }
}

// A run's part summed by one warp, and where it goes when the segment ends.
template <int V>
struct Segment {
  float4 g[V];
  int key;
  bool start;    // the segment's first position begins its run
};

template <int V>
__global__ void __launch_bounds__(kThreads)
bag_update_kernel(const int* __restrict__ keys, const long long* __restrict__ perm,
                  const float* __restrict__ grad, long long gstride,
                  const int* __restrict__ slot_field, int slots, long long n, int nvec,
                  float* __restrict__ table, float* __restrict__ acc,
                  float* __restrict__ head, float* __restrict__ tail,
                  int* __restrict__ pending, int* __restrict__ head_ends,
                  unsigned long long* __restrict__ counter, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  unsigned long long updated = 0;
  for (long long c = warp; c < n_chunks; c += n_warps) {
    const long long p0 = c * kChunk;
    const long long p1 = p0 + kChunk < n ? p0 + kChunk : n;
    // the key before the chunk (none at position 0: a run starts there)
    int prev_key = p0 > 0 ? keys[p0 - 1] : 0;
    bool prev_valid = p0 > 0;
    if (lane == 0) pending[c] = 0;
    Segment<V> seg;
    zero(seg.g);
    seg.key = 0;
    seg.start = false;
    bool have = false;

    // finish the segment in hand; `ends`: its run ends with it
    auto finish = [&](bool ends) {
      if (seg.start && ends) {
        apply_row<V>(table, acc, (long long)seg.key, nvec, lane, seg.g, lr, eps);
        ++updated;
      } else if (!seg.start) {          // the chunk's first segment, a run's later part
        store_row(head, c, nvec, lane, seg.g);
        if (lane == 0) head_ends[c] = ends ? 1 : 0;
      } else {                          // the chunk's last segment, going on after it
        store_row(tail, c, nvec, lane, seg.g);
        if (lane == 0) pending[c] = 1;
      }
    };

    for (long long q = p0; q < p1; q += 32) {
      const long long p = q + lane;
      const int cnt = p1 - q < 32 ? (int)(p1 - q) : 32;
      int key = 0;
      long long goff = 0;     // the slot's pooled-gradient row, in floats from grad
      if (p < p1) {
        key = keys[p];
        const long long pos = perm[p];
        const long long b = pos / slots;
        goff = b * gstride + (long long)__ldg(slot_field + (pos - b * slots)) * (nvec * 4);
      }
      int before = __shfl_up_sync(kFull, key, 1);
      bool valid_before = lane > 0 || prev_valid;
      if (lane == 0) before = prev_key;
      const bool start = p < p1 && (!valid_before || before != key);
      const unsigned starts = __ballot_sync(kFull, start);
      prev_key = __shfl_sync(kFull, key, cnt - 1);
      prev_valid = true;
      for (int j = 0; j < cnt; j += kAhead) {
        float4 r[kAhead][V];
        int k[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int src = (j + u) & 31;
          const long long go = __shfl_sync(kFull, goff, src);
          k[u] = __shfl_sync(kFull, key, src);
          if (j + u < cnt) load_at(grad + go, nvec, lane, r[u]);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (j + u < cnt) {
            const bool st = (starts >> (j + u)) & 1u;
            if (have && st) {
              finish(true);
              zero(seg.g);
            }
            if (!have || st) {
              seg.key = k[u];
              seg.start = st;
              have = true;
            }
            add_row(seg.g, r[u], nvec, lane);
          }
        }
      }
    }
    // the run of the chunk's last segment ends here unless the next chunk
    // begins with the same id
    finish(p1 >= n || keys[p1] != seg.key);
  }
  if (lane == 0 && updated && counter) atomicAdd(counter, updated);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bag_update_carry_kernel(const int* __restrict__ keys, long long n, int nvec,
                        float* __restrict__ table, float* __restrict__ acc,
                        const float* __restrict__ head, const float* __restrict__ tail,
                        const int* __restrict__ pending, const int* __restrict__ head_ends,
                        unsigned long long* __restrict__ counter, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  unsigned long long updated = 0;
  for (long long c = warp; c < n_chunks; c += n_warps) {
    if (!pending[c]) continue;
    const long long last = (c + 1) * kChunk - 1;   // < n: a later chunk exists
    const int key = keys[last];
    float4 g[V];
    load_row(tail, c, nvec, lane, g);
    bool done = false;
    for (long long c2 = c + 1; !done && c2 < n_chunks; c2 += kAhead) {
      float4 r[kAhead][V];
      int e[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        e[u] = 1;
        if (c2 + u < n_chunks) {
          e[u] = head_ends[c2 + u];
          load_row(head, c2 + u, nvec, lane, r[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (!done && c2 + u < n_chunks) {
          add_row(g, r[u], nvec, lane);
          done = e[u] != 0;
        }
      }
    }
    apply_row<V>(table, acc, (long long)key, nvec, lane, g, lr, eps);
    ++updated;
  }
  if (lane == 0 && updated && counter) atomicAdd(counter, updated);
}

// blocks for `warps` warps of work, at most the card's resident blocks
template <typename K>
cudaError_t grid_for(K kernel, long long warps, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long b = (warps + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (b > resident) b = resident;
  if (b < 1) b = 1;
  *blocks = (unsigned)b;
  return cudaSuccess;
}

template <int V>
int fwd(const float* table, const int* ids, const int* bag_start, int n_fields, int slots,
        long long batch, int nvec, float* out, cudaStream_t stream) {
  const long long n_bags = batch * n_fields;
  unsigned blocks = 0;
  cudaError_t err = grid_for(bag_fwd_kernel<V>, n_bags, &blocks);
  if (err != cudaSuccess) return (int)err;
  bag_fwd_kernel<V><<<blocks, kThreads, 0, stream>>>(table, ids, bag_start, n_fields, slots,
                                                     n_bags, nvec, out);
  return (int)cudaGetLastError();
}

template <int V>
int update(const int* keys, const long long* perm, const float* grad, long long gstride,
           const int* slot_field, int slots, long long n, int nvec, float* table, float* acc,
           float* head, float* tail, int* pending, int* head_ends,
           unsigned long long* counter, float lr, float eps, cudaStream_t stream) {
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  unsigned blocks = 0;
  cudaError_t err = grid_for(bag_update_kernel<V>, n_chunks, &blocks);
  if (err != cudaSuccess) return (int)err;
  bag_update_kernel<V><<<blocks, kThreads, 0, stream>>>(
      keys, perm, grad, gstride, slot_field, slots, n, nvec, table, acc, head, tail,
      pending, head_ends, counter, lr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = grid_for(bag_update_carry_kernel<V>, n_chunks, &blocks);
  if (err != cudaSuccess) return (int)err;
  bag_update_carry_kernel<V><<<blocks, kThreads, 0, stream>>>(
      keys, n, nvec, table, acc, head, tail, pending, head_ends, counter, lr, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Sorted positions one warp of the update walks (the wrapper sizes the
// head and tail scratch by it).
extern "C" int bag_update_chunk() { return kChunk; }

// C entries, bound with ctypes. Every pointer is device memory; rows are
// dim = 4 * nvec f32 wide (dim a multiple of 4, at most 512), 16-byte
// aligned. ids: (batch, slots) int32 rows of the stacked table; bag_start:
// n_fields + 1 int32, field f's bag the slots [bag_start[f],
// bag_start[f + 1]); out: (batch, n_fields, dim). Each launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches (0 = launched).
extern "C" int bag_fwd_launch(const float* table, const int* ids, const int* bag_start,
                              int n_fields, int slots, long long batch, int dim, float* out,
                              void* stream) {
  if (n_fields < 1 || slots < 1 || batch < 0 || dim < 4 || dim % 4 || dim > 512)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int nvec = dim / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nvec <= 32) return fwd<1>(table, ids, bag_start, n_fields, slots, batch, nvec, out, s);
  if (nvec <= 64) return fwd<2>(table, ids, bag_start, n_fields, slots, batch, nvec, out, s);
  return fwd<4>(table, ids, bag_start, n_fields, slots, batch, nvec, out, s);
}

// keys: the step's n ids sorted (int32), perm: each one's position b *
// slots + s in the id block (int64); grad: the pooled gradient, example b's
// (n_fields, dim) rows contiguous from grad + b * gstride floats (gstride a
// multiple of 4); slot_field: slots int32, each slot's field; table, acc:
// (rows, dim) updated in place at each distinct key; head, tail:
// ceil(n / bag_update_chunk()) x dim f32 scratch, pending, head_ends as
// many int32; counter: one uint64 adding the rows updated, or null.
extern "C" int bag_update_launch(const int* keys, const long long* perm, const float* grad,
                                 long long gstride, const int* slot_field, int slots,
                                 long long n, int dim, float* table, float* acc, float* head,
                                 float* tail, int* pending, int* head_ends,
                                 unsigned long long* counter, float lr, float eps,
                                 void* stream) {
  if (slots < 1 || n < 0 || dim < 4 || dim % 4 || dim > 512 || gstride % 4)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int nvec = dim / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nvec <= 32)
    return update<1>(keys, perm, grad, gstride, slot_field, slots, n, nvec, table, acc, head,
                     tail, pending, head_ends, counter, lr, eps, s);
  if (nvec <= 64)
    return update<2>(keys, perm, grad, gstride, slot_field, slots, n, nvec, table, acc, head,
                     tail, pending, head_ends, counter, lr, eps, s);
  return update<4>(keys, perm, grad, gstride, slot_field, slots, n, nvec, table, acc, head,
                   tail, pending, head_ends, counter, lr, eps, s);
}
