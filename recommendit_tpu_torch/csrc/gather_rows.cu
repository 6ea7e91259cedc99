// Row gather for Hopper (sm_90a): out[i, :] = table[clamp(idx[i], 0, N-1), :]
// for a flat index of any length, a table of any dtype and any row width.
//
// Replaces the Pallas TPU kernel recommendit_tpu/ops/gather.py::_gather_kernel
// (wrappers gather_rows, take_rows). The TPU kernel issues one DMA per row
// from HBM into a VMEM output block, keeping `lag` copies in flight on a
// semaphore, and needs rows padded to 128 lanes (a Mosaic rule). Here the copy
// is a plain byte copy of whole rows: no padding, no dtype, any width (the
// packed feature tables are 23 or 64 columns wide). Same contract: indices
// are clamped to the table, as jnp.take(..., mode="clip") does.
//
// What bounds it on an H100: it does no arithmetic, so the bytes do: each
// output row read once from the table and written once, plus the index. At
// the serve shape (1024 x 500 candidates of a 1M x 64 f32 table) that is
// ~0.26 GB, ~0.08 ms at 3.35 TB/s. Reads are random rows, so what matters is
// keeping enough bytes in flight: one warp per output row, each lane copying
// 16-byte vectors where the row's byte count and both base pointers allow it
// (8-, 4-, 2- or 1-byte words otherwise), and a grid of many warps per SM so
// that thousands of row reads are outstanding at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (recommendit_tpu_torch/ops/_build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;          // output rows per block pass
constexpr long long kMaxBlocks = 1LL << 20;    // grid-stride beyond this

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, const I* __restrict__ idx,
                   V* __restrict__ out, long long n_out, long long n_rows,
                   int row_words) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < n_out; r += stride) {
    long long src = (long long)idx[r];   // one address for the warp: a broadcast
    src = src < 0 ? 0 : (src >= n_rows ? n_rows - 1 : src);
    const V* s = table + src * row_words;
    V* d = out + r * row_words;
    for (int c = lane; c < row_words; c += 32) d[c] = s[c];
  }
}

template <typename V>
int launch(const void* table, const void* idx, int idx_int64, void* out,
           long long n_out, long long n_rows, long long row_bytes,
           cudaStream_t s) {
  const int row_words = (int)(row_bytes / (long long)sizeof(V));
  long long blocks = (n_out + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const V* t = static_cast<const V*>(table);
  V* o = static_cast<V*>(out);
  if (idx_int64) {
    gather_rows_kernel<V, int64_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, static_cast<const int64_t*>(idx), o, n_out, n_rows, row_words);
  } else {
    gather_rows_kernel<V, int32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, static_cast<const int32_t*>(idx), o, n_out, n_rows, row_words);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. table: (n_rows, row_bytes) bytes, contiguous;
// idx: n_out int32 (idx_int64 == 0) or int64 indices, contiguous; out:
// (n_out, row_bytes) bytes. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
// n_out == 0 launches nothing and returns 0.
extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  int idx_int64, void* out, long long n_out,
                                  long long n_rows, long long row_bytes,
                                  void* stream) {
  if (n_out < 0 || n_rows <= 0 || row_bytes <= 0 || row_bytes >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) | (uintptr_t)row_bytes;
  if (a % 16 == 0) return launch<uint4>(table, idx, idx_int64, out, n_out, n_rows, row_bytes, s);
  if (a % 8 == 0) return launch<uint2>(table, idx, idx_int64, out, n_out, n_rows, row_bytes, s);
  if (a % 4 == 0) return launch<uint32_t>(table, idx, idx_int64, out, n_out, n_rows, row_bytes, s);
  if (a % 2 == 0) return launch<uint16_t>(table, idx, idx_int64, out, n_out, n_rows, row_bytes, s);
  return launch<uint8_t>(table, idx, idx_int64, out, n_out, n_rows, row_bytes, s);
}
