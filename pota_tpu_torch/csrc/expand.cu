// Expand kernel (K2).
//
// Replaces: pota_tpu/ops/po_pallas.py::build_expand_kernel, which expands the
// compact per-source table to queue-slot resolution with a one-hot MXU
// matmul over a scalar-prefetched 1024-column window.
//
// Computes ex[r, s] = table[r, src[s]] for an f32 table (camera and world
// position, sky flag, rgba payload, |z|) and an int32 table (pixel x/y,
// queue start, sample id) side by side.  Integer columns stay integers, so
// none of the TPU workarounds remain: no (hi, lo) f32 start split, no ids in
// f32 (and no n < 2^24 gate), no window ids, no tile padding.
//
// What bounds it on the H100: device memory.  At 1080p it writes 16 rows x
// 16.6M slots x 4 B and reads src and the gathered table entries, about
// 1.26 GB a frame.
//
// Design: each thread owns V consecutive slots (V = 4 when the slot count
// is a multiple of 4, so every row's run of 4 starts on a 16-byte boundary;
// else 1).  It reads their sources once and walks every row of both
// tables: a warp's store of one row is 32 x V consecutive values (512
// bytes at V = 4, one 128-bit streaming store a thread), and each thread
// keeps V gathers of several rows in flight.  The gathers go through the
// read-only path: src is non-decreasing along the queue (slots are
// source-contiguous), so a warp's gathers of one row fall on a handful of
// cache lines.  An index outside [0, n_src) gives 0.
#include "common.cuh"

namespace pota {

constexpr int kExpandThreads = 256;
constexpr int kExpandRowsInFlight = 4;

template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<int, 4> {
  using type = int4;
};

// rows [0, rows) of table t [rows, n_src] gathered at the thread's V
// sources into out [rows, n_slots] at slot s0
template <typename T, int V>
__device__ __forceinline__ void gather_rows(const T* __restrict__ t, int rows,
                                            int n_src, const int j[V],
                                            const bool in[V],
                                            T* __restrict__ out, int n_slots,
                                            long long s0) {
  int r = 0;
  for (; r + kExpandRowsInFlight <= rows; r += kExpandRowsInFlight) {
    T v[kExpandRowsInFlight][V];
#pragma unroll
    for (int k = 0; k < kExpandRowsInFlight; ++k)
#pragma unroll
      for (int q = 0; q < V; ++q)
        v[k][q] = in[q] ? __ldg(t + (size_t)(r + k) * n_src + j[q]) : T(0);
#pragma unroll
    for (int k = 0; k < kExpandRowsInFlight; ++k) {
      T* dst = out + (size_t)(r + k) * n_slots + s0;
      if constexpr (V == 4) {
        using W = typename Vec<T, 4>::type;
        __stcs(reinterpret_cast<W*>(dst), W{v[k][0], v[k][1], v[k][2], v[k][3]});
      } else {
        __stcs(dst, v[k][0]);
      }
    }
  }
  for (; r < rows; ++r) {
    T* dst = out + (size_t)r * n_slots + s0;
#pragma unroll
    for (int q = 0; q < V; ++q)
      dst[q] = in[q] ? __ldg(t + (size_t)r * n_src + j[q]) : T(0);
  }
}

template <int V>
__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const int* __restrict__ src, int n_slots,
              const float* __restrict__ tf, int rows_f,
              const int* __restrict__ ti, int rows_i, int n_src,
              float* __restrict__ ef, int* __restrict__ ei) {
  const long long s0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (s0 >= n_slots) return;
  int j[V];
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(src + s0));
    j[0] = q.x;
    j[1] = q.y;
    j[2] = q.z;
    j[3] = q.w;
  } else {
    j[0] = __ldg(src + s0);
  }
  bool in[V];
#pragma unroll
  for (int q = 0; q < V; ++q) in[q] = (j[q] >= 0) && (j[q] < n_src);
  gather_rows<float, V>(tf, rows_f, n_src, j, in, ef, n_slots, s0);
  gather_rows<int, V>(ti, rows_i, n_src, j, in, ei, n_slots, s0);
}

}  // namespace pota

extern "C" int pota_expand(const int* src, int n_slots, const float* tf,
                           int rows_f, const int* ti, int rows_i, int n_src,
                           float* ef, int* ei, cudaStream_t stream) {
  if (n_slots <= 0 || rows_f + rows_i <= 0) return (int)cudaSuccess;
  const int threads = pota::kExpandThreads;
  // 16-byte runs need every row start aligned: n_slots % 4 == 0 and
  // 16-byte aligned bases (the allocator gives 256)
  const bool vec = n_slots % 4 == 0 &&
                   ((uintptr_t)src | (uintptr_t)ef | (uintptr_t)ei) % 16 == 0;
  if (vec) {
    const long long items = n_slots / 4;
    pota::expand_kernel<4>
        <<<(unsigned)((items + threads - 1) / threads), threads, 0, stream>>>(
            src, n_slots, tf, rows_f, ti, rows_i, n_src, ef, ei);
  } else {
    pota::expand_kernel<1>
        <<<(unsigned)(((long long)n_slots + threads - 1) / threads), threads,
           0, stream>>>(src, n_slots, tf, rows_f, ti, rows_i, n_src, ef, ei);
  }
  return (int)cudaGetLastError();
}
