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
// 2.3 GB a frame.
//
// Design: one thread per (slot, row).  blockIdx.y picks the row, so a warp
// writes 32 consecutive slots of one row (coalesced).  src is
// non-decreasing along the queue (slots are source-contiguous), so the
// gathered reads of a warp fall on few cache lines too.
#include "common.cuh"

namespace pota {

__global__ void expand_kernel(const int* __restrict__ src, int n_slots,
                              const float* __restrict__ tf, int rows_f,
                              const int* __restrict__ ti, int n_src,
                              float* __restrict__ ef, int* __restrict__ ei) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const int r = blockIdx.y;
  const int j = src[s];
  const bool in_range = (j >= 0) && (j < n_src);
  if (r < rows_f) {
    ef[(size_t)r * n_slots + s] = in_range ? tf[(size_t)r * n_src + j] : 0.0f;
  } else {
    const int ri = r - rows_f;
    ei[(size_t)ri * n_slots + s] = in_range ? ti[(size_t)ri * n_src + j] : 0;
  }
}

}  // namespace pota

extern "C" int pota_expand(const int* src, int n_slots, const float* tf,
                           int rows_f, const int* ti, int rows_i, int n_src,
                           float* ef, int* ei, cudaStream_t stream) {
  if (n_slots <= 0 || rows_f + rows_i <= 0) return (int)cudaSuccess;
  const int threads = 256;
  dim3 grid((n_slots + threads - 1) / threads, rows_f + rows_i);
  pota::expand_kernel<<<grid, threads, 0, stream>>>(src, n_slots, tf, rows_f,
                                                    ti, n_src, ef, ei);
  return (int)cudaGetLastError();
}
