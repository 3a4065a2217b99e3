// Sorted segment accumulator (K4).
//
// Replaces: pota_tpu/ops/splat_accum.py::_accum_kernel as driven by
// accumulate_presorted (and accumulate_sorted), which walks a (pixel, depth)
// sorted writer stream in 1024-row chunks and accumulates each band of 1024
// pixels with a one-hot MXU contraction.
//
// Input: the writer stream sorted stably (outside this kernel, by
// torch.sort) on the int64 key pixel << 32 | float_bits(|z|), its sort
// permutation, and the payload [W, K] and sample ids in WRITER order.  Dead
// writers carry pixel = npix and sort past every live one.  Output per
// pixel: the K payload sums, and the closest winner (the segment's first
// row: smallest depth, ties by writer order) as depth, sample id and a
// has-winner flag.
//
// What bounds it on the H100: memory latency.  Each writer costs an 8-byte
// permutation read and a gathered K x 4-byte payload read (random: the
// payload is read through the permutation, so no permuted copy is made),
// about 0.5 GB for the 18.7M writers of a 1080p frame (K = 5).
//
// Design: one thread per pixel.  The thread finds its segment by two binary
// searches over the sorted keys and sums the segment in sorted order, so
// the result is deterministic (no atomics; two runs give identical bits).
// Payloads wider than kColBlock columns (RGBA plus extra gaussian AOVs) are
// summed in blocks of kColBlock columns, one walk of the segment per block.
// Known limit: a hot pixel's segment is walked by one thread, so a frame
// whose splats pile onto few pixels serialises there.
#include "common.cuh"

namespace pota {

constexpr int kColBlock = 8;

__device__ __forceinline__ long long lower_bound_key(const long long* keys,
                                                     long long n,
                                                     long long value) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < value)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void segment_accum_kernel(const long long* __restrict__ keys,
                                     const long long* __restrict__ perm,
                                     long long n_writers,
                                     const float* __restrict__ payload, int K,
                                     const int* __restrict__ sid, int npix,
                                     float* __restrict__ accum,
                                     float* __restrict__ wdepth,
                                     int* __restrict__ wsample,
                                     uint8_t* __restrict__ has) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const long long lo = lower_bound_key(keys, n_writers, (long long)p << 32);
  const long long hi = lower_bound_key(keys, n_writers, (long long)(p + 1) << 32);
  for (int c0 = 0; c0 < K; c0 += kColBlock) {
    float s[kColBlock];
#pragma unroll
    for (int k = 0; k < kColBlock; ++k) s[k] = 0.0f;
    for (long long i = lo; i < hi; ++i) {
      const float* row = payload + perm[i] * K + c0;
#pragma unroll
      for (int k = 0; k < kColBlock; ++k)
        if (c0 + k < K) s[k] += row[k];
    }
#pragma unroll
    for (int k = 0; k < kColBlock; ++k)
      if (c0 + k < K) accum[(size_t)p * K + c0 + k] = s[k];
  }
  if (hi > lo) {
    wdepth[p] = __int_as_float((int)(keys[lo] & 0xFFFFFFFFll));
    wsample[p] = sid[perm[lo]];
    has[p] = 1;
  } else {
    wdepth[p] = 0.0f;
    wsample[p] = 0;
    has[p] = 0;
  }
}

}  // namespace pota

extern "C" int pota_segment_accum(const long long* keys, const long long* perm,
                                  long long n_writers, const float* payload,
                                  int K, const int* sid, int npix,
                                  float* accum, float* wdepth, int* wsample,
                                  uint8_t* has, cudaStream_t stream) {
  if (npix <= 0) return (int)cudaSuccess;
  if (K < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  pota::segment_accum_kernel<<<(npix + threads - 1) / threads, threads, 0,
                               stream>>>(keys, perm, n_writers, payload, K, sid,
                                         npix, accum, wdepth, wsample, has);
  return (int)cudaGetLastError();
}
