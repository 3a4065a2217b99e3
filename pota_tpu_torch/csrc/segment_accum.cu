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
// has-winner flag.  The wrapper zeroes the outputs first, so a pixel no
// writer touches reads zeros.
//
// What bounds it on the H100: bytes, and most of them the payload rows
// gathered through the permutation.  A live writer costs its 8-byte key and
// 8-byte permutation entry, read coalesced, and a K x 4-byte payload row at
// a random place (20 bytes for K = 5, in one or two 32-byte sectors); at
// the 1080p frame's 14M live writers the random reads run far below the
// card's streaming rate (chip_smoke.py times torch's index_select of the
// same rows beside K4: row_gather_ms).
//
// Design: the sorted rows are cut into tiles of kAccTile = 256 threads x 4
// consecutive rows, a block each; no pixel is searched for.
//   1. The block reads its tile's keys, then the live rows' permutation,
//      coalesced, into shared memory.  A tile whose first row is dead holds
//      no live row and stops there, so rows past the live ones are never
//      gathered.
//   2. Each thread gathers its 4 rows' payload, all 20 loads in flight
//      before the first is used, then sums the rows in order.  Of the
//      layouts timed on the H100 (4 or 8 rows a
//      thread; 2, 4 or all rows' loads in flight, or each row's behind its
//      head branch), this one (64 registers) ran fastest on the 1080p
//      frame's stream and tied on the seeded ones; loads behind the head
//      branch cost a round trip a row.  A head (the first
//      row of a pixel) closes the running segment: a segment that began at
//      an earlier head of the same thread is written to its pixel at once.
//      At each live head the thread writes the pixel's winner.
//   3. A segmented scan over the threads (warp shuffles, then the 8 warp
//      totals in order) gives each thread the sum of the rows before it
//      since the last head; the thread that holds a segment's closing head
//      adds it and writes the pixel.
//   4. The tile's first segment (rows before its first head) and its last
//      (from its last head on) go to a carry buffer, with the last one's
//      pixel; segment_carry_kernel adds, for each tile's last segment, the
//      first segments of the tiles after it up to the next head, in tile
//      order, and writes the pixel.  A hot pixel is summed by every thread
//      of every tile it spans, and costs one walk over those tiles.
// Every sum is taken in one fixed order (thread, warp tree, warps, tiles),
// so two runs give identical bits; there are no atomics.  Payloads wider
// than kColBlock columns (RGBA plus weight, then 4 more for each extra
// gaussian AOV) are summed kColBlock columns a pass over the shared rows.
#include "common.cuh"

namespace pota {

constexpr int kAccThreads = 256;                   // threads a tile
constexpr int kAccRows = 4;                        // consecutive rows a thread
constexpr int kAccTile = kAccThreads * kAccRows;   // rows a tile
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kColBlock = 5;                       // payload columns a pass
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kAccThreads)
segment_tile_kernel(const long long* __restrict__ keys,
                    const long long* __restrict__ perm, long long n_writers,
                    const float* __restrict__ payload, int K,
                    const int* __restrict__ sid, int npix,
                    float* __restrict__ accum, float* __restrict__ wdepth,
                    int* __restrict__ wsample, uint8_t* __restrict__ has,
                    float* __restrict__ lead, float* __restrict__ trail,
                    int* __restrict__ tail_pix) {
  __shared__ int s_pix[kAccTile + 1];   // [r + 1]: row r's pixel; [0]: the row before
  __shared__ int s_row[kAccTile];       // the row's writer (perm)
  __shared__ unsigned s_dep[kAccTile];  // the row's depth bits
  __shared__ int s_wf[kAccWarps];       // per warp: holds a head
  __shared__ float s_wv[kAccWarps][kColBlock];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const long long base = (long long)b * kAccTile;
  // 1. keys, then the live rows' writers, coalesced: every load of a phase
  // is issued before any is used (rows past the stream read as dead)
  long long key[kAccRows], wr[kAccRows];
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const long long i = base + j * kAccThreads + tid;
    key[j] = i < n_writers ? keys[i] : (long long)npix << 32;
  }
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const long long i = base + j * kAccThreads + tid;
    wr[j] = (key[j] >> 32) < npix ? perm[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const int r = j * kAccThreads + tid;
    s_pix[r + 1] = (int)min(key[j] >> 32, (long long)npix);
    s_row[r] = (int)wr[j];
    s_dep[r] = (unsigned)(key[j] & 0xFFFFFFFFll);
  }
  if (tid == 0) s_pix[0] = base > 0 ? min((int)(keys[base - 1] >> 32), npix) : -1;
  __syncthreads();
  if (s_pix[1] >= npix) {
    // dead from its first row on: the walk of an earlier tile stops here
    if (tid == 0) tail_pix[b] = npix;
    for (int c = tid; c < K; c += kAccThreads) lead[(size_t)b * K + c] = 0.0f;
    return;
  }

  // this thread's rows r0 .. r0 + kAccRows - 1: heads, winners' sample ids
  const int r0 = tid * kAccRows;
  unsigned heads = 0, live = 0;
  int win_sid[kAccRows];
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const int p = s_pix[r0 + j + 1];
    if (p != s_pix[r0 + j]) heads |= 1u << j;
    if (p < npix) live |= 1u << j;
    win_sid[j] = (heads & live) >> j & 1u ? sid[s_row[r0 + j]] : 0;
  }
  const int first_head = heads ? __ffs(heads) - 1 : kAccRows;

  for (int c0 = 0; c0 < K; c0 += kColBlock) {
    const int nc = min(kColBlock, K - c0);
    // 2. gather the rows' payload (all loads in flight), then sum in order
    float x[kAccRows][kColBlock];
#pragma unroll
    for (int j = 0; j < kAccRows; ++j) {
      const float* row = payload + (size_t)s_row[r0 + j] * K + c0;
#pragma unroll
      for (int k = 0; k < kColBlock; ++k)
        x[j][k] = (live >> j & 1u) && k < nc ? row[k] : 0.0f;
    }
    float run[kColBlock], head_sum[kColBlock];
#pragma unroll
    for (int k = 0; k < kColBlock; ++k) run[k] = head_sum[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kAccRows; ++j) {
      const int r = r0 + j;
      if (heads >> j & 1u) {
        if (j > first_head) {
          // a segment that began at an earlier head of this thread (live:
          // no head follows the dead rows)
          const int p = s_pix[r];
#pragma unroll
          for (int k = 0; k < kColBlock; ++k)
            if (k < nc) accum[(size_t)p * K + c0 + k] = run[k];
        } else {
#pragma unroll
          for (int k = 0; k < kColBlock; ++k) head_sum[k] = run[k];
        }
#pragma unroll
        for (int k = 0; k < kColBlock; ++k) run[k] = 0.0f;
      }
      if (live >> j & 1u) {
#pragma unroll
        for (int k = 0; k < kColBlock; ++k) run[k] += x[j][k];
      }
    }
    // 3. segmented scan of (holds a head, rows since its last head): within
    // the warp (Kogge-Stone), then over the warps in order
    bool f = heads != 0;
    float v[kColBlock];
#pragma unroll
    for (int k = 0; k < kColBlock; ++k) v[k] = run[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool g = __shfl_up_sync(kFull, f, d);
#pragma unroll
      for (int k = 0; k < kColBlock; ++k) {
        if (k < nc) {
          const float u = __shfl_up_sync(kFull, v[k], d);
          if (lane >= d && !f) v[k] = u + v[k];
        }
      }
      if (lane >= d) f = f || g;
    }
    if (lane == 31) {
      s_wf[warp] = f;
#pragma unroll
      for (int k = 0; k < kColBlock; ++k) s_wv[warp][k] = v[k];
    }
    // exclusive: the lane below's inclusive value
    bool ef = __shfl_up_sync(kFull, f, 1);
    float ev[kColBlock];
#pragma unroll
    for (int k = 0; k < kColBlock; ++k)
      ev[k] = k < nc ? __shfl_up_sync(kFull, v[k], 1) : 0.0f;
    if (lane == 0) {
      ef = false;
#pragma unroll
      for (int k = 0; k < kColBlock; ++k) ev[k] = 0.0f;
    }
    __syncthreads();
    bool pf = false;
    float pv[kColBlock];
#pragma unroll
    for (int k = 0; k < kColBlock; ++k) pv[k] = 0.0f;
    for (int w = 0; w < warp; ++w) {
      const bool wf = s_wf[w];
#pragma unroll
      for (int k = 0; k < kColBlock; ++k)
        pv[k] = wf ? s_wv[w][k] : pv[k] + s_wv[w][k];
      pf = pf || wf;
    }
    // (pf, pv) then (ef, ev): what precedes this thread in the tile
    const bool F = pf || ef;
    float C[kColBlock];
#pragma unroll
    for (int k = 0; k < kColBlock; ++k) C[k] = ef ? ev[k] : pv[k] + ev[k];

    if (heads) {
      // the segment that this thread's first head closes
      if (F) {
        const int p = s_pix[r0 + first_head];
        if (p < npix) {
#pragma unroll
          for (int k = 0; k < kColBlock; ++k)
            if (k < nc) accum[(size_t)p * K + c0 + k] = C[k] + head_sum[k];
        }
      } else {
        // 4. no head before it in the tile: the tile's first segment
#pragma unroll
        for (int k = 0; k < kColBlock; ++k)
          if (k < nc) lead[(size_t)b * K + c0 + k] = C[k] + head_sum[k];
      }
    }
    if (tid == kAccThreads - 1) {
      // 4. the whole tile: its last segment, or one segment without a head
      if (F || heads) {
#pragma unroll
        for (int k = 0; k < kColBlock; ++k)
          if (k < nc)
            trail[(size_t)b * K + c0 + k] = heads ? run[k] : C[k] + run[k];
        if (c0 == 0) tail_pix[b] = s_pix[kAccTile];
      } else {
#pragma unroll
        for (int k = 0; k < kColBlock; ++k)
          if (k < nc) lead[(size_t)b * K + c0 + k] = C[k] + run[k];
        if (c0 == 0) tail_pix[b] = -1;
      }
    }
    __syncthreads();  // s_wf / s_wv serve the next column block
  }
  // the winner of each pixel whose segment starts here: its first row
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    if ((heads & live) >> j & 1u) {
      const int p = s_pix[r0 + j + 1];
      wdepth[p] = __uint_as_float(s_dep[r0 + j]);
      wsample[p] = win_sid[j];
      has[p] = 1;
    }
  }
}

// For each tile whose last segment is live: that segment's sum plus the
// first segments of the tiles after it, in tile order, until a tile that
// holds a head (tail_pix >= 0).
__global__ void segment_carry_kernel(int n_tiles, int K, int npix,
                                     const float* __restrict__ lead,
                                     const float* __restrict__ trail,
                                     const int* __restrict__ tail_pix,
                                     float* __restrict__ accum) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_tiles) return;
  const int p = tail_pix[b];
  if (p < 0 || p >= npix) return;
  for (int c = 0; c < K; ++c) {
    float total = trail[(size_t)b * K + c];
    for (int t = b + 1; t < n_tiles; ++t) {
      total += lead[(size_t)t * K + c];
      if (tail_pix[t] >= 0) break;
    }
    accum[(size_t)p * K + c] = total;
  }
}

}  // namespace pota

// lead, trail [ceil(n_writers / kAccTile), K] and tail_pix [same] are the
// carry buffers (ops/splat_accum.py sizes them with the same tile).
extern "C" int pota_segment_accum(const long long* keys, const long long* perm,
                                  long long n_writers, const float* payload,
                                  int K, const int* sid, int npix,
                                  float* accum, float* wdepth, int* wsample,
                                  uint8_t* has, float* lead, float* trail,
                                  int* tail_pix, cudaStream_t stream) {
  if (npix <= 0 || n_writers <= 0) return (int)cudaSuccess;
  if (K < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_writers + pota::kAccTile - 1) / pota::kAccTile;
  if (tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)tiles;
  pota::segment_tile_kernel<<<n_tiles, pota::kAccThreads, 0, stream>>>(
      keys, perm, n_writers, payload, K, sid, npix, accum, wdepth, wsample,
      has, lead, trail, tail_pix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  pota::segment_carry_kernel<<<(n_tiles + threads - 1) / threads, threads, 0,
                               stream>>>(n_tiles, K, npix, lead, trail,
                                         tail_pix, accum);
  return (int)cudaGetLastError();
}
