// PO backward solve kernel (K6).
//
// Replaces: pota_tpu/ops/po_pallas.py::build_po_backward_kernel, the plain
// per-lens lt_sample_aperture solve of JAX's decomposed splat branch
// (render/splat.py::po_backward_project), which this port runs for the
// frames K3 does not take: camera motion blur.
//
// Per item: the target (px, py, pz) in lens-space mm (-10 * p_cam), the
// aperture point (ax, ay) in mm and the item's wavelength -> the sensor
// light field (sx, sy, sdx, sdy) and the transmittance, >= 0 and already
// cropped by the outer pupil.
//
// What bounds it on the H100: arithmetic.  Each Newton iteration of the
// folded solve is 2,436 FMAs over the basis and its Jacobian rows plus the
// chart and a 4x4 solve (po_solve_basis.cuh); the memory traffic is 24
// bytes in (28 with a table index) and 20 bytes out per item.
//
// Design: a frame has one wavelength, or under chroma three fixed ones
// (render/splat.py::chroma_wavelengths), so the kernel runs po_basis_solve
// on one to three tables that po_kernels.py fold_solve_tables folds at
// those wavelengths, the tables K3 and K3b run.  All of them go
// into shared memory (10,784 bytes each, 32.4 KB for three), and an
// optional int32 index per item (the chroma channel) picks the item's
// table.  Each table starts 2696 floats after the one before, 8 banks
// further round the 32, so lanes of one warp that read the same offset of
// different tables hit disjoint banks.  On an H100 (sm_90a, CUDA 12.8) the
// one build takes 121 registers and spills nothing; with the three chroma
// tables picked per item (slot % 3, as a chromatic queue interleaves them)
// it takes 1.5x the time of one table: a warp's 16-byte loads then carry
// three addresses, which the disjoint banks do not make free.  A layout
// whose tables share banks was not measured.  One thread per item, a
// grid-stride loop, 256 threads a block as K3's flagship instantiation
// takes.  One build serves every lens; the TPU kernel's [8, 128] padding
// and baked immediates have no counterpart here.
#include "po_solve_basis.cuh"

namespace pota {

constexpr int kBackwardThreads = 256;

__global__ void __launch_bounds__(kBackwardThreads)
po_backward_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ pz, const float* __restrict__ ax,
                   const float* __restrict__ ay,
                   const int* __restrict__ table_idx, int n,
                   const float* __restrict__ g_tab, int n_tab,
                   const float* __restrict__ lensc, int chart, int iterations,
                   float* __restrict__ sx, float* __restrict__ sy,
                   float* __restrict__ sdx, float* __restrict__ sdy,
                   float* __restrict__ trans) {
  extern __shared__ __align__(16) float smem[];
  float* s_tab = smem;                                 // [n_tab, kTableFloats]
  float* s_lens = s_tab + n_tab * basis::kTableFloats;  // PoLens
  block_load(s_tab, g_tab, n_tab * basis::kTableFloats);
  block_load(s_lens, lensc, 8);
  __syncthreads();

  const PoLens L{s_lens[0], s_lens[1], s_lens[2], s_lens[3],
                 s_lens[4], s_lens[5], s_lens[6], s_lens[7]};

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float* tab =
        table_idx ? s_tab + table_idx[i] * basis::kTableFloats : s_tab;
    float s[4];
    const float tr = po_basis_solve(tab, L, chart, iterations, px[i], py[i],
                                    pz[i], ax[i], ay[i], s);
    sx[i] = s[0];
    sy[i] = s[1];
    sdx[i] = s[2];
    sdy[i] = s[3];
    trans[i] = tr;
  }
}

}  // namespace pota

// tables: n_tables folded solve tables, one after another (po_kernels.py
// fold_solve_tables, pota::basis::kTableFloats floats each); table_idx:
// int32 [n] in [0, n_tables), or null for one table.
extern "C" int pota_po_backward(const float* px, const float* py,
                                const float* pz, const float* ax,
                                const float* ay, const int* table_idx, int n,
                                const float* tables, int n_tables,
                                const float* lensc, int chart, int iterations,
                                float* sx, float* sy, float* sdx, float* sdy,
                                float* trans, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_tables < 1 || n_tables > pota::kMaxSolveTables ||
      (n_tables > 1 && table_idx == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)n_tables * pota::basis::kTableFloats + 8);
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  constexpr int threads = pota::kBackwardThreads;
  pota::po_backward_kernel<<<pota::grid_for(n, threads), threads, smem,
                             stream>>>(px, py, pz, ax, ay, table_idx, n,
                                       tables, n_tables, lensc, chart,
                                       iterations, sx, sy, sdx, sdy, trans);
  return (int)cudaGetLastError();
}
