// PO backward solve kernel (K6).
//
// Replaces: pota_tpu/ops/po_pallas.py::build_po_backward_kernel, the plain
// per-lens lt_sample_aperture solve of JAX's decomposed splat branch
// (render/splat.py::po_backward_project), which this port runs for the
// frames K3 does not take: camera motion blur.
//
// Per item: the target (px, py, pz) in lens-space mm (-10 * p_cam), the
// aperture point (ax, ay) in mm and the wavelength lam (um) -> the sensor
// light field (sx, sy, sdx, sdy) and the transmittance, >= 0 and already
// cropped by the outer pupil.  The wavelength is per item, so the chromatic
// queue (three wavelengths per budget unit) is served too.
//
// What bounds it on the H100: arithmetic.  Each of the Newton iterations
// evaluates the 160-term polynomial for six outputs with four tangents
// (6 x 5 FMAs per term plus the powers), then the chart and a 4x4 solve;
// the memory traffic is 24 bytes in and 20 bytes out per item.
//
// Design: one thread per item, a grid-stride loop; the solve is
// po_backward_solve (po_solve.cuh), the code K3 runs.  The int8 exponents,
// the [7, T] coefficient rows, the conditioning and the lens constants are
// loaded into shared memory once per block, as K3 loads them, so one build
// serves every lens.  The TPU kernel's [8, 128] padding and baked
// immediates have no counterpart here.
#include "po_solve.cuh"

namespace pota {

__global__ void __launch_bounds__(128)
po_backward_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ pz, const float* __restrict__ ax,
                   const float* __restrict__ ay, const float* __restrict__ lam,
                   int n, const int8_t* __restrict__ g_e,
                   const float* __restrict__ g_c, int T,
                   const float* __restrict__ cond,
                   const float* __restrict__ lensc, int chart, int iterations,
                   float* __restrict__ sx, float* __restrict__ sy,
                   float* __restrict__ sdx, float* __restrict__ sdy,
                   float* __restrict__ trans) {
  extern __shared__ float smem[];
  float* s_c = smem;                    // [7, T]
  float* s_cond = s_c + 7 * T;          // scale[5], shift[5]
  float* s_lens = s_cond + 10;          // PoLens
  int8_t* s_e = (int8_t*)(s_lens + 8);  // [T, 5]
  block_load(s_c, g_c, 7 * T);
  block_load(s_cond, cond, 10);
  block_load(s_lens, lensc, 8);
  block_load(s_e, g_e, 5 * T);
  __syncthreads();

  const PoLens L{s_lens[0], s_lens[1], s_lens[2], s_lens[3],
                 s_lens[4], s_lens[5], s_lens[6], s_lens[7]};
  const float scale[4] = {s_cond[0], s_cond[1], s_cond[2], s_cond[3]};
  const float shift[4] = {s_cond[5], s_cond[6], s_cond[7], s_cond[8]};

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float ul = (lam[i] - s_cond[9]) * s_cond[4];
    float s[4];
    const float tr = po_backward_solve(s_e, s_c, T, scale, shift, ul, L,
                                       chart, iterations, px[i], py[i], pz[i],
                                       ax[i], ay[i], s);
    sx[i] = s[0];
    sy[i] = s[1];
    sdx[i] = s[2];
    sdy[i] = s[3];
    trans[i] = tr;
  }
}

}  // namespace pota

extern "C" int pota_po_backward(const float* px, const float* py,
                                const float* pz, const float* ax,
                                const float* ay, const float* lam, int n,
                                const int8_t* exps, const float* coeffs,
                                int T, const float* cond, const float* lensc,
                                int chart, int iterations, float* sx,
                                float* sy, float* sdx, float* sdy,
                                float* trans, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * (7 * (size_t)T + 10 + 8) + 5 * (size_t)T;
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  pota::po_backward_kernel<<<pota::grid_for(n, threads), threads, smem,
                             stream>>>(px, py, pz, ax, ay, lam, n, exps,
                                       coeffs, T, cond, lensc, chart,
                                       iterations, sx, sy, sdx, sdy, trans);
  return (int)cudaGetLastError();
}
