// PO splat kernel (K3): the whole per-slot program of the bidirectional
// redistribution, in three variants chosen at compile time (SplatMode):
//   SPLAT_DISK      in-kernel disk sample, one wavelength (the flagship);
//   SPLAT_DISK_LAM  in-kernel disk sample, a wavelength per slot (chroma);
//   SPLAT_EXTERNAL  aperture point and wavelength per slot (image bokeh,
//                   blade apertures).
//
// Replaces: pota_tpu/ops/po_pallas.py::build_po_splat_kernel with
// sample_aperture=True, lam_input=False / True, and sample_aperture=False
// (and its helpers _emit_backward_solve, _solve4, _tea_lcg2,
// _tea_concentric_disk).
//
// Per queue slot:
//   1. the aperture point: a TEA-8/LCG concentric-disk sample from
//      (seed, counter) scaled by the aperture radius (bit-exact uniforms),
//      or the slot's own point;
//   2. a fixed-iteration 4x4 Newton for the sensor (x, y, dx, dy) whose ray
//      crosses the iris at that point and lands on -10 * p_cam: chief-ray
//      init, residual through the outer-pupil chart;
//   3. trans > 0, outer-pupil crop (inside the solve) and inner-pupil crop;
//   4. sensor-shift compensation and the linear pixel index;
//   5. the sphere-scene segment-occlusion probe from the world lens point.
// Returns (lin int32, ok uint8).
//
// What bounds it on the H100: arithmetic.  Each Newton iteration evaluates
// six polynomial rows with four tangents each, plus the chart and a blocked
// 4x4 solve; the slot's memory traffic is 40 bytes in, 5 bytes out.
//
// Design: one thread per slot, a grid-stride loop.  Steps 2-3 are the
// backward solve.  SPLAT_DISK, whose slots share the frame's wavelength,
// runs po_basis_solve (po_solve_basis.cuh): the polynomial folded at that
// wavelength onto the compile-time degree-5 basis, its Jacobian rows
// tabulated, both walked fully unrolled from shared memory.  The
// per-slot-wavelength modes run po_backward_solve (po_solve.cuh): the
// runtime term set (int8 exponents, the [7, T] coefficient
// rows apx, apy, o0..o3, trans) with forward-mode tangents.  A small dual
// type (D4) carries the tangents through the pupil chart and the residual
// in both.  The tables and the sphere table are runtime data in shared
// memory: one build serves every lens and scene.
#include "po_solve_basis.cuh"

namespace pota {

enum SplatMode : int { SPLAT_DISK = 0, SPLAT_DISK_LAM = 1, SPLAT_EXTERNAL = 2 };

// Threads per block.  SPLAT_DISK takes 256, so each block's load of the
// 10.8 KB folded table serves twice the slots; at its 126 registers that is
// 2 blocks (16 warps) an SM, as 4 blocks of 128 would be.
constexpr int kDiskThreads = 256;
__host__ __device__ constexpr int splat_threads(int mode) {
  return mode == SPLAT_DISK ? kDiskThreads : 128;
}

// a_in / b_in: (seed, counter) uint32 words in the disk modes, the aperture
// point (mm) in SPLAT_EXTERNAL; lam_in: the per-slot wavelength (um), unused
// by SPLAT_DISK.  g_tab: SPLAT_DISK's folded table (basis::kTableFloats
// floats), else the [7, T] coefficient rows with the int8 exponents g_e
// [T, 5] and the conditioning cond (scale[5], shift[5]).
template <int MODE>
__global__ void __launch_bounds__(splat_threads(MODE))
po_splat_kernel(const float* __restrict__ pcx, const float* __restrict__ pcy,
                const float* __restrict__ pcz, const float* __restrict__ pwx,
                const float* __restrict__ pwy, const float* __restrict__ pwz,
                const void* __restrict__ a_in, const void* __restrict__ b_in,
                const float* __restrict__ lam_in, const float* __restrict__ sky,
                int n, const float* __restrict__ g_tab, int n_tab,
                const int8_t* __restrict__ g_e, int T,
                const float* __restrict__ cond, const float* __restrict__ lensc,
                int chart, int iterations, const float* __restrict__ g_par,
                const float* __restrict__ g_sph, int n_sph,
                int* __restrict__ lin_out, uint8_t* __restrict__ ok_out) {
  extern __shared__ __align__(16) float smem[];
  float* s_tab = smem;                  // n_tab
  float* s_sph = s_tab + n_tab;         // [n_sph, 4]
  float* s_par = s_sph + 4 * n_sph;     // [32]
  float* s_lens = s_par + SP_COUNT;     // PoLens
  float* s_cond = s_lens + 8;           // scale[5], shift[5]
  int8_t* s_e = (int8_t*)(s_cond + 10);  // [T, 5]
  block_load(s_tab, g_tab, n_tab);
  block_load(s_sph, g_sph, 4 * n_sph);
  block_load(s_par, g_par, (int)SP_COUNT);
  block_load(s_lens, lensc, 8);
  if constexpr (MODE != SPLAT_DISK) {
    block_load(s_cond, cond, 10);
    block_load(s_e, g_e, 5 * T);
  }
  __syncthreads();

  const PoLens L{s_lens[0], s_lens[1], s_lens[2], s_lens[3],
                 s_lens[4], s_lens[5], s_lens[6], s_lens[7]};
  const float ap_radius = s_par[SP_AP_RADIUS];

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float ax, ay;
    if constexpr (MODE == SPLAT_EXTERNAL) {
      ax = static_cast<const float*>(a_in)[i];
      ay = static_cast<const float*>(b_in)[i];
    } else {
      float ux_, uy_;
      tea_concentric_disk(static_cast<const uint32_t*>(a_in)[i],
                          static_cast<const uint32_t*>(b_in)[i], ux_, uy_);
      ax = ux_ * ap_radius;
      ay = uy_ * ap_radius;
    }

    // backward target is -p_cam * 10 (ref src/lentil_filter.cpp:271)
    const float px = pcx[i] * -10.0f;
    const float py = pcy[i] * -10.0f;
    const float pz = pcz[i] * -10.0f;

    float s[4];
    float tr;
    if constexpr (MODE == SPLAT_DISK) {
      tr = po_basis_solve(s_tab, L, chart, iterations, px, py, pz, ax, ay, s);
    } else {
      const float scale[4] = {s_cond[0], s_cond[1], s_cond[2], s_cond[3]};
      const float shift[4] = {s_cond[5], s_cond[6], s_cond[7], s_cond[8]};
      const float ul = (lam_in[i] - s_cond[9]) * s_cond[4];
      tr = po_backward_solve(s_e, s_tab, T, scale, shift, ul, L, chart,
                             iterations, px, py, pz, ax, ay, s);
    }

    const float x = s[0], y = s[1], dx = s[2], dy = s[3];
    const float ipx = x + dx * L.bfl;
    const float ipy = y + dy * L.bfl;
    const bool inner_ok = ipx * ipx + ipy * ipy <= L.r_inner2;

    const float sh = s_par[SP_SHIFT];
    const float hsw = s_par[SP_HSW];
    const float sx = (x + dx * -sh) / hsw;
    const float sy = (y + dy * -sh) / hsw * s_par[SP_ASPECT];
    const float pixel_x = (sx + 1.0f) * 0.5f * s_par[SP_XRES] - s_par[SP_RMINX];
    const float pixel_y = (-sy + 1.0f) * 0.5f * s_par[SP_YRES] - s_par[SP_RMINY];
    const float xr = s_par[SP_XRES_R];
    const float yr = s_par[SP_YRES_R];
    const bool in_bounds = (pixel_x >= 0.0f) && (pixel_x < xr) &&
                           (pixel_y >= 0.0f) && (pixel_y < yr);
    const float lin = floor_clip(pixel_y, yr - 1.0f) * xr +
                      floor_clip(pixel_x, xr - 1.0f);
    lin_out[i] = isfinite(lin) ? (int)lin : 0;

    // occlusion probe from the world lens point: -ap * 0.1 (mm -> cm),
    // 1/unit like the reference's per-unit rescale, then cam_to_world
    const float inv_unit = s_par[SP_INV_UNIT];
    float cwx, cwy, cwz;
    lens_point_ws(s_par, -ax * 0.1f * inv_unit, -ay * 0.1f * inv_unit, cwx,
                  cwy, cwz);
    const bool occ = occluded_spheres(pwx[i], pwy[i], pwz[i], cwx, cwy, cwz,
                                      s_sph, n_sph) &&
                     (sky[i] < 0.5f);

    ok_out[i] = (tr > 0.0f) && inner_ok && in_bounds && !occ;
  }
}

}  // namespace pota

template <int MODE>
static int launch_po_splat(const float* pcx, const float* pcy, const float* pcz,
                           const float* pwx, const float* pwy, const float* pwz,
                           const void* a, const void* b, const float* lam,
                           const float* sky, int n, const float* tab,
                           int n_tab, const int8_t* exps, int T,
                           const float* cond, const float* lensc, int chart,
                           int iterations, const float* params,
                           const float* spheres, int n_spheres, int* lin,
                           uint8_t* ok, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * ((size_t)n_tab + 4 * (size_t)n_spheres +
                                       pota::SP_COUNT + 8 + 10) +
                      5 * (size_t)T;
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  constexpr int threads = pota::splat_threads(MODE);
  pota::po_splat_kernel<MODE>
      <<<pota::grid_for(n, threads), threads, smem, stream>>>(
          pcx, pcy, pcz, pwx, pwy, pwz, a, b, lam, sky, n, tab, n_tab, exps,
          T, cond, lensc, chart, iterations, params, spheres, n_spheres, lin,
          ok);
  return (int)cudaGetLastError();
}

// table: the folded solve table of the frame's wavelength
// (po_kernels.py fold_solve_tables, pota::basis::kTableFloats floats)
extern "C" int pota_po_splat(const float* pcx, const float* pcy, const float* pcz,
                             const float* pwx, const float* pwy, const float* pwz,
                             const uint32_t* seed, const uint32_t* ctr,
                             const float* sky, int n, const float* table,
                             const float* lensc, int chart, int iterations,
                             const float* params, const float* spheres,
                             int n_spheres, int* lin, uint8_t* ok,
                             cudaStream_t stream) {
  return launch_po_splat<pota::SPLAT_DISK>(
      pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, nullptr, sky, n, table,
      pota::basis::kTableFloats, nullptr, 0, nullptr, lensc, chart,
      iterations, params, spheres, n_spheres, lin, ok, stream);
}

extern "C" int pota_po_splat_lam(const float* pcx, const float* pcy,
                                 const float* pcz, const float* pwx,
                                 const float* pwy, const float* pwz,
                                 const uint32_t* seed, const uint32_t* ctr,
                                 const float* lam, const float* sky, int n,
                                 const int8_t* exps, const float* coeffs,
                                 int T, const float* cond, const float* lensc,
                                 int chart, int iterations,
                                 const float* params, const float* spheres,
                                 int n_spheres, int* lin, uint8_t* ok,
                                 cudaStream_t stream) {
  return launch_po_splat<pota::SPLAT_DISK_LAM>(
      pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, lam, sky, n, coeffs, 7 * T,
      exps, T, cond, lensc, chart, iterations, params, spheres, n_spheres,
      lin, ok, stream);
}

extern "C" int pota_po_splat_ext(const float* pcx, const float* pcy,
                                 const float* pcz, const float* pwx,
                                 const float* pwy, const float* pwz,
                                 const float* ax, const float* ay,
                                 const float* lam, const float* sky, int n,
                                 const int8_t* exps, const float* coeffs,
                                 int T, const float* cond, const float* lensc,
                                 int chart, int iterations,
                                 const float* params, const float* spheres,
                                 int n_spheres, int* lin, uint8_t* ok,
                                 cudaStream_t stream) {
  return launch_po_splat<pota::SPLAT_EXTERNAL>(
      pcx, pcy, pcz, pwx, pwy, pwz, ax, ay, lam, sky, n, coeffs, 7 * T, exps,
      T, cond, lensc, chart, iterations, params, spheres, n_spheres, lin, ok,
      stream);
}
