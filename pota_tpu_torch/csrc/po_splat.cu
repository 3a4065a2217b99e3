// PO splat kernel (K3 and K3b): the whole per-slot program of the
// bidirectional redistribution, in three instantiations chosen at compile
// time (SplatMode):
//   SPLAT_DISK      in-kernel disk sample, the frame's one wavelength (K3,
//                   the flagship);
//   SPLAT_DISK_LAM  in-kernel disk sample, a wavelength per slot (K3b, the
//                   chromatic splat);
//   SPLAT_EXTERNAL  the aperture point per slot, and the wavelength per slot
//                   or the frame's (K3b, image bokeh and blade apertures).
//
// Replaces: pota_tpu/ops/po_pallas.py::build_po_splat_kernel with
// sample_aperture=True (K3), lam_input=True and sample_aperture=False (K3b),
// and its helpers _emit_backward_solve, _solve4, _tea_lcg2,
// _tea_concentric_disk.
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
// six polynomial rows and their Jacobian over the 126-monomial basis
// (2,436 FMAs), plus the chart and a blocked 4x4 solve; the slot's memory
// traffic is 40-44 bytes in, 5 bytes out.
//
// Design: one thread per slot, a grid-stride loop, 256 threads a block.
// Steps 2-3 are po_basis_solve (po_solve_basis.cuh) on a solve table that
// po_kernels.py fold_solve_tables folds at one wavelength.  A frame has one
// wavelength, or under chroma three fixed ones
// (render/splat.py::chroma_wavelengths), so the chromatic instantiations
// take one to three tables in shared memory (10,784 bytes each) and an
// optional int32 table index per slot (the chroma channel), as K6 does;
// SPLAT_DISK takes one table and no index.  A chromatic queue gives each
// budget unit three consecutive slots, one per channel, so slot q has
// channel q % 3 wherever its source's range starts on a multiple of 3.  With
// an index, thread i therefore takes slot 96 * (i / 96) + 3 * (i % 32) +
// (i / 32) % 3: each warp's 32 slots are of one channel and read one table,
// where consecutive slots would put all three tables' addresses into every
// warp's 16-byte loads.  Correctness never depends on the channel pattern:
// each slot reads its own index.  The sphere table and the frame's
// parameters are runtime data in shared memory: one build serves every
// lens and scene.
#include "po_solve_basis.cuh"

namespace pota {

enum SplatMode : int { SPLAT_DISK = 0, SPLAT_DISK_LAM = 1, SPLAT_EXTERNAL = 2 };

// Threads per block: each block's load of the folded tables serves 256
// slots a round; at ~126 registers that is 2 blocks (16 warps) an SM.
constexpr int kSplatThreads = 256;
// The slot group of channel-uniform warps: three warps, one per channel.
constexpr int kChannelGroup = 96;

// a_in / b_in: (seed, counter) uint32 words in the disk modes, the aperture
// point (mm) in SPLAT_EXTERNAL.  g_tab: n_tab folded solve tables
// (basis::kTableFloats floats each); table_idx: int32 [n] in [0, n_tab), or
// null for one table (always null in SPLAT_DISK).
template <int MODE>
__global__ void __launch_bounds__(kSplatThreads)
po_splat_kernel(const float* __restrict__ pcx, const float* __restrict__ pcy,
                const float* __restrict__ pcz, const float* __restrict__ pwx,
                const float* __restrict__ pwy, const float* __restrict__ pwz,
                const void* __restrict__ a_in, const void* __restrict__ b_in,
                const int* __restrict__ table_idx,
                const float* __restrict__ sky, int n,
                const float* __restrict__ g_tab, int n_tab,
                const float* __restrict__ lensc, int chart, int iterations,
                const float* __restrict__ g_par,
                const float* __restrict__ g_sph, int n_sph,
                int* __restrict__ lin_out, uint8_t* __restrict__ ok_out) {
  extern __shared__ __align__(16) float smem[];
  float* s_tab = smem;                                 // [n_tab, kTableFloats]
  float* s_sph = s_tab + n_tab * basis::kTableFloats;  // [n_sph, 4]
  float* s_par = s_sph + 4 * n_sph;                    // [32]
  float* s_lens = s_par + SP_COUNT;                    // PoLens
  block_load(s_tab, g_tab, n_tab * basis::kTableFloats);
  block_load(s_sph, g_sph, 4 * n_sph);
  block_load(s_par, g_par, (int)SP_COUNT);
  block_load(s_lens, lensc, 8);
  __syncthreads();

  const PoLens L{s_lens[0], s_lens[1], s_lens[2], s_lens[3],
                 s_lens[4], s_lens[5], s_lens[6], s_lens[7]};
  const float ap_radius = s_par[SP_AP_RADIUS];
  // with an index, the thread count rounds up to whole channel groups
  const bool by_channel = MODE != SPLAT_DISK && table_idx != nullptr;
  const int n_threads =
      by_channel ? (n + kChannelGroup - 1) / kChannelGroup * kChannelGroup : n;

  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n_threads;
       t += gridDim.x * blockDim.x) {
    int i = t;
    const float* tab = s_tab;
    if constexpr (MODE != SPLAT_DISK) {
      if (by_channel) {
        i = t / kChannelGroup * kChannelGroup + 3 * (t % 32) + (t / 32) % 3;
        if (i >= n) continue;
        tab = s_tab + table_idx[i] * basis::kTableFloats;
      }
    }
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
    const float tr =
        po_basis_solve(tab, L, chart, iterations, px, py, pz, ax, ay, s);

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
                           const void* a, const void* b, const int* table_idx,
                           const float* sky, int n, const float* tables,
                           int n_tables, const float* lensc, int chart,
                           int iterations, const float* params,
                           const float* spheres, int n_spheres, int* lin,
                           uint8_t* ok, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_tables < 1 || n_tables > pota::kMaxSolveTables ||
      (n_tables > 1 && table_idx == nullptr) ||
      (MODE == pota::SPLAT_DISK && table_idx != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)n_tables * pota::basis::kTableFloats +
                       4 * (size_t)n_spheres + pota::SP_COUNT + 8);
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  constexpr int threads = pota::kSplatThreads;
  pota::po_splat_kernel<MODE>
      <<<pota::grid_for(n, threads), threads, smem, stream>>>(
          pcx, pcy, pcz, pwx, pwy, pwz, a, b, table_idx, sky, n, tables,
          n_tables, lensc, chart, iterations, params, spheres, n_spheres, lin,
          ok);
  return (int)cudaGetLastError();
}

// The three entry points take the same arguments.  tables: n_tables folded
// solve tables (po_kernels.py fold_solve_tables, pota::basis::kTableFloats
// floats each), one after another; table_idx: int32 [n] in [0, n_tables),
// or null for one table.  K3 (pota_po_splat) takes one table and no index.
#define POTA_PO_SPLAT_ENTRY(NAME, MODE, A_TYPE)                              \
  extern "C" int NAME(const float* pcx, const float* pcy, const float* pcz, \
                      const float* pwx, const float* pwy, const float* pwz, \
                      const A_TYPE* a, const A_TYPE* b, const int* table_idx, \
                      const float* sky, int n, const float* tables,          \
                      int n_tables, const float* lensc, int chart,           \
                      int iterations, const float* params,                   \
                      const float* spheres, int n_spheres, int* lin,         \
                      uint8_t* ok, cudaStream_t stream) {                    \
    return launch_po_splat<MODE>(pcx, pcy, pcz, pwx, pwy, pwz, a, b,         \
                                 table_idx, sky, n, tables, n_tables, lensc, \
                                 chart, iterations, params, spheres,         \
                                 n_spheres, lin, ok, stream);                \
  }

// a / b: (seed, counter) uint32 words, or the aperture point (mm)
POTA_PO_SPLAT_ENTRY(pota_po_splat, pota::SPLAT_DISK, uint32_t)
POTA_PO_SPLAT_ENTRY(pota_po_splat_lam, pota::SPLAT_DISK_LAM, uint32_t)
POTA_PO_SPLAT_ENTRY(pota_po_splat_ext, pota::SPLAT_EXTERNAL, float)
