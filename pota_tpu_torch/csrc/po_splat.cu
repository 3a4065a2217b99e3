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
// the 160-term polynomial for six outputs with four tangents each
// (6 x 5 FMAs per term) plus the chart and a blocked 4x4 solve; the slot's
// memory traffic is 40 bytes in, 5 bytes out.
//
// Design: one thread per slot, a grid-stride loop.  The Jacobian is taken
// by forward mode, the counterpart of jax.linearize in the TPU kernel: the
// polynomial accumulates (value, d/dx, d/dy, d/ddx, d/ddy) from per-term
// powers and their derivatives, and a small dual type (D4) carries the
// tangents through the pupil chart and the residual.  The guards
// (safe sqrt, sqrt floor, |d2| < 1e-9) have zero tangents on their clamped
// branches, as JAX's `where` does.  The polynomial (int8 exponents, the
// [7, T] coefficient rows apx, apy, o0..o3, trans) and the sphere table are
// runtime data in shared memory: one build serves every lens and scene.
// The pupil chart (sphere / cyl-x / cyl-y) is a runtime switch.  In the
// per-slot-wavelength modes the conditioned wavelength is per thread; the
// flagship keeps it block-uniform, out of the slot loop, which holds its
// register count at 126.
#include "common.cuh"

namespace pota {

struct SplatLens {
  float R, R2, absR, r_outer2, front_z, bfl, inv_ap_z, r_inner2;
};

enum : int { CHART_SPHERE = 0, CHART_CYL_X = 1, CHART_CYL_Y = 2 };

enum SplatMode : int { SPLAT_DISK = 0, SPLAT_DISK_LAM = 1, SPLAT_EXTERNAL = 2 };

// Rows 0..5 (apx, apy, o0..o3) of the shared-term polynomial with tangents
// along the raw unknowns.  u[] are the conditioned unknowns, ul the
// conditioned wavelength, sc the conditioning scales of the unknowns.
__device__ __forceinline__ void poly6_d4(const int8_t* __restrict__ se,
                                         const float* __restrict__ sc_rows,
                                         int T, const float u[4], float ul,
                                         const float scale[4], D4 out[6]) {
  float acc[6][5];
#pragma unroll
  for (int o = 0; o < 6; ++o)
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[o][k] = 0.0f;

  for (int t = 0; t < T; ++t) {
    const int8_t* e = se + 5 * t;
    float p[4], q[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ev = e[v];
      const float pm1 = ipow(u[v], ev > 0 ? ev - 1 : 0);
      p[v] = ev ? pm1 * u[v] : 1.0f;
      q[v] = ev ? pm1 * (float)ev : 0.0f;
    }
    const float pl = ipow(ul, e[4]);
    const float mono = p[0] * p[1] * p[2] * p[3] * pl;
    const float p01 = p[0] * p[1];
    const float p23 = p[2] * p[3];
    const float g[4] = {q[0] * p[1] * p23 * pl, p[0] * q[1] * p23 * pl,
                        p01 * q[2] * p[3] * pl, p01 * p[2] * q[3] * pl};
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      const float c = sc_rows[o * T + t];
      acc[o][0] += c * mono;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[o][k + 1] += c * g[k];
    }
  }
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    out[o].v = acc[o][0];
#pragma unroll
    for (int k = 0; k < 4; ++k) out[o].d[k] = acc[o][k + 1] * scale[k];
  }
}

// Outer-pupil chart -> camera-space exit ray (po_pallas.py exit_ray):
// returns the chart's z position and the direction.
__device__ __forceinline__ void exit_ray(int chart, const SplatLens& L,
                                         const D4& o0, const D4& o1,
                                         const D4& o2, const D4& o3, D4& qz,
                                         D4& d0, D4& d1, D4& d2) {
  const D4 tz = dsafe_sqrt(1.0f - (o2 * o2 + o3 * o3));
  D4 nz;
  if (chart == CHART_SPHERE) {
    const D4 r2 = o0 * o0 + o1 * o1;
    nz = dsafe_sqrt(L.R2 - r2) / L.absR;
    const D4 n0 = o0 / L.R;
    const D4 n1 = o1 / L.R;
    // tangent frame: ex = normalize((nz, 0, -n0)); ey = n x ex
    const D4 inv_exn = recip(dsqrt_floor(nz * nz + n0 * n0, 1e-24f));
    const D4 e0 = nz * inv_exn;
    const D4 e2 = -n0 * inv_exn;
    const D4 f0 = n1 * e2;
    const D4 f1 = nz * e0 - n0 * e2;
    const D4 f2 = -n1 * e0;
    d0 = o2 * e0 + o3 * f0 + tz * n0;
    d1 = o3 * f1 + tz * n1;
    d2 = o2 * e2 + o3 * f2 + tz * nz;
  } else if (chart == CHART_CYL_Y) {  // cylinder axis along y
    nz = dsafe_sqrt(L.R2 - o0 * o0) / L.absR;
    const D4 n0 = o0 / L.R;
    d0 = o2 * nz + tz * n0;
    d1 = o3;
    d2 = -o2 * n0 + tz * nz;
  } else {  // cyl-x: cylinder axis along x
    nz = dsafe_sqrt(L.R2 - o1 * o1) / L.absR;
    const D4 n1 = o1 / L.R;
    d0 = o2;
    d1 = o3 * nz + tz * n1;
    d2 = -o3 * n1 + tz * nz;
  }
  qz = nz * L.R - L.R;
}

// Blocked 4x4 solve (Schur complement over the leading 2x2 block), in the
// operation order of po_pallas.py _solve4.
__device__ __forceinline__ void solve4(const float J[4][4], const float r[4],
                                       float x[4]) {
  const float a = J[0][0], b = J[0][1], c = J[1][0], d = J[1][1];
  float detA = a * d - b * c;
  detA = fabsf(detA) < 1e-12f ? 1e-12f : detA;
  const float ia00 = d / detA, ia01 = -b / detA;
  const float ia10 = -c / detA, ia11 = a / detA;
  const float B00 = J[0][2], B01 = J[0][3], B10 = J[1][2], B11 = J[1][3];
  const float C00 = J[2][0], C01 = J[2][1], C10 = J[3][0], C11 = J[3][1];
  const float ab00 = ia00 * B00 + ia01 * B10;
  const float ab01 = ia00 * B01 + ia01 * B11;
  const float ab10 = ia10 * B00 + ia11 * B10;
  const float ab11 = ia10 * B01 + ia11 * B11;
  const float s00 = J[2][2] - (C00 * ab00 + C01 * ab10);
  const float s01 = J[2][3] - (C00 * ab01 + C01 * ab11);
  const float s10 = J[3][2] - (C10 * ab00 + C11 * ab10);
  const float s11 = J[3][3] - (C10 * ab01 + C11 * ab11);
  const float av0 = ia00 * r[0] + ia01 * r[1];
  const float av1 = ia10 * r[0] + ia11 * r[1];
  const float rh0 = r[2] - (C00 * av0 + C01 * av1);
  const float rh1 = r[3] - (C10 * av0 + C11 * av1);
  float dets = s00 * s11 - s01 * s10;
  dets = fabsf(dets) < 1e-12f ? 1e-12f : dets;
  x[2] = (s11 * rh0 - s01 * rh1) / dets;
  x[3] = (-s10 * rh0 + s00 * rh1) / dets;
  const float t0 = r[0] - (B00 * x[2] + B01 * x[3]);
  const float t1 = r[1] - (B10 * x[2] + B11 * x[3]);
  x[0] = ia00 * t0 + ia01 * t1;
  x[1] = ia10 * t0 + ia11 * t1;
}

// a_in / b_in: (seed, counter) uint32 words in the disk modes, the aperture
// point (mm) in SPLAT_EXTERNAL; lam_in: the per-slot wavelength (um), unused
// by SPLAT_DISK
template <int MODE>
__global__ void __launch_bounds__(128)
po_splat_kernel(const float* __restrict__ pcx, const float* __restrict__ pcy,
                const float* __restrict__ pcz, const float* __restrict__ pwx,
                const float* __restrict__ pwy, const float* __restrict__ pwz,
                const void* __restrict__ a_in, const void* __restrict__ b_in,
                const float* __restrict__ lam_in, const float* __restrict__ sky,
                int n, const int8_t* __restrict__ g_e,
                const float* __restrict__ g_c, int T,
                const float* __restrict__ cond, const float* __restrict__ lensc,
                int chart, int iterations, const float* __restrict__ g_par,
                const float* __restrict__ g_sph, int n_sph,
                int* __restrict__ lin_out, uint8_t* __restrict__ ok_out) {
  extern __shared__ float smem[];
  float* s_c = smem;                    // [7, T]
  float* s_sph = s_c + 7 * T;           // [n_sph, 4]
  float* s_par = s_sph + 4 * n_sph;     // [32]
  float* s_cond = s_par + SP_COUNT;     // scale[5], shift[5]
  float* s_lens = s_cond + 10;          // SplatLens
  int8_t* s_e = (int8_t*)(s_lens + 8);  // [T, 5]
  block_load(s_c, g_c, 7 * T);
  block_load(s_sph, g_sph, 4 * n_sph);
  block_load(s_par, g_par, (int)SP_COUNT);
  block_load(s_cond, cond, 10);
  block_load(s_lens, lensc, 8);
  block_load(s_e, g_e, 5 * T);
  __syncthreads();

  const SplatLens L{s_lens[0], s_lens[1], s_lens[2], s_lens[3],
                    s_lens[4], s_lens[5], s_lens[6], s_lens[7]};
  const float scale[4] = {s_cond[0], s_cond[1], s_cond[2], s_cond[3]};
  const float shift[4] = {s_cond[5], s_cond[6], s_cond[7], s_cond[8]};
  const float ap_radius = s_par[SP_AP_RADIUS];
  const float ul_frame = (s_par[SP_LAMBDA] - s_cond[9]) * s_cond[4];

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
    float ul = ul_frame;
    if constexpr (MODE != SPLAT_DISK) ul = (lam_in[i] - s_cond[9]) * s_cond[4];

    // backward target is -p_cam * 10 (ref src/lentil_filter.cpp:271)
    const float px = pcx[i] * -10.0f;
    const float py = pcy[i] * -10.0f;
    const float pz = pcz[i] * -10.0f;

    // chief-ray init
    const float pz_safe = fabsf(pz) < 1e-6f ? 1e-6f : pz;
    float s[4];
    s[0] = -px * L.bfl / pz_safe;
    s[1] = -py * L.bfl / pz_safe;
    s[2] = (ax - s[0]) * L.inv_ap_z;
    s[3] = (ay - s[1]) * L.inv_ap_z;

    for (int it = 0; it < iterations; ++it) {
      float u[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) u[v] = (s[v] - shift[v]) * scale[v];
      D4 o[6];
      poly6_d4(s_e, s_c, T, u, ul, scale, o);
      D4 qz, d0, d1, d2;
      exit_ray(chart, L, o[2], o[3], o[4], o[5], qz, d0, d1, d2);
      const D4 dz = fabsf(d2.v) < 1e-9f ? dconst(1e-9f) : d2;
      const D4 t = (pz - (qz + L.front_z)) / dz;
      const D4 r2 = o[2] + t * d0 - px;
      const D4 r3 = o[3] + t * d1 - py;
      const float r[4] = {o[0].v - ax, o[1].v - ay, r2.v, r3.v};
      float J[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        J[0][j] = o[0].d[j];
        J[1][j] = o[1].d[j];
        J[2][j] = r2.d[j];
        J[3][j] = r3.d[j];
      }
      float dxs[4];
      solve4(J, r, dxs);
#pragma unroll
      for (int v = 0; v < 4; ++v) s[v] = s[v] - dxs[v];
    }

    // final evaluation: outer-pupil position and transmittance
    float o0 = 0.f, o1 = 0.f, tr = 0.f;
    {
      float u[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) u[v] = (s[v] - shift[v]) * scale[v];
      for (int t = 0; t < T; ++t) {
        const int8_t* e = s_e + 5 * t;
        const float m = ipow(u[0], e[0]) * ipow(u[1], e[1]) *
                        ipow(u[2], e[2]) * ipow(u[3], e[3]) * ipow(ul, e[4]);
        o0 += m * s_c[2 * T + t];
        o1 += m * s_c[3 * T + t];
        tr += m * s_c[6 * T + t];
      }
    }
    tr = relu_nan(tr);
    if (o0 * o0 + o1 * o1 > L.r_outer2) tr = 0.0f;

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
                           const float* sky, int n, const int8_t* exps,
                           const float* coeffs, int T, const float* cond,
                           const float* lensc, int chart, int iterations,
                           const float* params, const float* spheres,
                           int n_spheres, int* lin, uint8_t* ok,
                           cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * (7 * (size_t)T + 4 * (size_t)n_spheres +
                                       pota::SP_COUNT + 10 + 8) +
                      5 * (size_t)T;
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  pota::po_splat_kernel<MODE>
      <<<pota::grid_for(n, threads), threads, smem, stream>>>(
          pcx, pcy, pcz, pwx, pwy, pwz, a, b, lam, sky, n, exps, coeffs, T,
          cond, lensc, chart, iterations, params, spheres, n_spheres, lin, ok);
  return (int)cudaGetLastError();
}

extern "C" int pota_po_splat(const float* pcx, const float* pcy, const float* pcz,
                             const float* pwx, const float* pwy, const float* pwz,
                             const uint32_t* seed, const uint32_t* ctr,
                             const float* sky, int n, const int8_t* exps,
                             const float* coeffs, int T, const float* cond,
                             const float* lensc, int chart, int iterations,
                             const float* params, const float* spheres,
                             int n_spheres, int* lin, uint8_t* ok,
                             cudaStream_t stream) {
  return launch_po_splat<pota::SPLAT_DISK>(
      pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, nullptr, sky, n, exps, coeffs,
      T, cond, lensc, chart, iterations, params, spheres, n_spheres, lin, ok,
      stream);
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
      pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, lam, sky, n, exps, coeffs, T,
      cond, lensc, chart, iterations, params, spheres, n_spheres, lin, ok,
      stream);
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
      pcx, pcy, pcz, pwx, pwy, pwz, ax, ay, lam, sky, n, exps, coeffs, T,
      cond, lensc, chart, iterations, params, spheres, n_spheres, lin, ok,
      stream);
}
