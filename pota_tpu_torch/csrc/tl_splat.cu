// Thin-lens splat kernel (K5): the per-slot program of the bidirectional
// redistribution for the extended thin lens without coma, chromatic
// aberration, optical vignetting, distortion, image bokeh or blades.
//
// Replaces: pota_tpu/ops/po_pallas.py::build_tl_splat_kernel (and its
// helpers _tea_concentric_disk_aberrated, _occlude_spheres).
//
// Per queue slot:
//   1. a TEA-8/LCG concentric-disk aperture sample from (seed, counter)
//      (bit-exact uniforms) with the spherical-aberration bias and the
//      squircle lerp, the anamorphic squeeze, times the aperture radius;
//   2. the thin-lens image distance of the slot's depth, the ray from the
//      lens point through the image point to the focus plane, and its
//      projection to the sensor;
//   3. the in-region test and the linear pixel index;
//   4. the sphere-scene segment-occlusion probe from the world lens point.
// Returns (lin int32, ok uint8).
//
// What bounds it on the H100: near the balance point.  A slot reads 36
// bytes and writes 5, against a few hundred instructions (TEA-8, about ten
// divisions, exp/log, sin/cos, 8 iterations of the sphere loop for the
// teapot); the card does about 20 f32 operations per byte of memory.
//
// Design: one thread per slot, a grid-stride loop, the params row and the
// sphere table in shared memory (as K3).  The TPU kernel bakes the
// spherical-aberration and squircle strengths in as immediates, one compile
// per setting; here they are runtime scalars (the bias flag, its exponent
// log(abb_spherical) / log(0.5) formed in double on the host, and c2s), so
// one build serves every setting.
#include "common.cuh"

namespace pota {

__global__ void __launch_bounds__(256)
tl_splat_kernel(const float* __restrict__ pcx, const float* __restrict__ pcy,
                const float* __restrict__ pcz, const float* __restrict__ pwx,
                const float* __restrict__ pwy, const float* __restrict__ pwz,
                const uint32_t* __restrict__ seeds,
                const uint32_t* __restrict__ ctrs, const float* __restrict__ sky,
                int n, int bias, float expo, float c2s,
                const float* __restrict__ g_par, const float* __restrict__ g_sph,
                int n_sph, int* __restrict__ lin_out,
                uint8_t* __restrict__ ok_out) {
  extern __shared__ float smem[];
  float* s_sph = smem;               // [n_sph, 4]
  float* s_par = s_sph + 4 * n_sph;  // [32]
  block_load(s_sph, g_sph, 4 * n_sph);
  block_load(s_par, g_par, (int)SP_COUNT);
  __syncthreads();

  const float anam = s_par[SP_TL_ANAM];
  const float apr = s_par[SP_TL_APR];
  const float f = s_par[SP_TL_F];
  const float idfd = s_par[SP_TL_IDFD];
  const float sens = -f / s_par[SP_HSW];
  const float aspect = s_par[SP_ASPECT];
  const float xr = s_par[SP_XRES_R];
  const float yr = s_par[SP_YRES_R];
  const float inv_unit = s_par[SP_INV_UNIT];

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float ux, uy;
    tea_concentric_disk_aberrated(seeds[i], ctrs[i], bias != 0, expo, c2s,
                                  ux, uy);
    ux = ux * anam;
    const float lx = ux * apr;
    const float ly = uy * apr;

    const float px = pcx[i], py = pcy[i], pz = pcz[i];
    // image distance of the sample depth (ref src/lentil.h:665-671)
    const float ids = (-f * pz) / (-f + pz);
    const float pn = sqrtf(fmaxf(px * px + py * py + pz * pz, 1e-24f));
    const float dfcz = pz / pn;
    const float t_sp = fabsf(ids / dfcz);
    const float dlx = (px / pn) * t_sp - lx;
    const float dly = (py / pn) * t_sp - ly;
    const float dlz = dfcz * t_sp;
    // focus-plane point lens + dl * |idfd / dlz| (the norms of dl cancel)
    const float s = fabsf(idfd / (fabsf(dlz) < 1e-12f ? 1e-12f : dlz));
    const float fipx = lx + dlx * s;
    const float fipy = ly + dly * s;
    const float fipz = dlz * s;
    const float fipz_safe = fabsf(fipz) < 1e-12f ? 1e-12f : fipz;
    const float sx = fipx / fipz_safe * sens;
    const float sy = fipy / fipz_safe * sens * aspect;
    const float pixel_x = (sx + 1.0f) * 0.5f * s_par[SP_XRES] - s_par[SP_RMINX];
    const float pixel_y = (-sy + 1.0f) * 0.5f * s_par[SP_YRES] - s_par[SP_RMINY];
    const bool in_bounds = (pixel_x >= 0.0f) && (pixel_x < xr) &&
                           (pixel_y >= 0.0f) && (pixel_y < yr);
    const float lin = floor_clip(pixel_y, yr - 1.0f) * xr +
                      floor_clip(pixel_x, xr - 1.0f);
    lin_out[i] = isfinite(lin) ? (int)lin : 0;

    // occlusion probe from the world-space lens point (the thin lens probes
    // from the aperture sample itself, scaled 1/unit into scene units)
    float cwx, cwy, cwz;
    lens_point_ws(s_par, lx * inv_unit, ly * inv_unit, cwx, cwy, cwz);
    const bool occ = occluded_spheres(pwx[i], pwy[i], pwz[i], cwx, cwy, cwz,
                                      s_sph, n_sph) &&
                     (sky[i] < 0.5f);
    ok_out[i] = in_bounds && !occ;
  }
}

}  // namespace pota

extern "C" int pota_tl_splat(const float* pcx, const float* pcy, const float* pcz,
                             const float* pwx, const float* pwy, const float* pwz,
                             const uint32_t* seed, const uint32_t* ctr,
                             const float* sky, int n, int bias, float expo,
                             float c2s, const float* params,
                             const float* spheres, int n_spheres, int* lin,
                             uint8_t* ok, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * (4 * (size_t)n_spheres + pota::SP_COUNT);
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  pota::tl_splat_kernel<<<pota::grid_for(n, threads, 8), threads, smem,
                          stream>>>(pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr,
                                    sky, n, bias, expo, c2s, params, spheres,
                                    n_spheres, lin, ok);
  return (int)cudaGetLastError();
}
