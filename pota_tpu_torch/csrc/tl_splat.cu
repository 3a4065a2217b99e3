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
//   4. the sphere-scene segment-occlusion probe from the world lens point,
//      where it can change ok: in bounds and not on sky.
// Returns (lin int32, ok uint8).
//
// What bounds it on the H100: instruction issue and its latency, not
// bytes.  A slot reads 36 bytes and writes 5, against several hundred
// instructions: TEA-8's 8 rounds of integer work (bit-exact, so fixed), the
// projection's divisions, the disk's sine and cosine, and the probe's sphere
// tests (8 for the teapot).  chip_smoke.py counts a slot's instructions
// from the compiled code and gives the time they take to issue beside the
// byte bound.
//
// Design: a grid-stride loop over slots, one a thread, 256 threads a
// block, the params row and the sphere table in shared memory (as K3), the
// grid sized in whole waves from the occupancy the compiled kernel reaches
// (queried once for each sphere count).  The disk angle takes one division
// (the one its branch uses) and one sincos; the divisions and the sincos
// are the approximate ones (__fdividef, __sincosf), which move lin on a few
// slots in a million against the plain version.  The probe runs only where
// it can change ok (in bounds, off sky) and skips each sphere's root where
// the segment's line misses it.  The TPU kernel bakes the
// spherical-aberration and squircle strengths in as immediates, one compile
// per setting; here they are runtime scalars (the bias flag, its exponent
// log(abb_spherical) / log(0.5) formed in double on the host, and c2s), so
// one build serves every setting.  Each of these choices was timed against
// the first port's design on the H100, one change at a time (PERF.md).
#include "common.cuh"

#include <atomic>

namespace pota {

constexpr int kTlThreads = 256;

// Aberrated concentric disk point (po_pallas.py
// _tea_concentric_disk_aberrated): with ``bias`` the radius becomes
// sign(r) |r|^expo, expo = log(abb_spherical) / log(0.5), written as
// exp(log(max(|r|, 1e-30)) * expo); then the squircle lerp by c2s.  The
// angle is concentric_polar's, with only the division its branch uses.
__device__ __forceinline__ void tl_disk(uint32_t seed, uint32_t ctr,
                                        bool bias, float expo, float c2s,
                                        float& x, float& y) {
  uint32_t state = tea8(seed, ctr);
  const float r1 = lcg_uniform(state);
  const float r2 = lcg_uniform(state);
  const float a = 2.0f * r1 - 1.0f;
  const float b = 2.0f * r2 - 1.0f;
  const bool use_a = (a * a) > (b * b);
  const float den = use_a ? ((a == 0.0f) ? 1.0f : a) : ((b == 0.0f) ? 1.0f : b);
  const float q = __fdividef(use_a ? b : a, den);
  const float kPi4 = 0.78539816339744831f;
  const float kPi2 = 1.5707963267948966f;
  const float phi = use_a ? kPi4 * q : kPi2 - kPi4 * q;
  float r = use_a ? a : b;
  if (bias) {
    const float sgn = (r > 0.0f) ? 1.0f : ((r < 0.0f) ? -1.0f : 0.0f);
    r = sgn * __expf(logf(fmaxf(fabsf(r), 1e-30f)) * expo);
  }
  float sn, cs;
  __sincosf(phi, &sn, &cs);
  x = r * cs;
  y = r * sn;
  if (c2s > 0.0f) {
    x = x + c2s * (a - x);
    y = y + c2s * (b - y);
  }
  const bool both_zero = (a == 0.0f) && (b == 0.0f);
  x = both_zero ? 0.0f : x;
  y = both_zero ? 0.0f : y;
}

// occluded_spheres (common.cuh) with the same result, leaner for a probe
// that misses: the root and the hit tests run only where the segment's
// line meets the sphere (disc > 0, which the hit needs anyway), and the
// spheres are walked one at a time, so that a warp whose rays all miss a
// sphere skips the rest of its test.
__device__ __forceinline__ bool occluded_spheres_lean(
    float wx, float wy, float wz, float cwx, float cwy, float cwz,
    const float* s_sph, int n_sph) {
  const float t_min = 1e-3f;
  const float segx = cwx - wx, segy = cwy - wy, segz = cwz - wz;
  const float dist = sqrtf(fmaxf(segx * segx + segy * segy + segz * segz, 1e-24f));
  const float inv_d = 1.0f / dist;
  const float ddx = segx * inv_d, ddy = segy * inv_d, ddz = segz * inv_d;
  bool occ = false;
#pragma unroll 1
  for (int k = 0; k < n_sph; ++k) {
    const float ocx = wx - s_sph[4 * k + 0];
    const float ocy = wy - s_sph[4 * k + 1];
    const float ocz = wz - s_sph[4 * k + 2];
    const float rad = s_sph[4 * k + 3];
    const float b = ocx * ddx + ocy * ddy + ocz * ddz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = b * b - c;
    if (!(disc > 0.0f)) continue;
    const float sq = sqrtf(disc);
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float tt = (t0 > t_min) ? t0 : t1;
    occ = occ || ((tt > t_min) && (tt < dist - t_min));
  }
  return occ;
}

__global__ void __launch_bounds__(kTlThreads)
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
    tl_disk(seeds[i], ctrs[i], bias != 0, expo, c2s, ux, uy);
    ux = ux * anam;
    const float lx = ux * apr;
    const float ly = uy * apr;

    const float px = pcx[i], py = pcy[i], pz = pcz[i];
    // image distance of the sample depth (ref src/lentil.h:665-671)
    const float ids = __fdividef(-f * pz, -f + pz);
    const float pn = sqrtf(fmaxf(px * px + py * py + pz * pz, 1e-24f));
    const float dfcz = __fdividef(pz, pn);
    const float t_sp = fabsf(__fdividef(ids, dfcz));
    const float dlx = __fdividef(px, pn) * t_sp - lx;
    const float dly = __fdividef(py, pn) * t_sp - ly;
    const float dlz = dfcz * t_sp;
    // focus-plane point lens + dl * |idfd / dlz| (the norms of dl cancel)
    const float s_f = fabsf(__fdividef(idfd, fabsf(dlz) < 1e-12f ? 1e-12f : dlz));
    const float fipx = lx + dlx * s_f;
    const float fipy = ly + dly * s_f;
    const float fipz = dlz * s_f;
    const float fipz_safe = fabsf(fipz) < 1e-12f ? 1e-12f : fipz;
    const float sx = __fdividef(fipx, fipz_safe) * sens;
    const float sy = __fdividef(fipy, fipz_safe) * sens * aspect;
    const float pixel_x = (sx + 1.0f) * 0.5f * s_par[SP_XRES] - s_par[SP_RMINX];
    const float pixel_y = (-sy + 1.0f) * 0.5f * s_par[SP_YRES] - s_par[SP_RMINY];
    const bool in_bounds = (pixel_x >= 0.0f) && (pixel_x < xr) &&
                           (pixel_y >= 0.0f) && (pixel_y < yr);
    const float lin = floor_clip(pixel_y, yr - 1.0f) * xr +
                      floor_clip(pixel_x, xr - 1.0f);
    lin_out[i] = isfinite(lin) ? (int)lin : 0;

    // occlusion probe from the world-space lens point (the thin lens probes
    // from the aperture sample itself, scaled 1/unit into scene units); it
    // changes ok only for a slot in bounds and not on sky
    const bool probe = in_bounds && sky[i] < 0.5f;
    bool occ = false;
    if (probe) {
      float cwx, cwy, cwz;
      lens_point_ws(s_par, lx * inv_unit, ly * inv_unit, cwx, cwy, cwz);
      occ = occluded_spheres_lean(pwx[i], pwy[i], pwz[i], cwx, cwy, cwz,
                                  s_sph, n_sph);
    }
    ok_out[i] = in_bounds && !occ;
  }
}

inline size_t tl_smem(int n_spheres) {
  return sizeof(float) * (4 * (size_t)n_spheres + SP_COUNT);
}

}  // namespace pota

// Resident blocks an SM of tl_splat_kernel with n_spheres spheres
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once for each
// sphere count and kept), or -1 on an error.  pota_tl_splat sizes its grid
// from it.
extern "C" int pota_tl_splat_blocks_per_sm(int n_spheres) {
  // the last answer: n_spheres in the high word, the blocks in the low one
  static std::atomic<long long> last{-1};
  const long long got = last.load(std::memory_order_relaxed);
  if (got >= 0 && (got >> 32) == n_spheres) return (int)(got & 0xFFFFFFFFll);
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, pota::tl_splat_kernel, pota::kTlThreads,
          pota::tl_smem(n_spheres)) != cudaSuccess)
    return -1;
  last.store((long long)n_spheres << 32 | (unsigned)blocks,
             std::memory_order_relaxed);
  return blocks;
}

extern "C" int pota_tl_splat(const float* pcx, const float* pcy,
                             const float* pcz, const float* pwx,
                             const float* pwy, const float* pwz,
                             const uint32_t* seed, const uint32_t* ctr,
                             const float* sky, int n, int bias, float expo,
                             float c2s, const float* params,
                             const float* spheres, int n_spheres, int* lin,
                             uint8_t* ok, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = pota::tl_smem(n_spheres);
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  const int per_sm = pota_tl_splat_blocks_per_sm(n_spheres);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  pota::tl_splat_kernel<<<pota::grid_for(n, pota::kTlThreads, per_sm),
                          pota::kTlThreads, smem, stream>>>(
      pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky, n, bias, expo, c2s, params,
      spheres, n_spheres, lin, ok);
  return (int)cudaGetLastError();
}
