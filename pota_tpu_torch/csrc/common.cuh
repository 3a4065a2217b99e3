// Shared device helpers for the pota_tpu_torch kernels: launch sizing,
// cooperative copies into shared memory, the TEA-8/LCG stream, the
// concentric disk maps, the splat kernels' parameter layout, pixel map and
// sphere occlusion probe, and a small forward-mode dual number (value plus
// four tangents) for the Newton Jacobians.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pota {

// Blocks for a grid-stride loop over n items: enough to fill the card, few
// enough that each block's shared-memory table load is amortised.
inline int grid_for(long long n, int threads, int blocks_per_sm = 16) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long need = (n + threads - 1) / threads;
  long long cap = (long long)sms * blocks_per_sm;
  long long g = need < cap ? need : cap;
  return g < 1 ? 1 : (int)g;
}

// Largest dynamic shared memory a kernel may ask for without an opt-in.
constexpr size_t kSmemDefaultMax = 48 * 1024;

template <typename T>
__device__ __forceinline__ void block_load(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// max(v, 0) that keeps NaN, like jnp.maximum (fmaxf would drop it).
__device__ __forceinline__ float relu_nan(float v) {
  return (v != v) ? v : fmaxf(v, 0.0f);
}

// ---------------------------------------------------------------- TEA / LCG
// Bit-exact with pota_tpu/utils/rng.py (tea<8> seeding, src/global.h:32-57).
__device__ __forceinline__ uint32_t tea8(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ float lcg_uniform(uint32_t& state) {
  state = state * 1664525u + 1013904223u;
  return (float)(state & 0x00FFFFFFu) / 16777216.0f;
}

// Shirley's concentric square -> disk map in polar form: radius r, angle
// phi, and the square point (a, b) the squircle lerp blends toward.
__device__ __forceinline__ void concentric_polar(float r1, float r2, float& r,
                                                 float& phi, float& a,
                                                 float& b) {
  a = 2.0f * r1 - 1.0f;
  b = 2.0f * r2 - 1.0f;
  const bool use_a = (a * a) > (b * b);
  const float safe_a = (a == 0.0f) ? 1.0f : a;
  const float safe_b = (b == 0.0f) ? 1.0f : b;
  r = use_a ? a : b;
  const float kPi4 = 0.78539816339744831f;
  const float kPi2 = 1.5707963267948966f;
  phi = use_a ? kPi4 * (b / safe_a) : kPi2 - kPi4 * (a / safe_b);
}

// Plain concentric disk point from the (seed, counter) stream's first two
// uniforms (po_pallas.py _tea_concentric_disk).
__device__ __forceinline__ void tea_concentric_disk(uint32_t seed, uint32_t ctr,
                                                    float& x, float& y) {
  uint32_t state = tea8(seed, ctr);
  const float r1 = lcg_uniform(state);
  const float r2 = lcg_uniform(state);
  float r, phi, a, b;
  concentric_polar(r1, r2, r, phi, a, b);
  const bool both_zero = (a == 0.0f) && (b == 0.0f);
  x = both_zero ? 0.0f : r * cosf(phi);
  y = both_zero ? 0.0f : r * sinf(phi);
}

// ------------------------------------------------------------ splat helpers
// Per-frame scalar layout of the splat kernels (po_pallas.py _SP_*,
// SPLAT_PARAM_COUNT = 32).
enum : int {
  SP_ROT = 0, SP_TRANS = 9, SP_XRES = 12, SP_YRES = 13, SP_RMINX = 14,
  SP_RMINY = 15, SP_XRES_R = 16, SP_YRES_R = 17, SP_INV_UNIT = 18,
  SP_SHIFT = 19, SP_HSW = 20, SP_ASPECT = 21, SP_AP_RADIUS = 22,
  SP_LAMBDA = 23, SP_TL_APR = 27, SP_TL_F = 28, SP_TL_IDFD = 29,
  SP_TL_ANAM = 30, SP_COUNT = 32
};

// floor and clip to [0, hi] keeping NaN (jnp.clip does; fminf would not)
__device__ __forceinline__ float floor_clip(float v, float hi) {
  float f = floorf(v);
  f = (f < 0.0f) ? 0.0f : f;
  f = (f > hi) ? hi : f;
  return f;
}

// Camera-space lens point (lcx, lcy, 0) -> world, by the params' matrix.
__device__ __forceinline__ void lens_point_ws(const float* p, float lcx,
                                              float lcy, float& cwx,
                                              float& cwy, float& cwz) {
  cwx = p[SP_ROT + 0] * lcx + p[SP_ROT + 1] * lcy + p[SP_TRANS + 0];
  cwy = p[SP_ROT + 3] * lcx + p[SP_ROT + 4] * lcy + p[SP_TRANS + 1];
  cwz = p[SP_ROT + 6] * lcx + p[SP_ROT + 7] * lcy + p[SP_TRANS + 2];
}

// Segment occlusion of (world point w -> world lens point cw) against the
// sphere table [n_sph, 4] (po_pallas.py _occlude_spheres, t_min = 1e-3).
__device__ __forceinline__ bool occluded_spheres(float wx, float wy, float wz,
                                                 float cwx, float cwy,
                                                 float cwz,
                                                 const float* s_sph,
                                                 int n_sph) {
  const float t_min = 1e-3f;
  const float segx = cwx - wx, segy = cwy - wy, segz = cwz - wz;
  const float dist = sqrtf(fmaxf(segx * segx + segy * segy + segz * segz, 1e-24f));
  const float inv_d = 1.0f / dist;
  const float ddx = segx * inv_d, ddy = segy * inv_d, ddz = segz * inv_d;
  bool occ = false;
  for (int k = 0; k < n_sph; ++k) {
    const float ocx = wx - s_sph[4 * k + 0];
    const float ocy = wy - s_sph[4 * k + 1];
    const float ocz = wz - s_sph[4 * k + 2];
    const float rad = s_sph[4 * k + 3];
    const float b = ocx * ddx + ocy * ddy + ocz * ddz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = b * b - c;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float tt = (t0 > t_min) ? t0 : t1;
    occ = occ || ((disc > 0.0f) && (tt > t_min) && (tt < dist - t_min));
  }
  return occ;
}

// ------------------------------------------------------------- dual numbers
// Value and tangents along the four Newton unknowns (x, y, dx, dy).
struct D4 {
  float v, d[4];
};

__device__ __forceinline__ D4 dconst(float c) { return D4{c, {0.f, 0.f, 0.f, 0.f}}; }

__device__ __forceinline__ D4 operator+(const D4& a, const D4& b) {
  D4 r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ D4 operator-(const D4& a, const D4& b) {
  D4 r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ D4 operator-(const D4& a) {
  D4 r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = -a.d[i];
  return r;
}
__device__ __forceinline__ D4 operator*(const D4& a, const D4& b) {
  D4 r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ __forceinline__ D4 operator*(const D4& a, float s) {
  D4 r;
  r.v = a.v * s;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] * s;
  return r;
}
__device__ __forceinline__ D4 operator/(const D4& a, float s) {
  D4 r;
  r.v = a.v / s;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] / s;
  return r;
}
__device__ __forceinline__ D4 operator/(const D4& a, const D4& b) {
  D4 r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
__device__ __forceinline__ D4 operator+(const D4& a, float s) {
  D4 r = a;
  r.v = a.v + s;
  return r;
}
__device__ __forceinline__ D4 operator-(const D4& a, float s) {
  D4 r = a;
  r.v = a.v - s;
  return r;
}
__device__ __forceinline__ D4 operator-(float s, const D4& a) {
  D4 r = -a;
  r.v = s - a.v;
  return r;
}
__device__ __forceinline__ D4 recip(const D4& a) {
  D4 r;
  r.v = 1.0f / a.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = -(r.v * r.v) * a.d[i];
  return r;
}

// where(v > eps, sqrt(max(v, eps)), 0): zero value and zero tangent on the
// clamped branch, like po_pallas.py _safe_sqrt under jax.linearize.
__device__ __forceinline__ D4 dsafe_sqrt(const D4& a, float eps = 1e-20f) {
  if (!(a.v > eps)) return dconst(0.0f);
  D4 r;
  r.v = sqrtf(fmaxf(a.v, eps));
  const float g = 0.5f / r.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = g * a.d[i];
  return r;
}

// sqrt(max(v, eps)): the tangent is zero where the floor holds.
__device__ __forceinline__ D4 dsqrt_floor(const D4& a, float eps) {
  D4 r;
  r.v = sqrtf(fmaxf(a.v, eps));
  const float g = (a.v > eps) ? 0.5f / r.v : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = g * a.d[i];
  return r;
}

}  // namespace pota
