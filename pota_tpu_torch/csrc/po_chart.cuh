// The PO trace's epilogue for K1's select mode (po_forward.cu) and its VJP
// for K1v's (po_forward_vjp.cu): the pupil crops of a candidate, and the
// outer pupil's chart to a camera-space ray.
//
// Replaces: the torch epilogue of models/po_camera.py trace_fw_po (the
// crops, the first-success select, the chart to rays: po_kernels.py
// chart_rays, optics/geometry.py chart_to_cs, the unit scale, the
// normalisation), which the TPU ran as XLA
// ops after its forward kernel (pota_tpu/models/po_camera.py).
//
// Rounding.  chart_ray and crops_ok give the torch epilogue's bits on the
// card, operation for operation: every product, sum, quotient and square
// root rounded alone (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc
// would contract a product feeding a sum), a Python scalar rounded to float
// first (PupilSelect, formed on the host as torch forms it), a division by
// a Python scalar a product with its float reciprocal (torch's div by a
// CPU scalar), torch.linalg.cross's component as fmaf(a_j, b_k, -(a_k
// b_j)), and torch.sum over a last axis of three as (v0 + v2) + v1.  The
// last two were read off the card (torch 2.11, CUDA 12.8, H100).  The VJP
// needs no such care: it matches autograd of the torch epilogue to
// rounding.
#pragma once

#include "po_solve.cuh"

namespace pota {

// The select mode's lens constants, each the float32 that torch rounds
// the epilogue's Python scalar to (po_kernels.py _pupil_select).
struct PupilSelect {
  int chart;       // CHART_SPHERE / CHART_CYL_X / CHART_CYL_Y
  float R;         // the outer pupil's curvature radius
  float R2;        // R ** 2
  float inv_R;     // 1 / R in float (a division by the scalar R)
  float inv_absR;  // 1 / |R| in float
  float center;    // -R
  float scale;     // the unit scale (cfg.unit_scale_po)
  float r_outer2;  // outer_pupil_radius ** 2
  float r_inner2;  // inner_pupil_radius ** 2
  float bfl;       // back_focal_length
};

namespace chart {

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v != v) ? v : fmaxf(v, lo);
}

// geometry.safe_sqrt: 0 at and below eps
__device__ __forceinline__ float safe_sqrt(float v) {
  const float eps = 1e-20f;
  return v > eps ? __fsqrt_rn(clamp_min(v, eps)) : 0.0f;
}

// torch.sum(v * v, -1) of one row of three, in torch's order
__device__ __forceinline__ float norm2(const float v[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[2], v[2])),
                   __fmul_rn(v[1], v[1]));
}

// v / sqrt(clamp(|v|^2, min=lo)), each component divided alone
__device__ __forceinline__ void normalize(float v[3], float lo) {
  const float s = __fsqrt_rn(clamp_min(norm2(v), lo));
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = __fdiv_rn(v[k], s);
}

// torch.linalg.cross(a, b) as the card computes it
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float c[3]) {
  c[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// The chart's normal (n0, n1, nz) at (o0, o1).
__device__ __forceinline__ void normal(const PupilSelect& P, float o0,
                                       float o1, float n[3]) {
  if (P.chart == CHART_SPHERE) {
    const float r2 = __fadd_rn(__fmul_rn(o0, o0), __fmul_rn(o1, o1));
    n[2] = __fmul_rn(safe_sqrt(__fsub_rn(P.R2, r2)), P.inv_absR);
    n[0] = __fmul_rn(o0, P.inv_R);
    n[1] = __fmul_rn(o1, P.inv_R);
  } else if (P.chart == CHART_CYL_Y) {
    n[2] = __fmul_rn(safe_sqrt(__fsub_rn(P.R2, __fmul_rn(o0, o0))),
                     P.inv_absR);
    n[0] = __fmul_rn(o0, P.inv_R);
    n[1] = 0.0f;
  } else {
    n[2] = __fmul_rn(safe_sqrt(__fsub_rn(P.R2, __fmul_rn(o1, o1))),
                     P.inv_absR);
    n[0] = 0.0f;
    n[1] = __fmul_rn(o1, P.inv_R);
  }
}

}  // namespace chart

// The crops of one candidate (K1's outputs o, trans >= 0, dx, dy at the
// sensor point x, y): trans > 0, the outer pupil's radius, and the inner
// pupil's at the back focal length from the shifted sensor point.
__device__ __forceinline__ bool crops_ok(const PupilSelect& P, float x,
                                         float y, float dx, float dy,
                                         const float o[4], float trans,
                                         float sensor_shift) {
  const float r2 = __fadd_rn(__fmul_rn(o[0], o[0]), __fmul_rn(o[1], o[1]));
  const float xk = __fadd_rn(x, __fmul_rn(dx, sensor_shift));
  const float yk = __fadd_rn(y, __fmul_rn(dy, sensor_shift));
  const float px = __fadd_rn(xk, __fmul_rn(dx, P.bfl));
  const float py = __fadd_rn(yk, __fmul_rn(dy, P.bfl));
  const float p2 = __fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py));
  return trans > 0.0f && r2 <= P.r_outer2 && p2 <= P.r_inner2;
}

// The chart o[4] (mm) to the camera-space ray in scene units: chart_to_cs
// (the sphere's tangent frame, or the cylinder's with ey normalised), the
// scale, the direction normalised (ops/po_kernels.py chart_rays).
__device__ __forceinline__ void chart_ray(const PupilSelect& P,
                                          const float o[4], float org[3],
                                          float dir[3]) {
  float n[3];
  chart::normal(P, o[0], o[1], n);
  const float d2 = __fadd_rn(__fmul_rn(o[2], o[2]), __fmul_rn(o[3], o[3]));
  const float t[3] = {o[2], o[3], chart::safe_sqrt(__fsub_rn(1.0f, d2))};
  float ex[3] = {n[2], 0.0f, -n[0]};
  chart::normalize(ex, static_cast<float>(1e-12 * 1e-12));
  float ey[3];
  chart::cross(n, ex, ey);
  if (P.chart != CHART_SPHERE)
    chart::normalize(ey, static_cast<float>(1e-12 * 1e-12));
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dir[k] = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(t[0], ex[k]), __fmul_rn(t[1], ey[k])),
                  __fmul_rn(t[2], n[k])),
        P.scale);
  org[0] = __fmul_rn(o[0], P.scale);
  org[1] = __fmul_rn(o[1], P.scale);
  org[2] = __fmul_rn(__fadd_rn(__fmul_rn(n[2], P.R), P.center), P.scale);
  chart::normalize(dir, 1e-24f);
}

namespace chart {

// The VJP of v -> v / sqrt(max(|v|^2, lo)) at v: (g - m (g . y) y) / s, y
// the result, s its divisor, m whether the floor let |v|^2 through
// (torch's clamp passes the gradient where |v|^2 >= lo).
__device__ __forceinline__ void normalize_vjp(const float v[3], float lo,
                                              const float g[3], float gv[3]) {
  const float n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const float s = sqrtf(fmaxf(n2, lo));
  const float inv = 1.0f / s;
  const float gy = n2 >= lo ? (g[0] * v[0] + g[1] * v[1] + g[2] * v[2]) *
                                  inv * inv
                            : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) gv[k] = (g[k] - gy * v[k]) * inv;
}

// The VJP of safe_sqrt at v for the cotangent g: none at and below its
// floor, whatever g is (torch.where's branch not taken)
__device__ __forceinline__ float safe_sqrt_vjp(float v, float g) {
  return v > 1e-20f ? g * (0.5f / sqrtf(v)) : 0.0f;
}

}  // namespace chart

// The VJP of chart_ray at o[4]: the cotangents of the ray's origin and
// direction, g_org[3] and g_dir[3], to the chart's, g_o[4].
__device__ __forceinline__ void chart_ray_vjp(const PupilSelect& P,
                                              const float o[4],
                                              const float g_org[3],
                                              const float g_dir[3],
                                              float g_o[4]) {
  const float lo = 1e-24f;
  // the forward again, rounded freely
  float n[3];
  float a;  // the argument of nz's safe_sqrt
  if (P.chart == CHART_SPHERE) {
    a = P.R2 - (o[0] * o[0] + o[1] * o[1]);
    n[0] = o[0] * P.inv_R;
    n[1] = o[1] * P.inv_R;
  } else if (P.chart == CHART_CYL_Y) {
    a = P.R2 - o[0] * o[0];
    n[0] = o[0] * P.inv_R;
    n[1] = 0.0f;
  } else {
    a = P.R2 - o[1] * o[1];
    n[0] = 0.0f;
    n[1] = o[1] * P.inv_R;
  }
  n[2] = a > 1e-20f ? sqrtf(a) * P.inv_absR : 0.0f;
  const float b = 1.0f - (o[2] * o[2] + o[3] * o[3]);
  const float t[3] = {o[2], o[3], b > 1e-20f ? sqrtf(b) : 0.0f};
  const float w[3] = {n[2], 0.0f, -n[0]};
  const float sw = sqrtf(fmaxf(w[0] * w[0] + w[2] * w[2], lo));
  const float ex[3] = {w[0] / sw, 0.0f, w[2] / sw};
  const float c[3] = {n[1] * ex[2], n[2] * ex[0] - n[0] * ex[2],
                      -n[1] * ex[0]};
  float ey[3] = {c[0], c[1], c[2]};
  if (P.chart != CHART_SPHERE) {
    const float sc = sqrtf(fmaxf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2],
                                 lo));
#pragma unroll
    for (int k = 0; k < 3; ++k) ey[k] = c[k] / sc;
  }
  float D[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    D[k] = (t[0] * ex[k] + t[1] * ey[k] + t[2] * n[k]) * P.scale;

  // the direction's normalisation and scale, onto the frame's sum
  float g_od[3];
  chart::normalize_vjp(D, lo, g_dir, g_od);
#pragma unroll
  for (int k = 0; k < 3; ++k) g_od[k] *= P.scale;
  // dir = t0 ex + t1 ey + t2 n
  const float g_t0 = g_od[0] * ex[0] + g_od[1] * ex[1] + g_od[2] * ex[2];
  const float g_t1 = g_od[0] * ey[0] + g_od[1] * ey[1] + g_od[2] * ey[2];
  const float g_t2 = g_od[0] * n[0] + g_od[1] * n[1] + g_od[2] * n[2];
  float g_n[3], g_ex[3], g_c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_n[k] = t[2] * g_od[k];
    g_ex[k] = t[0] * g_od[k];
    g_c[k] = t[1] * g_od[k];
  }
  if (P.chart != CHART_SPHERE) {
    const float g_ey[3] = {g_c[0], g_c[1], g_c[2]};
    chart::normalize_vjp(c, lo, g_ey, g_c);
  }
  // c = n x ex: n gets ex x g_c, ex gets g_c x n
  g_n[0] += ex[1] * g_c[2] - ex[2] * g_c[1];
  g_n[1] += ex[2] * g_c[0] - ex[0] * g_c[2];
  g_n[2] += ex[0] * g_c[1] - ex[1] * g_c[0];
  g_ex[0] += g_c[1] * n[2] - g_c[2] * n[1];
  g_ex[1] += g_c[2] * n[0] - g_c[0] * n[2];
  g_ex[2] += g_c[0] * n[1] - g_c[1] * n[0];
  // ex = w / |w|, w = (nz, 0, -n0)
  float g_w[3];
  chart::normalize_vjp(w, lo, g_ex, g_w);
  const float g_nz = g_n[2] + g_w[0] + g_org[2] * P.scale * P.R;
  const float g_n0 = g_n[0] - g_w[2];
  // nz = safe_sqrt(a) / |R|, and the chart's normal onto (o0, o1)
  const float g_a = chart::safe_sqrt_vjp(a, g_nz * P.inv_absR);
  g_o[0] = g_org[0] * P.scale;
  g_o[1] = g_org[1] * P.scale;
  if (P.chart == CHART_SPHERE) {
    g_o[0] += g_n0 * P.inv_R - 2.0f * o[0] * g_a;
    g_o[1] += g_n[1] * P.inv_R - 2.0f * o[1] * g_a;
  } else if (P.chart == CHART_CYL_Y) {
    g_o[0] += g_n0 * P.inv_R - 2.0f * o[0] * g_a;
  } else {
    g_o[1] += g_n[1] * P.inv_R - 2.0f * o[1] * g_a;
  }
  // tz = safe_sqrt(1 - o2^2 - o3^2)
  const float g_b = chart::safe_sqrt_vjp(b, g_t2);
  g_o[2] = g_t0 - 2.0f * o[2] * g_b;
  g_o[3] = g_t1 - 2.0f * o[3] * g_b;
}

}  // namespace pota
