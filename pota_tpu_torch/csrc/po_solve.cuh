// The PO backward solve of K3's per-slot-wavelength variants (po_splat.cu):
// for a target point (px, py, pz) in lens-space mm and an aperture point
// (ax, ay) in mm, the sensor light field (x, y, dx, dy) whose ray crosses
// the iris at the aperture point and lands on the target, and its
// transmittance cropped by the outer pupil.
//
// Replaces the body both TPU backward kernels share:
// pota_tpu/ops/po_pallas.py::_emit_backward_solve (with _solve4).
//
// A fixed-iteration 4x4 Newton from the chief-ray guess: each iteration
// evaluates the shared-term polynomial's rows apx, apy, o0..o3 with four
// forward-mode tangents (the counterpart of jax.linearize in the TPU
// kernel), maps the outer-pupil chart to the exit ray through a small dual
// type (D4), and solves the 4x4 system by the Schur complement of its
// leading 2x2 block.  The guards (safe sqrt, sqrt floor, |d2| < 1e-9) have
// zero tangents on their clamped branches, as JAX's `where` does.  The
// polynomial (int8 exponents [T, 5], the [7, T] coefficient rows apx, apy,
// o0..o3, trans) lives in the caller's shared memory; the pupil chart
// (sphere / cyl-x / cyl-y) is a runtime switch.
#pragma once

#include "common.cuh"

namespace pota {

// Lens constants of the backward solve and the pupil crops, formed in
// double on the host (po_kernels.py _splat_lens_consts).
struct PoLens {
  float R, R2, absR, r_outer2, front_z, bfl, inv_ap_z, r_inner2;
};

enum : int { CHART_SPHERE = 0, CHART_CYL_X = 1, CHART_CYL_Y = 2 };

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
__device__ __forceinline__ void exit_ray(int chart, const PoLens& L,
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

// The backward solve of one item: writes the sensor light field to s[] and
// returns the transmittance, max(trans, 0) (NaN kept) and 0 outside the
// outer pupil.  ul is the conditioned wavelength; scale / shift the
// conditioning of the four unknowns.
__device__ __forceinline__ float po_backward_solve(
    const int8_t* __restrict__ s_e, const float* __restrict__ s_c, int T,
    const float scale[4], const float shift[4], float ul, const PoLens& L,
    int chart, int iterations, float px, float py, float pz, float ax,
    float ay, float s[4]) {
  // chief-ray init
  const float pz_safe = fabsf(pz) < 1e-6f ? 1e-6f : pz;
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
  return tr;
}

}  // namespace pota
