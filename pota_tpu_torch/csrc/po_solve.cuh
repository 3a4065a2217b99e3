// The parts of the PO backward solve that do not depend on how the lens
// polynomial is stored: the lens constants, the outer-pupil chart's exit
// ray and the blocked 4x4 solve of each Newton step.  po_solve_basis.cuh
// builds the solve of K3, K3b (po_splat.cu) and K6 (po_backward.cu) on
// them.
//
// Replaces those parts of the body both TPU backward kernels share:
// pota_tpu/ops/po_pallas.py::_emit_backward_solve's exit_ray and _solve4.
//
// exit_ray maps the chart to the exit ray through the dual type D4 (value
// and tangents along the four unknowns, the counterpart of jax.linearize in
// the TPU kernel); its guards (safe sqrt, sqrt floor) have zero tangents on
// their clamped branches, as JAX's `where` does.  The pupil chart (sphere /
// cyl-x / cyl-y) is a runtime switch.
#pragma once

#include "common.cuh"

namespace pota {

// Lens constants of the backward solve and the pupil crops, formed in
// double on the host (po_kernels.py _splat_lens_consts).
struct PoLens {
  float R, R2, absR, r_outer2, front_z, bfl, inv_ap_z, r_inner2;
};

enum : int { CHART_SPHERE = 0, CHART_CYL_X = 1, CHART_CYL_Y = 2 };

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

}  // namespace pota
