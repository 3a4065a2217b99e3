// K1's forward trace on the compile-time degree-5 basis, for rays that share
// one wavelength (the whole frame: trace_fw_po passes cfg.lambda_um).
//
// With the wavelength fixed, its power folds into every coefficient, and
// both of K1's polynomials become polynomials over the 126 monomials
// x^a y^b dx^c dy^d (a + b + c + d <= 5) of po_solve_basis.cuh: `ap`
// (sensor -> iris, rows apx, apy) and `pt` (sensor -> outer pupil, rows
// o0..o3 and trans).  They are folded separately, so they need not share a
// term set (po_kernels.py fold_forward_tables).
//
// The ray's x and y do not change in the aperture Newton, so `ap` is
// collapsed once per ray to a polynomial in (dx, dy) alone: 21 coefficients
// A_cd(x, y) = sum_ab c_abcd x^a y^b a row, 2 x 126 FMAs (Collapse).  Each
// Newton iteration then evaluates the 21-coefficient rows and both partials
// by nested Horner in (dx, dy), 38 FMAs a row, with no derivative table
// (pair_poly).  The final walk evaluates pt's five rows over all 126
// monomials of the shifted (x', y', dx, dy) (PtSums).
#pragma once

#include "po_solve_basis.cuh"

namespace pota {
namespace fwd {

using basis::kDegree;
using basis::kMonomials;

// Table layout (po_kernels.py FWD_*), f32:
//   [0, 8)        the unknowns' conditioning scale[4], shift[4];
//   [kAp, kPt)    ap: per monomial in basis order, (apx, apy);
//   [kPt, kTrans) pt: per monomial, (o0, o1, o2, o3);
//   [kTrans, end) pt: per monomial, trans, padded to a multiple of 4.
// Every section starts on 16 bytes, so each 16-byte load is aligned: the
// ap section is read two monomials a load, the trans section four.
constexpr int kHeader = 8;
constexpr int kAp = kHeader;
constexpr int kPt = kAp + 2 * kMonomials;
constexpr int kTrans = kPt + 4 * kMonomials;
constexpr int kTableFloats = kTrans + (kMonomials + 3) / 4 * 4;
static_assert(kTableFloats == 892, "forward table size (po_kernels.py)");
static_assert(kMonomials % 2 == 0 && kAp % 4 == 0 && kPt % 4 == 0 &&
                  kTrans % 4 == 0,
              "forward table sections must start on 16 bytes");

// The 21 monomials dx^c dy^d (c + d <= 5), c outer, d inner: the index of
// (c, d).
constexpr int kPairs = (kDegree + 1) * (kDegree + 2) / 2;
__host__ __device__ constexpr int pair_index(int c, int d) {
  return c * (kDegree + 1) - c * (c - 1) / 2 + d;
}
static_assert(pair_index(kDegree, 0) == kPairs - 1, "pair_index");

// Sums ap's two rows over the (x, y) part of each monomial into the
// coefficients of its (dx, dy) part.  Walked with u = (x, y, 1, 1), so the
// value handed in is x^a y^b.
struct Collapse {
  unsigned ap;  // shared-memory address of the ap section
  float A[2][kPairs];
  float4 two;   // the (apx, apy) of monomials k and k + 1, k even

  __device__ __forceinline__ void operator()(int k, int, int, int c, int d,
                                             float xy) {
    if ((k & 1) == 0) two = basis::ld4(ap + 8 * k);
    const int j = pair_index(c, d);
    A[0][j] = fmaf((k & 1) ? two.z : two.x, xy, A[0][j]);
    A[1][j] = fmaf((k & 1) ? two.w : two.y, xy, A[1][j]);
  }
};

// P(u, v) = sum_{c+d<=5} A[pair(c, d)] u^c v^d and its partials along u and
// v by nested Horner: in u for each power of v (with the u-derivative),
// then in v over those (with the v-derivative).
__device__ __forceinline__ void pair_poly(const float A[kPairs], float u,
                                          float v, float& p, float& pu,
                                          float& pv) {
  p = A[pair_index(0, kDegree)];
  pu = pv = 0.0f;
#pragma unroll
  for (int d = kDegree - 1; d >= 0; --d) {
    const int top = kDegree - d;  // the highest power of u beside v^d
    float q = A[pair_index(top, d)], qu = 0.0f;
#pragma unroll
    for (int c = top - 1; c >= 0; --c) {
      qu = c == top - 1 ? q : fmaf(qu, u, q);
      q = fmaf(q, u, A[pair_index(c, d)]);
    }
    pv = d == kDegree - 1 ? p : fmaf(pv, v, p);
    pu = d == kDegree - 1 ? qu : fmaf(pu, v, qu);
    p = fmaf(p, v, q);
  }
}

// pt's five rows over the basis: o0..o3 one 16-byte load a monomial, trans
// one load every four.
struct PtSums {
  unsigned pt, trans;  // shared-memory addresses of the two pt sections
  float o[4], tr;
  float4 four;         // trans of monomials k .. k + 3, k % 4 == 0

  __device__ __forceinline__ void operator()(int k, int, int, int, int,
                                             float mono) {
    const float4 c = basis::ld4(pt + 16 * k);
    o[0] = fmaf(c.x, mono, o[0]);
    o[1] = fmaf(c.y, mono, o[1]);
    o[2] = fmaf(c.z, mono, o[2]);
    o[3] = fmaf(c.w, mono, o[3]);
    if ((k & 3) == 0) four = basis::ld4(trans + 4 * k);
    const int q = k & 3;
    const float t = q == 0 ? four.x : q == 1 ? four.y : q == 2 ? four.z
                                                               : four.w;
    tr = fmaf(t, mono, tr);
  }
};

}  // namespace fwd

// One ray's forward trace on the folded table `tab` (shared memory, 16-byte
// aligned, fwd::kTableFloats floats): the 2x2 aperture Newton for (dx, dy)
// from the straight line to the aperture point, the sensor shift, then pt.
// Writes the outer-pupil chart o[4] and returns the raw transmittance.
// po_kernels.py po_forward_plain repeats this arithmetic operation for
// operation, so every expression a compiler could contract one way or
// another (a product feeding a sum) is an explicit fmaf or __fmul_rn here.
__device__ __forceinline__ float po_forward_trace(
    const float* __restrict__ tab, float inv_ap_z, float sensor_shift,
    int iterations, float x, float y, float ax, float ay, float& dx,
    float& dy, float o[4]) {
  const float s0 = tab[0], s1 = tab[1], s2 = tab[2], s3 = tab[3];
  const float h0 = tab[4], h1 = tab[5], h2 = tab[6], h3 = tab[7];
  const unsigned tab_s = (unsigned)__cvta_generic_to_shared(tab);

  fwd::Collapse col;
  col.ap = tab_s + 4 * fwd::kAp;
#pragma unroll
  for (int j = 0; j < fwd::kPairs; ++j) col.A[0][j] = col.A[1][j] = 0.0f;
  const float uxy[4] = {(x - h0) * s0, (y - h1) * s1, 1.0f, 1.0f};
  basis::for_each_monomial(uxy, col);

  // Newton init: straight line to the aperture point
  dx = (ax - x) * inv_ap_z;
  dy = (ay - y) * inv_ap_z;
#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    const float udx = (dx - h2) * s2;
    const float udy = (dy - h3) * s3;
    float apx, apy, j00, j01, j10, j11;
    fwd::pair_poly(col.A[0], udx, udy, apx, j00, j01);
    fwd::pair_poly(col.A[1], udx, udy, apy, j10, j11);
    // chain rule to the raw directions, closed-form 2x2 Newton update
    j00 *= s2;
    j10 *= s2;
    j01 *= s3;
    j11 *= s3;
    const float r0 = apx - ax;
    const float r1 = apy - ay;
    float det = __fmaf_rn(j00, j11, -__fmul_rn(j01, j10));
    det = fabsf(det) < 1e-12f ? 1e-12f : det;
    dx = dx - __fmaf_rn(j11, r0, -__fmul_rn(j01, r1)) / det;
    dy = dy - __fmaf_rn(-j10, r0, __fmul_rn(j00, r1)) / det;
  }

  // sensor shift onto the polynomial plane, then pt
  const float u[4] = {(__fmaf_rn(dx, sensor_shift, x) - h0) * s0,
                      (__fmaf_rn(dy, sensor_shift, y) - h1) * s1,
                      (dx - h2) * s2, (dy - h3) * s3};
  fwd::PtSums pts;
  pts.pt = tab_s + 4 * fwd::kPt;
  pts.trans = tab_s + 4 * fwd::kTrans;
  pts.o[0] = pts.o[1] = pts.o[2] = pts.o[3] = pts.tr = 0.0f;
  basis::for_each_monomial(u, pts);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = pts.o[k];
  return pts.tr;
}

}  // namespace pota
