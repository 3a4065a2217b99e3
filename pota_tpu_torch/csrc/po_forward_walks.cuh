// The derivative walks of K1's derivatives, K1v (po_forward_vjp.cu) and K1j
// (po_forward_jvp.cu): basis::for_each_monomial's walk over the 126
// monomials of po_solve_basis.cuh, each monomial carried with tangents, on
// K1's folded forward table (po_forward_basis.cuh).
//
// for_each_monomial_d carries the four partials along the conditioned
// variables (a D4 a monomial: 4 FMAs and 5 multiplies a step); ApJac sums
// ap's 2 x 4 Jacobian with it.  for_each_monomial_t carries T directional
// tangents instead (T + 1 operations a step, 2T where the tangent of the
// variable is not zero), for a walk whose tangents are known before it
// starts: K1j's pt rows along the two screen axes.
#pragma once

#include "po_forward_basis.cuh"

namespace pota {
namespace fwd {

// p * u_v for the conditioned variable v (unit tangent along v).
__device__ __forceinline__ D4 times_var(const D4& p, float uv, int v) {
  D4 r;
  r.v = p.v * uv;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r.d[i] = i == v ? fmaf(p.d[i], uv, p.v) : p.d[i] * uv;
  return r;
}

// basis::for_each_monomial's walk, each monomial with its partials along
// the four variables: calls f(k, m), m the k-th monomial as a D4.  The
// value m.v is formed by the same products as for_each_monomial's.
template <class F>
__device__ __forceinline__ void for_each_monomial_d(const float u[4],
                                                    F&& f) {
  int k = 0;
  D4 pa = dconst(1.0f);
#pragma unroll
  for (int a = 0; a <= kDegree; ++a) {
    D4 pb = pa;
#pragma unroll
    for (int b = 0; b <= kDegree; ++b) {
      if (a + b <= kDegree) {
        D4 pc = pb;
#pragma unroll
        for (int c = 0; c <= kDegree; ++c) {
          if (a + b + c <= kDegree) {
            D4 pd = pc;
#pragma unroll
            for (int d = 0; d <= kDegree; ++d) {
              if (a + b + c + d <= kDegree) {
                f(k, pd);
                ++k;
                pd = times_var(pd, u[3], 3);
              }
            }
            pc = times_var(pc, u[2], 2);
          }
        }
        pb = times_var(pb, u[1], 1);
      }
    }
    pa = times_var(pa, u[0], 0);
  }
}

// ap's two rows' partials along the four conditioned variables.
struct ApJac {
  unsigned ap;  // shared-memory address of the ap section
  float J[2][4];
  float4 two;   // the (apx, apy) of monomials k and k + 1, k even

  __device__ __forceinline__ void operator()(int k, const D4& m) {
    if ((k & 1) == 0) two = basis::ld4(ap + 8 * k);
    const float c0 = (k & 1) ? two.z : two.x;
    const float c1 = (k & 1) ? two.w : two.y;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      J[0][v] = fmaf(c0, m.d[v], J[0][v]);
      J[1][v] = fmaf(c1, m.d[v], J[1][v]);
    }
  }
};

// ap's Jacobian in the raw variables (x, y, dx, dy) at the conditioned
// point u: one D4 walk, then the chain rule through the table's scale,
// read after the walk (nothing but u and the sums is live during it).
__device__ __forceinline__ void ap_jacobian(unsigned tab_s, const float u[4],
                                            float J[2][4]) {
  ApJac aj;
  aj.ap = tab_s + 4 * kAp;
#pragma unroll
  for (int v = 0; v < 4; ++v) aj.J[0][v] = aj.J[1][v] = 0.0f;
  for_each_monomial_d(u, aj);
  const float4 s = basis::ld4(tab_s);
  const float scale[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    J[0][v] = aj.J[0][v] * scale[v];
    J[1][v] = aj.J[1][v] * scale[v];
  }
}

// A value and T directional tangents.
template <int T>
struct DualT {
  float v, d[T];
};

// p * u_v, the variable's tangents tv[T] given.
template <int T>
__device__ __forceinline__ DualT<T> times_dir(const DualT<T>& p, float uv,
                                              const float tv[T]) {
  DualT<T> r;
  r.v = p.v * uv;
#pragma unroll
  for (int t = 0; t < T; ++t) r.d[t] = fmaf(p.d[t], uv, p.v * tv[t]);
  return r;
}

// basis::for_each_monomial's walk with T directional tangents: tu[v][t]
// is the tangent of u[v] along direction t.  Calls f(k, m).
template <int T, class F>
__device__ __forceinline__ void for_each_monomial_t(const float u[4],
                                                    const float tu[4][T],
                                                    F&& f) {
  int k = 0;
  DualT<T> pa;
  pa.v = 1.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) pa.d[t] = 0.0f;
#pragma unroll
  for (int a = 0; a <= kDegree; ++a) {
    DualT<T> pb = pa;
#pragma unroll
    for (int b = 0; b <= kDegree; ++b) {
      if (a + b <= kDegree) {
        DualT<T> pc = pb;
#pragma unroll
        for (int c = 0; c <= kDegree; ++c) {
          if (a + b + c <= kDegree) {
            DualT<T> pd = pc;
#pragma unroll
            for (int d = 0; d <= kDegree; ++d) {
              if (a + b + c + d <= kDegree) {
                f(k, pd);
                ++k;
                pd = times_dir<T>(pd, u[3], tu[3]);
              }
            }
            pc = times_dir<T>(pc, u[2], tu[2]);
          }
        }
        pb = times_dir<T>(pb, u[1], tu[1]);
      }
    }
    pa = times_dir<T>(pa, u[0], tu[0]);
  }
}

}  // namespace fwd
}  // namespace pota
