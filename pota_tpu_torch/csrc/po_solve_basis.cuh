// The PO backward solve of every kernel that runs one: K3 and K3b
// (po_splat.cu) and K6 (po_backward.cu).  For a target point (px, py, pz)
// in lens-space mm and an aperture point (ax, ay) in mm, the sensor light
// field (x, y, dx, dy) whose ray crosses the iris at the aperture point and
// lands on the target, and its transmittance cropped by the outer pupil.
//
// Replaces the body both TPU backward kernels share,
// pota_tpu/ops/po_pallas.py::_emit_backward_solve: the same chief-ray
// guess, fixed-iteration 4x4 Newton, chart, residual, 4x4 solve
// (po_solve.cuh), relu_nan and outer-pupil crop, on another form of the
// same polynomial.
//
// What bounds it on the H100: the instruction stream, FMAs and the shared-
// memory loads of their coefficients (one 16-byte load per 3.6 FMAs).  Each
// table holds one wavelength: its power folds into every term's
// coefficient, and the rows apx, apy, o0..o3, trans become polynomials over
// the complete degree-<=5 basis in the four unknowns (x, y, dx, dy): 126
// monomials, the same for every committed fit.  The derivative of each
// monomial is a constant times a monomial of degree <= 4 (70 of them), so
// the Newton rows' Jacobian is a polynomial over those 70 with coefficients
// formed once per frame.  A Newton iteration is then 70 x 30 + 56 x 6 =
// 2,436 FMAs and 125 multiplies.  A fit with a term outside the basis
// (a degree above 5) has no table: the wrappers refuse it on the card
// (po_kernels.py check_basis), and its route there would be a larger basis
// with the degree as a parameter, not a walk over a runtime term list.
//
// Design: the walk over the basis (walk below) is a loop nest that unrolls
// completely at compile time: it keeps the prefix products x^a, x^a y^b,
// x^a y^b dx^c in registers, so each monomial costs one multiply, and
// consumes each monomial at once into 6 value and, below degree 5, 24
// derivative accumulators.  The coefficients come from the folded table
// (po_kernels.py fold_solve_tables) in the caller's shared memory, at
// compile-time offsets, as warp-uniform float4 broadcast loads.  The table
// is passed by pointer, so each item may pick its own.  The loop nest of
// the walk (for_each_monomial) also serves K1's forward table
// (po_forward_basis.cuh).
#pragma once

#include "po_solve.cuh"

namespace pota {
namespace basis {

constexpr int kDegree = 5;
constexpr int kMonomials = 126;
// The basis in walk order: x^a y^b dx^c dy^d with a + b + c + d <= 5, a
// outermost and d innermost, each ascending.  po_kernels.py BASIS is the
// same list (tests/test_torch_fold.py reads this one), and a compile-time
// check below holds the walk's loop nest to this order.
constexpr unsigned char kExps[kMonomials][4] = {
    {0, 0, 0, 0}, {0, 0, 0, 1}, {0, 0, 0, 2}, {0, 0, 0, 3}, {0, 0, 0, 4},
    {0, 0, 0, 5}, {0, 0, 1, 0}, {0, 0, 1, 1}, {0, 0, 1, 2}, {0, 0, 1, 3},
    {0, 0, 1, 4}, {0, 0, 2, 0}, {0, 0, 2, 1}, {0, 0, 2, 2}, {0, 0, 2, 3},
    {0, 0, 3, 0}, {0, 0, 3, 1}, {0, 0, 3, 2}, {0, 0, 4, 0}, {0, 0, 4, 1},
    {0, 0, 5, 0}, {0, 1, 0, 0}, {0, 1, 0, 1}, {0, 1, 0, 2}, {0, 1, 0, 3},
    {0, 1, 0, 4}, {0, 1, 1, 0}, {0, 1, 1, 1}, {0, 1, 1, 2}, {0, 1, 1, 3},
    {0, 1, 2, 0}, {0, 1, 2, 1}, {0, 1, 2, 2}, {0, 1, 3, 0}, {0, 1, 3, 1},
    {0, 1, 4, 0}, {0, 2, 0, 0}, {0, 2, 0, 1}, {0, 2, 0, 2}, {0, 2, 0, 3},
    {0, 2, 1, 0}, {0, 2, 1, 1}, {0, 2, 1, 2}, {0, 2, 2, 0}, {0, 2, 2, 1},
    {0, 2, 3, 0}, {0, 3, 0, 0}, {0, 3, 0, 1}, {0, 3, 0, 2}, {0, 3, 1, 0},
    {0, 3, 1, 1}, {0, 3, 2, 0}, {0, 4, 0, 0}, {0, 4, 0, 1}, {0, 4, 1, 0},
    {0, 5, 0, 0}, {1, 0, 0, 0}, {1, 0, 0, 1}, {1, 0, 0, 2}, {1, 0, 0, 3},
    {1, 0, 0, 4}, {1, 0, 1, 0}, {1, 0, 1, 1}, {1, 0, 1, 2}, {1, 0, 1, 3},
    {1, 0, 2, 0}, {1, 0, 2, 1}, {1, 0, 2, 2}, {1, 0, 3, 0}, {1, 0, 3, 1},
    {1, 0, 4, 0}, {1, 1, 0, 0}, {1, 1, 0, 1}, {1, 1, 0, 2}, {1, 1, 0, 3},
    {1, 1, 1, 0}, {1, 1, 1, 1}, {1, 1, 1, 2}, {1, 1, 2, 0}, {1, 1, 2, 1},
    {1, 1, 3, 0}, {1, 2, 0, 0}, {1, 2, 0, 1}, {1, 2, 0, 2}, {1, 2, 1, 0},
    {1, 2, 1, 1}, {1, 2, 2, 0}, {1, 3, 0, 0}, {1, 3, 0, 1}, {1, 3, 1, 0},
    {1, 4, 0, 0}, {2, 0, 0, 0}, {2, 0, 0, 1}, {2, 0, 0, 2}, {2, 0, 0, 3},
    {2, 0, 1, 0}, {2, 0, 1, 1}, {2, 0, 1, 2}, {2, 0, 2, 0}, {2, 0, 2, 1},
    {2, 0, 3, 0}, {2, 1, 0, 0}, {2, 1, 0, 1}, {2, 1, 0, 2}, {2, 1, 1, 0},
    {2, 1, 1, 1}, {2, 1, 2, 0}, {2, 2, 0, 0}, {2, 2, 0, 1}, {2, 2, 1, 0},
    {2, 3, 0, 0}, {3, 0, 0, 0}, {3, 0, 0, 1}, {3, 0, 0, 2}, {3, 0, 1, 0},
    {3, 0, 1, 1}, {3, 0, 2, 0}, {3, 1, 0, 0}, {3, 1, 0, 1}, {3, 1, 1, 0},
    {3, 2, 0, 0}, {4, 0, 0, 0}, {4, 0, 0, 1}, {4, 0, 1, 0}, {4, 1, 0, 0},
    {5, 0, 0, 0},
};

// Table layout (po_kernels.py FOLD_*): a header of the unknowns'
// conditioning scale[4], shift[4]; then per monomial a block whose first 8
// floats are the values of rows o0, o1, trans, apx | apy, o2, o3, 0 and,
// below degree 5, 24 more: d(row)/d(raw unknown v) at 8 + 4 * row + v for
// the Newton rows apx, apy, o0..o3.
constexpr int kHeader = 8;
constexpr int kLowStride = 32;
constexpr int kHighStride = 8;

constexpr int degree(int m) {
  return kExps[m][0] + kExps[m][1] + kExps[m][2] + kExps[m][3];
}
constexpr int block_offset(int m) {
  int off = kHeader;
  for (int k = 0; k < m; ++k)
    off += degree(k) < kDegree ? kLowStride : kHighStride;
  return off;
}
constexpr int kTableFloats = block_offset(kMonomials);
static_assert(kTableFloats == 2696, "folded table size (po_kernels.py)");

// The walk below visits the basis in the order of this loop nest; it must
// be kExps's order.
constexpr bool loop_order_is_kexps() {
  int m = 0;
  for (int a = 0; a <= kDegree; ++a)
    for (int b = 0; a + b <= kDegree; ++b)
      for (int c = 0; a + b + c <= kDegree; ++c)
        for (int d = 0; a + b + c + d <= kDegree; ++d, ++m)
          if (kExps[m][0] != a || kExps[m][1] != b || kExps[m][2] != c ||
              kExps[m][3] != d)
            return false;
  return m == kMonomials;
}
static_assert(loop_order_is_kexps(), "the walk's order differs from kExps");

// A 16-byte load from the shared-memory window at byte address `addr`.
// The table does not change while a block runs, so the compiler hoists
// plain loads of it, all ~3,200 of the walks', out of the slot loop and
// keeps the values in local memory (CUDA 12.8 for sm_90a: 13.5 KB of stack
// and 32 registers, six times the time of the kernel's loads left in
// place); a volatile asm load stays where the walk puts it.
__device__ __forceinline__ float4 ld4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// ------------------------------------------------------------- the walk
// Visits every monomial x^a y^b dx^c dy^d of the basis in kExps order and
// calls f(k, a, b, c, d, value), k the monomial's index.  The running
// products pa = x^a, pb = x^a y^b, pc = x^a y^b dx^c stay in registers, so
// each monomial costs one multiply (none where u[v] is the literal 1).
// Every loop has the constant trip count kDegree + 1 and a guard, so the
// nest unrolls completely: k, the exponents and whatever f derives from
// them (table offsets, accumulator indices) become constants, and no
// exponent is read at run time.
template <class F>
__device__ __forceinline__ void for_each_monomial(const float u[4], F&& f) {
  int k = 0;
  float pa = 1.0f;
#pragma unroll
  for (int a = 0; a <= kDegree; ++a) {
    float pb = pa;
#pragma unroll
    for (int b = 0; b <= kDegree; ++b) {
      if (a + b <= kDegree) {
        float pc = pb;
#pragma unroll
        for (int c = 0; c <= kDegree; ++c) {
          if (a + b + c <= kDegree) {
            float pd = pc;
#pragma unroll
            for (int d = 0; d <= kDegree; ++d) {
              if (a + b + c + d <= kDegree) {
                f(k, a, b, c, d, pd);
                ++k;
                pd *= u[3];
              }
            }
            pc *= u[2];
          }
        }
        pb *= u[1];
      }
    }
    pa *= u[0];
  }
}

// The solve table's walk: calls f.term(block, value, low) for every
// monomial, block the shared-memory address of its block of the table, low
// whether its degree is below kDegree.
template <class F>
__device__ __forceinline__ void walk(unsigned tab, const float u[4], F& f) {
  unsigned off = kHeader * 4;
  for_each_monomial(u, [&](int, int a, int b, int c, int d, float mono) {
    const bool low = a + b + c + d < kDegree;
    f.term(tab + off, mono, low);
    off += 4 * (low ? kLowStride : kHighStride);
  });
}

// One Newton iteration's sums: the six rows and their derivatives along
// the raw unknowns.
struct NewtonSums {
  float v[6];
  float d[6][4];

  __device__ __forceinline__ void term(unsigned blk, float mono, bool low) {
    const float4 a = ld4(blk);       // o0 o1 trans apx
    const float4 b = ld4(blk + 16);  // apy o2 o3 -
    v[0] = fmaf(a.w, mono, v[0]);
    v[1] = fmaf(b.x, mono, v[1]);
    v[2] = fmaf(a.x, mono, v[2]);
    v[3] = fmaf(a.y, mono, v[3]);
    v[4] = fmaf(b.y, mono, v[4]);
    v[5] = fmaf(b.z, mono, v[5]);
    if (low) {
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const float4 g = ld4(blk + 32 + 16 * r);
        d[r][0] = fmaf(g.x, mono, d[r][0]);
        d[r][1] = fmaf(g.y, mono, d[r][1]);
        d[r][2] = fmaf(g.z, mono, d[r][2]);
        d[r][3] = fmaf(g.w, mono, d[r][3]);
      }
    }
  }
};

// The final evaluation: outer-pupil position and transmittance.
struct FinalSums {
  float o0, o1, tr;

  __device__ __forceinline__ void term(unsigned blk, float mono, bool) {
    const float4 a = ld4(blk);
    o0 = fmaf(a.x, mono, o0);
    o1 = fmaf(a.y, mono, o1);
    tr = fmaf(a.z, mono, tr);
  }
};

}  // namespace basis

// The most tables a kernel takes at once: one wavelength a frame, or the
// three chroma wavelengths (po_kernels.py MAX_SOLVE_TABLES).
constexpr int kMaxSolveTables = 3;

// The backward solve of one item on the folded table `tab` (in shared
// memory, 16-byte aligned, basis::kTableFloats floats): writes the sensor
// light field to s[] and returns the transmittance, max(trans, 0) (NaN
// kept) and 0 outside the outer pupil.
__device__ __forceinline__ float po_basis_solve(
    const float* __restrict__ tab, const PoLens& L, int chart, int iterations,
    float px, float py, float pz, float ax, float ay, float s[4]) {
  const float scale[4] = {tab[0], tab[1], tab[2], tab[3]};
  const float shift[4] = {tab[4], tab[5], tab[6], tab[7]};
  const unsigned tab_s = (unsigned)__cvta_generic_to_shared(tab);
  // chief-ray init
  const float pz_safe = fabsf(pz) < 1e-6f ? 1e-6f : pz;
  s[0] = -px * L.bfl / pz_safe;
  s[1] = -py * L.bfl / pz_safe;
  s[2] = (ax - s[0]) * L.inv_ap_z;
  s[3] = (ay - s[1]) * L.inv_ap_z;

#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    float u[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) u[v] = (s[v] - shift[v]) * scale[v];
    basis::NewtonSums acc;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      acc.v[r] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc.d[r][k] = 0.0f;
    }
    basis::walk(tab_s, u, acc);
    D4 o[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      o[r].v = acc.v[r];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[r].d[k] = acc.d[r][k];
    }
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

  float u[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) u[v] = (s[v] - shift[v]) * scale[v];
  basis::FinalSums fin{0.0f, 0.0f, 0.0f};
  basis::walk(tab_s, u, fin);
  const float tr = relu_nan(fin.tr);
  return fin.o0 * fin.o0 + fin.o1 * fin.o1 > L.r_outer2 ? 0.0f : tr;
}

}  // namespace pota
