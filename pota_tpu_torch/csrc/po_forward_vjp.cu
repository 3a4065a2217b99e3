// PO forward VJP kernel (K1v): the gradient of K1's function.
//
// Replaces: no TPU kernel.  A pallas_call has no VJP, so JAX trains through
// its pure path (pota_tpu/models/po_camera.py:194-205: lax.custom_root in
// pota_tpu/optics/polynomial.py:256-324, then pt_evaluate); this is the
// backward of K1 (po_forward.cu, po_pallas.py::build_po_forward_kernel) on
// the same folded table, bound as K1's gradient by po_kernels.py ForwardFn.
//
// Per candidate, at K1's solution (dx, dy) and with u = (x, y, dx, dy) and
// u' = (x + dx s, y + dy s, dx, dy) conditioned (s the sensor shift):
//   w      the cotangents of pt's five rows at u' (o0..o3, and trans's
//          where its raw value is > 0: relu_nan's mask);
//   g      the partials of sum_r w_r pt_r at u' (one walk over the basis
//          with a value and four tangents a monomial);
//   h      g carried onto (dx, dy) through u', plus the cotangents of dx, dy;
//   J      ap's 2x2 Jacobian in (dx, dy) at u (a second such walk);
//   l      J^T l = h (the determinant floored at 1e-12, as _solve2);
// and the folded coefficients' cotangents are the sums over candidates
//   G_pt[r][k] += w_r mono_k(u'),  G_ap[i][k] += -l_i mono_k(u),
// 7 x 126 sums that po_kernels.py unfold_forward_grads maps onto the fit's
// terms.  The rays' cotangents (x, y: through u' and -l^T dap/dx; ax, ay:
// l) are written per candidate when asked for.
//
// What bounds it on the H100: arithmetic.  About 8,400 f32 operations a
// candidate that carries a cotangent (two tangent walks, the 7 x 126 sums)
// against 32 bytes in; on the differentiable frame the first-success
// select passes a cotangent to one candidate a ray.
//
// Design: the reduction.  882 sums over 24.9M candidates (config 5's 4K
// step) cannot live in a thread's registers, and float atomics would add in
// a different order each run.  So each warp stages its 32 candidates (the
// powers u'^e and u^e of each variable, e <= 5, and the seven weights) in
// shared memory, and then, for each candidate that carries a cotangent in
// lane order (a ballot: the others are skipped), lane j forms monomials k =
// j, j + 32, j + 64, j + 96 of both points from the staged powers and adds
// the weighted values into its 28 register sums.  At the end the block adds
// its warps' sums in warp order into one partial row [882] in device
// memory; po_forward_vjp_finish adds the rows block by block in float64.
// The grid is fixed by the candidate count and the card (its resident
// blocks), so two runs add in the same order and give the same bits.  No
// [M, 126] monomial tensor leaves the SM.  The table (3.5 KB, K1's) is read
// from shared memory by basis::ld4 as K1 reads it.
#include "po_forward_basis.cuh"

namespace pota {
namespace vjp {

using basis::kDegree;
using basis::kMonomials;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kApRows = 2, kPtRows = 5, kRows = kApRows + kPtRows;
// the folded cotangents: ap's rows (apx, apy), then pt's (o0..o3, trans),
// 126 each (po_kernels.py VJP_SUMS)
constexpr int kSums = kRows * kMonomials;
static_assert(kSums == 882, "folded cotangent count (po_kernels.py)");
// A candidate's stage: u'^e then u^e, variable by variable (e = 0..5), then
// pt's five weights and -l0, -l1.  Its stride is odd, so the 32 lanes'
// writes fall in distinct banks.
constexpr int kPowers = kDegree + 1;
constexpr int kStPt = 0, kStAp = 4 * kPowers, kStW = 8 * kPowers;
constexpr int kStage = kStW + kRows;
static_assert(kStage % 2 == 1, "the stage stride must be odd");
// a lane's monomials in the sums: lane, lane + 32, ...
constexpr int kLaneMonos = (kMonomials + 31) / 32;
static_assert(kWarps * kSums <= kWarps * 32 * kStage,
              "the block's partial sums reuse the stage");
constexpr int kFinishThreads = 256;

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
// the four variables: calls f(k, m), m the k-th monomial as a D4.
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

// The partials of sum_r w_r pt_r over the basis: per monomial the weighted
// coefficient q = sum_r w_r P[r][k], then g += q dm.
struct PtVjp {
  unsigned pt, trans;  // shared-memory addresses of the two pt sections
  float w[kPtRows];
  float g[4];
  float4 four;         // trans of monomials k .. k + 3, k % 4 == 0

  __device__ __forceinline__ void operator()(int k, const D4& m) {
    const float4 c = basis::ld4(pt + 16 * k);
    if ((k & 3) == 0) four = basis::ld4(trans + 4 * k);
    const int q4 = k & 3;
    const float t = q4 == 0 ? four.x : q4 == 1 ? four.y : q4 == 2 ? four.z
                                                                  : four.w;
    float q = w[0] * c.x;
    q = fmaf(w[1], c.y, q);
    q = fmaf(w[2], c.z, q);
    q = fmaf(w[3], c.w, q);
    q = fmaf(w[4], t, q);
#pragma unroll
    for (int v = 0; v < 4; ++v) g[v] = fmaf(q, m.d[v], g[v]);
  }
};

// ap's two rows' partials along the four variables.
struct ApJac {
  unsigned ap;  // shared-memory address of the ap section
  float J[kApRows][4];
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

// Monomial k's four stage offsets, a byte each (x^a at a, y^b at
// kPowers + b, ...); past the basis the constant monomial's, whose sums
// are dropped.
__device__ int monomial_offsets(int k) {
  int m = 0;
#pragma unroll 1
  for (int a = 0; a <= kDegree; ++a)
#pragma unroll 1
    for (int b = 0; a + b <= kDegree; ++b)
#pragma unroll 1
      for (int c = 0; a + b + c <= kDegree; ++c)
#pragma unroll 1
        for (int d = 0; a + b + c + d <= kDegree; ++d, ++m)
          if (m == k)
            return a | (kPowers + b) << 8 | (2 * kPowers + c) << 16 |
                   (3 * kPowers + d) << 24;
  return kPowers << 8 | (2 * kPowers) << 16 | (3 * kPowers) << 24;
}

// The product of the four staged powers at offsets `o` from `p`.
__device__ __forceinline__ float staged_monomial(const float* p, int o) {
  return p[o & 0xff] * p[(o >> 8) & 0xff] * p[(o >> 16) & 0xff] *
         p[o >> 24];
}

}  // namespace vjp

__global__ void __launch_bounds__(vjp::kThreads)
po_forward_vjp_kernel(const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const float* __restrict__ dxs,
                      const float* __restrict__ dys,
                      const float* __restrict__ g_out4,
                      const float* __restrict__ g_trans,
                      const float* __restrict__ g_dx,
                      const float* __restrict__ g_dy, int n,
                      const float* __restrict__ g_tab, float sensor_shift,
                      float* __restrict__ partials, float* __restrict__ g_x,
                      float* __restrict__ g_y, float* __restrict__ g_ax,
                      float* __restrict__ g_ay) {
  using namespace vjp;
  __shared__ __align__(16) float s_tab[fwd::kTableFloats];
  __shared__ float s_stage[kWarps * 32 * kStage];
  block_load(s_tab, g_tab, fwd::kTableFloats);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = s_stage + warp * 32 * kStage;
  const unsigned tab_s = (unsigned)__cvta_generic_to_shared(s_tab);
  const float s0 = s_tab[0], s1 = s_tab[1], s2 = s_tab[2], s3 = s_tab[3];
  const float h0 = s_tab[4], h1 = s_tab[5], h2 = s_tab[6], h3 = s_tab[7];
  const float scale[4] = {s0, s1, s2, s3};

  int offs[kLaneMonos];
#pragma unroll
  for (int j = 0; j < kLaneMonos; ++j)
    offs[j] = monomial_offsets(lane + 32 * j);
  float acc_pt[kLaneMonos][kPtRows], acc_ap[kLaneMonos][kApRows];
#pragma unroll
  for (int j = 0; j < kLaneMonos; ++j) {
#pragma unroll
    for (int r = 0; r < kPtRows; ++r) acc_pt[j][r] = 0.0f;
#pragma unroll
    for (int r = 0; r < kApRows; ++r) acc_ap[j][r] = 0.0f;
  }

  // the loop bound is the warp's, so every lane reaches the ballot
  for (int base = (blockIdx.x * kWarps + warp) * 32; base < n;
       base += gridDim.x * kThreads) {
    const int i = base + lane;
    bool active = false;
    if (i < n) {
      float w[kPtRows];
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = g_out4 ? g_out4[4 * i + r] : 0.0f;
      const float gt = g_trans ? g_trans[i] : 0.0f;
      const float gdx = g_dx ? g_dx[i] : 0.0f;
      const float gdy = g_dy ? g_dy[i] : 0.0f;
      active = w[0] != 0.0f || w[1] != 0.0f || w[2] != 0.0f ||
               w[3] != 0.0f || gt != 0.0f || gdx != 0.0f || gdy != 0.0f;
      float l0 = 0.0f, l1 = 0.0f, gx = 0.0f, gy = 0.0f;
      if (active) {
        const float x = xs[i], y = ys[i], dx = dxs[i], dy = dys[i];
        const float u[4] = {(x - h0) * s0, (y - h1) * s1, (dx - h2) * s2,
                            (dy - h3) * s3};
        const float up[4] = {(__fmaf_rn(dx, sensor_shift, x) - h0) * s0,
                             (__fmaf_rn(dy, sensor_shift, y) - h1) * s1,
                             u[2], u[3]};
        w[4] = 0.0f;
        if (gt != 0.0f) {
          // relu_nan's mask needs trans's raw value at u'
          fwd::PtSums pts;
          pts.pt = tab_s + 4 * fwd::kPt;
          pts.trans = tab_s + 4 * fwd::kTrans;
          pts.o[0] = pts.o[1] = pts.o[2] = pts.o[3] = pts.tr = 0.0f;
          basis::for_each_monomial(up, pts);
          w[4] = pts.tr > 0.0f ? gt : 0.0f;
        }
        PtVjp pv;
        pv.pt = tab_s + 4 * fwd::kPt;
        pv.trans = tab_s + 4 * fwd::kTrans;
#pragma unroll
        for (int r = 0; r < kPtRows; ++r) pv.w[r] = w[r];
#pragma unroll
        for (int v = 0; v < 4; ++v) pv.g[v] = 0.0f;
        for_each_monomial_d(up, pv);
        float gu[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) gu[v] = pv.g[v] * scale[v];
        // onto (dx, dy): u'_0 = x + dx s, u'_2 = dx (and y, dy alike)
        const float hx = fmaf(gu[0], sensor_shift, gu[2]) + gdx;
        const float hy = fmaf(gu[1], sensor_shift, gu[3]) + gdy;

        ApJac aj;
        aj.ap = tab_s + 4 * fwd::kAp;
#pragma unroll
        for (int v = 0; v < 4; ++v) aj.J[0][v] = aj.J[1][v] = 0.0f;
        for_each_monomial_d(u, aj);
        float J[kApRows][4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          J[0][v] = aj.J[0][v] * scale[v];
          J[1][v] = aj.J[1][v] * scale[v];
        }
        // J^T l = h: _solve2(J00, J10, J01, J11, hx, hy)
        float det = J[0][2] * J[1][3] - J[1][2] * J[0][3];
        det = fabsf(det) < 1e-12f ? 1e-12f : det;
        l0 = (J[1][3] * hx - J[1][2] * hy) / det;
        l1 = (-J[0][3] * hx + J[0][2] * hy) / det;
        gx = gu[0] - (l0 * J[0][0] + l1 * J[1][0]);
        gy = gu[1] - (l0 * J[0][1] + l1 * J[1][1]);

        float* st = stage + lane * kStage;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float pp = 1.0f, pa = 1.0f;
#pragma unroll
          for (int e = 0; e < kPowers; ++e) {
            st[kStPt + v * kPowers + e] = pp;
            st[kStAp + v * kPowers + e] = pa;
            pp *= up[v];
            pa *= u[v];
          }
        }
#pragma unroll
        for (int r = 0; r < kPtRows; ++r) st[kStW + r] = w[r];
        st[kStW + kPtRows] = -l0;
        st[kStW + kPtRows + 1] = -l1;
      }
      if (g_x) {
        g_x[i] = gx;
        g_y[i] = gy;
        g_ax[i] = l0;
        g_ay[i] = l1;
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, active);
    __syncwarp();
    while (todo) {
      const int t = __ffs(todo) - 1;
      todo &= todo - 1;
      const float* st = stage + t * kStage;
      float wt[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) wt[r] = st[kStW + r];
#pragma unroll
      for (int j = 0; j < kLaneMonos; ++j) {
        const float mp = staged_monomial(st + kStPt, offs[j]);
        const float ma = staged_monomial(st + kStAp, offs[j]);
#pragma unroll
        for (int r = 0; r < kPtRows; ++r)
          acc_pt[j][r] = fmaf(wt[r], mp, acc_pt[j][r]);
#pragma unroll
        for (int r = 0; r < kApRows; ++r)
          acc_ap[j][r] = fmaf(wt[kPtRows + r], ma, acc_ap[j][r]);
      }
    }
    __syncwarp();
  }

  // the block's partial row: its warps' sums added in warp order
  __syncthreads();
  float* part = s_stage;  // [kWarps][kSums]
#pragma unroll
  for (int j = 0; j < kLaneMonos; ++j) {
    const int k = lane + 32 * j;
    if (k < kMonomials) {
#pragma unroll
      for (int r = 0; r < kApRows; ++r)
        part[warp * kSums + r * kMonomials + k] = acc_ap[j][r];
#pragma unroll
      for (int r = 0; r < kPtRows; ++r)
        part[warp * kSums + (kApRows + r) * kMonomials + k] = acc_pt[j][r];
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kSums; s += kThreads) {
    float sum = part[s];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += part[w * kSums + s];
    partials[(size_t)blockIdx.x * kSums + s] = sum;
  }
}

// out[s] = the sum over blocks of partials[b][s], in float64, in a fixed
// order: warp w adds rows w, w + 8, ...; then the eight warp sums in order.
__global__ void __launch_bounds__(vjp::kFinishThreads)
po_forward_vjp_finish(const float* __restrict__ partials, int blocks,
                      double* __restrict__ out) {
  constexpr int kFinishWarps = vjp::kFinishThreads / 32;
  __shared__ double s_sum[kFinishWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  double sum = 0.0;
  if (s < vjp::kSums)
    for (int b = warp; b < blocks; b += kFinishWarps)
      sum += (double)partials[(size_t)b * vjp::kSums + s];
  s_sum[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && s < vjp::kSums) {
    double t = s_sum[0][lane];
    for (int w = 1; w < kFinishWarps; ++w) t += s_sum[w][lane];
    out[s] = t;
  }
}

}  // namespace pota

// The blocks (partial rows) of a launch over n candidates: one wave of the
// kernel's resident blocks at most, so the sums' order depends only on n
// and the card.
extern "C" int pota_po_forward_vjp_blocks(int n) {
  if (n <= 0) return 0;
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, pota::po_forward_vjp_kernel, pota::vjp::kThreads, 0);
    return b < 1 ? 1 : b;
  }();
  return pota::grid_for(n, pota::vjp::kThreads, per_sm);
}

// table: K1's folded forward table of the frame's wavelength
// (po_kernels.py fold_forward_tables); partials: blocks x 882 floats of
// scratch, blocks = pota_po_forward_vjp_blocks(n); out: 882 doubles, ap's
// two rows then pt's five over the basis.  A null cotangent is zero; g_x,
// g_y, g_ax, g_ay are all null or all written.
extern "C" int pota_po_forward_vjp(const float* x, const float* y,
                                   const float* dx, const float* dy,
                                   const float* g_out4, const float* g_trans,
                                   const float* g_dx, const float* g_dy,
                                   int n, const float* table,
                                   float sensor_shift, float* partials,
                                   int blocks, double* out, float* g_x,
                                   float* g_y, float* g_ax, float* g_ay,
                                   cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (blocks != pota_po_forward_vjp_blocks(n)) return (int)cudaErrorInvalidValue;
  pota::po_forward_vjp_kernel<<<blocks, pota::vjp::kThreads, 0, stream>>>(
      x, y, dx, dy, g_out4, g_trans, g_dx, g_dy, n, table, sensor_shift,
      partials, g_x, g_y, g_ax, g_ay);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pota::po_forward_vjp_finish<<<(pota::vjp::kSums + 31) / 32,
                                pota::vjp::kFinishThreads, 0, stream>>>(
      partials, blocks, out);
  return (int)cudaGetLastError();
}
