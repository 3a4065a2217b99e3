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
// 7 x 126 sums, which the finishing kernel adds over blocks and maps onto
// the fit's terms (po_kernels.py unfold_forward_grads is its plain
// version).  The rays' cotangents (x, y: through u' and -l^T dap/dx; ax,
// ay: l) are written per candidate when asked for.
//
// The select mode (pota_po_forward_vjp_selected, po_forward_vjp_kernel<
// true>): the backward of K1's select mode.  Its candidates are the rays'
// selected ones, [N], which K1's select mode saves (x, y, dx, dy, out4);
// their cotangents are the rays' (origin, direction [N, 3]), which the
// walk takes through the chart's VJP (po_chart.cuh chart_ray_vjp) onto
// out4 before the walks above.  trans, dx and dy carry none: the torch
// epilogue it replaces reads them only through the crops and the select,
// which carry no gradient.  A ray is live where its cotangents are not all
// zero.
//
// What bounds it on the H100: arithmetic over the candidates that carry a
// cotangent, about 8,400 f32 operations each (two tangent walks, the 7 x
// 126 sums), and the cotangents of all candidates (28 bytes each).  On the
// differentiable frame the first-success select passes a cotangent to one
// candidate a ray at most: 6.4% of config 5's, 19.2% of its rays in the
// select mode, which walks the selected candidates alone.
//
// Design.
// * Only live candidates are walked.  Each warp first reads the
//   cotangents of its whole grid-stride range, four strides of 32 at a
//   time (their loads in flight together), ballots the live lanes and
//   writes their indices, in stride and lane order, over its own slots of
//   a queue in device memory.  Then it takes them 32 at a time, one a
//   lane, so no lane runs the walks for a dead candidate; the walks' code
//   holds none of the scan's registers.  Nothing is read back to the host.
// * The reduction.  882 sums over 24.9M candidates cannot live in a
//   thread's registers, and float atomics would add in a different order
//   each run.  A batch's lanes stage their candidates' powers u'^e, u^e (e
//   <= 5) and seven weights in shared memory; then lane j forms monomials
//   j, j + 32, j + 64, j + 96 of each staged candidate in queue order and
//   adds them into its 28 sums, kept in shared memory between batches, so
//   that they are not live during the walks.  At the end the block adds its
//   warps' sums in warp order into one partial row [882] in device memory.
//   The grid is fixed by the candidate count and the card (one wave of its
//   resident blocks): the queue order and every addition's order depend on
//   nothing else, so two runs give the same bits.
// * po_forward_vjp_finish adds the rows block by block in float64 and
//   writes the fit's cotangents directly: a term's is its monomial's sum
//   times the term's conditioned wavelength power (an index of the terms of
//   each monomial and the powers, on the card, cached per lens and λ).
// * The walks run one after another in a batch (at most 8 sums live), so a
//   thread stays within 128 registers: four blocks of 128 an SM.  No [M,
//   126] monomial tensor leaves the SM.  The table (3.5 KB, K1's) is read
//   from shared memory by basis::ld4 as K1 reads it.
#include "po_chart.cuh"
#include "po_forward_walks.cuh"

namespace pota {
namespace vjp {

using basis::kDegree;
using basis::kMonomials;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// at most 128 registers a thread: four blocks an SM
constexpr int kMinBlocks = 4;
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
// a lane's monomials in the sums: lane, lane + 32, ...; its sums, row r of
// monomial lane + 32 j at [j * kRows + r] (ap's rows first)
constexpr int kLaneMonos = (kMonomials + 31) / 32;
constexpr int kLaneSums = kLaneMonos * kRows;
// the strides of 32 candidates a warp reads before it ballots (their loads
// in flight together)
constexpr int kScan = 4;
// the finishing kernel: 32 warps add a column group's rows
constexpr int kFinishThreads = 1024;

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

// Each monomial's four stage offsets, a byte each (x^a at a, y^b at
// kPowers + b, ...), in basis order; past the basis the constant
// monomial's, whose sums are dropped.
struct StageOffsets {
  int v[kLaneMonos * 32];
};
constexpr StageOffsets make_stage_offsets() {
  StageOffsets t{};
  int m = 0;
  for (int a = 0; a <= kDegree; ++a)
    for (int b = 0; a + b <= kDegree; ++b)
      for (int c = 0; a + b + c <= kDegree; ++c)
        for (int d = 0; a + b + c + d <= kDegree; ++d, ++m)
          t.v[m] = a | (kPowers + b) << 8 | (2 * kPowers + c) << 16 |
                   (3 * kPowers + d) << 24;
  for (; m < kLaneMonos * 32; ++m)
    t.v[m] = kPowers << 8 | (2 * kPowers) << 16 | (3 * kPowers) << 24;
  return t;
}
__constant__ StageOffsets kStageOffsets = make_stage_offsets();

// The product of the four staged powers at offsets `o` from `p`.
__device__ __forceinline__ float staged_monomial(const float* p, int o) {
  return p[o & 0xff] * p[(o >> 8) & 0xff] * p[(o >> 16) & 0xff] *
         p[o >> 24];
}

// The cotangents of candidate i, zero where a pointer is null.
struct Cotangents {
  float w[4], gt, gdx, gdy;

  __device__ __forceinline__ Cotangents(const float* g_out4,
                                        const float* g_trans,
                                        const float* g_dx, const float* g_dy,
                                        int i) {
    const float4 o = g_out4 ? reinterpret_cast<const float4*>(g_out4)[i]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    w[0] = o.x;
    w[1] = o.y;
    w[2] = o.z;
    w[3] = o.w;
    gt = g_trans ? g_trans[i] : 0.0f;
    gdx = g_dx ? g_dx[i] : 0.0f;
    gdy = g_dy ? g_dy[i] : 0.0f;
  }

  __device__ __forceinline__ bool live() const {
    return w[0] != 0.0f || w[1] != 0.0f || w[2] != 0.0f || w[3] != 0.0f ||
           gt != 0.0f || gdx != 0.0f || gdy != 0.0f;
  }
};

// The select mode's inputs: the rays' cotangents in place of K1's, and
// the selected candidates' charts, whose VJP (po_chart.cuh chart_ray_vjp)
// gives each candidate's out4 cotangent.
struct SelectVjp {
  const float* out4;         // [n, 4], 16-byte aligned
  const float* g_origin;     // [n, 3]; null: zero
  const float* g_direction;  // [n, 3]; null: zero
  PupilSelect pupil;

  __device__ __forceinline__ bool live(int i) const {
    bool any = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (g_origin) any = any || g_origin[3 * i + k] != 0.0f;
      if (g_direction) any = any || g_direction[3 * i + k] != 0.0f;
    }
    return any;
  }

  // candidate i's out4 cotangent
  __device__ __forceinline__ void cotangents(int i, float w[4]) const {
    const float4 c = reinterpret_cast<const float4*>(out4)[i];
    const float o[4] = {c.x, c.y, c.z, c.w};
    float go[3], gd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      go[k] = g_origin ? g_origin[3 * i + k] : 0.0f;
      gd[k] = g_direction ? g_direction[3 * i + k] : 0.0f;
    }
    chart_ray_vjp(pupil, o, go, gd, w);
  }
};

// One live candidate c, on its lane: its stage `st` (the powers first, so
// that u' and u die with the walks), the weights, both walks one after the
// other, J^T l = h and the rays' cotangents.  The conditioning is read from
// the table where it is used, and u from the stage, not kept in registers
// across the walks.  In the select mode (kSelect) its out4 cotangent is
// the VJP of its chart's ray, and trans, dx and dy have none.
template <bool kSelect>
__device__ __forceinline__ void walk_candidate(
    int c, const SelectVjp& sel, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ dxs,
    const float* __restrict__ dys,
    const float* __restrict__ g_out4, const float* __restrict__ g_trans,
    const float* __restrict__ g_dx, const float* __restrict__ g_dy,
    unsigned tab_s, float sensor_shift, float* st, float* __restrict__ g_x,
    float* __restrict__ g_y, float* __restrict__ g_ax,
    float* __restrict__ g_ay) {
  float u[4], up[4];
  {
    const float4 sc = basis::ld4(tab_s), sh = basis::ld4(tab_s + 16);
    const float x = xs[c], y = ys[c], dx = dxs[c], dy = dys[c];
    u[0] = (x - sh.x) * sc.x;
    u[1] = (y - sh.y) * sc.y;
    u[2] = (dx - sh.z) * sc.z;
    u[3] = (dy - sh.w) * sc.w;
    up[0] = (__fmaf_rn(dx, sensor_shift, x) - sh.x) * sc.x;
    up[1] = (__fmaf_rn(dy, sensor_shift, y) - sh.y) * sc.y;
    up[2] = u[2];
    up[3] = u[3];
  }
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
  // out4's and trans's cotangents now; dx's and dy's after the walk, so
  // that they are not live during it
  PtVjp pv;
  pv.pt = tab_s + 4 * fwd::kPt;
  pv.trans = tab_s + 4 * fwd::kTrans;
  float gt = 0.0f;
  if constexpr (kSelect) {
    sel.cotangents(c, pv.w);
  } else {
    const Cotangents ct(g_out4, g_trans, nullptr, nullptr, c);
#pragma unroll
    for (int r = 0; r < 4; ++r) pv.w[r] = ct.w[r];
    gt = ct.gt;
  }
  pv.w[4] = 0.0f;
  if (gt != 0.0f) {
    // relu_nan's mask needs trans's raw value at u'
    fwd::PtSums pts;
    pts.pt = tab_s + 4 * fwd::kPt;
    pts.trans = tab_s + 4 * fwd::kTrans;
    pts.o[0] = pts.o[1] = pts.o[2] = pts.o[3] = pts.tr = 0.0f;
    basis::for_each_monomial(up, pts);
    pv.w[4] = pts.tr > 0.0f ? gt : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kPtRows; ++r) st[kStW + r] = pv.w[r];
#pragma unroll
  for (int v = 0; v < 4; ++v) pv.g[v] = 0.0f;
  fwd::for_each_monomial_d(up, pv);
  const float4 sc = basis::ld4(tab_s);
  const float gu0 = pv.g[0] * sc.x, gu1 = pv.g[1] * sc.y;
  // onto (dx, dy): u'_0 = x + dx s, u'_2 = dx (and y, dy alike)
  const float hx = fmaf(gu0, sensor_shift, pv.g[2] * sc.z) +
                   (g_dx ? g_dx[c] : 0.0f);
  const float hy = fmaf(gu1, sensor_shift, pv.g[3] * sc.w) +
                   (g_dy ? g_dy[c] : 0.0f);

  // u again from its staged first powers (a volatile read: u itself is
  // not kept live through the pt walk)
  float u1[4];
#pragma unroll
  for (int v = 0; v < 4; ++v)
    u1[v] = reinterpret_cast<volatile float*>(st)[kStAp + v * kPowers + 1];
  float J[kApRows][4];
  fwd::ap_jacobian(tab_s, u1, J);
  // J^T l = h: _solve2(J00, J10, J01, J11, hx, hy)
  float det = J[0][2] * J[1][3] - J[1][2] * J[0][3];
  det = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float l0 = (J[1][3] * hx - J[1][2] * hy) / det;
  const float l1 = (-J[0][3] * hx + J[0][2] * hy) / det;
  st[kStW + kPtRows] = -l0;
  st[kStW + kPtRows + 1] = -l1;
  if (g_x) {
    g_x[c] = gu0 - (l0 * J[0][0] + l1 * J[1][0]);
    g_y[c] = gu1 - (l0 * J[0][1] + l1 * J[1][1]);
    g_ax[c] = l0;
    g_ay[c] = l1;
  }
}

// The sums of a batch: the warp's `count` staged candidates in queue
// order, each lane its monomials' 28 sums (`sums`: the warp's, in shared
// memory, [kLaneSums][32]; `s_offs`: each monomial's stage offsets).
__device__ __forceinline__ void add_batch(const float* stage, int count,
                                          const int* s_offs, float* sums,
                                          int lane) {
  int offs[kLaneMonos];
#pragma unroll
  for (int j = 0; j < kLaneMonos; ++j) offs[j] = s_offs[lane + 32 * j];
  float acc[kLaneMonos][kRows];
#pragma unroll
  for (int j = 0; j < kLaneMonos; ++j)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      acc[j][r] = sums[(j * kRows + r) * 32 + lane];
  for (int t = 0; t < count; ++t) {
    const float* st = stage + t * kStage;
    float wt[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) wt[r] = st[kStW + r];
#pragma unroll
    for (int j = 0; j < kLaneMonos; ++j) {
      const float mp = staged_monomial(st + kStPt, offs[j]);
      const float ma = staged_monomial(st + kStAp, offs[j]);
#pragma unroll
      for (int r = 0; r < kApRows; ++r)
        acc[j][r] = fmaf(wt[kPtRows + r], ma, acc[j][r]);
#pragma unroll
      for (int r = 0; r < kPtRows; ++r)
        acc[j][kApRows + r] = fmaf(wt[r], mp, acc[j][kApRows + r]);
    }
  }
#pragma unroll
  for (int j = 0; j < kLaneMonos; ++j)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      sums[(j * kRows + r) * 32 + lane] = acc[j][r];
}

}  // namespace vjp

template <bool kSelect>
__global__ void __launch_bounds__(vjp::kThreads, vjp::kMinBlocks)
po_forward_vjp_kernel(const vjp::SelectVjp sel, const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const float* __restrict__ dxs,
                      const float* __restrict__ dys,
                      const float* __restrict__ g_out4,
                      const float* __restrict__ g_trans,
                      const float* __restrict__ g_dx,
                      const float* __restrict__ g_dy, int n,
                      const float* __restrict__ g_tab, float sensor_shift,
                      int* __restrict__ queue,
                      float* __restrict__ partials, float* __restrict__ g_x,
                      float* __restrict__ g_y, float* __restrict__ g_ax,
                      float* __restrict__ g_ay, int* __restrict__ live_count) {
  using namespace vjp;
  __shared__ __align__(16) float s_tab[fwd::kTableFloats];
  __shared__ float s_stage[kWarps * 32 * kStage];
  __shared__ float s_sums[kWarps * kLaneSums * 32];
  __shared__ int s_offs[kLaneMonos * 32];
  block_load(s_tab, g_tab, fwd::kTableFloats);
  for (int s = threadIdx.x; s < kWarps * kLaneSums * 32; s += kThreads)
    s_sums[s] = 0.0f;
  for (int k = threadIdx.x; k < kLaneMonos * 32; k += kThreads)
    s_offs[k] = kStageOffsets.v[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = s_stage + warp * 32 * kStage;
  float* sums = s_sums + warp * kLaneSums * 32;
  const unsigned tab_s = (unsigned)__cvta_generic_to_shared(s_tab);

  // Pass 1: the warp's live candidates, in stride and lane order, into its
  // own slots of `queue` (entry j at the j / 32-th of its strides, lane j %
  // 32: never more entries than the warp has candidates).  The loop's bound
  // is the warp's, so every lane reaches the ballots.
  const int first = (blockIdx.x * kWarps + warp) * 32;
  const int stride = gridDim.x * kThreads;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int base = first; base < n; base += kScan * stride) {
    bool live[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int i = base + q * stride + lane;
      if constexpr (kSelect)
        live[q] = i < n && sel.live(i);
      else
        live[q] = i < n && Cotangents(g_out4, g_trans, g_dx, g_dy, i).live();
    }
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int i = base + q * stride + lane;
      if (i < n && !live[q] && g_x)
        g_x[i] = g_y[i] = g_ax[i] = g_ay[i] = 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, live[q]);
      const int j = count + __popc(mask & below);
      if (live[q]) queue[first + (j >> 5) * stride + (j & 31)] = i;
      count += __popc(mask);
    }
  }
  // the live candidates counted (a traced run): one add a warp
  if (live_count && lane == 0 && count > 0) atomicAdd(live_count, count);
  __syncwarp();
  // Pass 2: batches of 32 queued candidates, one a lane, the last partial
  for (int b = 0; b < count; b += 32) {
    const int batch = min(count - b, 32);
    const int c = lane < batch ? queue[first + (b >> 5) * stride + lane] : -1;
    if (c >= 0)
      walk_candidate<kSelect>(c, sel, xs, ys, dxs, dys, g_out4, g_trans,
                              g_dx, g_dy, tab_s, sensor_shift,
                              stage + lane * kStage, g_x, g_y, g_ax, g_ay);
    __syncwarp();
    add_batch(stage, batch, s_offs, sums, lane);
    __syncwarp();
  }

  // the block's partial row: its warps' sums added in warp order
  __syncthreads();
  for (int s = threadIdx.x; s < kSums; s += kThreads) {
    const int row = s / kMonomials, k = s - row * kMonomials;
    const int at = ((k >> 5) * kRows + row) * 32 + (k & 31);
    float sum = s_sums[at];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += s_sums[w * kLaneSums * 32 + at];
    partials[(size_t)blockIdx.x * kSums + s] = sum;
  }
}

// The sum over blocks of partials[b][s], in float64, in a fixed order (warp
// w adds rows w, w + 32, ...; then the 32 warp sums in order), mapped onto
// the fit's terms: d c[row][t] = G[row][k] * lam_pow[t] for each term t of
// monomial k.  unfold: per polynomial (pt, then ap) kMonomials + 1 offsets
// into the term list that follows them (pt's terms, then ap's, each
// monomial's together); lam_pow: each term's conditioned wavelength power
// (pt's t_pt, then ap's t_ap).  g_pt [5][t_pt], g_ap [2][t_ap] f32.
__global__ void __launch_bounds__(vjp::kFinishThreads)
po_forward_vjp_finish(const float* __restrict__ partials, int blocks,
                      const int* __restrict__ unfold,
                      const double* __restrict__ lam_pow,
                      float* __restrict__ g_pt, int t_pt,
                      float* __restrict__ g_ap, int t_ap) {
  using namespace vjp;
  constexpr int kFinishWarps = kFinishThreads / 32;
  __shared__ double s_sum[kFinishWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  double sum = 0.0;
  if (s < kSums)
    for (int b = warp; b < blocks; b += kFinishWarps)
      sum += (double)partials[(size_t)b * kSums + s];
  s_sum[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && s < kSums) {
    double G = s_sum[0][lane];
    for (int w = 1; w < kFinishWarps; ++w) G += s_sum[w][lane];
    const int row = s / kMonomials, k = s - row * kMonomials;
    const bool ap = row < kApRows;
    const int* start = unfold + (ap ? kMonomials + 1 : 0);
    const int* terms = unfold + 2 * (kMonomials + 1);
    const double* lp = ap ? lam_pow + t_pt : lam_pow;
    float* out = ap ? g_ap + (size_t)row * t_ap
                    : g_pt + (size_t)(row - kApRows) * t_pt;
    for (int e = start[k]; e < start[k + 1]; ++e) {
      const int t = terms[e];
      out[t] = (float)(G * lp[t]);
    }
  }
}

}  // namespace pota

template <bool kSelect>
static int vjp_blocks_per_sm() {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, pota::po_forward_vjp_kernel<kSelect>, pota::vjp::kThreads, 0);
    return b;
  }();
  return per_sm;
}

template <bool kSelect>
static int vjp_blocks(int n) {
  if (n <= 0) return 0;
  const int per_sm = vjp_blocks_per_sm<kSelect>();
  return pota::grid_for(n, pota::vjp::kThreads, per_sm < 1 ? 1 : per_sm);
}

// Resident blocks of K1v's kernel an SM (the occupancy query), in each
// mode.
extern "C" int pota_po_forward_vjp_blocks_per_sm() {
  return vjp_blocks_per_sm<false>();
}
extern "C" int pota_po_forward_vjp_selected_blocks_per_sm() {
  return vjp_blocks_per_sm<true>();
}

// The blocks (partial rows) of a launch over n candidates: one wave of the
// kernel's resident blocks at most, so the sums' order depends only on n
// and the card.
extern "C" int pota_po_forward_vjp_blocks(int n) {
  return vjp_blocks<false>(n);
}

// The same for the select mode's kernel.
extern "C" int pota_po_forward_vjp_selected_blocks(int n) {
  return vjp_blocks<true>(n);
}

// Both modes' launch: the kernel over n candidates, then the finish.
template <bool kSelect>
static int launch_vjp(const pota::vjp::SelectVjp& sel, const float* x,
                      const float* y, const float* dx, const float* dy,
                      const float* g_out4, const float* g_trans,
                      const float* g_dx, const float* g_dy, int n,
                      const float* table, float sensor_shift, int* queue,
                      float* partials, int blocks, const int* unfold,
                      const double* lam_pow, float* g_pt, int t_pt,
                      float* g_ap, int t_ap, float* g_x, float* g_y,
                      float* g_ax, float* g_ay, int* live_count,
                      cudaStream_t stream) {
  if (blocks != vjp_blocks<kSelect>(n)) return (int)cudaErrorInvalidValue;
  if (live_count) {
    const cudaError_t err =
        cudaMemsetAsync(live_count, 0, sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    pota::po_forward_vjp_kernel<kSelect>
        <<<blocks, pota::vjp::kThreads, 0, stream>>>(
            sel, x, y, dx, dy, g_out4, g_trans, g_dx, g_dy, n, table,
            sensor_shift, queue, partials, g_x, g_y, g_ax, g_ay, live_count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pota::po_forward_vjp_finish<<<(pota::vjp::kSums + 31) / 32,
                                pota::vjp::kFinishThreads, 0, stream>>>(
      partials, blocks, unfold, lam_pow, g_pt, t_pt, g_ap, t_ap);
  return (int)cudaGetLastError();
}

// table: K1's folded forward table of the frame's wavelength
// (po_kernels.py fold_forward_tables); queue: n ints of scratch; partials:
// blocks x 882 floats of scratch, blocks = pota_po_forward_vjp_blocks(n);
// unfold, lam_pow: the
// fit's term index (po_forward_vjp_finish); g_pt [5][t_pt], g_ap
// [2][t_ap]: the coefficients' cotangents, written whole (zero when n is
// 0).  A null cotangent is zero; g_out4 is 16-byte aligned; g_x, g_y,
// g_ax, g_ay are all null or all written.  live_count, if not null, is set
// to the count of live candidates (one int, zeroed here by a memset).
extern "C" int pota_po_forward_vjp(const float* x, const float* y,
                                   const float* dx, const float* dy,
                                   const float* g_out4, const float* g_trans,
                                   const float* g_dx, const float* g_dy,
                                   int n, const float* table,
                                   float sensor_shift, int* queue,
                                   float* partials, int blocks,
                                   const int* unfold,
                                   const double* lam_pow, float* g_pt,
                                   int t_pt, float* g_ap, int t_ap,
                                   float* g_x, float* g_y, float* g_ax,
                                   float* g_ay, int* live_count,
                                   cudaStream_t stream) {
  return launch_vjp<false>(pota::vjp::SelectVjp{}, x, y, dx, dy, g_out4,
                           g_trans, g_dx, g_dy, n, table, sensor_shift,
                           queue, partials, blocks, unfold, lam_pow, g_pt,
                           t_pt, g_ap, t_ap, g_x, g_y, g_ax, g_ay,
                           live_count, stream);
}

// The select mode: n rays' selected candidates (x, y, dx, dy [n] and
// their charts out4 [n, 4], 16-byte aligned: K1's select mode saves them)
// and the rays' cotangents g_origin, g_direction [n, 3] (null: zero); the
// pupil's constants as K1's select mode takes them (PupilSelect, chart to
// scale); blocks = pota_po_forward_vjp_selected_blocks(n); the rest as
// pota_po_forward_vjp takes it, without the rays' cotangents.
extern "C" int pota_po_forward_vjp_selected(
    const float* x, const float* y, const float* dx, const float* dy,
    const float* out4, const float* g_origin, const float* g_direction,
    int n, const float* table, float sensor_shift, int chart, float R,
    float R2, float inv_R, float inv_absR, float center, float scale,
    int* queue, float* partials, int blocks, const int* unfold,
    const double* lam_pow, float* g_pt, int t_pt, float* g_ap, int t_ap,
    int* live_count, cudaStream_t stream) {
  const pota::vjp::SelectVjp sel{
      out4, g_origin, g_direction,
      pota::PupilSelect{chart, R, R2, inv_R, inv_absR, center, scale, 0.0f,
                        0.0f, 0.0f}};
  return launch_vjp<true>(sel, x, y, dx, dy, nullptr, nullptr, nullptr,
                          nullptr, n, table, sensor_shift, queue, partials,
                          blocks, unfold, lam_pow, g_pt, t_pt, g_ap, t_ap,
                          nullptr, nullptr, nullptr, nullptr, live_count,
                          stream);
}
