// PO forward JVP kernel (K1j): K1's function and its derivative in the
// sensor point (x, y), for the ray differentials.
//
// Replaces: no TPU kernel.  A pallas_call has no JVP, so JAX takes the ray
// differentials by jax.jvp over its pure path
// (pota_tpu/render/renderer.py:126-131, use_pallas=False: lax.custom_root
// in pota_tpu/optics/polynomial.py:277-324, then pt_evaluate); this is the
// forward derivative of K1 (po_forward.cu, po_pallas.py::
// build_po_forward_kernel) on the same folded table.
//
// Per ray (x, y) with aperture point (ax, ay):
//   the primal    po_forward_trace, K1's arithmetic bit for bit: the
//                 Newton's solution d* = (dx, dy), out4, trans;
//   J             ap's 2 x 4 Jacobian in (x, y, dx, dy) at u = (x, y, dx,
//                 dy) (one D4 walk);
//   D             d(dx, dy)/d(x, y) = -J_d^-1 J_xy, JAX's custom_root
//                 tangent at the final iterate (not a JVP through the
//                 unrolled Newton), the determinant floored at 1e-12 as
//                 _solve2 floors it;
//   the tangents  of u' = (x + dx s, y + dy s, dx, dy) along x and y;
//   out4's 4 x 2  pt's rows o0..o3 along those two tangents at u' (one
//   Jacobian      walk with two directional tangents, 8 sums).
// Both screen axes come from one launch: the caller applies its pixel
// steps to the Jacobian (po_camera.py trace_fw_po_jvp).
//
// What bounds it on the H100: arithmetic.  About 8,200 f32 operations a ray
// (K1's ~2,460, the D4 walk of ap ~2,780, the directional walk of pt
// ~2,900) against 16 bytes in and 60 out (chip_smoke.py
// basis_forward_jvp_flops).
//
// Design: K1's layout.  One thread per ray and a grid-stride loop; the 3.5
// KB table is copied into shared memory once per block and read with
// volatile 16-byte loads (basis::ld4).  The three walks run one after the
// other, so only one walk's accumulators are live at a time (8 for ap, 8
// for pt); the pt walk carries two directional tangents, known before it
// starts, instead of the four partials (half the work of a D4 walk).
#include "po_forward_walks.cuh"

namespace pota {
namespace jvp {

constexpr int kThreads = 256;
// at most 128 registers: two blocks of 256 threads an SM
constexpr int kMinBlocks = 2;
// out4's Jacobian: rows o0..o3, columns (x, y), 8 floats a ray
constexpr int kJacFloats = 8;

// pt's rows o0..o3 along two directional tangents.
struct PtJvp {
  unsigned pt;  // shared-memory address of the o0..o3 section
  float J[4][2];

  __device__ __forceinline__ void operator()(int k,
                                             const fwd::DualT<2>& m) {
    const float4 c = basis::ld4(pt + 16 * k);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      J[0][t] = fmaf(c.x, m.d[t], J[0][t]);
      J[1][t] = fmaf(c.y, m.d[t], J[1][t]);
      J[2][t] = fmaf(c.z, m.d[t], J[2][t]);
      J[3][t] = fmaf(c.w, m.d[t], J[3][t]);
    }
  }
};

}  // namespace jvp

__global__ void __launch_bounds__(jvp::kThreads, jvp::kMinBlocks)
po_forward_jvp_kernel(const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const float* __restrict__ axs,
                      const float* __restrict__ ays, int n,
                      const float* __restrict__ g_tab, float inv_ap_z,
                      float sensor_shift, int iterations,
                      float* __restrict__ out4,
                      float* __restrict__ trans_out,
                      float* __restrict__ dx_out, float* __restrict__ dy_out,
                      float* __restrict__ jac_out) {
  __shared__ __align__(16) float s_tab[fwd::kTableFloats];
  block_load(s_tab, g_tab, fwd::kTableFloats);
  __syncthreads();
  const unsigned tab_s = (unsigned)__cvta_generic_to_shared(s_tab);

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float x = xs[i], y = ys[i];
    float dx, dy, o[4];
    const float tr = po_forward_trace(s_tab, inv_ap_z, sensor_shift,
                                      iterations, x, y, axs[i], ays[i], dx,
                                      dy, o);
    reinterpret_cast<float4*>(out4)[i] = make_float4(o[0], o[1], o[2], o[3]);
    trans_out[i] = relu_nan(tr);
    dx_out[i] = dx;
    dy_out[i] = dy;

    const float scale[4] = {s_tab[0], s_tab[1], s_tab[2], s_tab[3]};
    const float h0 = s_tab[4], h1 = s_tab[5], h2 = s_tab[6], h3 = s_tab[7];
    const float u[4] = {(x - h0) * scale[0], (y - h1) * scale[1],
                        (dx - h2) * scale[2], (dy - h3) * scale[3]};
    float J[2][4];
    fwd::ap_jacobian(tab_s, u, J);
    // D = -J_d^-1 J_xy: _solve2(J02, J03, J12, J13, -J0c, -J1c) a column
    float det = J[0][2] * J[1][3] - J[0][3] * J[1][2];
    det = fabsf(det) < 1e-12f ? 1e-12f : det;
    float D[2][2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      D[0][c] = (J[0][3] * J[1][c] - J[1][3] * J[0][c]) / det;
      D[1][c] = (J[1][2] * J[0][c] - J[0][2] * J[1][c]) / det;
    }
    // u' and its conditioned tangents along x (t = 0) and y (t = 1)
    const float up[4] = {(__fmaf_rn(dx, sensor_shift, x) - h0) * scale[0],
                         (__fmaf_rn(dy, sensor_shift, y) - h1) * scale[1],
                         u[2], u[3]};
    float tu[4][2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      tu[0][c] = scale[0] * fmaf(D[0][c], sensor_shift, c == 0 ? 1.0f : 0.0f);
      tu[1][c] = scale[1] * fmaf(D[1][c], sensor_shift, c == 1 ? 1.0f : 0.0f);
      tu[2][c] = scale[2] * D[0][c];
      tu[3][c] = scale[3] * D[1][c];
    }
    jvp::PtJvp pj;
    pj.pt = tab_s + 4 * fwd::kPt;
#pragma unroll
    for (int r = 0; r < 4; ++r) pj.J[r][0] = pj.J[r][1] = 0.0f;
    fwd::for_each_monomial_t<2>(up, tu, pj);
    float4* jac = reinterpret_cast<float4*>(jac_out + (size_t)i *
                                            jvp::kJacFloats);
    jac[0] = make_float4(pj.J[0][0], pj.J[0][1], pj.J[1][0], pj.J[1][1]);
    jac[1] = make_float4(pj.J[2][0], pj.J[2][1], pj.J[3][0], pj.J[3][1]);
  }
}

}  // namespace pota

// Resident blocks of K1j an SM (the occupancy query), for the record.
extern "C" int pota_po_forward_jvp_blocks_per_sm() {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, pota::po_forward_jvp_kernel, pota::jvp::kThreads, 0);
  return b;
}

// K1's arguments and outputs (po_forward.cu) plus jac: n x 8 floats, out4's
// Jacobian in (x, y), row-major [o0..o3][x, y].  table: K1's folded forward
// table of the frame's wavelength (po_kernels.py fold_forward_tables).
extern "C" int pota_po_forward_jvp(const float* x, const float* y,
                                   const float* ax, const float* ay, int n,
                                   const float* table, float inv_ap_z,
                                   float sensor_shift, int iterations,
                                   float* out4, float* trans, float* dx,
                                   float* dy, float* jac,
                                   cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  constexpr int threads = pota::jvp::kThreads;
  pota::po_forward_jvp_kernel<<<pota::grid_for(n, threads), threads, 0,
                                stream>>>(x, y, ax, ay, n, table, inv_ap_z,
                                          sensor_shift, iterations, out4,
                                          trans, dx, dy, jac);
  return (int)cudaGetLastError();
}
