// PO forward kernel (K1).
//
// Replaces: pota_tpu/ops/po_pallas.py::build_po_forward_kernel, the fused
// per-lens forward trace behind models/po_camera.py::trace_fw_po.
//
// Per ray: a fixed-iteration 2x2 Newton on the aperture polynomial `ap` for
// the sensor directions (dx, dy) that reach the aperture sample, the sensor
// shift, then pt_evaluate of the outer-pupil chart + transmittance.
//
// What bounds it on the H100: arithmetic.  A 160-term degree-5 lens costs
// about 3 x 160 monomials with two partials each in the Newton loop plus
// 160 x 5 FMAs in the final evaluation, against 20 bytes in and 28 bytes out
// per ray.
//
// Design: one thread per ray, a grid-stride loop over the rays.  The
// polynomial is runtime data (int8 exponents, f32 coefficients and input
// conditioning) copied once per block into shared memory; every thread of a
// warp reads the same term at the same time, so the reads broadcast.  One
// build serves every lens (the TPU kernel baked each lens into immediates).
// Separate term sets for `ap` and `pt` are accepted.
#include "common.cuh"

namespace pota {

__global__ void __launch_bounds__(128)
po_forward_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ axs, const float* __restrict__ ays,
                  const float* __restrict__ lams, int n,
                  const int8_t* __restrict__ g_ap_e, const float* __restrict__ g_ap_c,
                  int t_ap, const int8_t* __restrict__ g_pt_e,
                  const float* __restrict__ g_pt_c, int t_pt,
                  const float* __restrict__ cond, float inv_ap_z,
                  float sensor_shift, int iterations, float* __restrict__ out4,
                  float* __restrict__ trans_out, float* __restrict__ dx_out,
                  float* __restrict__ dy_out) {
  extern __shared__ float smem[];
  float* s_ap_c = smem;                       // [2, t_ap]
  float* s_pt_c = s_ap_c + 2 * t_ap;          // [5, t_pt]
  float* s_cond = s_pt_c + 5 * t_pt;          // scale[5], shift[5]
  int8_t* s_ap_e = (int8_t*)(s_cond + 10);    // [t_ap, 5]
  int8_t* s_pt_e = s_ap_e + 5 * t_ap;         // [t_pt, 5]
  block_load(s_ap_c, g_ap_c, 2 * t_ap);
  block_load(s_pt_c, g_pt_c, 5 * t_pt);
  block_load(s_cond, cond, 10);
  block_load(s_ap_e, g_ap_e, 5 * t_ap);
  block_load(s_pt_e, g_pt_e, 5 * t_pt);
  __syncthreads();

  const float s0 = s_cond[0], s1 = s_cond[1], s2 = s_cond[2], s3 = s_cond[3],
              s4 = s_cond[4];
  const float h0 = s_cond[5], h1 = s_cond[6], h2 = s_cond[7], h3 = s_cond[8],
              h4 = s_cond[9];

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float x = xs[i], y = ys[i], ax = axs[i], ay = ays[i];
    const float ux = (x - h0) * s0;
    const float uy = (y - h1) * s1;
    const float ul = (lams[i] - h4) * s4;

    // Newton init: straight line to the aperture point
    float dx = (ax - x) * inv_ap_z;
    float dy = (ay - y) * inv_ap_z;

    for (int it = 0; it < iterations; ++it) {
      const float udx = (dx - h2) * s2;
      const float udy = (dy - h3) * s3;
      float apx = 0.f, apy = 0.f, j00 = 0.f, j01 = 0.f, j10 = 0.f, j11 = 0.f;
      for (int t = 0; t < t_ap; ++t) {
        const int8_t* e = s_ap_e + 5 * t;
        const int e2 = e[2], e3 = e[3];
        // static factor of the term (x, y, lambda), then the two unknowns
        const float base = ipow(ux, e[0]) * ipow(uy, e[1]) * ipow(ul, e[4]);
        const float pm2 = ipow(udx, e2 > 0 ? e2 - 1 : 0);
        const float pm3 = ipow(udy, e3 > 0 ? e3 - 1 : 0);
        const float m2 = e2 ? pm2 * udx : 1.0f;
        const float m3 = e3 ? pm3 * udy : 1.0f;
        const float mono = base * m2 * m3;
        const float dm_dx = e2 ? base * pm2 * m3 * (float)e2 : 0.0f;
        const float dm_dy = e3 ? base * m2 * pm3 * (float)e3 : 0.0f;
        const float cax = s_ap_c[t], cay = s_ap_c[t_ap + t];
        apx += mono * cax;
        apy += mono * cay;
        j00 += dm_dx * cax;
        j10 += dm_dx * cay;
        j01 += dm_dy * cax;
        j11 += dm_dy * cay;
      }
      // chain rule to the raw directions, closed-form 2x2 Newton update
      j00 *= s2;
      j10 *= s2;
      j01 *= s3;
      j11 *= s3;
      const float r0 = apx - ax;
      const float r1 = apy - ay;
      float det = j00 * j11 - j01 * j10;
      det = fabsf(det) < 1e-12f ? 1e-12f : det;
      dx = dx - (j11 * r0 - j01 * r1) / det;
      dy = dy - (-j10 * r0 + j00 * r1) / det;
    }

    // sensor shift onto the polynomial plane, then pt_evaluate
    const float uxs = (x + dx * sensor_shift - h0) * s0;
    const float uys = (y + dy * sensor_shift - h1) * s1;
    const float udx = (dx - h2) * s2;
    const float udy = (dy - h3) * s3;
    float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < t_pt; ++t) {
      const int8_t* e = s_pt_e + 5 * t;
      const float m = ipow(uxs, e[0]) * ipow(uys, e[1]) * ipow(udx, e[2]) *
                      ipow(udy, e[3]) * ipow(ul, e[4]);
#pragma unroll
      for (int o = 0; o < 5; ++o) acc[o] += m * s_pt_c[o * t_pt + t];
    }
    float4 o4 = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(out4)[i] = o4;
    trans_out[i] = relu_nan(acc[4]);
    dx_out[i] = dx;
    dy_out[i] = dy;
  }
}

}  // namespace pota

extern "C" int pota_po_forward(const float* x, const float* y, const float* ax,
                               const float* ay, const float* lam, int n,
                               const int8_t* ap_e, const float* ap_c, int t_ap,
                               const int8_t* pt_e, const float* pt_c, int t_pt,
                               const float* cond, float inv_ap_z,
                               float sensor_shift, int iterations, float* out4,
                               float* trans, float* dx, float* dy,
                               cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * (2 * t_ap + 5 * t_pt + 10) +
                      5 * (size_t)(t_ap + t_pt);
  if (smem > pota::kSmemDefaultMax) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  pota::po_forward_kernel<<<pota::grid_for(n, threads), threads, smem,
                            stream>>>(x, y, ax, ay, lam, n, ap_e, ap_c, t_ap,
                                      pt_e, pt_c, t_pt, cond, inv_ap_z,
                                      sensor_shift, iterations, out4, trans, dx,
                                      dy);
  return (int)cudaGetLastError();
}
