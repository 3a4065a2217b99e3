// PO forward kernel (K1), with a candidate mode and a select mode.
//
// Replaces: pota_tpu/ops/po_pallas.py::build_po_forward_kernel, the fused
// per-lens forward trace behind models/po_camera.py::trace_fw_po; the
// select mode also the XLA epilogue after it (po_chart.cuh).
//
// Per candidate: a fixed-iteration 2x2 Newton on the aperture polynomial
// `ap` for the sensor directions (dx, dy) that reach the aperture sample,
// the sensor shift, then pt_evaluate of the outer-pupil chart +
// transmittance.
//
// Two modes:
// - candidates (pota_po_forward, po_forward_kernel): the caller hands
//   every candidate's sensor point and aperture point, [M] each; the image
//   bokeh's trace takes it, its candidates drawn from the bokeh's CDF;
// - select (pota_po_forward_selected, po_forward_select_kernel): the
//   caller hands each ray's screen point, its (r1, r2) and its uint32 retry
//   key, and the kernel draws the ray's K aperture candidates itself, as
//   po_kernels.py drawn_rays does in torch: candidate 0 on (r1, r2),
//   candidate k >= 1 on two LCG steps after TEA-8(key, k), the concentric
//   disk (fewer than 2 blades) or the blade fan, times the aperture radius.
//   Every float operation of the draw is the torch chain's, in its order,
//   rounded alone (__fmul_rn / __fadd_rn / __fdiv_rn, cosf / sinf as
//   torch's kernels call them), so the candidates are those of the torch
//   chain bit for bit.  Thread i takes ray i: it draws and traces the ray's
//   candidates in turn, stops at the first that passes the pupil crops,
//   maps that chart (or candidate 0's, when none passes) to the
//   camera-space ray and writes origin, direction, weight and tries, the
//   bits of the torch draw, the candidate mode and trace_fw_po's torch
//   epilogue (po_chart.cuh); where asked, the selected candidate's sensor
//   point, solution and chart, which the differentiable route saves for
//   K1v's select mode.  A candidate after the first that passes is never
//   traced: its outputs reach no ray.
//
// What bounds it on the H100: arithmetic.  On the folded table about 1,100
// FMAs a candidate (the collapse of `ap` to (dx, dy), 3 Newton iterations
// of 76, pt's five rows over the 126-monomial basis) and 221 broadcast
// 16-byte shared loads, against 20 bytes in and 28 bytes out in the
// candidate mode.  The select mode's draw adds about 200 integer operations
// (TEA's 8 rounds, two LCG steps) and one sine and cosine a candidate; it
// reads 24 bytes a ray (sx, sy, r1, r2, the key) and writes 32 (64 with the
// saved candidate), and traces between one candidate a ray and K: a warp
// runs until its last lane's first success.
//
// Design: every ray of a frame has the frame's wavelength, so the kernel
// runs po_forward_trace (po_forward_basis.cuh) on the table
// po_kernels.py fold_forward_tables folds at that wavelength: exponents
// known at compile time (no runtime powers, no loop over a term list, no
// per-ray wavelength), `ap` collapsed once per candidate to its 21
// coefficients in (dx, dy).  One thread per candidate (per ray in the
// select mode), a grid-stride loop; the 3.5 KB table is copied into shared
// memory once per block and read with volatile 16-byte loads (basis::ld4),
// which the compiler cannot hoist out of the loop.  On an H100 (sm_90a,
// CUDA 12.8) the candidate mode takes 87 registers and the select mode 102,
// and neither spills.  One build serves every lens (the TPU kernel baked
// each lens into immediates).
#include "po_chart.cuh"
#include "po_forward_basis.cuh"

namespace pota {

constexpr int kForwardThreads = 256;

// The select mode's draw: its inputs per ray and the draw's constants.
struct ForwardDraw {
  const float* r1;
  const float* r2;
  const long long* key;  // the uint32 retry key in an int64 word
  int tries;             // K candidates a ray
  int blades;            // < 2: the concentric disk; else the blade fan
  float radius;          // the aperture radius (mm)
  float blade_angle;     // float32 of 2 pi / blades (a double in torch)
};

// samplers.concentric_disk_sample, each torch op rounded alone.  It is
// common.cuh's concentric_polar and tea_concentric_disk but for that
// rounding: there nvcc contracts phi's kPi2 - kPi4 * q into one FMA, which
// K3's splat disk keeps (rounded alone, K3's frames would change bits),
// while the select mode must round as torch does to give the torch chain's
// candidates bit for bit.
__device__ __forceinline__ void drawn_disk(float r1, float r2, float& x,
                                           float& y) {
  const float kPi4 = static_cast<float>(3.141592653589793 / 4.0);
  const float kPi2 = static_cast<float>(3.141592653589793 / 2.0);
  const float a = __fadd_rn(__fmul_rn(2.0f, r1), -1.0f);
  const float b = __fadd_rn(__fmul_rn(2.0f, r2), -1.0f);
  const bool use_a = __fmul_rn(a, a) > __fmul_rn(b, b);
  const float safe_a = (a == 0.0f) ? 1.0f : a;
  const float safe_b = (b == 0.0f) ? 1.0f : b;
  const float r = use_a ? a : b;
  const float phi = use_a ? __fmul_rn(kPi4, __fdiv_rn(b, safe_a))
                          : __fsub_rn(kPi2, __fmul_rn(kPi4,
                                                      __fdiv_rn(a, safe_b)));
  const bool both_zero = (a == 0.0f) && (b == 0.0f);
  x = both_zero ? 0.0f : __fmul_rn(r, cosf(phi));
  y = both_zero ? 0.0f : __fmul_rn(r, sinf(phi));
}

// samplers.triangular_aperture_sample at radius 1, each torch op rounded
// alone (its `radius *` is a multiplication by 1.0, exact).
__device__ __forceinline__ void drawn_fan(float r1, float r2, int blades,
                                          float blade_angle, float& x,
                                          float& y) {
  const float scaled = __fmul_rn(r1, static_cast<float>(blades));
  const float tri = floorf(scaled);
  const float a = __fsqrt_rn(__fsub_rn(scaled, tri));
  const float b = __fmul_rn(__fsub_rn(1.0f, r2), a);
  const float c = __fmul_rn(r2, a);
  const float ang1 = __fmul_rn(blade_angle, __fadd_rn(tri, 1.0f));
  const float ang2 = __fmul_rn(blade_angle, tri);
  x = __fadd_rn(__fmul_rn(b, cosf(ang1)), __fmul_rn(c, cosf(ang2)));
  y = __fadd_rn(__fmul_rn(b, sinf(ang1)), __fmul_rn(c, sinf(ang2)));
}

// Candidate k of ray `ray`: its aperture point (mm).
__device__ __forceinline__ void drawn_aperture(const ForwardDraw& d, int ray,
                                               int k, float& ax, float& ay) {
  float u1, u2;
  if (k == 0) {
    u1 = d.r1[ray];
    u2 = d.r2[ray];
  } else {
    uint32_t state = tea8(static_cast<uint32_t>(d.key[ray]),
                          static_cast<uint32_t>(k));
    u1 = lcg_uniform(state);  // exact: a 24-bit integer times 2^-24
    u2 = lcg_uniform(state);
  }
  float px, py;
  if (d.blades < 2) {
    drawn_disk(u1, u2, px, py);
  } else {
    drawn_fan(u1, u2, d.blades, d.blade_angle, px, py);
  }
  ax = __fmul_rn(px, d.radius);
  ay = __fmul_rn(py, d.radius);
}

// n candidates: sensor points xs, ys and aperture points axs, ays [n].
__global__ void __launch_bounds__(kForwardThreads)
po_forward_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ axs, const float* __restrict__ ays,
                  int n, const float* __restrict__ g_tab, float inv_ap_z,
                  float sensor_shift, int iterations, float* __restrict__ out4,
                  float* __restrict__ trans_out, float* __restrict__ dx_out,
                  float* __restrict__ dy_out) {
  __shared__ __align__(16) float s_tab[fwd::kTableFloats];
  block_load(s_tab, g_tab, fwd::kTableFloats);
  __syncthreads();

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float dx, dy, o[4];
    const float tr = po_forward_trace(s_tab, inv_ap_z, sensor_shift,
                                      iterations, xs[i], ys[i], axs[i],
                                      ays[i], dx, dy, o);
    reinterpret_cast<float4*>(out4)[i] = make_float4(o[0], o[1], o[2], o[3]);
    trans_out[i] = relu_nan(tr);
    dx_out[i] = dx;
    dy_out[i] = dy;
  }
}

// The select mode's per-ray inputs and outputs beside ForwardDraw's.
struct ForwardSelect {
  const float* sx;  // the rays' screen points [n_rays]
  const float* sy;
  float hsw;        // half the sensor width (mm): x = sx hsw, y = sy hsw
  PupilSelect pupil;
  float* origin;     // [n_rays, 3]
  float* direction;  // [n_rays, 3]
  float* weight;     // [n_rays]
  int* tries;        // [n_rays]
  // the selected candidate's sensor point, solution and chart, [n_rays]
  // and [n_rays, 4]; null: not written
  float *x, *y, *dx, *dy, *out4;
};

// One thread a ray: its K candidates drawn (drawn_aperture) and traced in
// turn, until the first that passes the crops (crops_ok); that one's
// chart, or candidate 0's when none passes, mapped to the ray (chart_ray);
// weight 1 where a candidate passed and the ray is finite, tries the first
// candidate that passed (K when none did), as po_kernels.py select_rays
// selects them.
__global__ void __launch_bounds__(kForwardThreads)
po_forward_select_kernel(int n_rays, const float* __restrict__ g_tab,
                         float inv_ap_z, float sensor_shift, int iterations,
                         const ForwardDraw draw, const ForwardSelect sel) {
  __shared__ __align__(16) float s_tab[fwd::kTableFloats];
  block_load(s_tab, g_tab, fwd::kTableFloats);
  __syncthreads();

  for (int ray = blockIdx.x * blockDim.x + threadIdx.x; ray < n_rays;
       ray += gridDim.x * blockDim.x) {
    const float x = __fmul_rn(sel.sx[ray], sel.hsw);
    const float y = __fmul_rn(sel.sy[ray], sel.hsw);
    float o[4], dx, dy;
    float o_first[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dx_first = 0.0f,
          dy_first = 0.0f;
    int first = draw.tries;
    for (int k = 0; k < draw.tries; ++k) {
      float ax, ay;
      drawn_aperture(draw, ray, k, ax, ay);
      const float tr = relu_nan(po_forward_trace(
          s_tab, inv_ap_z, sensor_shift, iterations, x, y, ax, ay, dx, dy,
          o));
      if (crops_ok(sel.pupil, x, y, dx, dy, o, tr, sensor_shift)) {
        first = k;
        break;
      }
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o_first[j] = o[j];
        dx_first = dx;
        dy_first = dy;
      }
    }
    if (first == draw.tries) {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = o_first[j];
      dx = dx_first;
      dy = dy_first;
    }
    float org[3], dir[3];
    chart_ray(sel.pupil, o, org, dir);
    bool finite = true;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      finite = finite && isfinite(org[j]) && isfinite(dir[j]);
      sel.origin[3 * ray + j] = org[j];
      sel.direction[3 * ray + j] = dir[j];
    }
    sel.weight[ray] = (first < draw.tries && finite) ? 1.0f : 0.0f;
    sel.tries[ray] = first;
    if (sel.x != nullptr) {
      sel.x[ray] = x;
      sel.y[ray] = y;
      sel.dx[ray] = dx;
      sel.dy[ray] = dy;
      reinterpret_cast<float4*>(sel.out4)[ray] =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

}  // namespace pota

// table: the folded forward table of the frame's wavelength
// (po_kernels.py fold_forward_tables, pota::fwd::kTableFloats floats)
extern "C" int pota_po_forward(const float* x, const float* y, const float* ax,
                               const float* ay, int n, const float* table,
                               float inv_ap_z, float sensor_shift,
                               int iterations, float* out4, float* trans,
                               float* dx, float* dy, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  constexpr int threads = pota::kForwardThreads;
  pota::po_forward_kernel<<<pota::grid_for(n, threads), threads, 0,
                            stream>>>(x, y, ax, ay, n, table, inv_ap_z,
                                      sensor_shift, iterations, out4, trans,
                                      dx, dy);
  return (int)cudaGetLastError();
}

// The select mode: n_rays rays of `tries` candidates each; sx, sy, r1, r2
// (f32) and key (int64) [n_rays] (key null when tries is 1); the pupil's
// constants (PupilSelect, in its order); origin, direction [n_rays, 3],
// weight [n_rays] f32, tries_out [n_rays] int32; the selected candidate's
// x, y, dx, dy [n_rays] and out4 [n_rays, 4] (16-byte aligned) written
// when x is not null (then all five are given).
extern "C" int pota_po_forward_selected(
    const float* sx, const float* sy, float hsw, const float* r1,
    const float* r2, const long long* key, int n_rays, int tries,
    float radius, int blades, float blade_angle, const float* table,
    float inv_ap_z, float sensor_shift, int iterations, int chart, float R,
    float R2, float inv_R, float inv_absR, float center, float scale,
    float r_outer2, float r_inner2, float bfl, float* origin,
    float* direction, float* weight, int* tries_out, float* x, float* y,
    float* dx, float* dy, float* out4, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  const pota::ForwardDraw draw{r1, r2, key, tries, blades, radius,
                               blade_angle};
  const pota::ForwardSelect sel{
      sx, sy, hsw,
      pota::PupilSelect{chart, R, R2, inv_R, inv_absR, center, scale,
                        r_outer2, r_inner2, bfl},
      origin, direction, weight, tries_out, x, y, dx, dy, out4};
  constexpr int threads = pota::kForwardThreads;
  pota::po_forward_select_kernel<<<pota::grid_for(n_rays, threads), threads,
                                   0, stream>>>(
      n_rays, table, inv_ap_z, sensor_shift, iterations, draw, sel);
  return (int)cudaGetLastError();
}
