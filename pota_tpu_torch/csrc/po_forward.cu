// PO forward kernel (K1).
//
// Replaces: pota_tpu/ops/po_pallas.py::build_po_forward_kernel, the fused
// per-lens forward trace behind models/po_camera.py::trace_fw_po.
//
// Per ray: a fixed-iteration 2x2 Newton on the aperture polynomial `ap` for
// the sensor directions (dx, dy) that reach the aperture sample, the sensor
// shift, then pt_evaluate of the outer-pupil chart + transmittance.
//
// What bounds it on the H100: arithmetic.  On the folded table about 1,100
// FMAs a ray (the collapse of `ap` to (dx, dy), 3 Newton iterations of 76,
// pt's five rows over the 126-monomial basis) and 221 broadcast 16-byte
// shared loads, against 20 bytes in and 28 bytes out.
//
// Design: every ray of a frame has the frame's wavelength, so the kernel
// runs po_forward_trace (po_forward_basis.cuh) on the table
// po_kernels.py fold_forward_tables folds at that wavelength: exponents
// known at compile time (no runtime powers, no loop over a term list, no
// per-ray wavelength), `ap` collapsed once per ray to its 21 coefficients in
// (dx, dy).  One thread per ray, a grid-stride loop; the 3.5 KB table is
// copied into shared memory once per block and read with volatile 16-byte
// loads (basis::ld4), which the compiler cannot hoist out of the ray loop.
// On an H100 (sm_90a, CUDA 12.8) it takes 87 registers and spills nothing.
// One build serves every lens (the TPU kernel baked each lens into
// immediates).
#include "po_forward_basis.cuh"

namespace pota {

constexpr int kForwardThreads = 256;

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
