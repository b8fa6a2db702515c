// curl_advect_epilogue: curl head + upwind advection-diffusion step.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/epilogue_kernel.py::
// _epilogue_kernel (CurlAdvectEpilogue). From the raw merge-3 stream
// function psi (before mean subtraction — the mean cancels in the central
// differences, so results differ from the composition only by float32
// reassociation):
//   pass 1  u = d(a_bound psi)/dy, v = -d(a_bound psi)/dx on the interior,
//           replicate pad, antisymmetric u sidewalls / v top-bottom rows,
//           zero corners, times the velocity scaler; per-block max of
//           max(|u|, |v|) over the interior;
//   pass 2  one block reduces the block maxima and writes
//           dt = min(0.5 cn_max dx_min / max|uv|, dt_diffuse) to device
//           memory — no host round trip inside a step;
//   pass 3  reads dt from device memory: metric-aware upwind advection,
//           conservative Laplacian and source, Euler update, replicate
//           pad, T = 1 on row 0 and 0 on row H-1, clip to [0, 2].
//
// What bounds it: bytes. ~40 flops per point against 11 float32 fields
// read or written (~2.8 MB at 128x506, ~0.85 us at 3.35 TB/s); the fields
// stay in the 50 MB L2 between passes. Design: one thread per point,
// coalesced row-major access, neighbours read through the read-only
// cache; the only cross-block dependency (the global max) is a separate
// one-block pass, so no atomics or host syncs.
#include "pmc_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
epi_velocity_kernel(const float* __restrict__ psi, float* __restrict__ u,
                    float* __restrict__ v, float* __restrict__ block_max,
                    int H, int W, float a_bound, float scaler) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.f;
  if (i < H * W) {
    const int R = i / W, C = i - (i / W) * W;
    // the interior point whose value this one copies (replicate pad)
    const int ii = min(max(R, 1), H - 2), jj = min(max(C, 1), W - 2);
    const float u0 = (0.5f * a_bound) *
                     (__ldg(&psi[(ii + 1) * W + jj]) - __ldg(&psi[(ii - 1) * W + jj]));
    const float v0 = (-0.5f * a_bound) *
                     (__ldg(&psi[ii * W + jj + 1]) - __ldg(&psi[ii * W + jj - 1]));
    const float us = u0 * scaler, vs = v0 * scaler;
    const bool edge_r = (R == 0 || R == H - 1), edge_c = (C == 0 || C == W - 1);
    float uo = edge_c ? -us : us;
    float vo = edge_r ? -vs : vs;
    if (edge_r && edge_c) {
      uo = 0.f;
      vo = 0.f;
    }
    u[i] = uo;
    v[i] = vo;
    if (!edge_r && !edge_c) m = fmaxf(fabsf(us), fabsf(vs));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ float sh[kBlock / 32];
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = sh[0];
    for (int k = 1; k < kBlock / 32; ++k) b = fmaxf(b, sh[k]);
    block_max[blockIdx.x] = b;
  }
}

__global__ void __launch_bounds__(1024)
epi_dt_kernel(const float* __restrict__ block_max, int n, float adv_num,
              float dt_diffuse, float* __restrict__ dt) {
  float m = 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) m = fmaxf(m, block_max[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ float sh[32];
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = sh[0];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) b = fmaxf(b, sh[k]);
    dt[0] = fminf(adv_num / b, dt_diffuse);
  }
}

__global__ void __launch_bounds__(kBlock)
epi_temperature_kernel(const float* __restrict__ T, const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ dxl,
                       const float* __restrict__ dxr,
                       const float* __restrict__ dyt,
                       const float* __restrict__ dyb,
                       const float* __restrict__ dt_ptr,
                       const float* __restrict__ src_ptr,
                       float* __restrict__ Tn, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int R = i / W, C = i - (i / W) * W;
  float val;
  if (R == 0) {
    val = 1.f;
  } else if (R == H - 1) {
    val = 0.f;
  } else {
    const int jj = min(max(C, 1), W - 2);   // sidewalls copy their neighbour
    const int p = R * W + jj;
    const int m = (R - 1) * (W - 2) + (jj - 1);
    const float tc = __ldg(&T[p]);
    const float dl = __ldg(&dxl[m]), dr = __ldg(&dxr[m]);
    const float dtp = __ldg(&dyt[m]), dbm = __ldg(&dyb[m]);
    const float gxl = (tc - __ldg(&T[p - 1])) / dl;
    const float gxr = (__ldg(&T[p + 1]) - tc) / dr;
    const float gyt = (tc - __ldg(&T[p - W])) / dtp;
    const float gyb = (__ldg(&T[p + W]) - tc) / dbm;
    const float ui = __ldg(&u[p]), vi = __ldg(&v[p]);
    const float dTdx = (ui > 0.f ? gxl : 0.f) + (ui < 0.f ? gxr : 0.f);
    const float dTdy = (vi > 0.f ? gyt : 0.f) + (vi < 0.f ? gyb : 0.f);
    const float lap = (gxr - gxl) / (0.5f * dr + 0.5f * dl) +
                      (gyb - gyt) / (0.5f * dbm + 0.5f * dtp);
    val = tc + __ldg(dt_ptr) * (-ui * dTdx - vi * dTdy + lap + __ldg(src_ptr));
  }
  Tn[i] = fminf(fmaxf(val, 0.f), 2.f);
}

}  // namespace

// psi, T, u, v, T_new (H, W); metrics (H-2, W-2); src and dt device
// scalars; block_max holds ceil(H*W / 256) floats of scratch.
extern "C" int pmc_curl_advect_epilogue(
    const float* psi, const float* T, const float* dxl, const float* dxr,
    const float* dyt, const float* dyb, const float* src, float* u, float* v,
    float* Tn, float* dt, float* block_max, int H, int W, float a_bound,
    float scaler, float adv_num, float dt_diffuse, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H < 3 || W < 3) return cudaErrorInvalidValue;
  const int nb = (H * W + kBlock - 1) / kBlock;
  epi_velocity_kernel<<<nb, kBlock, 0, stream>>>(psi, u, v, block_max, H, W,
                                                  a_bound, scaler);
  epi_dt_kernel<<<1, 1024, 0, stream>>>(block_max, nb, adv_num, dt_diffuse,
                                        dt);
  epi_temperature_kernel<<<nb, kBlock, 0, stream>>>(
      T, u, v, dxl, dxr, dyt, dyb, dt, src, Tn, H, W);
  return cudaGetLastError();
}
