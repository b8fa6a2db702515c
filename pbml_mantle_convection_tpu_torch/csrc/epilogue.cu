// curl_advect_epilogue: curl head + upwind advection-diffusion step, in
// one cooperative launch.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/epilogue_kernel.py::
// _epilogue_kernel (CurlAdvectEpilogue). From the raw merge-3 stream
// function psi (before mean subtraction — the mean cancels in the central
// differences, so results differ from the composition only by float32
// reassociation), each thread takes one point (more, when the field
// exceeds the co-resident grid: it loops):
//   1. u = d(a_bound psi)/dy, v = -d(a_bound psi)/dx at the interior point
//      it holds or copies (psi's halo through the read-only cache),
//      replicate pad, antisymmetric u sidewalls / v top-bottom rows, zero
//      corners, times the velocity scaler; u and v stored (the engine
//      keeps them); max(|u|, |v|) over the interior, reduced in the block;
//      and everything of the temperature update but dt: the metric-aware
//      upwind advection, the conservative Laplacian and the source, with
//      u and v still in registers;
//   2. the grid-wide join: each block writes its maximum, the grid meets
//      at cooperative_groups::this_grid().sync(), and every block reduces
//      all block maxima itself (at most a few hundred floats, from L2) to
//      dt = min(0.5 cn_max dx_min / max|uv|, dt_diffuse) — the same bits
//      in every block, no atomics, no second launch, no host round trip;
//   3. T_new = T + dt rhs, T = 1 on row 0 and 0 on row H-1, clip to
//      [0, 2]. A point of the first wave uses the rhs it holds; a looped
//      point re-reads u, v from L2 and recomputes its rhs.
//
// What bounds it: at these sizes, a launch, not bytes. ~45 flops per
// point against 11 float32 fields read or written (2.3 MB at 128x506,
// 0.7 us at 3.35 TB/s); on an H100 an empty launch of the same grid takes
// 2.0 us and one grid sync 1.2 us more (tools/torch_port_energy_variants.py).
// Splitting the step at the dt join would cost a launch per pass (and a
// re-read of u, v); this design takes one, the grid capped at the
// co-resident block count (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs, cached per device) so that the grid sync is guaranteed, in
// blocks of 512 threads (fewer blocks to join: faster than 256 at every
// adaptive-dt shape measured). Two launches joined by a self-resetting ticket,
// the second a programmatic dependent launch, measured slower (the
// variants tool's two_pass_pdl). The cooperative launch captures in a
// CUDA graph, and the block-maxima scratch is rewritten before it is
// read, so a replay needs no reset.
#include "pmc_common.cuh"

namespace {

constexpr int kBlock = 512;

struct EpiArgs {
  const float* psi;
  const float* T;
  const float* dxl;
  const float* dxr;
  const float* dyt;
  const float* dyb;
  const float* src;
  float* u;
  float* v;
  float* Tn;
  float* dt;
  float* block_max;   // one float per block of the grid
  int H, W;
  float a_bound, scaler, adv_num, dt_diffuse;
};

// Point (R, C): stores u, v; returns its share of the interior max and
// the unflipped, scaled (us, vs) of the interior point it holds or copies.
__device__ __forceinline__ float velocity(const EpiArgs& a, int R, int C,
                                          float& us, float& vs) {
  const int H = a.H, W = a.W;
  const int ii = min(max(R, 1), H - 2), jj = min(max(C, 1), W - 2);
  const float u0 = (0.5f * a.a_bound) * (__ldg(&a.psi[(ii + 1) * W + jj]) -
                                         __ldg(&a.psi[(ii - 1) * W + jj]));
  const float v0 = (-0.5f * a.a_bound) * (__ldg(&a.psi[ii * W + jj + 1]) -
                                          __ldg(&a.psi[ii * W + jj - 1]));
  us = u0 * a.scaler;
  vs = v0 * a.scaler;
  const bool edge_r = (R == 0 || R == H - 1), edge_c = (C == 0 || C == W - 1);
  float uo = edge_c ? -us : us;
  float vo = edge_r ? -vs : vs;
  if (edge_r && edge_c) {
    uo = 0.f;
    vo = 0.f;
  }
  a.u[R * W + C] = uo;
  a.v[R * W + C] = vo;
  return (edge_r || edge_c) ? 0.f : fmaxf(fabsf(us), fabsf(vs));
}

// The update's right-hand side at interior row R, column jj (sidewalls
// copy their neighbour column), with velocities (ui, vi) there; tc = T.
__device__ __forceinline__ float update_rhs(const EpiArgs& a, int R, int jj,
                                            float ui, float vi, float& tc) {
  const int W = a.W;
  const int p = R * W + jj;
  const int m = (R - 1) * (W - 2) + (jj - 1);
  tc = __ldg(&a.T[p]);
  const float dl = __ldg(&a.dxl[m]), dr = __ldg(&a.dxr[m]);
  const float dtp = __ldg(&a.dyt[m]), dbm = __ldg(&a.dyb[m]);
  const float gxl = (tc - __ldg(&a.T[p - 1])) / dl;
  const float gxr = (__ldg(&a.T[p + 1]) - tc) / dr;
  const float gyt = (tc - __ldg(&a.T[p - W])) / dtp;
  const float gyb = (__ldg(&a.T[p + W]) - tc) / dbm;
  const float dTdx = (ui > 0.f ? gxl : 0.f) + (ui < 0.f ? gxr : 0.f);
  const float dTdy = (vi > 0.f ? gyt : 0.f) + (vi < 0.f ? gyb : 0.f);
  const float lap = (gxr - gxl) / (0.5f * dr + 0.5f * dl) +
                    (gyb - gyt) / (0.5f * dbm + 0.5f * dtp);
  return -ui * dTdx - vi * dTdy + lap + __ldg(a.src);
}

// The block's max of m, in every thread. Every thread must call it.
__device__ __forceinline__ float block_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float sh[kBlock / 32];
  __syncthreads();   // sh may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  m = sh[0];
#pragma unroll
  for (int k = 1; k < kBlock / 32; ++k) m = fmaxf(m, sh[k]);
  return m;
}

// [join] the grid-wide dt: every block returns the same value
__device__ __forceinline__ float grid_dt(const EpiArgs& a, float bmax) {
  if (threadIdx.x == 0) a.block_max[blockIdx.x] = bmax;
  cooperative_groups::this_grid().sync();
  float m = 0.f;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kBlock)
    m = fmaxf(m, __ldcg(&a.block_max[k]));
  m = block_max(m);
  const float dt = fminf(a.adv_num / m, a.dt_diffuse);   // m = 0: dt_diffuse
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.dt = dt;
  return dt;
}
// [/join]

__device__ __forceinline__ float stamp(int R, int H, float val) {
  val = R == 0 ? 1.f : (R == H - 1 ? 0.f : val);
  return fminf(fmaxf(val, 0.f), 2.f);
}

__global__ void __launch_bounds__(kBlock) epilogue_kernel(const EpiArgs a) {
  const int H = a.H, W = a.W, n = H * W;
  const int stride = gridDim.x * kBlock;
  const int i0 = blockIdx.x * kBlock + threadIdx.x;
  const int R0 = i0 / W, C0 = i0 - R0 * W;
  float m = 0.f, tc0 = 0.f, rhs0 = 0.f;
  if (i0 < n) {
    float us, vs;
    m = velocity(a, R0, C0, us, vs);
    if (R0 > 0 && R0 < H - 1)
      rhs0 = update_rhs(a, R0, min(max(C0, 1), W - 2), us, vs, tc0);
  }
  for (int i = i0 + stride; i < n; i += stride) {
    const int R = i / W;
    float us, vs;
    m = fmaxf(m, velocity(a, R, i - R * W, us, vs));
  }
  const float dt = grid_dt(a, block_max(m));
  if (i0 < n) a.Tn[i0] = stamp(R0, H, tc0 + dt * rhs0);
  for (int i = i0 + stride; i < n; i += stride) {
    const int R = i / W;
    float val = 0.f;
    if (R > 0 && R < H - 1) {
      const int jj = min(max(i - R * W, 1), W - 2);
      // written by this launch before the sync: through L2, not the
      // read-only cache
      const float ui = __ldcg(&a.u[R * W + jj]), vi = __ldcg(&a.v[R * W + jj]);
      float tc;
      const float rhs = update_rhs(a, R, jj, ui, vi, tc);
      val = tc + dt * rhs;
    }
    a.Tn[i] = stamp(R, H, val);
  }
}

}  // namespace

// psi, T, u, v, T_new (H, W); metrics (H-2, W-2); src and dt device
// scalars; block_max holds max_blocks floats of scratch (the grid is
// capped at max_blocks and at the co-resident block count).
extern "C" int pmc_curl_advect_epilogue(
    const float* psi, const float* T, const float* dxl, const float* dxr,
    const float* dyt, const float* dyb, const float* src, float* u, float* v,
    float* Tn, float* dt, float* block_max, int max_blocks, int H, int W,
    float a_bound, float scaler, float adv_num, float dt_diffuse,
    void* stream_ptr) {
  if (H < 3 || W < 3 || max_blocks < 1) return cudaErrorInvalidValue;
  const EpiArgs a{psi, T, dxl, dxr, dyt, dyb, src, u, v, Tn, dt, block_max,
                  H, W, a_bound, scaler, adv_num, dt_diffuse};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // [launch]
  int blocks = 0;
  const cudaError_t err =
      pmc::coresident_blocks(epilogue_kernel, kBlock, &blocks);
  if (err != cudaSuccess) return err;
  blocks = min(min(blocks, max_blocks), (H * W + kBlock - 1) / kBlock);
  return pmc::launch_cooperative(epilogue_kernel, blocks, kBlock, stream, a);
  // [/launch]
}

// The launch floor, for measurement: an empty kernel of `blocks` x
// `threads` (mode 0), the same as a cooperative launch (mode 1), and a
// cooperative launch whose blocks meet once at this_grid().sync() (mode
// 2; blocks at most the co-resident count).
__global__ void pmc_empty_kernel(int sync) {
  if (sync) cooperative_groups::this_grid().sync();
}

extern "C" int pmc_empty(int blocks, int threads, int mode,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (mode == 0) {
    pmc_empty_kernel<<<blocks, threads, 0, stream>>>(0);
    return cudaGetLastError();
  }
  return pmc::launch_cooperative(pmc_empty_kernel, blocks, threads, stream,
                                 mode == 2 ? 1 : 0);
}
