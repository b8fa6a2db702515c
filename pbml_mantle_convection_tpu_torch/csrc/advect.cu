// advect_diffuse_step_fused: the explicit energy step of the coupled rollout.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/pallas_kernels.py::
// _advect_kernel (advect_diffuse_step_pallas). For B simulations of (H, W):
//   pass 1  (only when the caller gives no dt) per-block max of |u|, |v|
//           over the interior of every simulation, and min of dx_l;
//   pass 2  one block reduces the block results and writes
//           dt = min(0.5 cn_max dx_min / max|uv|, 0.5 (dx²)² / (dx² + dx²))
//           to device memory: one dt for the whole batch, as in JAX, and
//           no host round trip inside a step;
//   pass 3  one thread per output point (b, r, c): metric-aware upwind
//           advection, conservative Laplacian, the source (a device scalar
//           or a (B, H-2, W-2) field), the Euler update, the optional clip
//           of the interior to [0, 2], then the BCs in the Pallas kernel's
//           order: the sidewalls copy their neighbour column, row H-1 =
//           top_T, row 0 = bottom_T or, under core cooling, a copy of row 1
//           (corners included).
// Templated on float and double: the JAX kernel is dtype-generic, and GAIA
// studies run in float64.
//
// What bounds it: bytes. ~30 flops per point against u, v, T and four
// (H-2, W-2) metric arrays read and T written: at 128x506 in float32 about
// 2.0 MB, ~0.6 us at 3.35 TB/s, below the time of one launch, so launch
// latency sets its time. Design (as csrc/epilogue.cu): one thread per point,
// coalesced row-major access, neighbours through the read-only cache; a
// boundary point recomputes the interior point it copies rather than wait
// for it, so the BCs need no extra pass; the only cross-block dependency
// (the global max for dt) is a one-block second pass: no atomics.
#include "pmc_common.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// Block-wide (max, min) of one value pair per thread; thread 0 ends with
// the block's result. Every thread of the block must call it.
template <typename T>
__device__ void block_max_min(T& mx, T& mn) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = tmax(mx, __shfl_down_sync(0xffffffffu, mx, off));
    mn = tmin(mn, __shfl_down_sync(0xffffffffu, mn, off));
  }
  __shared__ T smx[32], smn[32];
  if ((threadIdx.x & 31) == 0) {
    smx[threadIdx.x >> 5] = mx;
    smn[threadIdx.x >> 5] = mn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      mx = tmax(mx, smx[k]);
      mn = tmin(mn, smn[k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
adv_reduce_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ dxl, T* __restrict__ part, int B,
                  int H, int W) {
  const int hw = (H - 2) * (W - 2);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T mx = T(0);
  T mn = __ldg(&dxl[0]);
  if (i < B * hw) {
    const int b = i / hw, m = i - b * hw;
    const int r = m / (W - 2) + 1, c = m - (m / (W - 2)) * (W - 2) + 1;
    const int p = (b * H + r) * W + c;
    mx = tmax(tabs(__ldg(&u[p])), tabs(__ldg(&v[p])));
    mn = __ldg(&dxl[m]);
  }
  block_max_min(mx, mn);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = mx;
    part[2 * blockIdx.x + 1] = mn;
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
adv_dt_kernel(const T* __restrict__ part, int nb, T adv_coef,
              T* __restrict__ dt) {
  T mx = T(0);
  T mn = part[1];
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    mx = tmax(mx, part[2 * k]);
    mn = tmin(mn, part[2 * k + 1]);
  }
  block_max_min(mx, mn);
  if (threadIdx.x == 0) {
    // the plain version's expressions, in its order
    const T d2 = mn * mn;
    const T dt_advect = adv_coef * mn / mx;
    const T dt_diffuse = T(0.5) * (d2 * d2) / (d2 + d2);
    dt[0] = tmin(dt_advect, dt_diffuse);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
adv_update_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ Tf, const T* __restrict__ dxl,
                  const T* __restrict__ dxr, const T* __restrict__ dyt,
                  const T* __restrict__ dyb, const T* __restrict__ src,
                  int src_field, const T* __restrict__ dt_ptr,
                  T* __restrict__ out, int B, int H, int W, T bottom_T,
                  T top_T, int core_cool, int clip_T) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int b = i / (H * W), q = i - b * (H * W);
  const int R = q / W, C = q - (q / W) * W;
  if (R == H - 1) {
    out[i] = top_T;
    return;
  }
  if (R == 0 && !core_cool) {
    out[i] = bottom_T;
    return;
  }
  // the interior point this one holds or copies
  const int ii = R == 0 ? 1 : R;
  const int jj = min(max(C, 1), W - 2);
  const int p = (b * H + ii) * W + jj;
  const int m = (ii - 1) * (W - 2) + (jj - 1);
  const T tc = __ldg(&Tf[p]);
  const T dl = __ldg(&dxl[m]), dr = __ldg(&dxr[m]);
  const T dtp = __ldg(&dyt[m]), dbm = __ldg(&dyb[m]);
  const T gl = (tc - __ldg(&Tf[p - 1])) / dl;
  const T gr = (__ldg(&Tf[p + 1]) - tc) / dr;
  const T gt = (tc - __ldg(&Tf[p - W])) / dtp;
  const T gb = (__ldg(&Tf[p + W]) - tc) / dbm;
  const T ui = __ldg(&u[p]), vi = __ldg(&v[p]);
  const T dTdx = ui > T(0) ? gl : (ui < T(0) ? gr : T(0));
  const T dTdy = vi > T(0) ? gt : (vi < T(0) ? gb : T(0));
  const T lap = (gr - gl) / (T(0.5) * dr + T(0.5) * dl) +
                (gb - gt) / (T(0.5) * dbm + T(0.5) * dtp);
  const T s = src_field ? __ldg(&src[b * (H - 2) * (W - 2) + m]) : __ldg(src);
  T val = tc + __ldg(dt_ptr) * (-ui * dTdx - vi * dTdy + lap + s);
  if (clip_T) val = tmin(tmax(val, T(0)), T(2));
  out[i] = val;
}

template <typename T>
int advect(const T* u, const T* v, const T* Tf, const T* dxl, const T* dxr,
           const T* dyt, const T* dyb, const T* src, int src_field,
           const T* dt_in, T* dt_out, T* part, T* out, int B, int H, int W,
           double cn_max, double bottom_T, double top_T, int core_cool,
           int clip_T, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || H < 3 || W < 3) return cudaErrorInvalidValue;
  const T* dt = dt_in;
  if (dt == nullptr) {
    const int nb = (B * (H - 2) * (W - 2) + kBlock - 1) / kBlock;
    adv_reduce_kernel<T><<<nb, kBlock, 0, stream>>>(u, v, dxl, part, B, H, W);
    adv_dt_kernel<T><<<1, 1024, 0, stream>>>(part, nb, T(0.5 * cn_max),
                                             dt_out);
    dt = dt_out;
  }
  const int nb = (B * H * W + kBlock - 1) / kBlock;
  adv_update_kernel<T><<<nb, kBlock, 0, stream>>>(
      u, v, Tf, dxl, dxr, dyt, dyb, src, src_field, dt, out, B, H, W,
      T(bottom_T), T(top_T), core_cool, clip_T);
  return cudaGetLastError();
}

}  // namespace

// u, v, T, out (B, H, W); metrics (H-2, W-2); src a device scalar
// (src_field = 0) or (B, H-2, W-2); dt_in a device scalar or null, in which
// case dt_out receives the adaptive dt and part holds
// 2 * ceil(B (H-2) (W-2) / 256) values of scratch.
#define PMC_ADVECT_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const T* u, const T* v, const T* Tf, const T* dxl,      \
                      const T* dxr, const T* dyt, const T* dyb, const T* src, \
                      int src_field, const T* dt_in, T* dt_out, T* part,      \
                      T* out, int B, int H, int W, double cn_max,             \
                      double bottom_T, double top_T, int core_cool,           \
                      int clip_T, void* stream) {                             \
    return advect<T>(u, v, Tf, dxl, dxr, dyt, dyb, src, src_field, dt_in,     \
                     dt_out, part, out, B, H, W, cn_max, bottom_T, top_T,     \
                     core_cool, clip_T, stream);                              \
  }

PMC_ADVECT_ENTRY(pmc_advect_f32, float)
PMC_ADVECT_ENTRY(pmc_advect_f64, double)
