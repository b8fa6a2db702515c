// advect_diffuse_step_fused: the explicit energy step of the coupled
// rollout, in one launch.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/pallas_kernels.py::
// _advect_kernel (advect_diffuse_step_pallas). For B simulations of (H, W),
// one thread per output point (b, r, c), looping when B H W exceeds the
// co-resident grid (B = 16 at 128x506 does, on an H100):
//   1. the interior point it holds or copies: u, v and the metrics there,
//      T and its four neighbours; the metric-aware upwind advection, the
//      conservative Laplacian and the source (a device scalar or a
//      (B, H-2, W-2) field) — the whole update but dt, held in registers;
//      and its share of max(|u|, |v|) and of min(dx_l), reduced in the
//      block;
//   2. (only when the caller gives no dt) the grid-wide join: each block
//      writes its (max, min) pair, the grid meets at
//      cooperative_groups::this_grid().sync(), and every block reduces all
//      pairs itself to dt = min(0.5 cn_max dx_min / max|uv|,
//      0.5 (dx²)² / (dx² + dx²)): one dt for the whole batch, as in JAX,
//      the same bits in every block, no host round trip;
//   3. T + dt rhs, the optional clip of the interior to [0, 2], then the
//      BCs in the Pallas kernel's order: the sidewalls copy their
//      neighbour column, row H-1 = top_T, row 0 = bottom_T or, under core
//      cooling, a copy of row 1 (corners included). A looped point re-reads
//      its inputs from L2 past the sync.
// dx_min stays in the kernel: the update reads dx_l at every interior
// point anyway, so its min costs no bytes, and the caller needs no host
// read of the metrics. Templated on float and double: the JAX kernel is
// dtype-generic, and GAIA studies run in float64.
//
// What bounds it: at these sizes, a launch, not bytes. ~30 flops per point
// against u, v, T and four (H-2, W-2) metric arrays read and T written:
// at 128x506 in float32 about 2.0 MB, 0.6 us at 3.35 TB/s, against 2.0 us
// for an empty launch of the same grid on an H100 and 1.2 us more for one
// grid sync (tools/torch_port_energy_variants.py). Splitting the step at
// the dt join would cost a launch per pass; this design takes one
// cooperative launch, the grid capped at the co-resident block count so
// that the grid sync is guaranteed, in blocks of 512 threads (as
// csrc/epilogue.cu). With a given dt it is one ordinary launch of one
// thread per point. The cooperative launch captures in a CUDA graph, and
// the per-block scratch is rewritten before it is read, so a replay needs
// no reset.
#include "pmc_common.cuh"

namespace {

constexpr int kBlock = 512;

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

template <typename T>
struct AdvArgs {
  const T* u;
  const T* v;
  const T* Tf;
  const T* dxl;
  const T* dxr;
  const T* dyt;
  const T* dyb;
  const T* src;
  const T* dt_in;   // null: the adaptive dt
  T* dt_out;
  T* part;          // a (max, min) pair per block of the grid
  T* out;
  int src_field, B, H, W;
  T adv_coef, bottom_T, top_T;   // adv_coef = 0.5 cn_max
  int core_cool, clip_T;
};

// Output point i = (b, R, C) of a plate row that the BCs set, or the
// interior point (b, ii, jj) whose update it holds or copies.
template <typename T>
struct Point {
  int b, R, p, m;   // p: (b, ii, jj) in the fields; m: (ii, jj) in metrics
  bool plate;
  T plate_value;
};

template <typename T>
__device__ __forceinline__ Point<T> locate(const AdvArgs<T>& a, int i) {
  const int H = a.H, W = a.W;
  Point<T> q;
  q.b = i / (H * W);
  const int r = i - q.b * (H * W);
  q.R = r / W;
  const int C = r - q.R * W;
  q.plate = q.R == H - 1 || (q.R == 0 && !a.core_cool);
  q.plate_value = q.R == H - 1 ? a.top_T : a.bottom_T;
  const int ii = q.R == 0 ? 1 : q.R;
  const int jj = min(max(C, 1), W - 2);
  q.p = (q.b * H + ii) * W + jj;
  q.m = (ii - 1) * (W - 2) + (jj - 1);
  return q;
}

// The update's right-hand side at q with velocities (ui, vi) there;
// tc = T and dl = dx_l there.
template <typename T>
__device__ __forceinline__ T update_rhs(const AdvArgs<T>& a,
                                        const Point<T>& q, T ui, T vi, T& tc,
                                        T& dl) {
  const int p = q.p, m = q.m, W = a.W;
  tc = __ldg(&a.Tf[p]);
  dl = __ldg(&a.dxl[m]);
  const T dr = __ldg(&a.dxr[m]);
  const T dtp = __ldg(&a.dyt[m]), dbm = __ldg(&a.dyb[m]);
  const T gl = (tc - __ldg(&a.Tf[p - 1])) / dl;
  const T gr = (__ldg(&a.Tf[p + 1]) - tc) / dr;
  const T gt = (tc - __ldg(&a.Tf[p - W])) / dtp;
  const T gb = (__ldg(&a.Tf[p + W]) - tc) / dbm;
  const T dTdx = ui > T(0) ? gl : (ui < T(0) ? gr : T(0));
  const T dTdy = vi > T(0) ? gt : (vi < T(0) ? gb : T(0));
  const T lap = (gr - gl) / (T(0.5) * dr + T(0.5) * dl) +
                (gb - gt) / (T(0.5) * dbm + T(0.5) * dtp);
  const T s = a.src_field ? __ldg(&a.src[q.b * (a.H - 2) * (a.W - 2) + m])
                          : __ldg(a.src);
  return -ui * dTdx - vi * dTdy + lap + s;
}

template <typename T>
__device__ __forceinline__ T finish(const AdvArgs<T>& a, const Point<T>& q,
                                    T tc, T rhs, T dt) {
  if (q.plate) return q.plate_value;
  T val = tc + dt * rhs;
  if (a.clip_T) val = tmin(tmax(val, T(0)), T(2));
  return val;
}

// The block's (max, min) of (mx, mn), in every thread. Every thread must
// call it.
template <typename T>
__device__ __forceinline__ void block_max_min(T& mx, T& mn) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = tmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = tmin(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  __shared__ T smx[kBlock / 32], smn[kBlock / 32];
  __syncthreads();   // the arrays may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) {
    smx[threadIdx.x >> 5] = mx;
    smn[threadIdx.x >> 5] = mn;
  }
  __syncthreads();
  mx = smx[0];
  mn = smn[0];
#pragma unroll
  for (int k = 1; k < kBlock / 32; ++k) {
    mx = tmax(mx, smx[k]);
    mn = tmin(mn, smn[k]);
  }
}

// [join] the grid-wide dt: every block returns the same value
template <typename T>
__device__ __forceinline__ T grid_dt(const AdvArgs<T>& a, T mx, T mn) {
  block_max_min(mx, mn);
  if (threadIdx.x == 0) {
    a.part[2 * blockIdx.x] = mx;
    a.part[2 * blockIdx.x + 1] = mn;
  }
  cooperative_groups::this_grid().sync();
  mx = T(0);
  mn = T(INFINITY);
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kBlock) {
    mx = tmax(mx, __ldcg(&a.part[2 * k]));
    mn = tmin(mn, __ldcg(&a.part[2 * k + 1]));
  }
  block_max_min(mx, mn);
  // the plain version's expressions, in its order; mx = 0 gives
  // dt_advect = inf and so dt_diffuse
  const T d2 = mn * mn;
  const T dt_advect = a.adv_coef * mn / mx;
  const T dt_diffuse = T(0.5) * (d2 * d2) / (d2 + d2);
  const T dt = tmin(dt_advect, dt_diffuse);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.dt_out = dt;
  return dt;
}
// [/join]

template <typename T>
__global__ void __launch_bounds__(kBlock) advect_kernel(const AdvArgs<T> a) {
  const int n = a.B * a.H * a.W;
  const int stride = gridDim.x * kBlock;
  const int i0 = blockIdx.x * kBlock + threadIdx.x;
  // the first point's update, held across the join
  Point<T> q0{};
  T tc0 = T(0), rhs0 = T(0), mx = T(0), mn = T(INFINITY);
  if (i0 < n) {
    q0 = locate(a, i0);
    if (!q0.plate) {
      const T ui = __ldg(&a.u[q0.p]), vi = __ldg(&a.v[q0.p]);
      rhs0 = update_rhs(a, q0, ui, vi, tc0, mn);
      mx = tmax(tabs(ui), tabs(vi));
    }
  }
  T dt;
  if (a.dt_in == nullptr) {
    // the looped points' shares of the max and min: interior points only
    // (each once), u, v and dx_l there
    for (int i = i0 + stride; i < n; i += stride) {
      const int r = i % (a.H * a.W), R = r / a.W, C = r - R * a.W;
      if (R > 0 && R < a.H - 1 && C > 0 && C < a.W - 1) {
        mx = tmax(mx, tmax(tabs(__ldg(&a.u[i])), tabs(__ldg(&a.v[i]))));
        mn = tmin(mn, __ldg(&a.dxl[(R - 1) * (a.W - 2) + C - 1]));
      }
    }
    dt = grid_dt(a, mx, mn);
  } else {
    dt = __ldg(a.dt_in);
  }
  if (i0 < n) a.out[i0] = finish(a, q0, tc0, rhs0, dt);
  for (int i = i0 + stride; i < n; i += stride) {
    const Point<T> q = locate(a, i);
    T tc = T(0), rhs = T(0), dl;
    if (!q.plate)
      rhs = update_rhs(a, q, __ldg(&a.u[q.p]), __ldg(&a.v[q.p]), tc, dl);
    a.out[i] = finish(a, q, tc, rhs, dt);
  }
}

template <typename T>
int advect(const AdvArgs<T>& a, int max_blocks, cudaStream_t stream) {
  if (a.B < 1 || a.H < 3 || a.W < 3) return cudaErrorInvalidValue;
  const long long n = (long long)a.B * a.H * a.W;
  if (n > (1LL << 30)) return cudaErrorInvalidValue;
  const int need = (int)((n + kBlock - 1) / kBlock);
  if (a.dt_in != nullptr) {
    advect_kernel<T><<<need, kBlock, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (max_blocks < 1) return cudaErrorInvalidValue;
  // [launch]
  int blocks = 0;
  const cudaError_t err =
      pmc::coresident_blocks(advect_kernel<T>, kBlock, &blocks);
  if (err != cudaSuccess) return err;
  blocks = min(min(blocks, max_blocks), need);
  return pmc::launch_cooperative(advect_kernel<T>, blocks, kBlock, stream,
                                 a);
  // [/launch]
}

}  // namespace

// u, v, T, out (B, H, W); metrics (H-2, W-2); src a device scalar
// (src_field = 0) or (B, H-2, W-2); dt_in a device scalar or null, in which
// case dt_out receives the adaptive dt and part holds 2 * max_blocks values
// of scratch (the grid is capped at max_blocks and at the co-resident
// block count).
#define PMC_ADVECT_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const T* u, const T* v, const T* Tf, const T* dxl,      \
                      const T* dxr, const T* dyt, const T* dyb, const T* src, \
                      int src_field, const T* dt_in, T* dt_out, T* part,      \
                      int max_blocks, T* out, int B, int H, int W,            \
                      double cn_max, double bottom_T, double top_T,           \
                      int core_cool, int clip_T, void* stream) {              \
    const AdvArgs<T> a{u, v, Tf, dxl, dxr, dyt, dyb, src, dt_in, dt_out,    \
                       part, out, src_field, B, H, W, T(0.5 * cn_max),        \
                       T(bottom_T), T(top_T), core_cool, clip_T};             \
    return advect<T>(a, max_blocks, static_cast<cudaStream_t>(stream));       \
  }

PMC_ADVECT_ENTRY(pmc_advect_f32, float)
PMC_ADVECT_ENTRY(pmc_advect_f64, double)
