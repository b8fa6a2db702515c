// The fused layer: one launch computes the 5x5 conv of a whole field on
// the tensor cores, adds the bias, and either applies the activation
// (layers without GroupNorm) or leaves the raw field and its GroupNorm
// statistics for the next launch, which normalises while it stages its
// input. Shared by layer_stack.cu (the stacks, up to kMaxLevels pyramid
// levels in one grid) and trunk.cu (merge-1, whose input is assembled in
// the staging step). Two instances (template parameter ZERO): the
// learned-boundary conv (interior and boundary ring, 9 weight classes)
// and the zero-padded SAME conv (one weight class; the staged window
// reads 0 outside the field). Each of them once per activation (template
// parameter ACT): the seven of the JAX package's models/layers.py.
//
// Implicit GEMM: M = output pixels, N = c_o (8 or 16 columns), K = 25 taps
// x 8-channel chunks. mma.sync.aligned.m16n8k8 TF32 with the 3xTF32 split
// (a = a_hi + a_lo, w = w_hi + w_lo; a_lo*w_hi + a_hi*w_lo + a_hi*w_hi
// summed in float32), so results stay within float32 rounding of a
// float32 conv. mma.sync and not wgmma: an M fragment is 16 pixels of one
// window row, addressed per lane in a staged halo tile, which wgmma's
// shared-memory descriptors cannot express without an im2col copy.
#pragma once

#include <cstdint>

#include "pmc_common.cuh"

// Everything here has internal linkage: layer_stack.cu and trunk.cu each
// compile their own instances.
namespace pmc {
namespace {

constexpr int KS = 5;
constexpr int NTAP = KS * KS;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFragsPerWarp = 2;      // M fragments of 16 pixels per warp
constexpr int kSumLanes = kThreads / 16;  // last block: threads per channel
constexpr int kHaloPix = 432;         // staged pixels per chunk (12 x 36)
constexpr int kRec = 16;              // floats per staged pixel per chunk
constexpr int kMaxCo = 16;
constexpr int kUpBuf = 640;           // trunk: row-upsampled values per channel
// work items of the learned instance: interior 8x32 tiles, 2x64 row
// bands, 64x2 column bands, 2x2 corners; of the zero instance: 8x32
// tiles over the whole field
constexpr int IT_H = 8, IT_W = 32, BAND = 64;

struct Item {
  int r0, c0, th, tw;     // output rectangle
  int rlim, clim;         // exclusive limits of the valid outputs
  int cls, dr, dc;        // weight class, window origin offsets
};

__host__ __device__ inline int items_interior_x(int W) {
  return (W - 4 + IT_W - 1) / IT_W;
}
__host__ __device__ inline int items_interior_y(int H) {
  return (H - 4 + IT_H - 1) / IT_H;
}
__host__ __device__ inline int items_band(int n) {
  return (n - 4 + BAND - 1) / BAND;
}
__host__ __device__ inline int n_items(int H, int W, bool zero) {
  if (zero) return ((H + IT_H - 1) / IT_H) * ((W + IT_W - 1) / IT_W);
  return items_interior_x(W) * items_interior_y(H) + 2 * items_band(W) +
         2 * items_band(H) + 4;
}

// Item k of an H x W field. Learned instance: interior tiles, then the
// bands, then corners, with the row flip of the reference: output rows
// 0-1 read rows H-6..H-1 (class row 0, conv_bottom*), rows H-2..H-1 read
// rows 0..5 (class row 2). Zero instance: tile k of the row-major 8x32
// tiling from (0, 0), its window from (-2, -2), class 0.
template <bool ZERO>
__device__ inline Item decode_item(int k, int H, int W) {
  Item it;
  if constexpr (ZERO) {
    const int gx = (W + IT_W - 1) / IT_W;
    it.r0 = (k / gx) * IT_H;
    it.c0 = (k % gx) * IT_W;
    it.th = IT_H;
    it.tw = IT_W;
    it.rlim = H;
    it.clim = W;
    it.cls = 0;
    it.dr = it.dc = -2;
    return it;
  }
  const int gx = items_interior_x(W), gy = items_interior_y(H);
  const int nb = items_band(W), nc = items_band(H);
  int rc, cc;
  if (k < gx * gy) {
    rc = cc = 1;
    it.r0 = 2 + (k / gx) * IT_H;
    it.c0 = 2 + (k % gx) * IT_W;
    it.th = IT_H;
    it.tw = IT_W;
    it.rlim = H - 2;
    it.clim = W - 2;
  } else if ((k -= gx * gy) < 2 * nb) {
    rc = (k / nb) * 2;
    cc = 1;
    it.r0 = rc ? H - 2 : 0;
    it.c0 = 2 + (k % nb) * BAND;
    it.th = 2;
    it.tw = BAND;
    it.rlim = it.r0 + 2;
    it.clim = W - 2;
  } else if ((k -= 2 * nb) < 2 * nc) {
    rc = 1;
    cc = (k / nc) * 2;
    it.r0 = 2 + (k % nc) * BAND;
    it.c0 = cc ? W - 2 : 0;
    it.th = BAND;
    it.tw = 2;
    it.rlim = H - 2;
    it.clim = it.c0 + 2;
  } else {
    k -= 2 * nc;
    rc = (k >> 1) * 2;
    cc = (k & 1) * 2;
    it.r0 = rc ? H - 2 : 0;
    it.c0 = cc ? W - 2 : 0;
    it.th = it.tw = 2;
    it.rlim = it.r0 + 2;
    it.clim = it.c0 + 2;
  }
  it.cls = rc * 3 + cc;
  it.dr = rc == 0 ? H - 6 : (rc == 1 ? -2 : -(H - 2));
  it.dc = cc == 0 ? 0 : (cc == 1 ? -2 : -4);
  return it;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The activation codes of the C entry points (ops/branch_kernel.py::
// ACT_CODES): 0 applies none, 1-7 the Flax functions of the JAX
// package's models/layers.py::_ACTIVATIONS in float32. Every one has
// act(0) = 0, so a padding of zeros stays zeros after it.
enum Act : int {
  kActNone = 0,
  kGelu = 1,
  kSelu = 2,
  kElu = 3,
  kSilu = 4,
  kRelu = 5,
  kTanh = 6,
  kSine = 7,
};

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kGelu) {
    return gelu_erf(v);
  } else if constexpr (ACT == kSelu) {   // jax.nn.selu
    return 1.0507009873554805f * (v > 0.f ? v : 1.6732632423543772f *
                                                    expm1f(v));
  } else if constexpr (ACT == kElu) {    // jax.nn.elu, alpha 1
    return v > 0.f ? v : expm1f(v);
  } else if constexpr (ACT == kSilu) {
    return v / (1.f + expf(-v));
  } else if constexpr (ACT == kRelu) {
    return v > 0.f ? v : 0.f;
  } else if constexpr (ACT == kTanh) {
    return tanhf(v);
  } else {
    static_assert(ACT == kSine, "unknown activation");
    return sinf(30.f * v);               // sine30; never __sinf
  }
}

// Stage 8 channel values of one pixel as its record: for t = 0..3,
// [hi(t), hi(t+4), lo(t), lo(t+4)], so lane t of an A fragment reads its
// four values for one pixel with one 16-byte load.
__device__ __forceinline__ void put_record(float* rec, const float (&v)[8]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t h0 = to_tf32(v[t]), h1 = to_tf32(v[t + 4]);
    const uint32_t l0 = to_tf32(v[t] - __uint_as_float(h0));
    const uint32_t l1 = to_tf32(v[t + 4] - __uint_as_float(h1));
    reinterpret_cast<float4*>(rec)[t] =
        make_float4(__uint_as_float(h0), __uint_as_float(h1),
                    __uint_as_float(l0), __uint_as_float(l1));
  }
}

// One field of a layer launch.
struct LayerLevel {
  const float* x;         // input (c_in, H, W)
  float* y;               // output (c_o, H, W): raw when gn_out
  const float* frag;      // weight fragments of this layer
  const float* bias;      // (c_o)
  const float* in_stats;  // GN (mean, rstd) per group of the input, or null
  const float* in_scale;  // GN affine of the input's layer
  const float* in_shift;
  float* stats_out;       // (groups, 2) of this layer's output when gn_out
  double* partial;        // (items, c_o, 2) per-block sums
  int* counter;           // self-resetting ticket
  int H, W, start;        // first block of this level
};

struct LayerArgs {
  LayerLevel lv[kMaxLevels];
  int n_levels;
  int c_in, c_o, groups;  // the input's GroupNorm has the same groups
  int gn_out, act_out;    // and the same activation as the output's
                          // (act_out: apply the instance's ACT)
};

// How the trunk assembles its input chunks (see trunk.cu).
struct TrunkSrc {
  const float* b0;
  const float* coarse[kMaxLevels];
  int ch[kMaxLevels], cw[kMaxLevels];
  const float* x;
  const int* yi;
  const float* yw;
  const int* xi;
  const float* xw;
  int n_coarse, c_h, c_x;
};

// Stage chunk q of a plain planar input, normalising on load when the
// input is a raw GroupNorm field. Each thread loads all its pixels' values
// before it converts any, so its loads are in flight together. A pixel
// outside the field stages as 0 (the zero instance's window starts at
// -2; the learned instance's never leaves the field on that side), and
// stays 0: the padding pads the activated field.
constexpr int kPixPerThread = (kHaloPix + kThreads - 1) / kThreads;

template <bool ZERO, int ACT>
__device__ inline void stage_planar(float* s, const float* base, int nvalid,
                                    const float* tr, int act, int H, int W,
                                    int hr0, int hc0, int hh, int hw) {
  const size_t HW = (size_t)H * W;
  float v[kPixPerThread][8];
  bool inf[kPixPerThread];
#pragma unroll
  for (int u = 0; u < kPixPerThread; ++u) {
    const int p = threadIdx.x + u * kThreads;
    const int i = p / hw, j = p - (p / hw) * hw;
    const int gr = hr0 + i, gc = hc0 + j;
    inf[u] = p < hh * hw && gr < H && gc < W &&
             (!ZERO || (gr >= 0 && gc >= 0));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[u][k] = inf[u] && k < nvalid
                    ? __ldg(&base[k * HW + (size_t)gr * W + gc])
                    : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPixPerThread; ++u) {
    const int p = threadIdx.x + u * kThreads;
    if (p >= hh * hw) continue;
    if (tr != nullptr && inf[u]) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= nvalid) continue;
        const float t = (v[u][k] - tr[3 * k + 1]) * tr[3 * k] + tr[3 * k + 2];
        v[u][k] = act ? activate<ACT>(t) : t;
      }
    }
    put_record(s + p * kRec, v[u]);
  }
}

template <bool ZERO, int ACT>
__device__ inline void stage_plain(float* s, const LayerArgs& a,
                                   const LayerLevel& L, const float* s_tr,
                                   int q, int hr0, int hc0, int hh, int hw) {
  stage_planar<ZERO, ACT>(s, L.x + (size_t)q * 8 * L.H * L.W,
                     min(8, a.c_in - q * 8),
                     L.in_stats != nullptr ? s_tr + 24 * q : nullptr,
                     a.act_out, L.H, L.W, hr0, hc0, hh, hw);
}

// Stage chunk q of the trunk's 87-channel input: branch 0 and the network
// input are read directly; a coarse branch is upsampled here, rows first
// (into `up`), then columns, from the per-row / per-column tap tables.
// Window rows [i_lo, rows) and columns [j_lo, cols) lie in the field;
// the others stage as 0 (i_lo, j_lo > 0 only in the zero instance).
template <bool ZERO>
__device__ inline void stage_trunk(float* s, float* up, const TrunkSrc& t,
                                   const LayerLevel& L, int q, int hr0,
                                   int hc0, int hh, int hw) {
  const int H = L.H, W = L.W;
  const size_t HW = (size_t)H * W;
  const int c_branch = t.c_h * (t.n_coarse + 1);
  const int ci0 = q * 8;
  if (ci0 >= t.c_h && ci0 < c_branch) {
    const int l = ci0 / t.c_h - 1;
    const int cc0 = ci0 - (l + 1) * t.c_h;
    const int ch = t.ch[l], cw = t.cw[l];
    const float* src = t.coarse[l] + (size_t)cc0 * ch * cw;
    const int* yi = t.yi + (size_t)l * H * 4;
    const float* yw = t.yw + (size_t)l * H * 4;
    const int* xi = t.xi + (size_t)l * W * 4;
    const float* xw = t.xw + (size_t)l * W * 4;
    const int rows = min(hh, H - hr0), cols = min(hw, W - hc0);
    const int i_lo = ZERO ? max(0, -hr0) : 0, j_lo = ZERO ? max(0, -hc0) : 0;
    // coarse columns the tile's output columns read (the tables hold
    // ascending indices; zero-weight padding repeats the first)
    const int cmin = __ldg(&xi[(hc0 + j_lo) * 4]);
    int cmax = cmin;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      cmax = max(cmax, __ldg(&xi[(hc0 + cols - 1) * 4 + b]));
    const int ncol = cmax - cmin + 1;
    const int piece = kUpBuf / ncol;
    // the tile's rows' and columns' taps, relative to the coarse window
    __shared__ int s_yi[(BAND + KS - 1) * 4], s_xi[(BAND + KS - 1) * 4];
    __shared__ float s_yw[(BAND + KS - 1) * 4], s_xw[(BAND + KS - 1) * 4];
    for (int e = threadIdx.x; e < 4 * (hh + hw); e += kThreads) {
      if (e < 4 * hh) {
        const int r = hr0 + e / 4;
        const int gr = min(ZERO ? max(r, 0) : r, H - 1);
        s_yi[e] = __ldg(&yi[gr * 4 + (e & 3)]);
        s_yw[e] = __ldg(&yw[gr * 4 + (e & 3)]);
      } else {
        const int e2 = e - 4 * hh;
        const int c = hc0 + e2 / 4;
        const int gc = min(ZERO ? max(c, 0) : c, W - 1);
        s_xi[e2] = __ldg(&xi[gc * 4 + (e2 & 3)]) - cmin;
        s_xw[e2] = __ldg(&xw[gc * 4 + (e2 & 3)]);
      }
    }
    for (int i0 = 0; i0 < hh; i0 += piece) {
      const int i1 = min(hh, i0 + piece), ni = i1 - i0;
      __syncthreads();   // `up` free, tables written
#pragma unroll 4
      for (int e = threadIdx.x; e < 8 * ni * ncol; e += kThreads) {
        const int k = e / (ni * ncol);
        const int rem = e - k * ni * ncol;
        const int i = i0 + rem / ncol, jc = rem - (rem / ncol) * ncol;
        if (i >= rows || (ZERO && i < i_lo)) continue;
        const float* sc = src + (size_t)k * ch * cw + cmin + jc;
        float sum = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          sum += s_yw[i * 4 + a] * __ldg(&sc[(size_t)s_yi[i * 4 + a] * cw]);
        up[(k * ni + (i - i0)) * ncol + jc] = sum;
      }
      __syncthreads();
      for (int p = threadIdx.x; p < ni * hw; p += kThreads) {
        const int i = i0 + p / hw, j = p - (p / hw) * hw;
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = 0.f;
        if (i < rows && j < cols && (!ZERO || (i >= i_lo && j >= j_lo))) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float w = s_xw[j * 4 + b];
            const float* u = up + (i - i0) * ncol + s_xi[j * 4 + b];
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] += w * u[k * ni * ncol];
          }
        }
        put_record(s + (i * hw + j) * kRec, v);
      }
    }
    return;
  }
  if (ci0 < t.c_h)
    stage_planar<ZERO, kGelu>(s, t.b0 + (size_t)ci0 * HW, min(8, t.c_h - ci0),
                       nullptr, 0, H, W, hr0, hc0, hh, hw);
  else
    stage_planar<ZERO, kGelu>(s, t.x + (size_t)(ci0 - c_branch) * HW,
                       min(8, t.c_x - (ci0 - c_branch)), nullptr, 0, H, W,
                       hr0, hc0, hh, hw);
}

// The layer kernel. NJ: output-channel tiles of 8 (c_o 1..8 -> 1, 16 -> 2).
// TRUNK: assemble the input with stage_trunk instead of stage_plain.
// ZERO: the zero-padded instance (see decode_item).
// ACT: the activation (Act) that a.act_out switches on.
// Blocks per SM: 3 for the stacks (<= 80 registers; the third block
// overlaps its staging with the others' MMAs), 2 for the trunk, whose
// upsampling buffer and 127 registers leave room for no more.
template <int NJ, bool TRUNK, bool ZERO, int ACT>
__global__ void __launch_bounds__(kThreads, TRUNK ? 2 : 3)
blc_fused_kernel(const __grid_constant__ LayerArgs a,
                 const __grid_constant__ TrunkSrc tsrc) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                                 // [432][16]
  float4* s_w = reinterpret_cast<float4*>(smem + kHaloPix * kRec);
  float* s_up = smem + kHaloPix * kRec + NTAP * NJ * 32 * 4;  // trunk only
  __shared__ float s_tr[3 * kMaxCo];
  __shared__ double s_red[kWarps][kMaxCo][2];
  __shared__ int s_last;

  int lvl = 0;
  while (lvl + 1 < a.n_levels && (int)blockIdx.x >= a.lv[lvl + 1].start)
    ++lvl;
  const LayerLevel& L = a.lv[lvl];
  const int item = blockIdx.x - L.start;
  const Item it = decode_item<ZERO>(item, L.H, L.W);
  const int H = L.H, W = L.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hh = it.th + KS - 1, hw = it.tw + KS - 1;
  const int hr0 = it.r0 + it.dr, hc0 = it.c0 + it.dc;
  const int nq = (a.c_in + 7) / 8;
  const int npix = it.th * it.tw;
  const int nfrag = (npix + 15) / 16;
  int fmask = 0;     // which of this warp's M fragments hold pixels
#pragma unroll
  for (int f = 0; f < kFragsPerWarp; ++f)
    fmask |= (warp + kWarps * f < nfrag) << f;

  if (!TRUNK && L.in_stats != nullptr && tid < a.c_in) {
    const int gi = tid / (a.c_in / a.groups);
    s_tr[3 * tid] = L.in_stats[2 * gi + 1] * L.in_scale[tid];
    s_tr[3 * tid + 1] = L.in_stats[2 * gi];
    s_tr[3 * tid + 2] = L.in_shift[tid];
  }

  // this lane's two pixels (rows g and g+8) of each of its M fragments,
  // as staged-pixel offsets; pixels past the item read pixel 0
  int poff[kFragsPerWarp][2];
#pragma unroll
  for (int f = 0; f < kFragsPerWarp; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp + kWarps * f) * 16 + g + 8 * h;
      const int rr = m / it.tw, cc = m - (m / it.tw) * it.tw;
      poff[f][h] = m < npix ? (rr * hw + cc) * kRec + 4 * t4 : 4 * t4;
    }

  float acc[kFragsPerWarp][NJ][4];
#pragma unroll
  for (int f = 0; f < kFragsPerWarp; ++f)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  // chunk q's weights of this item's class: 25 taps x NJ tiles x 32
  // lanes of float4, contiguous in the fragment layout
  const int wchunk = NTAP * NJ * 32;
  const float4* wcls = reinterpret_cast<const float4*>(L.frag) +
                       (size_t)it.cls * nq * wchunk;
  for (int q = 0; q < nq; ++q) {
    __syncthreads();   // s_a and s_w free, s_tr written
    for (int i = tid; i < wchunk; i += kThreads)
      cp_async16(s_w + i, wcls + (size_t)q * wchunk + i);
    cp_async_commit();
    if constexpr (TRUNK)
      stage_trunk<ZERO>(s_a, s_up, tsrc, L, q, hr0, hc0, hh, hw);
    else
      stage_plain<ZERO, ACT>(s_a, a, L, s_tr, q, hr0, hc0, hh, hw);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < NTAP; ++tap) {
      const int ky = tap / KS, kx = tap - (tap / KS) * KS;
      const float* s = s_a + (ky * hw + kx) * kRec;
      {
        uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 b = s_w[(tap * NJ + j) * 32 + lane];
          bh[j][0] = __float_as_uint(b.x);
          bh[j][1] = __float_as_uint(b.y);
          bl[j][0] = __float_as_uint(b.z);
          bl[j][1] = __float_as_uint(b.w);
        }
        // all A fragments first (pixels past the item read pixel 0), then
        // the three passes, so a warp's MMAs form NJ * kFragsPerWarp
        // independent accumulator chains
        float4 pa[kFragsPerWarp], pb[kFragsPerWarp];
#pragma unroll
        for (int f = 0; f < kFragsPerWarp; ++f) {
          pa[f] = *reinterpret_cast<const float4*>(s + poff[f][0]);
          pb[f] = *reinterpret_cast<const float4*>(s + poff[f][1]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int f = 0; f < kFragsPerWarp; ++f) {
            if (!(fmask >> f & 1)) continue;
            // pass 0: a_lo * w_hi, 1: a_hi * w_lo, 2: a_hi * w_hi
            const float4 x0 = pa[f], x1 = pb[f];
            const uint32_t a0 = __float_as_uint(pass ? x0.x : x0.z);
            const uint32_t a1 = __float_as_uint(pass ? x1.x : x1.z);
            const uint32_t a2 = __float_as_uint(pass ? x0.y : x0.w);
            const uint32_t a3 = __float_as_uint(pass ? x1.y : x1.w);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              if (pass == 1)
                mma_tf32(acc[f][j], a0, a1, a2, a3, bl[j][0], bl[j][1]);
              else
                mma_tf32(acc[f][j], a0, a1, a2, a3, bh[j][0], bh[j][1]);
            }
          }
      }
    }
  }

  // epilogue: bias, activation or GroupNorm sums, store
  const size_t HW = (size_t)H * W;
  double sum[NJ][2], sq[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    sum[j][0] = sum[j][1] = sq[j][0] = sq[j][1] = 0.0;
#pragma unroll
  for (int f = 0; f < kFragsPerWarp; ++f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp + kWarps * f) * 16 + g + 8 * h;
      const int rr = m / it.tw, cc = m - (m / it.tw) * it.tw;
      const int r = it.r0 + rr, c = it.c0 + cc;
      const bool out = m < npix && r < it.rlim && c < it.clim;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int co = 8 * j + 2 * t4 + p;
          if (!out || co >= a.c_o) continue;
          float v = acc[f][j][2 * h + p] + __ldg(&L.bias[co]);
          if (a.gn_out) {
            sum[j][p] += (double)v;
            sq[j][p] += (double)v * v;
          } else if (a.act_out) {
            v = activate<ACT>(v);
          }
          L.y[co * HW + (size_t)r * W + c] = v;
        }
    }
  }
  if (!a.gn_out) return;

  // per-channel block sums in a fixed order: over the 8 lanes of one
  // column, then over the warps
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sum[j][p] += __shfl_xor_sync(0xffffffffu, sum[j][p], off);
        sq[j][p] += __shfl_xor_sync(0xffffffffu, sq[j][p], off);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int co = 8 * j + 2 * t4 + p;
        if (co < kMaxCo) {
          s_red[warp][co][0] = sum[j][p];
          s_red[warp][co][1] = sq[j][p];
        }
      }
  }
  __syncthreads();
  if (tid < a.c_o) {
    double s = 0.0, ss = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      s += s_red[w][tid][0];
      ss += s_red[w][tid][1];
    }
    double* dst = L.partial + ((size_t)item * a.c_o + tid) * 2;
    dst[0] = s;
    dst[1] = ss;
    __threadfence();
  }
  __syncthreads();
  const int nitems = n_items(H, W, ZERO);
  if (tid == 0) s_last = atomicAdd(L.counter, 1) == nitems - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block of this field: sum the partials in block order, then
  // the (mean, rstd) of each group
  __threadfence();
  double* s_tot = &s_red[0][0][0];   // reused: [c_o][2]
  __syncthreads();
  const int co = tid / kSumLanes, k = tid % kSumLanes;
  double s = 0.0, ss = 0.0;
  if (co < a.c_o) {
#pragma unroll 4
    for (int i = k; i < nitems; i += kSumLanes) {
      const double* src = L.partial + ((size_t)i * a.c_o + co) * 2;
      s += __ldcg(src);
      ss += __ldcg(src + 1);
    }
  }
  __shared__ double s_part[kMaxCo][kSumLanes][2];
  if (co < a.c_o) {
    s_part[co][k][0] = s;
    s_part[co][k][1] = ss;
  }
  __syncthreads();
  if (tid < a.c_o) {
    double ts = 0.0, tss = 0.0;
    for (int i = 0; i < kSumLanes; ++i) {
      ts += s_part[tid][i][0];
      tss += s_part[tid][i][1];
    }
    s_tot[2 * tid] = ts;
    s_tot[2 * tid + 1] = tss;
  }
  __syncthreads();
  if (tid < a.groups) {
    const int cpg = a.c_o / a.groups;
    double ts = 0.0, tss = 0.0;
    for (int i = 0; i < cpg; ++i) {
      ts += s_tot[2 * (tid * cpg + i)];
      tss += s_tot[2 * (tid * cpg + i) + 1];
    }
    const double n = (double)cpg * HW;
    const double mean = ts / n;
    double var = tss / n - mean * mean;
    if (var < 0.0) var = 0.0;
    L.stats_out[2 * tid] = (float)mean;
    L.stats_out[2 * tid + 1] = (float)(1.0 / sqrt(var + 1e-5));
  }
  if (tid == 0) *L.counter = 0;
}

inline size_t layer_smem_bytes(int nj, bool trunk) {
  return sizeof(float) * ((size_t)kHaloPix * kRec + NTAP * nj * 32 * 4 +
                          (trunk ? 8 * kUpBuf : 0));
}

template <int NJ, bool TRUNK, bool ZERO, int ACT>
cudaError_t launch_layer_nj(const LayerArgs& a, const TrunkSrc& t,
                            int blocks, cudaStream_t stream) {
  static bool attr = false;
  const size_t smem = layer_smem_bytes(NJ, TRUNK);
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        blc_fused_kernel<NJ, TRUNK, ZERO, ACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  blc_fused_kernel<NJ, TRUNK, ZERO, ACT>
      <<<blocks, kThreads, smem, stream>>>(a, t);
  return cudaGetLastError();
}

template <bool TRUNK, bool ZERO, int ACT>
cudaError_t launch_layer_pad(const LayerArgs& a, const TrunkSrc& t,
                             cudaStream_t stream) {
  int blocks = 0;
  for (int l = 0; l < a.n_levels; ++l)
    blocks = a.lv[l].start + n_items(a.lv[l].H, a.lv[l].W, ZERO);
  if (a.c_o > 8)
    return launch_layer_nj<2, TRUNK, ZERO, ACT>(a, t, blocks, stream);
  return launch_layer_nj<1, TRUNK, ZERO, ACT>(a, t, blocks, stream);
}

template <bool TRUNK, int ACT>
cudaError_t launch_layer_act(const LayerArgs& a, const TrunkSrc& t,
                             bool zero, cudaStream_t stream) {
  return zero ? launch_layer_pad<TRUNK, true, ACT>(a, t, stream)
              : launch_layer_pad<TRUNK, false, ACT>(a, t, stream);
}

inline bool valid_act(int act) { return act >= kActNone && act <= kSine; }

// zero: the zero-padded instance, else the learned-boundary one; act: the
// activation code, which a.act_out switches on (kActNone runs the GELU
// instance with a.act_out off). The trunk's layer always ends in
// GroupNorm, so its activation is gn_apply_kernel's alone: one instance.
template <bool TRUNK>
cudaError_t launch_layer(const LayerArgs& a, const TrunkSrc& t, bool zero,
                         int act, cudaStream_t stream) {
  if constexpr (TRUNK) {
    return launch_layer_act<true, kGelu>(a, t, zero, stream);
  } else {
    switch (act) {
      case kSelu: return launch_layer_act<false, kSelu>(a, t, zero, stream);
      case kElu: return launch_layer_act<false, kElu>(a, t, zero, stream);
      case kSilu: return launch_layer_act<false, kSilu>(a, t, zero, stream);
      case kRelu: return launch_layer_act<false, kRelu>(a, t, zero, stream);
      case kTanh: return launch_layer_act<false, kTanh>(a, t, zero, stream);
      case kSine: return launch_layer_act<false, kSine>(a, t, zero, stream);
      default: return launch_layer_act<false, kGelu>(a, t, zero, stream);
    }
  }
}

// The pass after a stack's last GroupNorm layer: y = act(GN(y)) in place
// (act the template parameter ACT, switched on by a.act),
// and optionally the successive VALID 2x2 pools of the result (the next
// pyramid levels' inputs, odd sizes floor). One block per 16x16 tile of
// one channel of one field.
constexpr int kApplyTile = 16;
constexpr int kMaxPyramid = 4;

struct ApplyLevel {
  float* y;
  const float* stats;      // (groups, 2) or null: no GroupNorm
  const float* scale;
  const float* shift;
  float* pyr[kMaxPyramid];
  int H, W, start, n_pyr;
};

struct ApplyArgs {
  ApplyLevel lv[kMaxLevels];
  int n_levels, c_o, groups, act;
};

__host__ __device__ inline int apply_blocks(int H, int W, int c_o) {
  return c_o * ((H + kApplyTile - 1) / kApplyTile) *
         ((W + kApplyTile - 1) / kApplyTile);
}

template <int ACT>
__global__ void __launch_bounds__(kApplyTile* kApplyTile)
gn_apply_kernel(const __grid_constant__ ApplyArgs a) {
  int lvl = 0;
  while (lvl + 1 < a.n_levels && (int)blockIdx.x >= a.lv[lvl + 1].start)
    ++lvl;
  const ApplyLevel& L = a.lv[lvl];
  const int H = L.H, W = L.W;
  const int tx = (W + kApplyTile - 1) / kApplyTile;
  const int ty = (H + kApplyTile - 1) / kApplyTile;
  int b = blockIdx.x - L.start;
  const int ch = b / (tx * ty);
  b -= ch * tx * ty;
  const int R0 = (b / tx) * kApplyTile, C0 = (b % tx) * kApplyTile;
  const int i = threadIdx.x / kApplyTile, j = threadIdx.x % kApplyTile;
  const int r = R0 + i, c = C0 + j;
  const size_t at = ((size_t)ch * H + r) * W + c;
  float v = 0.f;
  if (r < H && c < W) {
    v = L.y[at];
    if (L.stats != nullptr) {
      const int gi = ch / (a.c_o / a.groups);
      v = (v - L.stats[2 * gi]) * (L.stats[2 * gi + 1] * L.scale[ch]) +
          L.shift[ch];
      if (a.act) v = activate<ACT>(v);
      L.y[at] = v;
    }
  }
  if (L.n_pyr == 0) return;
  __shared__ float s[2][kApplyTile][kApplyTile];
  s[0][i][j] = v;
  int n = kApplyTile;
  for (int l = 1; l <= L.n_pyr; ++l) {
    __syncthreads();
    n >>= 1;
    const float(*src)[kApplyTile] = s[(l - 1) & 1];
    float(*dst)[kApplyTile] = s[l & 1];
    float p = 0.f;
    if (i < n && j < n)
      p = 0.25f * ((src[2 * i][2 * j] + src[2 * i][2 * j + 1]) +
                   (src[2 * i + 1][2 * j] + src[2 * i + 1][2 * j + 1]));
    __syncthreads();
    if (i < n && j < n) {
      dst[i][j] = p;
      const int hl = H >> l, wl = W >> l;
      const int rl = (R0 >> l) + i, cl = (C0 >> l) + j;
      if (rl < hl && cl < wl) L.pyr[l - 1][((size_t)ch * hl + rl) * wl + cl] = p;
    }
  }
}

template <int ACT>
cudaError_t launch_apply_act(const ApplyArgs& a, int blocks,
                             cudaStream_t stream) {
  gn_apply_kernel<ACT><<<blocks, kApplyTile * kApplyTile, 0, stream>>>(a);
  return cudaGetLastError();
}

// act: the activation code (kActNone: the GELU instance with a.act off)
inline cudaError_t launch_apply(const ApplyArgs& a, int act,
                                cudaStream_t stream) {
  int blocks = 0;
  for (int l = 0; l < a.n_levels; ++l)
    blocks = a.lv[l].start + apply_blocks(a.lv[l].H, a.lv[l].W, a.c_o);
  switch (act) {
    case kSelu: return launch_apply_act<kSelu>(a, blocks, stream);
    case kElu: return launch_apply_act<kElu>(a, blocks, stream);
    case kSilu: return launch_apply_act<kSilu>(a, blocks, stream);
    case kRelu: return launch_apply_act<kRelu>(a, blocks, stream);
    case kTanh: return launch_apply_act<kTanh>(a, blocks, stream);
    case kSine: return launch_apply_act<kSine>(a, blocks, stream);
    default: return launch_apply_act<kGelu>(a, blocks, stream);
  }
}

}  // namespace
}  // namespace pmc
