// layer_stack: a stack of R learned-boundary FluidLayers on the card.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/branch_kernel.py::
// _stack_kernel (built by LayerStack). Per layer: 5x5 conv whose weight set
// and input window depend on where the output pixel lies (the interior
// `conv`, the 4 edge and 4 corner convs of the learned padding, with the
// reference's row flip: output rows 0-1 read input rows H-6..H-1 through
// the conv_bottom* weights, rows H-2..H-1 read rows 0..5 through conv_top*),
// learnable bias, GroupNorm over the whole field (eps 1e-5), exact-erf GELU.
// Optionally also the VALID 2x2 average pool of the stack's INPUT (the next
// pyramid level's input; odd sizes floor, 253 -> 126).
//
// What bounds it: operations. A 16->16 layer at 128x506 is 0.83 GFLOP of
// float32 FMAs against ~8 MB of traffic; the whole step (8 stacks + trunk)
// is ~12 GFLOP, i.e. ~0.19 ms at the 67 TFLOP/s float32 (non-tensor-core)
// peak. Design: the interior (rows 2..H-3, cols 2..W-3) is a tiled direct
// convolution — a block per 8x32 output tile, each thread two rows of all
// c_o channels in registers, input and weights staged through shared
// memory 8 input channels at a time, weights read as float4 broadcasts so
// one shared load feeds 8 FMAs; on the small pyramid levels (down to 8x31)
// the channels are split 4 per block so they do not run one latency-bound
// block per tile. The boundary ring (4W + 4(H-4) pixels, ~4% of the
// field) is a separate direct kernel that picks its weight class and window
// origin per pixel; one warp per pixel splits the c_in*25-term dot across
// its lanes (a thread per (pixel, channel) running the whole dot serially
// was latency-bound: 47% of the step's device time at 128x506).
// GroupNorm statistics are per-block partial sums in double (no f32
// cancellation in E[x^2] - E[x]^2, no atomics, so the result is
// deterministic), finished once per block of the normalize+GELU pass.
// Later work: tensor cores (TF32/bf16 wgmma) for the interior conv and
// fusing the normalization into the next layer's input load.
#include <algorithm>

#include "pmc_common.cuh"

namespace pmc {
namespace {

constexpr int KS = 5;       // kernel size
constexpr int NTAP = KS * KS;
constexpr int TH = 8;       // interior tile: output rows
constexpr int TW = 32;      //                output cols (one warp wide)
constexpr int RPT = 2;      // output rows per thread
constexpr int CK = 8;       // input channels per shared-memory stage
constexpr int kThreads = TW * (TH / RPT);  // 128

// One block: an 8x32 output tile and COB of the CO output channels
// (blockIdx.z picks which), so even the 8x31 deepest level has CO/COB
// blocks in flight and each thread's serial chain is COB channels long.
template <int CO, int COB>
__global__ void __launch_bounds__(kThreads)
blc_interior_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ w,
                    const float* __restrict__ bias,
                    int c_in, int H, int W) {
  static_assert(CO % COB == 0, "COB must divide CO");
  __shared__ float s_in[CK][TH + KS - 1][TW + KS - 1];
  __shared__ __align__(16) float s_w[CK][NTAP][COB];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int r0 = 2 + blockIdx.y * TH;   // first output row of the tile
  const int c0 = 2 + blockIdx.x * TW;   // first output col of the tile
  const int co0 = blockIdx.z * COB;     // first output channel
  // weight class 4 = the interior `conv`
  const float* wc = w + (size_t)4 * c_in * NTAP * CO;

  float acc[RPT][COB];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int o = 0; o < COB; ++o) acc[i][o] = 0.f;

  constexpr int kInTile = (TH + KS - 1) * (TW + KS - 1);
  for (int ci0 = 0; ci0 < c_in; ci0 += CK) {
    const int nk = min(CK, c_in - ci0);
    for (int i = tid; i < CK * kInTile; i += kThreads) {
      const int k = i / kInTile;
      const int rem = i - k * kInTile;
      const int rr = rem / (TW + KS - 1);
      const int cc = rem - rr * (TW + KS - 1);
      const int gr = r0 - 2 + rr, gc = c0 - 2 + cc;   // always >= 0
      float v = 0.f;
      if (k < nk && gr < H && gc < W)
        v = __ldg(&x[((size_t)(ci0 + k) * H + gr) * W + gc]);
      s_in[k][rr][cc] = v;
    }
    for (int i = tid; i < CK * NTAP * COB; i += kThreads) {
      const int kt = i / COB;              // k * NTAP + tap
      const int j = i - kt * COB;
      const int k = kt / NTAP;
      (&s_w[0][0][0])[i] =
          k < nk ? __ldg(&wc[((size_t)ci0 * NTAP + kt) * CO + co0 + j]) : 0.f;
    }
    __syncthreads();

    for (int k = 0; k < nk; ++k) {
#pragma unroll
      for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          float a[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            a[i] = s_in[k][ty + i * (TH / RPT) + ky][tx + kx];
          const float* wp = s_w[k][ky * KS + kx];
          if constexpr (COB % 4 == 0) {
#pragma unroll
            for (int o = 0; o < COB; o += 4) {
              const float4 wv = *reinterpret_cast<const float4*>(wp + o);
#pragma unroll
              for (int i = 0; i < RPT; ++i) {
                acc[i][o + 0] += a[i] * wv.x;
                acc[i][o + 1] += a[i] * wv.y;
                acc[i][o + 2] += a[i] * wv.z;
                acc[i][o + 3] += a[i] * wv.w;
              }
            }
          } else {
#pragma unroll
            for (int o = 0; o < COB; ++o)
#pragma unroll
              for (int i = 0; i < RPT; ++i) acc[i][o] += a[i] * wp[o];
          }
        }
      }
    }
    __syncthreads();
  }

  const int c = c0 + tx;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + i * (TH / RPT);
    if (r <= H - 3 && c <= W - 3) {
#pragma unroll
      for (int o = 0; o < COB; ++o)
        y[((size_t)(co0 + o) * H + r) * W + c] =
            acc[i][o] + __ldg(&bias[co0 + o]);
    }
  }
}

// The boundary ring: rows 0,1,H-2,H-1 (all cols) then cols 0,1,W-2,W-1 of
// rows 2..H-3. One warp per ring pixel: the 32 lanes split the c_in*25
// terms of the dot, each keeps all c_o partial sums, and a butterfly
// shuffle reduction combines them.
template <int CO>
__global__ void __launch_bounds__(256)
blc_ring_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ w, const float* __restrict__ bias,
                int c_in, int H, int W) {
  const int n_ring = 4 * W + 4 * (H - 4);
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_ring) return;   // the whole warp leaves together
  int r, c;
  if (p < 4 * W) {
    const int rr = p / W;
    c = p - rr * W;
    r = rr < 2 ? rr : H - 4 + rr;
  } else {
    const int q = p - 4 * W;
    const int side = q / (2 * (H - 4));
    const int q2 = q - side * 2 * (H - 4);
    r = 2 + q2 / 2;
    c = side == 0 ? (q2 & 1) : W - 2 + (q2 & 1);
  }
  const int rc = r < 2 ? 0 : (r >= H - 2 ? 2 : 1);
  const int cc = c < 2 ? 0 : (c >= W - 2 ? 2 : 1);
  // window origins: the row flip of the bottom/top slabs, plain slabs
  // for the columns
  const int orow = rc == 0 ? H - 6 + r : (rc == 1 ? r - 2 : r - (H - 2));
  const int ocol = cc == 0 ? c : (cc == 1 ? c - 2 : c - 4);
  const float* wcls = w + (size_t)(rc * 3 + cc) * c_in * NTAP * CO;

  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;
  const int nterm = c_in * NTAP;
  for (int t = lane; t < nterm; t += 32) {
    const int ci = t / NTAP, tap = t - (t / NTAP) * NTAP;
    const int ky = tap / KS, kx = tap - (tap / KS) * KS;
    const float a = __ldg(&x[((size_t)ci * H + orow + ky) * W + ocol + kx]);
    const float* wp = wcls + (size_t)t * CO;
    if constexpr (CO % 4 == 0) {
#pragma unroll
      for (int o = 0; o < CO; o += 4) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wp + o));
        acc[o + 0] += a * wv.x;
        acc[o + 1] += a * wv.y;
        acc[o + 2] += a * wv.z;
        acc[o + 3] += a * wv.w;
      }
    } else {
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[o] += a * __ldg(&wp[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    float v = acc[o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == o) y[((size_t)o * H + r) * W + c] = v + __ldg(&bias[o]);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid (kGnStatsBlocks, groups), 256 threads: partial sum and sum of
// squares of one group's contiguous span, in double.
__global__ void __launch_bounds__(256)
gn_stats_kernel(const float* __restrict__ y, double* __restrict__ partial,
                int group_elems) {
  const float* base = y + (size_t)blockIdx.y * group_elems;
  double s = 0.0, ss = 0.0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < group_elems;
       i += gridDim.x * blockDim.x) {
    const double v = base[i];
    s += v;
    ss += v * v;
  }
  __shared__ double sh[2][8];
  s = warp_sum(s);
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][wid] = s;
    sh[1][wid] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ts = 0.0, tss = 0.0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      ts += sh[0][i];
      tss += sh[1][i];
    }
    const size_t at = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2;
    partial[at] = ts;
    partial[at + 1] = tss;
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// In place: y = (y - mean) * (rstd * scale) + shift, then GELU.
// grid (blocks per channel, c_o): each block finishes its channel's group
// statistics from the partial sums once, then walks its share of the
// channel.
__global__ void __launch_bounds__(256)
norm_act_kernel(float* __restrict__ y, const double* __restrict__ partial,
                const float* __restrict__ scale,
                const float* __restrict__ shift, int c_o, int HW, int groups,
                int use_gn, int use_act) {
  const int ch = blockIdx.y;
  __shared__ float s_ab[2];
  if (threadIdx.x == 0) {
    float a = 1.f, b = 0.f;
    if (use_gn) {
      const int g = ch / (c_o / groups);
      double s = 0.0, ss = 0.0;
      for (int k = 0; k < kGnStatsBlocks; ++k) {
        s += partial[((size_t)g * kGnStatsBlocks + k) * 2];
        ss += partial[((size_t)g * kGnStatsBlocks + k) * 2 + 1];
      }
      const double n = (double)(c_o / groups) * HW;
      const double mean = s / n;
      double var = ss / n - mean * mean;
      if (var < 0.0) var = 0.0;
      a = (float)(1.0 / sqrt(var + 1e-5)) * scale[ch];
      b = (float)mean;
    }
    s_ab[0] = a;
    s_ab[1] = b;
  }
  __syncthreads();
  const float a = s_ab[0], mean = s_ab[1];
  const float b = use_gn ? __ldg(&shift[ch]) : 0.f;
  float* yc = y + (size_t)ch * HW;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < HW;
       i += gridDim.x * blockDim.x) {
    float v = yc[i];
    if (use_gn) v = (v - mean) * a + b;
    if (use_act) v = gelu_erf(v);
    yc[i] = v;
  }
}

// VALID 2x2 average pool, (C, H, W) -> (C, H/2, W/2), odd sizes floor.
__global__ void __launch_bounds__(256)
avg_pool2_kernel(const float* __restrict__ x, float* __restrict__ out, int C,
                 int H, int W) {
  const int h = H / 2, w = W / 2;
  const size_t total = (size_t)C * h * w;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i / ((size_t)h * w));
    const int rem = (int)(i - (size_t)c * h * w);
    const int r = rem / w, col = rem - (rem / w) * w;
    const float* p = x + ((size_t)c * H + 2 * r) * W + 2 * col;
    out[i] = 0.25f * ((p[0] + p[1]) + (p[W] + p[W + 1]));
  }
}

int grid_for(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

template <int CO>
void launch_conv(const float* x, float* y, const float* w, const float* bias,
                 int c_in, int H, int W, cudaStream_t stream) {
  const dim3 blk(TW, TH / RPT);
  const int gx = (W - 4 + TW - 1) / TW, gy = (H - 4 + TH - 1) / TH;
  // Fields with fewer tiles than the card has SMs split the channels over
  // blocks (latency-bound otherwise); larger ones keep every channel in
  // one block so the input tile is staged once (measured on the H100:
  // 17 vs 27 us per 16->16 launch at 8x31..64x253, 58 vs 46 us at
  // 128x506).
  constexpr int COS = CO < 4 ? CO : 4;
  if (CO > COS && gx * gy < 132) {
    blc_interior_kernel<CO, COS><<<dim3(gx, gy, CO / COS), blk, 0, stream>>>(
        x, y, w, bias, c_in, H, W);
  } else {
    blc_interior_kernel<CO, CO><<<dim3(gx, gy, 1), blk, 0, stream>>>(
        x, y, w, bias, c_in, H, W);
  }
  const int n_ring = 4 * W + 4 * (H - 4);
  blc_ring_kernel<CO><<<(n_ring * 32 + 255) / 256, 256, 0, stream>>>(
      x, y, w, bias, c_in, H, W);
}

}  // namespace

cudaError_t blc_layer(const float* x, float* y, double* stats,
                      const float* w, const float* bias,
                      const float* gn_scale, const float* gn_bias, int c_in,
                      int c_o, int H, int W, int groups, int use_gn,
                      int use_act, cudaStream_t stream) {
  if (H < 6 || W < 6 || c_in < 1) return cudaErrorInvalidValue;
  if (use_gn && (groups < 1 || groups > kMaxGroups || c_o % groups))
    return cudaErrorInvalidValue;
  switch (c_o) {
    case 16: launch_conv<16>(x, y, w, bias, c_in, H, W, stream); break;
    case 8: launch_conv<8>(x, y, w, bias, c_in, H, W, stream); break;
    case 1: launch_conv<1>(x, y, w, bias, c_in, H, W, stream); break;
    default: return cudaErrorInvalidValue;
  }
  const int HW = H * W;
  if (use_gn)
    gn_stats_kernel<<<dim3(kGnStatsBlocks, groups), 256, 0, stream>>>(
        y, stats, (c_o / groups) * HW);
  if (use_gn || use_act) {
    // ~2 blocks per SM over all channels, at most one element per thread
    const int per_ch = std::max(1, std::min((HW + 255) / 256, 264 / c_o));
    norm_act_kernel<<<dim3(per_ch, c_o), 256, 0, stream>>>(
        y, stats, gn_scale, gn_bias, c_o, HW, groups, use_gn, use_act);
  }
  return cudaGetLastError();
}

}  // namespace pmc

extern "C" {

const char* pmc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pmc_gn_stats_blocks() { return pmc::kGnStatsBlocks; }

// R layers; layer i reads c_in (i == 0) or c_o channels. Weights are the
// layers' packed (9, c_in_i, 25, c_o) blocks back to back; bias, gn_scale,
// gn_bias are (R, c_o). Layers ping-pong between `scratch` and `y` so the
// last one lands in `y` (scratch may be null when R == 1). With pool_out
// non-null, also writes the 2x2 average pool of x to pool_out.
int pmc_layer_stack(const float* x, float* y, float* scratch, double* stats,
                    const float* w, const float* bias, const float* gn_scale,
                    const float* gn_bias, float* pool_out, int c_in, int c_o,
                    int H, int W, int R, int groups, int use_gn, int use_act,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R < 1 || (R > 1 && scratch == nullptr)) return cudaErrorInvalidValue;
  if (pool_out != nullptr) {
    const size_t n = (size_t)c_in * (H / 2) * (W / 2);
    pmc::avg_pool2_kernel<<<pmc::grid_for(n, 256), 256, 0, stream>>>(
        x, pool_out, c_in, H, W);
  }
  const float* src = x;
  size_t w_off = 0;
  for (int i = 0; i < R; ++i) {
    float* dst = ((R - 1 - i) % 2 == 0) ? y : scratch;
    const int ci = i == 0 ? c_in : c_o;
    const cudaError_t err = pmc::blc_layer(
        src, dst, stats, w + w_off, bias + (size_t)i * c_o,
        gn_scale + (size_t)i * c_o, gn_bias + (size_t)i * c_o, ci, c_o, H, W,
        groups, use_gn, use_act, stream);
    if (err != cudaSuccess) return err;
    w_off += (size_t)9 * ci * 25 * c_o;
    src = dst;
  }
  return cudaGetLastError();
}

}  // extern "C"
