// projection_conv: the two 3x3 SAME, zero-padded conv projections of a
// structured-mesh Transolver block (in_project_fx and in_project_x), in one
// launch over the block's channels-last image.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA
// (pbml_mantle_convection_tpu/models/transolver.py:165-168), and the port
// called cuDNN, whose float32 implicit GEMM runs on the SIMT units and wraps
// each call in NHWC <-> NCHW copies. It was added because the two convs took
// 57% of the 128x506 Transolver's forward.
//
// What bounds it: operations. Per block at B = 1 it is an implicit GEMM of
// M = 64,768 pixels, N = 2 x 128 channels, K = 9 taps x 128 channels:
// 38.2 GFLOP, 0.232 ms at the 3xTF32 rate (495/3 TFLOP/s), against about
// 100 MB moved (the image once, both outputs once, the weights): 0.03 ms at
// 3.35 TB/s. Alone at that shape on an H100 80GB HBM3 (700 W) it runs
// 0.343 ms a block, 111 TFLOP/s of 3xTF32 work, 68% of that bound; its
// products without their loads run 0.29 ms.
//
// Design. Each block of two warpgroups computes a tile of 128 output pixels
// (a run of one image row) by 128 output channels (one projection's, or a
// part of one past 128); the tiles of the two projections over the same
// pixels are neighbours in the grid, so the image rows they read meet in L2.
// The products run on wgmma (m64n128k8, TF32), the one route to the tensor
// cores' full TF32 rate, in 3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with
// each operand split as hi = TF32(x), lo = x - hi, float32-accurate, never a
// single TF32 product. The K loop takes 16 input channels of one tap row
// (dr) a stage, two stages ahead of the products. A stage's weights come
// already split: the wrapper packs both projections' weights once
// (ops/projection_conv.py::pack_weights) into one contiguous 48 KB block a
// stage, hi and lo in wgmma's no-swizzle K-major layout (core matrices of 8
// rows x 16 bytes), which one bulk copy (TMA) brings into a four-stage ring
// in shared memory and an mbarrier reports. The image row r + dr - 1 at
// columns c0 - 1 .. c0 + 128 comes by cp.async, 32 channels (128 bytes a
// pixel) at a time for two stages; columns and rows outside the field are
// zero-filled on load, which is the SAME padding: the input is never padded
// or copied. The A operand (pixels) comes from registers: each lane loads its
// two pixels' channel pairs of the staged row at the tap's shift (the 3x3
// reuse: 3 taps read one staged row) and splits them, since wgmma's
// shared-memory descriptors could not express the shifted rows without a
// copy per tap. The k-index t of a product stands for channel 2t and t + 4
// for 2t + 1 of an 8-channel step, so a lane reads its A fragment as 8-byte
// loads (the staged row's 16-byte units swizzled so that these fall on 32
// banks). Each stage's 18 products a warpgroup issues as two commit groups
// over two register sets, so the loads and splits of the second half
// overlap the tensor cores' work on the first. The accumulator holds one
// stage (18 products of 8 inputs) and is then added to float32 register
// sums that start at the bias: the tensor cores' accumulation rounds toward
// zero, and a chain over all 1,152 inputs drifts far past a float32 conv.
// Each lane stores its two adjacent channels of a pixel straight into the
// projection's (B, H, W, C_out) channels-last output.
//
// Layouts: the image is (B, H, W, C) with C adjacent (the LayerNorm's
// (B, N, C) rows), 16-byte aligned; the packed weights are [2 projections]
// [C_out / 128 tiles][C / 32][3 tap rows][2 stages][hi, lo][3 taps][2
// k-steps][the 128 x 8 B tile: 16 row groups][2 k halves][8 rows][4]
// floats; the outputs are (B, H, W, C_out), the memory of a channels-last
// (B, C_out, H, W) tensor.
#include <cstdint>

#include "pmc_common.cuh"

namespace {

using pmc::b_desc;
using pmc::bulk_load;
using pmc::cp_async16_zfill;
using pmc::cp_async_commit;
using pmc::cp_async_wait_pending;
using pmc::mbar_init;
using pmc::mbar_wait;
using pmc::split;
using pmc::wgmma_commit;
using pmc::wgmma_fence;
using pmc::wgmma_tf32;
using pmc::wgmma_wait_pending;

constexpr int kBM = 128;  // output pixels of a tile: a run of one image row
constexpr int kBN = 128;  // output channels of a tile: one wgmma's N
constexpr int kBK = 16;   // input channels of a stage
constexpr int kAK = 2 * kBK;     // input channels of a staged image row
constexpr int kKS = kBK / 8;     // k-steps of a tap
constexpr int kSteps = 3 * kKS;  // k-steps of a stage (3 taps)
constexpr int kHalf = kSteps / 2;
constexpr int kGroups = 2;  // warpgroups, 64 pixels each
constexpr int kThreads = 128 * kGroups;
constexpr int kHaloW = kBM + 2;
constexpr int kBufs = 4;   // weight stages in the ring
constexpr int kAhead = 2;  // stages loaded ahead of the products
constexpr int kTileFloats = kBN * 8;                // a (tap, k-step) B tile
constexpr int kBFloats = 2 * kSteps * kTileFloats;  // a stage's hi and lo
constexpr int kAFloats = kHaloW * kAK;              // a staged image row
constexpr int kSmemBytes =
    (kBufs * kBFloats + 2 * kAFloats) * static_cast<int>(sizeof(float)) +
    kBufs * static_cast<int>(sizeof(uint64_t));

static_assert(kBufs >= kAhead + 2, "a buffer is reloaded after its products");
static_assert(kAhead == 2, "an image row serves two stages");
static_assert(kSmemBytes <= 232448, "the ring fits a block's shared memory");

// Where the 16-byte unit u (of 8) of pixel p lies in a staged row: the
// 8-byte fragment loads of a half warp (4 pixels, 2 units each) fall on 32
// banks.
__device__ __forceinline__ int a_unit(int p, int u) {
  return u ^ ((p & 3) << 1);
}

// Image row rr, input channels c0 .. c0 + 31, at columns col0 - 1 ..
// col0 + kBM (zeros outside the field) into sa, as [kHaloW][32] in
// swizzled units.
__device__ __forceinline__ void load_row(float* sa, const float* x, int rr,
                                         int col0, int H, int W, int C,
                                         int c0) {
  const bool row_ok = rr >= 0 && rr < H;
  for (int i = threadIdx.x; i < kHaloW * 8; i += kThreads) {
    const int u = i & 7, col = i >> 3;
    const int cc = col0 + col - 1;
    const bool ok = row_ok && cc >= 0 && cc < W;
    const float* src =
        ok ? x + (static_cast<long long>(rr) * W + cc) * C + c0 + 4 * u : x;
    cp_async16_zfill(sa + col * kAK + 4 * a_unit(col, u), src, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    projection_conv_kernel(const float* __restrict__ x,
                           const float* __restrict__ packed,
                           const float* __restrict__ b0,
                           const float* __restrict__ b1,
                           float* __restrict__ y0, float* __restrict__ y1,
                           int H, int W, int C, int CO) {
  extern __shared__ __align__(128) float smem[];
  float* s_b = smem;                     // kBufs stages' weights
  float* s_a = s_b + kBufs * kBFloats;   // two staged image rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_a + 2 * kAFloats);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, wq = warp & 3;

  // the tile: (image row, column run, projection and channel tile), the
  // channel tiles fastest
  const int n_tiles = (CO + kBN - 1) / kBN;
  const int col_tiles = (W + kBM - 1) / kBM;
  int k = blockIdx.x;
  const int nt = k % (2 * n_tiles);
  k /= 2 * n_tiles;
  const int ct = k % col_tiles;
  const int row = k / col_tiles;  // b * H + r
  const int b = row / H, r = row - b * H;
  const int proj = nt / n_tiles, n0 = (nt - proj * n_tiles) * kBN;
  const float* bias = proj ? b1 : b0;
  float* y = proj ? y1 : y0;
  const int col0 = ct * kBM;
  x += static_cast<long long>(b) * H * W * C;
  // stage s: input channels 16 s' .. 16 s' + 15 of tap row (s / 2) % 3,
  // s' = 2 (s / 6) + s % 2; image row a = s / 2 (row r + a % 3 - 1,
  // channels 32 (a / 3) ..) serves stages 2a and 2a + 1
  const int stages = 3 * (C / kBK);
  const float* wp = packed + static_cast<long long>(nt) * stages * kBFloats;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kBufs; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage s's weights (one bulk copy) and, for an even s, its image row
  const auto load = [&](int s) {
    if (threadIdx.x == 0)
      bulk_load(s_b + (s % kBufs) * kBFloats,
                wp + static_cast<long long>(s) * kBFloats,
                kBFloats * static_cast<int>(sizeof(float)),
                bars + s % kBufs);
    if (s % 2 == 0) {
      const int a = s / 2;
      load_row(s_a + a % 2 * kAFloats, x, r + a % 3 - 1, col0, H, W, C,
               kAK * (a / 3));
    }
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }

  float sum[64];  // as d: rows g, g + 8; channels 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    const float e0 = bias && n < CO ? bias[n] : 0.f;
    const float e1 = bias && n < CO ? bias[n + 1] : 0.f;
    sum[4 * j] = sum[4 * j + 2] = e0;
    sum[4 * j + 1] = sum[4 * j + 3] = e1;
  }
  // the accumulator of a stage's products (the first of them starts it
  // from zero: a write of it here would serialize the products)
  float d[64];
  uint32_t ah[2][kHalf][4], al[2][kHalf][4];

  for (int s = 0; s < stages; ++s) {
    // stage s has arrived: its image row (cp.async, this thread's part,
    // then the barrier for the others') and its weights (the barrier)
    cp_async_wait_pending(kAhead - 1);
    mbar_wait(bars + s % kBufs, (s / kBufs) & 1);
    __syncthreads();
    // stage s + 2 into the buffers of stage s - 2 (weights) and of the
    // image row of stages s - 2 and s - 1, read before the barrier; the
    // products of stage s - 2 completed before it
    if (s + kAhead < stages) load(s + kAhead);
    cp_async_commit();

    // the previous stage's products are complete: their sum goes to the
    // float32 sums, and both register sets are free
    wgmma_wait_pending<0>();
    if (s > 0) {
#pragma unroll
      for (int e = 0; e < 64; ++e) sum[e] += d[e];
    }
    const float* sa = s_a + (s / 2) % 2 * kAFloats;
    const float* sb = s_b + (s % kBufs) * kBFloats;
    // two halves of the stage's k-steps, each in its own register set: the
    // second half's loads and splits overlap the first half's products
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // A: warp wq of the group owns pixels 64 grp + 16 wq + g (+ 8); k-step
      // q of the stage is tap q / 2, row channels 16 (s % 2) + 8 (q % 2) +
      // 2t (k-index t) and + 1 (t + 4): unit 4 (s % 2) + 2 (q % 2) + t / 2,
      // floats 2 (t % 2) and + 1
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int q = h * kHalf + i;
        const int u = 4 * (s % 2) + 2 * (q % kKS) + (t >> 1), f = 2 * (t & 1);
        const int m = 64 * grp + 16 * wq + g + q / kKS;
        const float2 e = *reinterpret_cast<const float2*>(
            sa + m * kAK + 4 * a_unit(m, u) + f);
        const float2 o = *reinterpret_cast<const float2*>(
            sa + (m + 8) * kAK + 4 * a_unit(m + 8, u) + f);
        split(e.x, ah[h][i][0], al[h][i][0]);
        split(o.x, ah[h][i][1], al[h][i][1]);
        split(e.y, ah[h][i][2], al[h][i][2]);
        split(o.y, ah[h][i][3], al[h][i][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int q = h * kHalf + i;
        const float* hi = sb + q * kTileFloats;
        const float* lo = hi + kSteps * kTileFloats;
        wgmma_tf32(d, al[h][i], b_desc(hi), q != 0);
        wgmma_tf32(d, ah[h][i], b_desc(lo), 1);
        wgmma_tf32(d, ah[h][i], b_desc(hi), 1);
      }
      wgmma_commit();
    }
  }
  wgmma_wait_pending<0>();
  cp_async_wait_pending(0);
#pragma unroll
  for (int e = 0; e < 64; ++e) sum[e] += d[e];

  // pixel col0 + m of row r, channels n0 + 8j + 2t, + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = col0 + 64 * grp + 16 * wq + g + 8 * half;
    if (col >= W) continue;
    float* dst = y + ((static_cast<long long>(b) * H + r) * W + col) * CO +
                 n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      if (n0 + 8 * j < CO)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(sum[4 * j + 2 * half], sum[4 * j + 2 * half + 1]);
  }
}

}  // namespace

// x: (B, H, W, C) float32, C adjacent, 16-byte aligned; packed: both
// projections' weights as pack_weights lays them out; b0, b1: the
// projections' biases (C_out) or null; y0, y1: their (B, H, W, C_out)
// outputs. Takes C and C_out multiples of 32; returns cudaErrorInvalidValue
// for other shapes and for a grid it cannot hold, else cudaGetLastError()
// after the launch.
extern "C" int pmc_projection_conv(const float* x, const float* packed,
                                   const float* b0, const float* b1,
                                   float* y0, float* y1, int B, int H, int W,
                                   int C, int CO, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 32 || C % 32 || CO < 32 || CO % 32)
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(B) * H *
                           ((W + kBM - 1) / kBM) * 2 * ((CO + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      projection_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  projection_conv_kernel<<<static_cast<unsigned>(blocks), kThreads,
                           kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, packed, b0, b1, y0, y1, H, W, C, CO);
  return cudaGetLastError();
}
