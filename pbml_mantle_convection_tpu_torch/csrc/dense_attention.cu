// dense_attention: softmax(q . k^T * scale) . v for every (batch, head) of
// the ViT's attention core, in one kernel that never writes the scores.
//
// Replaces no TPU kernel: the JAX package computes this core as einsum +
// softmax + einsum (pbml_mantle_convection_tpu/models/vit.py::Attention), and
// so did the port. It was added because over the 128x506 field's 4,049
// tokens the plain path writes 12 x 4,049^2 float32 scores (787 MB) a block
// at 12 heads and passes over them about six times.
//
// What bounds it: operations. q . k^T and the weighted sum of v take
// 2 * 2 * N^2 * 64 operations a head (50.4 GFLOP a ViT-Base block at
// N = 4,049: 0.305 ms at the 3xTF32 rate, 495/3 TFLOP/s), against q, k, v
// and the output moved once (50 MB: 0.015 ms at 3.35 TB/s).
//
// Design. One block of 8 warps per (128-query tile, head, batch); each warp
// owns 16 query rows. A warp loads its q rows once, multiplies them by
// scale * log2(e) and keeps them split into TF32 hi and lo parts in
// registers. Tiles of 64 keys of k and v stream through a two-stage cp.async
// ring in dynamic shared memory, their 16-byte units swizzled by row so that
// a warp reads its fragments as whole 16-byte units free of bank conflicts:
// the dot products take the dims in the order that lets lane t read dims
// 16t .. 16t + 15 of a key (k-index t of step ks is dim 16t + 2ks, t + 4 is
// 16t + 2ks + 1, for q as for k), and column g of the output's n-tile n is
// dim 8g + n, so a lane reads dims 8g .. 8g + 7 of v's rows and holds dims
// 16t .. 16t + 15 of its output rows. For each tile a warp computes
// S (16 x 64) = Q . K^T on the tensor cores (mma.sync m16n8k8 TF32 in
// 3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed in float32,
// float32-accurate, never a single TF32 product), updates the running row
// max m and the running sums l in float32 (online softmax on exp2), and adds
// P . V to its output rows, with P = exp2(S - m) split into hi and lo too.
// The accumulator fragment of S is the A fragment of P . V once k-index t
// stands for key 2t and t + 4 for key 2t + 1 of each 8-key step
// ((a0, a1, a2, a3) = (c0, c2, c1, c3)) and v's B fragment reads the same
// key rows: P never leaves the registers and needs no shuffle. Each tile's
// P . V goes to a fresh MMA accumulator and is added to the float32 output
// rows, O = O * exp2(m_old - m_new) + P . V, so no chain longer than one
// tile's 64 keys runs in the tensor cores' accumulator. Keys past N (the
// ragged last tile: 4,049 = 63 * 64 + 17) are zero-filled on load and set
// to -inf before the max; query rows past N are read as zeros and never
// stored. Each row's sum is kept as four partial sums across its quad,
// added once at the end, where the rows are divided by it and stored.
//
// Layouts: q, k, v and out are (B, H, N, 64) views given by their element
// strides (b, h, n), with a channel stride of 1 and rows that start 16-byte
// aligned. So the kernel reads the three parts of the qkv projection's
// (B, N, 3 * H * 64) output where they lie, and writes the (B, N, H * 64)
// rows that the output projection reads: no layout copy on either side.
#include <cmath>
#include <cstdint>

#include "pmc_common.cuh"

namespace {

using pmc::cp_async16_zfill;
using pmc::cp_async_commit;
using pmc::cp_async_wait_pending;
using pmc::mma3;
using pmc::split;

constexpr int kD = 64;              // head width, the only one taken
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr int kKeys = 64;           // keys of a tile
constexpr int kStages = 2;
// Tile rows of 64 floats, their 16-byte units swizzled by row so that
// every 16-byte fragment load of a quarter warp falls on 32 banks.
constexpr int kStride = kD;
constexpr int kTile = kKeys * kStride;  // floats of one k or v tile
constexpr int kSmemBytes =
    kStages * 2 * kTile * static_cast<int>(sizeof(float));
constexpr int kDefaultSmem = 48 * 1024;

// Element strides (b, h, n) of a (B, H, N, 64) view whose channel stride
// is 1.
struct Rows {
  long long b, h, n;
};

// The 16-byte unit where unit u of row r lies: in k, a lane reads units
// 4t .. 4t + 3 of row 8j + g; in v, units 2g and 2g + 1 of rows 8kk + 2t
// and 8kk + 2t + 1.
__device__ __forceinline__ int k_unit(int u, int r) {
  return (u & 8) | ((u ^ ((u & 8) >> 2) ^ (r & 1)) & 7);
}
__device__ __forceinline__ int v_unit(int u, int r) {
  return u ^ (((r >> 1) & 1) | (r & 4));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keys n0 .. n0 + 63 of k and v into one stage of the ring (rows past N:
// zeros, nothing read).
__device__ __forceinline__ void load_tile(float* sk, float* sv,
                                          const float* k, const float* v,
                                          long long kn, long long vn, int n0,
                                          int N) {
#pragma unroll
  for (int i = 0; i < kKeys * (kD / 4) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 4, u = c & 15;
    const bool ok = n0 + r < N;
    const long long row = ok ? n0 + r : 0;
    cp_async16_zfill(sk + r * kStride + 4 * k_unit(u, r),
                     k + row * kn + 4 * u, ok);
    cp_async16_zfill(sv + r * kStride + 4 * v_unit(u, r),
                     v + row * vn + 4 * u, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    dense_attention_kernel(const float* __restrict__ q, Rows qr,
                           const float* __restrict__ k, Rows kr,
                           const float* __restrict__ v, Rows vr,
                           float* __restrict__ out, Rows orow, int N,
                           float qscale) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  q += b * qr.b + h * qr.h;
  k += b * kr.b + h * kr.h;
  v += b * vr.b + h * vr.h;
  out += b * orow.b + h * orow.h;
  const int tiles = (N + kKeys - 1) / kKeys;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      load_tile(smem + s * 2 * kTile, smem + s * 2 * kTile + kTile, k, v,
                kr.n, vr.n, s * kKeys, N);
    cp_async_commit();
  }

  // this warp's rows g and g + 8, as the A fragments of every 8-dim step
  const int row0 = blockIdx.x * kRows + warp * 16 + g, row1 = row0 + 8;
  uint32_t qh[kD / 8][4], ql[kD / 8][4];
  {
    const bool ok0 = row0 < N, ok1 = row1 < N;
    // k-index t of step ks is dim 16t + 2ks, k-index t + 4 dim 16t + 2ks + 1
    const float* q0 =
        q + static_cast<long long>(ok0 ? row0 : 0) * qr.n + 16 * t;
    const float* q1 =
        q + static_cast<long long>(ok1 ? row1 : 0) * qr.n + 16 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 a = ok0 ? ld4(q0 + 4 * c) : zero;
      const float4 e = ok1 ? ld4(q1 + 4 * c) : zero;
      split(a.x * qscale, qh[2 * c][0], ql[2 * c][0]);
      split(e.x * qscale, qh[2 * c][1], ql[2 * c][1]);
      split(a.y * qscale, qh[2 * c][2], ql[2 * c][2]);
      split(e.y * qscale, qh[2 * c][3], ql[2 * c][3]);
      split(a.z * qscale, qh[2 * c + 1][0], ql[2 * c + 1][0]);
      split(e.z * qscale, qh[2 * c + 1][1], ql[2 * c + 1][1]);
      split(a.w * qscale, qh[2 * c + 1][2], ql[2 * c + 1][2]);
      split(e.w * qscale, qh[2 * c + 1][3], ql[2 * c + 1][3]);
    }
  }

  float o[kD / 8][4];  // rows g, g + 8; dims 16t + n, 16t + 8 + n
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row maxima (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the row sums

  for (int it = 0; it < tiles; ++it) {
    // tile it has arrived for every thread, and every warp is done with
    // the stage that the next load overwrites
    cp_async_wait_pending(kStages - 2);
    __syncthreads();
    {
      const int next = it + kStages - 1;
      if (next < tiles) {
        float* st = smem + (next % kStages) * 2 * kTile;
        load_tile(st, st + kTile, k, v, kr.n, vr.n, next * kKeys, N);
      }
      cp_async_commit();
    }
    const float* sk = smem + (it % kStages) * 2 * kTile;
    const float* sv = sk + kTile;

    // S = Q . K^T: n-tile j holds keys 8j .. 8j + 7 of the tile
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int r = 8 * j + g;
      const float* kj = sk + r * kStride;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 x = ld4(kj + 4 * k_unit(4 * t + c, r));
        uint32_t bh0, bl0, bh1, bl1;
        split(x.x, bh0, bl0);
        split(x.y, bh1, bl1);
        mma3(s[j], qh[2 * c], ql[2 * c], bh0, bh1, bl0, bl1);
        split(x.z, bh0, bl0);
        split(x.w, bh1, bl1);
        mma3(s[j], qh[2 * c + 1], ql[2 * c + 1], bh0, bh1, bl0, bl1);
      }
    }
    const int n0 = it * kKeys;
    if (n0 + kKeys > N) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const int key = n0 + 8 * j + 2 * t;
        if (key >= N) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    // online softmax: key n0 < N is in every tile, so the maxima are finite
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
      x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float a0 = ex2(m0 - x0), a1 = ex2(m1 - x1);  // 0 at the first tile
    m0 = x0;
    m1 = x1;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      s[j][0] = ex2(s[j][0] - x0);
      s[j][1] = ex2(s[j][1] - x0);
      s[j][2] = ex2(s[j][2] - x1);
      s[j][3] = ex2(s[j][3] - x1);
      p0 += s[j][0] + s[j][1];
      p1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + p0;
    l1 = l1 * a1 + p1;

    // P . V, 8 keys a k-step: k-index t is key 8kk + 2t, t + 4 is key
    // 8kk + 2t + 1
    float pv[kD / 8][4];
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      uint32_t ah[4], al[4];
      split(s[kk][0], ah[0], al[0]);
      split(s[kk][2], ah[1], al[1]);
      split(s[kk][1], ah[2], al[2]);
      split(s[kk][3], ah[3], al[3]);
      // column g of n-tile n is dim 8g + n
      const int r = 8 * kk + 2 * t;
      const float* v0 = sv + r * kStride;
      const float* v1 = v0 + kStride;
      const float4 e0 = ld4(v0 + 4 * v_unit(2 * g, r));
      const float4 e1 = ld4(v0 + 4 * v_unit(2 * g + 1, r));
      const float4 f0 = ld4(v1 + 4 * v_unit(2 * g, r + 1));
      const float4 f1 = ld4(v1 + 4 * v_unit(2 * g + 1, r + 1));
      const float b0[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      const float b1[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split(b0[n], bh0, bl0);
        split(b1[n], bh1, bl1);
        mma3(pv[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] = fmaf(o[n][0], a0, pv[n][0]);
      o[n][1] = fmaf(o[n][1], a0, pv[n][1]);
      o[n][2] = fmaf(o[n][2], a1, pv[n][2]);
      o[n][3] = fmaf(o[n][3], a1, pv[n][3]);
    }
  }
  cp_async_wait_pending(0);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  // o[n][0], o[n][1]: dims 16t + n and 16t + 8 + n of row g (2, 3: g + 8)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    const float r = half ? r1 : r0;
    if (row < N) {
      float4* dst = reinterpret_cast<float4*>(out + row * orow.n + 16 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * half + e;
        dst[2 * e] = make_float4(o[0][i] * r, o[1][i] * r, o[2][i] * r,
                                 o[3][i] * r);
        dst[2 * e + 1] = make_float4(o[4][i] * r, o[5][i] * r, o[6][i] * r,
                                     o[7][i] * r);
      }
    }
  }
}

}  // namespace

// q, k, v and out: (B, H, N, 64) float32 views of element strides
// (*_b, *_h, *_n), channel stride 1, every row 16-byte aligned; qscale is
// the softmax scale times log2(e). Returns cudaErrorInvalidValue for
// dimensions the grid cannot hold, else cudaGetLastError() after the launch.
extern "C" int pmc_dense_attention(const float* q, const float* k,
                                   const float* v, float* out, int B, int H,
                                   int N, long long q_b, long long q_h,
                                   long long q_n, long long k_b,
                                   long long k_h, long long k_n,
                                   long long v_b, long long v_h,
                                   long long v_n, long long o_b,
                                   long long o_h, long long o_n,
                                   float qscale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (kSmemBytes > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  dense_attention_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      q, Rows{q_b, q_h, q_n}, k, Rows{k_b, k_h, k_n}, v, Rows{v_b, v_h, v_n},
      out, Rows{o_b, o_h, o_n}, N, qscale);
  return cudaGetLastError();
}
