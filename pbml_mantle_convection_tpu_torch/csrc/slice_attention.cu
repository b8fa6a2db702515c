// slice_pool / slice_deslice: the Physics-Attention core of the Transolver.
//
// Replaces the TPU kernels pbml_mantle_convection_tpu/ops/slice_attention.py::
// _pool_kernel and ::_deslice_kernel (slice_attention_fused). For each
// (batch, head) pair (b, h), bh = b * H + h, and each point n, with
// x = x_mid[b, h, n, :] (D values) and G slices:
//   w[n, g] = softmax_g((x . ws[:, g] + bs[g]) / temp[h])
//   slice_pool     num[bh, g, d] = sum_n w[n, g] fx[b, h, n, d]
//                  den[bh, g]    = sum_n w[n, g]
//   slice_deslice  out[b, h, n, d] = sum_g w[n, g] tok[bh, g, d]
// The (B, H, N, G) weights never reach device memory: each kernel recomputes
// them from x_mid, as the Pallas kernels do. Storage is float32, float64,
// bfloat16 or float16: 16-bit values are loaded into float32, the math is
// float32 (float64 for float64), and the results are stored in the input
// type, as the Pallas kernel does.
//
// Layouts: x_mid, fx and out are (B, H, N, D) views given by their element
// strides (b, h, n) with a channel stride of 1 (struct Rows). So the kernels
// read the projections' outputs where they lie (a channels-last conv or
// Dense heads: rows of D values, H * D apart), and slice_deslice writes the
// (B, N, H * D) rows that the output projection reads: no layout copy on
// either side. ws (D, G) comes at any strides (the Dense weight's
// transpose); tok (BH, G, D), bs (G) and temp (H) are dense.
//
// What bounds them: at the serving shape (BH = 8, N = 64,768, D = 16, G = 32)
// bytes: each kernel streams two (BH, N, D) float32 arrays, 66 MB (20 us at
// 3.35 TB/s), for ~1.1 GFLOP of multiply-adds.
//
// Tensor cores (float32, bfloat16 and float16 storage, D and G <= 128): both
// products of each kernel run as mma.sync m16n8k8 TF32 in 3xTF32 (x = hi +
// lo; a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed in float32: float32-accurate,
// never single-pass TF32). A block of 8 warps walks `tiles_per_chunk` tiles
// of P points of one bh (a grid of one wave: SMs x resident blocks), with
// the next tiles in flight through cp.async while tile i computes. The logits
// (16 x G) = X (16 x D) . Ws (D x G) of a warp's 16 points take every column;
// Ws is staged once per block (the deslice at G > 64 adds each 8-deep k-step
// of the logits to float32 registers: warp_logits' FLUSH). Bias, temperature
// and the softmax across G run on the accumulator fragments (row max and sum
// by quad shuffles, expf).
//   slice_pool: the block shares a two-stage ring of tiles of x_mid and fx.
//      After the softmax each warp writes its weight rows over its own rows
//      of X, then
//      [num | den] (G x (D + 1)) += W^T (G x P) . [F | 1] (P x (D + 1)): the
//      staged F tile carries a column of ones, so the same product sums the
//      weights (den). Each warp owns a run of the 16 x 8 output tiles; the
//      tensor cores accumulate one tile's points, which are then added to
//      float32 register sums (a chain of 1,408 points in the MMA
//      accumulator drifted 1.3e-5 of max |num| on an H100). Warp groups
//      split a tile's points where the outputs are few, and meet in shared
//      memory in a fixed order. Every block writes its chunk's sums; a
//      one-block-per-bh pass adds the chunks in a fixed order: no float
//      atomics, repeated calls give the same bits.
//   slice_deslice: each warp owns 16 rows of every tile and its own ring
//      of up to four stages of them (no block barrier after the set-up). The
//      unnormalised weights exp(l - max) never leave the registers: the
//      m16n8 accumulator of slices 8j..8j+7 is the A fragment of
//      out (16 x D) = W (16 x G) . tok (G x D) once k-index t stands for
//      slice 8j+2t and t+4 for slice 8j+2t+1, i.e. (a0, a1, a2, a3) =
//      (c0, c2, c1, c3); the tokens (staged once per block) are stored in the
//      same row order, and a sum over G does not depend on it. Slices and
//      columns are zero-padded (to 32, 64 or 128 and to 16) so that no
//      fragment loop tests a bound. The output fragments are multiplied by
//      1 / sum at the end, staged over the warp's X rows and stored as whole
//      rows of D values.
// Rows past N are zero-filled on load: the pool gives them weight 0, the
// deslice never stores them. Tile rows are padded so that every fragment
// load is free of bank conflicts.
//
// SIMT (float64 at every shape; every type where D or G > 128): a block of
// 128 threads takes tiles of P points: it loads a tile of x_mid (and fx)
// into shared rows padded to D + 1, thread t < P computes the G softmax
// weights of point t into a shared (P, G + 1) tile, then every thread works
// on the tile's products, consecutive threads on consecutive outputs.
//   slice_pool: each block walks `tiles_per_chunk` tiles of one bh and keeps
//   a slab of kSimtAcc x 128 of the (G, D + 1) sums in registers (column D
//   of the fx tile is 1: den); slabs are a third grid dimension.
//   slice_deslice: one tile per block; the attended tokens (G, D) are
//   staged in shared memory and the (P, D) output tile is written by rows.
// P is chosen at launch so that ws, tok and the tiles fit in 227 KB; where
// ws and tok cannot they are read from global memory. The widest D and G
// are those whose 16-point tiles fit (simt_plan; past them the *_plan_*
// entries return cudaErrorInvalidValue).
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "pmc_common.cuh"

namespace {

using pmc::cp_async16_zfill;
using pmc::cp_async_commit;
using pmc::cp_async_wait_all;
using pmc::cp_async_wait_pending;
using pmc::mma3;
using pmc::split;

constexpr int kMaxTensorCoreDim = 128;  // D and G of the tensor-core kernels
constexpr int kSmemMax = 232448;  // 227 KB: the most one block may use
// the most each of two resident blocks may use: half an SM's 228 KB, less
// the 1 KB the runtime keeps per block
constexpr int kSmemTwoBlocks = 233472 / 2 - 1024;
constexpr int kDefaultSmem = 48 * 1024;

// storage type <-> math type
template <typename T, typename S>
__device__ __forceinline__ T cvt(S x) {
  return static_cast<T>(x);
}
template <>
__device__ __forceinline__ float cvt<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float cvt<float, __half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16, float>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half cvt<__half, float>(float x) {
  return __float2half(x);
}

template <typename S>
struct Math {
  using T = float;
};
template <>
struct Math<double> {
  using T = double;
};

// Element strides (b, h, n) of a (B, H, N, D) view whose channel stride is
// 1; a dimension of size 1 has stride 0.
struct Rows {
  long long b, h, n;
};

// Row 0 of bh = b * H + h in a (B, H, N, D) view.
template <typename P>
__device__ __forceinline__ P* head_rows(P* base, const Rows& r, int bh,
                                        int H) {
  const int b = bh / H;
  return base + b * r.b + (bh - b * H) * r.h;
}

// Do the view's rows start 16-byte aligned, and hold whole 16-byte chunks?
template <typename S>
bool rows16(const S* p, const Rows& r, int D) {
  const long long e = sizeof(S);
  return D * e % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         r.b * e % 16 == 0 && r.h * e % 16 == 0 && r.n * e % 16 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool dims_ok(int BH, int N, int D, int G) {
  return BH >= 1 && BH <= 65535 && N >= 1 && D >= 1 && G >= 1;
}

// The tensor-core kernels take 32-bit and 16-bit storage (never float64)
// up to 128 wide.
bool tensor_cores(int D, int G) {
  return D <= kMaxTensorCoreDim && G <= kMaxTensorCoreDim;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Blocks of `rows` grid rows (bh, slab) that cover `tiles` tiles each in
// one wave of `slots` resident blocks (no more blocks than slots, unless
// rows > slots): every chunk holds tiles_per_chunk tiles (the last one may
// hold fewer) and at least one.
void split_chunks(long long tiles, int slots, int rows, int* chunks,
                  int* tiles_per_chunk) {
  long long c = slots / rows;
  c = c < 1 ? 1 : (c > tiles ? tiles : c);
  const long long per = (tiles + c - 1) / c;
  *tiles_per_chunk = static_cast<int>(per);
  *chunks = static_cast<int>((tiles + per - 1) / per);
}

bool chunks_ok(long long tiles, int chunks, int tiles_per_chunk) {
  return chunks >= 1 && tiles_per_chunk >= 1 &&
         static_cast<long long>(chunks) * tiles_per_chunk >= tiles &&
         static_cast<long long>(chunks - 1) * tiles_per_chunk < tiles;
}

template <typename Kernel>
cudaError_t resident_slots(Kernel kernel, int threads, size_t smem,
                           int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  return e;
}

// ---------------------------------------------------------------------
// Tensor-core pieces of both kernels (float32, bfloat16, float16 storage)

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// Do the 32 lanes of a fragment load hit 32 distinct banks (or share a
// word)? Lane (g = lane / 4, t = lane % 4) reads element (g, t) (row_g) or
// (t, g) of a tile whose rows are `stride` elements apart.
bool conflict_free(int stride, int esize, bool row_g) {
  long long word_at[32];
  for (int b = 0; b < 32; ++b) word_at[b] = -1;
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    const int row = row_g ? g : t, col = row_g ? t : g;
    const long long word = (static_cast<long long>(row) * stride + col) *
                           esize / 4;
    const int b = static_cast<int>(word % 32);
    if (word_at[b] >= 0 && word_at[b] != word) return false;
    word_at[b] = word;
  }
  return true;
}

// The least row stride >= min_elems whose rows start 16-byte aligned
// (cp.async) and whose fragment loads are free of bank conflicts.
int pick_stride(int min_elems, int esize, bool row_g) {
  const int step = 16 / esize;
  int s = round_up(min_elems, step);
  while (!conflict_free(s, esize, row_g)) s += step;
  return s;
}

// The logits of a warp's 16 points: acc[j] (16 x 8: slices 8j..8j+7, the
// first nt) = X (16 x Dk) . Ws, with x0, x1 at rows g and g + 8 of the
// warp's X tile and Ws (Dk, sws) zero-padded in shared memory. FLUSH: each
// 8-deep k-step in a fresh MMA accumulator, added to acc in float32 (the
// deslice at D = G = 128 read up to 1.17e-5 of max |out| on five seeds,
// over its 1e-5 bound, with the chain of 16 k-steps in the accumulator;
// at most 3.9e-6 flushed, for 1.4% of its time on an H100).
template <typename S, int NT, bool FLUSH>
__device__ __forceinline__ void warp_logits(const S* x0, const S* x1,
                                            const float* sws, int sws_stride,
                                            int D, int Dk, int nt,
                                            float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int ks = 0; ks < Dk / 8; ++ks) {
    const int k0 = ks * 8 + t, k1 = k0 + 4;
    uint32_t ah[4], al[4];
    split(k0 < D ? cvt<float>(x0[k0]) : 0.f, ah[0], al[0]);
    split(k0 < D ? cvt<float>(x1[k0]) : 0.f, ah[1], al[1]);
    split(k1 < D ? cvt<float>(x0[k1]) : 0.f, ah[2], al[2]);
    split(k1 < D ? cvt<float>(x1[k1]) : 0.f, ah[3], al[3]);
    const float* b0 = sws + k0 * sws_stride + g;
    const float* b1 = sws + k1 * sws_stride + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split(b0[j * 8], bh0, bl0);
        split(b1[j * 8], bh1, bl1);
        if constexpr (FLUSH) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(p, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] += p[q];
        } else {
          mma3(acc[j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
}

// Rows g and g + 8 of the logits to exp(l - max l), l = (logit + bs) /
// temp over the G columns (columns past G: 0); r0, r1: 1 / the row sums.
template <int NT>
__device__ __forceinline__ void warp_softmax(float (&acc)[NT][4],
                                             const float* sbs, float rtemp,
                                             int G, int nt, float& r0,
                                             float& r1) {
  const int t = threadIdx.x & 3;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = j * 8 + 2 * t + h;
        const bool in = c < G;
        acc[j][h] = in ? (acc[j][h] + sbs[c]) * rtemp : -INFINITY;
        acc[j][2 + h] = in ? (acc[j][2 + h] + sbs[c]) * rtemp : -INFINITY;
        mx0 = fmaxf(mx0, acc[j][h]);
        mx1 = fmaxf(mx1, acc[j][2 + h]);
      }
    }
  }
#pragma unroll
  for (int q = 1; q <= 2; q <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, q));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, q));
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[j][h] = expf(acc[j][h] - mx0);
        acc[j][2 + h] = expf(acc[j][2 + h] - mx1);
        s0 += acc[j][h];
        s1 += acc[j][2 + h];
      }
    }
  }
#pragma unroll
  for (int q = 1; q <= 2; q <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, q);
    s1 += __shfl_xor_sync(0xffffffffu, s1, q);
  }
  r0 = 1.f / s0;
  r1 = 1.f / s1;
}

// Ws (D, G) at strides (ws_d, ws_g) into shared (Dk, sws) floats and bs
// into Gp floats (G rounded up), zero-padded.
template <typename S>
__device__ __forceinline__ void stage_ws(const S* __restrict__ ws, int ws_d,
                                         int ws_g, const S* __restrict__ bs,
                                         int D, int G, int Dk, int Gp,
                                         int sws_stride, float* sws,
                                         float* sbs) {
  for (int i = threadIdx.x; i < Dk * sws_stride; i += blockDim.x) {
    const int d = i / sws_stride, c = i - d * sws_stride;
    sws[i] = d < D && c < G ? cvt<float>(ws[d * ws_d + c * ws_g]) : 0.f;
  }
  for (int c = threadIdx.x; c < Gp; c += blockDim.x)
    sbs[c] = c < G ? cvt<float>(bs[c]) : 0.f;
}

// GT: G rounded up to 32, 64 or 128 (the logits' accumulator fragments).
int g_bucket(int G) { return G <= 32 ? 32 : (G <= 64 ? 64 : 128); }

// ---------------------------------------------------------------------
// slice_pool on the tensor cores

// Shared-memory layout of slice_pool_kernel (host-computed, passed by
// value). Byte offsets: Ws (Dk, sws) floats at 0, bs at off_bs, the two
// stages at off_stage. A stage holds P / 16 warp regions (16 rows of X at
// stride sx, overwritten by 16 weight rows at stride sw) and then F
// (P rows at stride sf, columns D..sf-1 = 1, 0, 0, ...).
struct PoolLayout {
  int P;        // points per tile
  int kw;       // warp groups that split a tile's points in the sums
  int Dk;       // D rounded up to 8: the logits' depth
  int G8;       // G rounded up to 8: the logits' columns
  int MT;       // 16-slice tiles of the sums
  int NT2;      // 8-column tiles of the sums ([F | 1]: D + 1 columns)
  int sws, sx, sw, sf;  // row strides (elements)
  int region;   // bytes of one warp's X / weight rows
  int off_bs, off_stage, stage_bytes, off_f, bytes;
};

// sums fragments per warp: (GT / 16) x 17 tiles at D = 128, over 8 warps
__host__ __device__ constexpr int acc_tiles(int GT) {
  return (GT / 16 * 17 + kWarps - 1) / kWarps;
}

// P: the largest tile whose two stages leave room for two resident blocks
// (G <= 64: registers allow them), else the largest that fits. kw: as many
// warp groups along the points as the output tiles leave warps for, so
// that each warp's dependent MMA chains are short; their sums meet in
// shared memory at the end.
PoolLayout pool_layout(int D, int G, int esize) {
  PoolLayout L{};
  L.Dk = round_up(D, 8);
  L.G8 = round_up(G, 8);
  L.MT = (G + 15) / 16;
  L.NT2 = (D + 1 + 7) / 8;
  L.sws = pick_stride(L.G8, 4, false);
  L.sx = pick_stride(L.Dk, esize, true);
  L.sw = pick_stride(L.MT * 16, 4, false);
  L.sf = pick_stride(L.NT2 * 8, esize, false);
  L.region = 16 * (L.sx * esize > L.sw * 4 ? L.sx * esize : L.sw * 4);
  L.off_bs = L.Dk * L.sws * 4;
  L.off_stage = L.off_bs + round_up(L.G8 * 4, 16);
  // sets L for the largest P whose two stages fit in `limit` bytes
  auto fit = [&](int limit) {
    for (L.P = 128; L.P >= 16; L.P /= 2) {
      L.off_f = L.P / 16 * L.region;
      L.stage_bytes = L.off_f + round_up(L.P * L.sf * esize, 16);
      L.bytes = L.off_stage + 2 * L.stage_bytes;
      if (L.bytes <= limit) return true;
    }
    return false;
  };
  if (!fit(G <= 64 ? kSmemTwoBlocks : kSmemMax) && !fit(kSmemMax)) {
    L.P = 0;
    return L;
  }
  const int n_out = L.MT * L.NT2;
  const int acc = acc_tiles(g_bucket(G));
  const int need = (n_out + acc - 1) / acc;  // warps that hold the sums
  L.kw = 1;
  while (2 * L.kw * need <= kWarps &&
         2 * L.kw * n_out * 128 * 4 <= 2 * L.stage_bytes)
    L.kw *= 2;
  return L;
}

// part: (BH, chunks, G, D + 1) float32 sums, column D = den.
template <typename S, int GT>
__global__ void __launch_bounds__(kThreads)
slice_pool_kernel(const S* __restrict__ fx, const Rows fr,
                  const S* __restrict__ xm, const Rows xr, int H,
                  const S* __restrict__ ws, int ws_d, int ws_g,
                  const S* __restrict__ bs, const S* __restrict__ temp,
                  int N, int D, int G, int tiles_per_chunk, int vec,
                  const PoolLayout L, float* __restrict__ part) {
  constexpr int NT = GT / 8;  // logits fragments per warp
  constexpr int ACC = acc_tiles(GT);
  extern __shared__ __align__(16) unsigned char smem[];
  float* sws = reinterpret_cast<float*>(smem);
  float* sbs = reinterpret_cast<float*>(smem + L.off_bs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, chunk = blockIdx.x;
  const int first = chunk * tiles_per_chunk;
  const int count = min(tiles_per_chunk, (N + L.P - 1) / L.P - first);
  const S* xb = head_rows(xm, xr, bh, H);
  const S* fb = head_rows(fx, fr, bh, H);
  const float tb = cvt<float>(temp[bh % H]);
  auto stage_at = [&](int s) {
    return smem + L.off_stage + s * L.stage_bytes;
  };
  auto f_at = [&](int s) {
    return reinterpret_cast<S*>(stage_at(s) + L.off_f);
  };

  // Ws and bs zero-padded; the ones column and zero padding of F
  stage_ws(ws, ws_d, ws_g, bs, D, G, L.Dk, L.G8, L.sws, sws, sbs);
  const int padc = L.sf - D;
  for (int s = 0; s < 2; ++s) {
    S* f = f_at(s);
    for (int i = tid; i < L.P * padc; i += kThreads) {
      const int r = i / padc, c = D + (i - r * padc);
      f[r * L.sf + c] = cvt<S>(c == D ? 1.f : 0.f);
    }
  }

  // Tile `tile` into stage s: rows past N are zeros. vec: rows of x_mid
  // and fx start 16-byte aligned (cp.async), else plain loads.
  auto stage = [&](int tile, int s) {
    const int n0 = tile * L.P, nv = min(L.P, N - n0);
    unsigned char* x = stage_at(s);
    S* f = f_at(s);
    const S* gx = xb + n0 * xr.n;
    const S* gf = fb + n0 * fr.n;
    if (vec) {
      const int cpr = D * static_cast<int>(sizeof(S)) / 16;
      for (int i = tid; i < L.P * cpr; i += kThreads) {
        const int r = i / cpr, c = i - r * cpr;
        const bool ok = r < nv;
        const long long row = ok ? r : 0;
        cp_async16_zfill(x + (r >> 4) * L.region +
                             ((r & 15) * L.sx) * sizeof(S) + c * 16,
                         reinterpret_cast<const unsigned char*>(
                             gx + row * xr.n) + c * 16,
                         ok);
        cp_async16_zfill(reinterpret_cast<unsigned char*>(f + r * L.sf) +
                             c * 16,
                         reinterpret_cast<const unsigned char*>(
                             gf + row * fr.n) + c * 16,
                         ok);
      }
    } else {
      for (int i = tid; i < L.P * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const bool ok = r < nv;
        S* xrow = reinterpret_cast<S*>(x + (r >> 4) * L.region) +
                  (r & 15) * L.sx;
        xrow[d] = ok ? gx[r * xr.n + d] : cvt<S>(0.f);
        f[r * L.sf + d] = ok ? gf[r * fr.n + d] : cvt<S>(0.f);
      }
    }
  };

  // this warp's group kg takes k-steps kg, kg + kw, ... of each tile; in
  // it, the warp takes a run of the output tiles, m-major: o = (m, n)
  const int n_out = L.MT * L.NT2;
  const int wpg = kWarps / L.kw, kg = warp / wpg, wi = warp - kg * wpg;
  const int per = (n_out + wpg - 1) / wpg;
  const int o_first = wi * per;
  const int o_count = max(0, min(per, n_out - o_first));
  const int m_first = o_first / L.NT2, n_first = o_first - m_first * L.NT2;
  float sum[ACC][4];
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    sum[j][0] = sum[j][1] = sum[j][2] = sum[j][3] = 0.f;
  const float rtemp = 1.f / tb;

  stage(first, 0);
  cp_async_commit();
  for (int it = 0; it < count; ++it) {
    const int s = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; stage s ^ 1 is free again
    if (it + 1 < count) stage(first + it + 1, s ^ 1);
    cp_async_commit();
    const int nv = min(L.P, N - (first + it) * L.P);
    unsigned char* xw = stage_at(s);

    // 1. logits and softmax weights of this warp's 16 points
    if (warp * 16 < L.P) {
      unsigned char* region = xw + warp * L.region;
      const S* x0 = reinterpret_cast<const S*>(region) + g * L.sx;
      const int nt = L.G8 / 8;
      float acc[NT][4];
      warp_logits<S, NT, false>(x0, x0 + 8 * L.sx, sws, L.sws, D, L.Dk, nt,
                                acc);
      float s0, s1;
      warp_softmax(acc, sbs, rtemp, G, nt, s0, s1);
      // the weights go over the warp's own X rows: every lane has read them
      __syncwarp();
      const bool ok0 = warp * 16 + g < nv, ok1 = warp * 16 + g + 8 < nv;
      float* w0 = reinterpret_cast<float*>(region) + g * L.sw;
      float* w1 = w0 + 8 * L.sw;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const int c = j * 8 + 2 * t;
          *reinterpret_cast<float2*>(w0 + c) =
              ok0 ? make_float2(acc[j][0] * s0, acc[j][1] * s0)
                  : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(w1 + c) =
              ok1 ? make_float2(acc[j][2] * s1, acc[j][3] * s1)
                  : make_float2(0.f, 0.f);
        }
      }
    }
    __syncthreads();  // the weight tile is complete

    // 2. [num | den] += W^T . [F | 1] over the tile's valid points
    float acc2[ACC][4];
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
    const S* fs = f_at(s);
    const int nks = (nv + 7) >> 3;
    for (int ks = kg; ks < nks; ks += L.kw) {
      const int p0 = ks * 8 + t, p1 = p0 + 4;
      const float* w0 = reinterpret_cast<const float*>(
                            xw + (p0 >> 4) * L.region) +
                        (p0 & 15) * L.sw + g;
      const float* w1 = reinterpret_cast<const float*>(
                            xw + (p1 >> 4) * L.region) +
                        (p1 & 15) * L.sw + g;
      const S* f0 = fs + p0 * L.sf + g;
      const S* f1 = fs + p1 * L.sf + g;
      int m = m_first, n = n_first, m_have = -1;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        if (j < o_count) {
          if (m != m_have) {
            split(w0[m * 16], ah[0], al[0]);
            split(w0[m * 16 + 8], ah[1], al[1]);
            split(w1[m * 16], ah[2], al[2]);
            split(w1[m * 16 + 8], ah[3], al[3]);
            m_have = m;
          }
          uint32_t bh0, bl0, bh1, bl1;
          split(cvt<float>(f0[n * 8]), bh0, bl0);
          split(cvt<float>(f1[n * 8]), bh1, bl1);
          mma3(acc2[j], ah, al, bh0, bh1, bl0, bl1);
          if (++n == L.NT2) {
            n = 0;
            ++m;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ACC; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[j][q] += acc2[j][q];
  }

  float* out = part + (static_cast<size_t>(bh) * gridDim.x + chunk) * G *
                          (D + 1);
  if (L.kw == 1) {
    int m = m_first, n = n_first;
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      if (j < o_count) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int slice = m * 16 + g + 8 * h;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = n * 8 + 2 * t + q;
            if (slice < G && col <= D)
              out[slice * (D + 1) + col] = sum[j][2 * h + q];
          }
        }
        if (++n == L.NT2) {
          n = 0;
          ++m;
        }
      }
    }
    return;
  }
  // the groups' sums, (kw, n_out, 32 lanes, 4) over the stages, added in
  // group order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L.off_stage);
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    if (j < o_count)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[((kg * n_out + o_first + j) * 32 + lane) * 4 + q] = sum[j][q];
  __syncthreads();
  for (int e = tid; e < n_out * 128; e += kThreads) {
    float v = 0.f;
    for (int k = 0; k < L.kw; ++k) v += red[k * n_out * 128 + e];
    const int o = e >> 7, ln = (e >> 2) & 31, q = e & 3;
    const int m = o / L.NT2, n = o - m * L.NT2;
    const int slice = m * 16 + (ln >> 2) + 8 * (q >> 1);
    const int col = n * 8 + 2 * (ln & 3) + (q & 1);
    if (slice < G && col <= D) out[slice * (D + 1) + col] = v;
  }
}

template <typename S>
using PoolKernel = void (*)(const S*, const Rows, const S*, const Rows, int,
                            const S*, int, int, const S*, const S*, int, int,
                            int, int, int, const PoolLayout, float*);

template <typename S>
PoolKernel<S> pool_kernel(int G) {
  if (G <= 32) return slice_pool_kernel<S, 32>;
  if (G <= 64) return slice_pool_kernel<S, 64>;
  return slice_pool_kernel<S, 128>;
}

// ---------------------------------------------------------------------
// slice_deslice on the tensor cores

// Shared-memory layout of slice_deslice_kernel (host-computed, passed by
// value). Byte offsets: Ws (D8, sws) floats at 0; the tokens (GT, stok)
// floats at off_tok, row 8j + q holding slice 8j + 2q (q < 4) or
// 8j + 2(q - 4) + 1; bs at off_bs; all zero-padded to GT slices and D16
// columns, so that the kernel's fragment loops have no bounds to test.
// From off_stage the warps' rings, stage s of warp w at
// (stages * w + s) * region: 16 rows of X at stride sx, overwritten by the
// 16 output rows (float) at stride so.
struct DesliceLayout {
  int warps;     // per block: P = 16 * warps points per tile
  int stages;    // of each warp's ring: stages - 1 tiles ahead
  int D8, D16;   // D rounded up to 8 (the logits' depth) and to 16
  int GT;        // G rounded up to 32, 64 or 128
  int sws, stok, sx, so;  // row strides (elements)
  int region;    // bytes of one stage of one warp
  int off_tok, off_bs, off_stage, bytes;
};

// Row stride of the output rows: 16-byte aligned (float4 reads) and
// `stride % 32` in {8, 24}, so that the float2 fragment stores of each half
// warp (rows g, columns 2t) cover 32 banks.
int out_stride(int D16) {
  int s = round_up(D16, 4);
  while (s % 32 != 8 && s % 32 != 24) s += 4;
  return s;
}

// 8 warps with rings of 4 stages where they leave room for two resident
// blocks (G <= 64), else the deepest rings that fit (one stage: no tile
// ahead; the other warps' loads overlap a warp's products), else fewer
// warps.
DesliceLayout deslice_layout(int D, int G, int esize) {
  DesliceLayout L{};
  L.D8 = round_up(D, 8);
  L.D16 = round_up(D, 16);
  L.GT = g_bucket(G);
  L.sws = pick_stride(L.GT, 4, false);
  L.stok = pick_stride(L.D16, 4, false);
  L.sx = pick_stride(L.D8, esize, true);
  L.so = out_stride(L.D16);
  L.region = 16 * (L.sx * esize > L.so * 4 ? L.sx * esize : L.so * 4);
  L.off_tok = L.D8 * L.sws * 4;
  L.off_bs = L.off_tok + L.GT * L.stok * 4;
  L.off_stage = L.off_bs + L.GT * 4;
  for (const int limit : {G <= 64 ? kSmemTwoBlocks : kSmemMax, kSmemMax})
    for (L.warps = kWarps; L.warps >= 1; L.warps /= 2)
      for (L.stages = 4; L.stages >= 1; --L.stages) {
        L.bytes = L.off_stage + L.stages * L.warps * L.region;
        if (L.bytes <= limit) return L;
      }
  L.warps = 0;
  return L;
}

// 16 bytes of output from 16 / sizeof(S) floats in shared memory
template <typename S>
__device__ __forceinline__ void store16(S* dst, const float* src);
template <>
__device__ __forceinline__ void store16<float>(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst,
                                                       const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
  p[0] = __floats2bfloat162_rn(a.x, a.y);
  p[1] = __floats2bfloat162_rn(a.z, a.w);
  p[2] = __floats2bfloat162_rn(b.x, b.y);
  p[3] = __floats2bfloat162_rn(b.z, b.w);
  *reinterpret_cast<uint4*>(dst) = u;
}
template <>
__device__ __forceinline__ void store16<__half>(__half* dst,
                                                const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  uint4 u;
  __half2* p = reinterpret_cast<__half2*>(&u);
  p[0] = __floats2half2_rn(a.x, a.y);
  p[1] = __floats2half2_rn(a.z, a.w);
  p[2] = __floats2half2_rn(b.x, b.y);
  p[3] = __floats2half2_rn(b.z, b.w);
  *reinterpret_cast<uint4*>(dst) = u;
}

// GT: G rounded up to 32, 64 or 128 (the logits' accumulator fragments);
// two resident blocks per SM up to 64 (<= 128 registers).
// vec_in, vec_out: x_mid's and out's rows are whole 16-byte chunks.
template <typename S, int GT>
__global__ void __launch_bounds__(kThreads, GT <= 64 ? 2 : 1)
slice_deslice_kernel(const S* __restrict__ xm, const Rows xr, int H,
                     const S* __restrict__ tok, const S* __restrict__ ws,
                     int ws_d, int ws_g, const S* __restrict__ bs,
                     const S* __restrict__ temp, int N, int D, int G,
                     int tiles_per_chunk, int vec_in, int vec_out,
                     const DesliceLayout L, S* __restrict__ out,
                     const Rows orow) {
  constexpr int NT = GT / 8;  // 8-slice fragments per warp, all computed
  extern __shared__ __align__(16) unsigned char smem[];
  float* sws = reinterpret_cast<float*>(smem);
  float* stok = reinterpret_cast<float*>(smem + L.off_tok);
  float* sbs = reinterpret_cast<float*>(smem + L.off_bs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, P = 16 * L.warps;
  const int first = blockIdx.x * tiles_per_chunk;
  const int count = min(tiles_per_chunk, (N + P - 1) / P - first);
  const S* xb = head_rows(xm, xr, bh, H);
  S* ob = head_rows(out, orow, bh, H);
  const S* tk = tok + static_cast<size_t>(bh) * G * D;
  const float rtemp = 1.f / cvt<float>(temp[bh % H]);

  stage_ws(ws, ws_d, ws_g, bs, D, G, L.D8, GT, L.sws, sws, sbs);
  for (int i = threadIdx.x; i < GT * L.stok; i += blockDim.x) {
    const int r = i / L.stok, d = i - r * L.stok, q = r & 7;
    const int c = (r & ~7) + (q < 4 ? 2 * q : 2 * q - 7);
    stok[i] = c < G && d < D ? cvt<float>(tk[c * D + d]) : 0.f;
  }
  __syncthreads();

  // Rows of whole 16-byte chunks (vec_in, vec_out): lane (lr, lc) moves
  // chunk lc of rows lr, lr + rstep, ... (lr >= rstep: idle).
  const int cpr = D * static_cast<int>(sizeof(S)) / 16;
  const int rstep = cpr > 0 ? 32 / cpr : 1;
  const int lr = cpr > 0 ? lane / cpr : 32, lc = lane - lr * cpr;

  // This warp's rows of tile `tile` into its stage s: rows past N are
  // zeros.
  unsigned char* ring = smem + L.off_stage + L.stages * warp * L.region;
  auto stage = [&](int tile, int s) {
    const int n0 = tile * P + warp * 16, nv = min(16, N - n0);
    unsigned char* x = ring + s * L.region;
    const S* gx = xb + n0 * xr.n;
    if (vec_in) {
      if (lr < rstep)
        for (int r = lr; r < 16; r += rstep) {
          const bool ok = r < nv;
          cp_async16_zfill(x + r * L.sx * sizeof(S) + lc * 16,
                           reinterpret_cast<const unsigned char*>(
                               ok ? gx + r * xr.n : xb) + lc * 16,
                           ok);
        }
    } else {
      for (int i = lane; i < 16 * D; i += 32) {
        const int r = i / D, d = i - r * D;
        reinterpret_cast<S*>(x)[r * L.sx + d] =
            r < nv ? gx[r * xr.n + d] : cvt<S>(0.f);
      }
    }
  };

  const int ahead = L.stages - 1;
  for (int k = 0; k < ahead; ++k) {
    if (k < count) stage(first + k, k);
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    const int s = it % L.stages;
    // the stage of tile it + ahead held tile it - 1, done with
    if (it + ahead < count)
      stage(first + it + ahead, (it + ahead) % L.stages);
    cp_async_commit();
    cp_async_wait_pending(ahead);
    __syncwarp();  // the warp's rows of tile it landed
    const int n0 = (first + it) * P + warp * 16, nv = min(16, N - n0);
    if (nv <= 0) continue;  // the same for the whole warp
    unsigned char* region = ring + s * L.region;

    // 1. logits and the unnormalised softmax weights of the 16 points
    const S* x0 = reinterpret_cast<const S*>(region) + g * L.sx;
    float acc[NT][4];
    warp_logits<S, NT, GT == 128>(x0, x0 + 8 * L.sx, sws, L.sws, D, L.D8,
                                  NT, acc);
    float s0, s1;
    warp_softmax(acc, sbs, rtemp, G, NT, s0, s1);

    // 2. out = W . tok, 16 columns at a time, over the warp's own X rows
    // (every lane has read them)
    __syncwarp();
    float* o0 = reinterpret_cast<float*>(region) + g * L.so;
    float* o1 = o0 + 8 * L.so;
    for (int cb = 0; cb < L.D16; cb += 16) {
      float oacc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ah[4], al[4];
        split(acc[j][0], ah[0], al[0]);
        split(acc[j][2], ah[1], al[1]);
        split(acc[j][1], ah[2], al[2]);
        split(acc[j][3], ah[3], al[3]);
        const float* b0 = stok + (j * 8 + t) * L.stok + cb + g;
        const float* b1 = b0 + 4 * L.stok;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(b0[n * 8], bh0, bl0);
          split(b1[n * 8], bh1, bl1);
          mma3(oacc[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = cb + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(o0 + c) =
            make_float2(oacc[n][0] * s0, oacc[n][1] * s0);
        *reinterpret_cast<float2*>(o1 + c) =
            make_float2(oacc[n][2] * s1, oacc[n][3] * s1);
      }
    }
    __syncwarp();

    // 3. the nv valid rows, D values each
    const float* rows = reinterpret_cast<const float*>(region);
    S* go = ob + n0 * orow.n;
    if (vec_out) {
      constexpr int E = 16 / sizeof(S);
      if (lr < rstep)
        for (int r = lr; r < nv; r += rstep)
          store16(go + r * orow.n + lc * E, rows + r * L.so + lc * E);
    } else {
      for (int i = lane; i < nv * D; i += 32) {
        const int r = i / D, d = i - r * D;
        go[r * orow.n + d] = cvt<S>(rows[r * L.so + d]);
      }
    }
    __syncwarp();  // stage s is free for tile it + stages
  }
}

template <typename S>
using DesliceKernel = void (*)(const S*, const Rows, int, const S*, const S*,
                               int, int, const S*, const S*, int, int, int,
                               int, int, int, const DesliceLayout, S*,
                               const Rows);

template <typename S>
DesliceKernel<S> deslice_kernel(int G) {
  if (G <= 32) return slice_deslice_kernel<S, 32>;
  if (G <= 64) return slice_deslice_kernel<S, 64>;
  return slice_deslice_kernel<S, 128>;
}

// ---------------------------------------------------------------------
// SIMT kernels: float64, and every type where D or G > 128

constexpr int kSimtThreads = 128;
constexpr int kSimtAcc = 16;  // slice_pool: sums per thread
constexpr int kSlab = kSimtThreads * kSimtAcc;

__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ double texp(double x) { return exp(x); }

// Copies rows [0, nv) of a (rows, D) view with row stride `stride` into
// shared rows of stride D + 1, in the math type.
template <typename T, typename S>
__device__ void load_rows(const S* __restrict__ src, long long stride,
                          int nv, int D, T* __restrict__ dst) {
  for (int i = threadIdx.x; i < nv * D; i += kSimtThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * (D + 1) + d] = cvt<T>(src[r * stride + d]);
  }
}

template <typename T, typename S>
__device__ void load_flat(const S* __restrict__ src, int n,
                          T* __restrict__ dst) {
  for (int i = threadIdx.x; i < n; i += kSimtThreads) dst[i] = cvt<T>(src[i]);
}

// ws (D, G) at strides (ws_d, ws_g) into a dense (D, G) shared tile
template <typename T, typename S>
__device__ void load_ws(const S* __restrict__ ws, int ws_d, int ws_g, int D,
                        int G, T* __restrict__ dst) {
  for (int i = threadIdx.x; i < D * G; i += kSimtThreads) {
    const int d = i / G, g = i - d * G;
    dst[i] = cvt<T>(ws[d * ws_d + g * ws_g]);
  }
}

// Softmax weights of the tile's nv points: row t of sw (stride G + 1) from
// row t of sx (stride D + 1). The expressions of jax.nn.softmax: logits
// (x . ws + bs) / temp, minus their max, exp, divided by the sum. ws at
// strides (ws_d, ws_g): staged in shared memory (W = T) or read from global
// memory (W = S). Ends with a barrier.
template <typename T, typename W>
__device__ void tile_weights(const T* __restrict__ sx,
                             const W* __restrict__ ws, int ws_d, int ws_g,
                             const T* __restrict__ sbs, T temp, int nv, int D,
                             int G, T* __restrict__ sw) {
  const int t = threadIdx.x;
  if (t < nv) {
    const T* x = sx + t * (D + 1);
    T* row = sw + t * (G + 1);
    T mx = T(0);
    for (int g = 0; g < G; ++g) {
      T acc = T(0);
      for (int d = 0; d < D; ++d)
        acc += x[d] * cvt<T>(ws[d * ws_d + g * ws_g]);
      const T l = (acc + sbs[g]) / temp;
      row[g] = l;
      if (g == 0 || l > mx) mx = l;
    }
    T sum = T(0);
    for (int g = 0; g < G; ++g) {
      const T e = texp(row[g] - mx);
      row[g] = e;
      sum += e;
    }
    for (int g = 0; g < G; ++g) row[g] = row[g] / sum;
  }
  __syncthreads();
}

// P and whether ws (and, for slice_deslice, tok) are staged in shared
// memory: staged where they fit beside tiles of P >= 16 points. tsize: the
// math type's bytes.
struct SimtPlan {
  int P;
  int staged;
  size_t bytes;
};

SimtPlan simt_plan(int D, int G, size_t tsize, bool deslice) {
  const int p_max = tsize == 8 ? 64 : 128;
  for (int staged = 1; staged >= 0; --staged) {
    const size_t fixed = G + (staged ? (deslice ? 2 : 1) * D * G : 0);
    for (int P = p_max; P >= 16; P /= 2) {
      const size_t tiles = (deslice ? 1 : 2) * P * (D + 1) + P * (G + 1);
      const size_t bytes = tsize * (fixed + tiles);
      if (bytes <= kSmemMax) return SimtPlan{P, staged, bytes};
    }
  }
  return SimtPlan{0, 0, 0};
}

// part: (BH, chunks, G, D + 1) sums in the math type, column D = den.
template <typename S>
__global__ void __launch_bounds__(kSimtThreads)
slice_pool_simt_kernel(const S* __restrict__ fx, const Rows fr,
                       const S* __restrict__ xm, const Rows xr, int H,
                       const S* __restrict__ ws, int ws_d, int ws_g,
                       const S* __restrict__ bs, const S* __restrict__ temp,
                       int N, int D, int G, int P, int staged,
                       int tiles_per_chunk,
                       typename Math<S>::T* __restrict__ part) {
  using T = typename Math<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sws = reinterpret_cast<T*>(smem_raw);  // (D, G) if staged
  T* sbs = sws + (staged ? D * G : 0);      // (G)
  T* sx = sbs + G;                          // (P, D + 1)
  T* sf = sx + P * (D + 1);                 // (P, D + 1), column D = 1
  T* sw = sf + P * (D + 1);                 // (P, G + 1)
  const int bh = blockIdx.y, chunk = blockIdx.x, o0 = blockIdx.z * kSlab;
  const int GD1 = G * (D + 1);
  if (staged) load_ws(ws, ws_d, ws_g, D, G, sws);
  load_flat(bs, G, sbs);
  for (int r = threadIdx.x; r < P; r += kSimtThreads)
    sf[r * (D + 1) + D] = T(1);
  const T tb = cvt<T>(temp[bh % H]);
  const S* xb = head_rows(xm, xr, bh, H);
  const S* fb = head_rows(fx, fr, bh, H);

  T acc[kSimtAcc];
#pragma unroll
  for (int k = 0; k < kSimtAcc; ++k) acc[k] = T(0);

  for (int it = 0; it < tiles_per_chunk; ++it) {
    const int n0 = (chunk * tiles_per_chunk + it) * P;
    if (n0 >= N) break;  // the same for every thread of the block
    const int nv = min(P, N - n0);
    __syncthreads();  // the last tile's products are done with sx, sf, sw
    load_rows(xb + n0 * xr.n, xr.n, nv, D, sx);
    load_rows(fb + n0 * fr.n, fr.n, nv, D, sf);
    __syncthreads();
    if (staged)
      tile_weights(sx, sws, G, 1, sbs, tb, nv, D, G, sw);
    else
      tile_weights(sx, ws, ws_d, ws_g, sbs, tb, nv, D, G, sw);
#pragma unroll
    for (int k = 0; k < kSimtAcc; ++k) {
      const int o = o0 + threadIdx.x + k * kSimtThreads;
      if (o < GD1) {
        const int g = o / (D + 1), d = o - g * (D + 1);
        T s = acc[k];
        for (int n = 0; n < nv; ++n)
          s += sw[n * (G + 1) + g] * sf[n * (D + 1) + d];
        acc[k] = s;
      }
    }
  }
  T* out = part + (static_cast<size_t>(bh) * gridDim.x + chunk) * GD1;
#pragma unroll
  for (int k = 0; k < kSimtAcc; ++k) {
    const int o = o0 + threadIdx.x + k * kSimtThreads;
    if (o < GD1) out[o] = acc[k];
  }
}

// Adds the chunks' (G, D + 1) sums of bh = blockIdx.y in chunk order, one
// thread per sum.
template <typename S, typename A>
__global__ void __launch_bounds__(256)
slice_pool_reduce_kernel(const A* __restrict__ part, int chunks, int D, int G,
                         S* __restrict__ num, S* __restrict__ den) {
  const int bh = blockIdx.y, GD1 = G * (D + 1);
  const A* p = part + static_cast<size_t>(bh) * chunks * GD1;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o < GD1) {
    A s = A(0);
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) s += p[static_cast<size_t>(c) * GD1 + o];
    const int g = o / (D + 1), d = o - g * (D + 1);
    if (d < D)
      num[(static_cast<size_t>(bh) * G + g) * D + d] = cvt<S>(s);
    else
      den[static_cast<size_t>(bh) * G + g] = cvt<S>(s);
  }
}

// out[n * stride + d] = sum_g w[n, g] tok[g, d] for the tile's points; tok
// staged (V = T) or in global memory (V = S).
template <typename T, typename S, typename V>
__device__ void tile_broadcast(const T* __restrict__ sw,
                               const V* __restrict__ tok, int nv, int D,
                               int G, S* __restrict__ out, long long stride) {
  for (int i = threadIdx.x; i < nv * D; i += kSimtThreads) {
    const int n = i / D, d = i - n * D;
    const T* w = sw + n * (G + 1);
    T s = T(0);
    for (int g = 0; g < G; ++g) s += w[g] * cvt<T>(tok[g * D + d]);
    out[n * stride + d] = cvt<S>(s);
  }
}

template <typename S>
__global__ void __launch_bounds__(kSimtThreads)
slice_deslice_simt_kernel(const S* __restrict__ xm, const Rows xr, int H,
                          const S* __restrict__ tok,
                          const S* __restrict__ ws, int ws_d, int ws_g,
                          const S* __restrict__ bs,
                          const S* __restrict__ temp, int N, int D, int G,
                          int P, int staged, S* __restrict__ out,
                          const Rows orow) {
  using T = typename Math<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sws = reinterpret_cast<T*>(smem_raw);  // (D, G) if staged
  T* stok = sws + (staged ? D * G : 0);     // (G, D) if staged
  T* sbs = stok + (staged ? G * D : 0);     // (G)
  T* sx = sbs + G;                          // (P, D + 1)
  T* sw = sx + P * (D + 1);                 // (P, G + 1)
  const int bh = blockIdx.y, n0 = blockIdx.x * P;
  const int nv = min(P, N - n0);
  const S* tk = tok + static_cast<size_t>(bh) * G * D;
  S* ob = head_rows(out, orow, bh, H) + n0 * orow.n;
  if (staged) {
    load_ws(ws, ws_d, ws_g, D, G, sws);
    load_flat(tk, G * D, stok);
  }
  load_flat(bs, G, sbs);
  load_rows(head_rows(xm, xr, bh, H) + n0 * xr.n, xr.n, nv, D, sx);
  __syncthreads();
  const T tb = cvt<T>(temp[bh % H]);
  if (staged) {
    tile_weights(sx, sws, G, 1, sbs, tb, nv, D, G, sw);
    tile_broadcast(sw, stok, nv, D, G, ob, orow.n);
  } else {
    tile_weights(sx, ws, ws_d, ws_g, sbs, tb, nv, D, G, sw);
    tile_broadcast(sw, tk, nv, D, G, ob, orow.n);
  }
}

// ---------------------------------------------------------------------
// host side

// chunks x tiles_per_chunk of slice_pool for these shapes (one wave)
template <typename S>
int slice_pool_plan(int BH, int N, int D, int G, int* chunks,
                    int* tiles_per_chunk) {
  if (!dims_ok(BH, N, D, G)) return cudaErrorInvalidValue;
  int slots = 0;
  long long tiles = 0;
  int rows = BH;
  cudaError_t e;
  if constexpr (sizeof(S) != 8) {
    if (tensor_cores(D, G)) {
      const PoolLayout L = pool_layout(D, G, sizeof(S));
      if (!L.P) return cudaErrorInvalidValue;
      e = allow_smem(pool_kernel<S>(G), L.bytes);
      if (e == cudaSuccess)
        e = resident_slots(pool_kernel<S>(G), kThreads, L.bytes, &slots);
      if (e != cudaSuccess) return e;
      split_chunks((N + L.P - 1) / L.P, slots, rows, chunks,
                   tiles_per_chunk);
      return cudaSuccess;
    }
  }
  const SimtPlan sp = simt_plan(D, G, sizeof(typename Math<S>::T), false);
  if (!sp.P) return cudaErrorInvalidValue;
  e = allow_smem(slice_pool_simt_kernel<S>, sp.bytes);
  if (e == cudaSuccess)
    e = resident_slots(slice_pool_simt_kernel<S>, kSimtThreads, sp.bytes,
                       &slots);
  tiles = (N + sp.P - 1) / sp.P;
  rows *= (G * (D + 1) + kSlab - 1) / kSlab;
  if (e != cudaSuccess) return e;
  split_chunks(tiles, slots, rows, chunks, tiles_per_chunk);
  return cudaSuccess;
}

template <typename S>
int slice_pool(const S* fx, const S* xm, const S* ws, const S* bs,
               const S* temp, void* part, S* num, S* den, int BH, int H,
               int N, int D, int G, Rows fr, Rows xr, int ws_d, int ws_g,
               int chunks, int tiles_per_chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!dims_ok(BH, N, D, G) || H < 1 || BH % H) return cudaErrorInvalidValue;
  using A = typename Math<S>::T;
  cudaError_t e;
  bool simt = true;
  if constexpr (sizeof(S) != 8) {
    if (tensor_cores(D, G)) {
      simt = false;
      const PoolLayout L = pool_layout(D, G, sizeof(S));
      if (!L.P || !chunks_ok((N + L.P - 1) / L.P, chunks, tiles_per_chunk))
        return cudaErrorInvalidValue;
      const PoolKernel<S> kernel = pool_kernel<S>(G);
      e = allow_smem(kernel, L.bytes);
      if (e != cudaSuccess) return e;
      const bool vec = rows16(fx, fr, D) && rows16(xm, xr, D);
      kernel<<<dim3(chunks, BH), kThreads, L.bytes, stream>>>(
          fx, fr, xm, xr, H, ws, ws_d, ws_g, bs, temp, N, D, G,
          tiles_per_chunk, vec, L, static_cast<float*>(part));
    }
  }
  if (simt) {
    const SimtPlan sp = simt_plan(D, G, sizeof(A), false);
    if (!sp.P || !chunks_ok((N + sp.P - 1) / sp.P, chunks, tiles_per_chunk))
      return cudaErrorInvalidValue;
    e = allow_smem(slice_pool_simt_kernel<S>, sp.bytes);
    if (e != cudaSuccess) return e;
    const int slabs = (G * (D + 1) + kSlab - 1) / kSlab;
    slice_pool_simt_kernel<S>
        <<<dim3(chunks, BH, slabs), kSimtThreads, sp.bytes, stream>>>(
            fx, fr, xm, xr, H, ws, ws_d, ws_g, bs, temp, N, D, G, sp.P,
            sp.staged, tiles_per_chunk, static_cast<A*>(part));
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  slice_pool_reduce_kernel<S, A>
      <<<dim3((G * (D + 1) + 255) / 256, BH), 256, 0, stream>>>(
          static_cast<const A*>(part), chunks, D, G, num, den);
  return cudaGetLastError();
}

// chunks x tiles_per_chunk of slice_deslice: one wave on the tensor cores;
// on SIMT one tile per block.
template <typename S>
int slice_deslice_plan(int BH, int N, int D, int G, int* chunks,
                       int* tiles_per_chunk) {
  if (!dims_ok(BH, N, D, G)) return cudaErrorInvalidValue;
  if constexpr (sizeof(S) != 8) {
    if (tensor_cores(D, G)) {
      const DesliceLayout L = deslice_layout(D, G, sizeof(S));
      if (!L.warps) return cudaErrorInvalidValue;
      int slots = 0;
      cudaError_t e = allow_smem(deslice_kernel<S>(G), L.bytes);
      if (e == cudaSuccess)
        e = resident_slots(deslice_kernel<S>(G), 32 * L.warps, L.bytes,
                           &slots);
      if (e != cudaSuccess) return e;
      const int P = 16 * L.warps;
      split_chunks((N + P - 1) / P, slots, BH, chunks, tiles_per_chunk);
      return cudaSuccess;
    }
  }
  const SimtPlan sp = simt_plan(D, G, sizeof(typename Math<S>::T), true);
  if (!sp.P) return cudaErrorInvalidValue;
  *chunks = (N + sp.P - 1) / sp.P;
  *tiles_per_chunk = 1;
  return cudaSuccess;
}

template <typename S>
int slice_deslice(const S* xm, const S* tok, const S* ws, const S* bs,
                  const S* temp, S* out, int BH, int H, int N, int D, int G,
                  Rows xr, Rows orow, int ws_d, int ws_g, int chunks,
                  int tiles_per_chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!dims_ok(BH, N, D, G) || H < 1 || BH % H) return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (sizeof(S) != 8) {
    if (tensor_cores(D, G)) {
      const DesliceLayout L = deslice_layout(D, G, sizeof(S));
      const int P = 16 * L.warps;
      if (!L.warps || !chunks_ok((N + P - 1) / P, chunks, tiles_per_chunk))
        return cudaErrorInvalidValue;
      const DesliceKernel<S> kernel = deslice_kernel<S>(G);
      e = allow_smem(kernel, L.bytes);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(chunks, BH), 32 * L.warps, L.bytes, stream>>>(
          xm, xr, H, tok, ws, ws_d, ws_g, bs, temp, N, D, G,
          tiles_per_chunk, rows16(xm, xr, D), rows16(out, orow, D), L, out,
          orow);
      return cudaGetLastError();
    }
  }
  const SimtPlan sp = simt_plan(D, G, sizeof(typename Math<S>::T), true);
  if (!sp.P || tiles_per_chunk != 1 ||
      !chunks_ok((N + sp.P - 1) / sp.P, chunks, 1))
    return cudaErrorInvalidValue;
  e = allow_smem(slice_deslice_simt_kernel<S>, sp.bytes);
  if (e != cudaSuccess) return e;
  slice_deslice_simt_kernel<S>
      <<<dim3(chunks, BH), kSimtThreads, sp.bytes, stream>>>(
          xm, xr, H, tok, ws, ws_d, ws_g, bs, temp, N, D, G, sp.P, sp.staged,
          out, orow);
  return cudaGetLastError();
}

}  // namespace

// fx, xm and out: (B, H, N, D) views of element strides (*_b, *_h, *_n)
// and channel stride 1, BH = B * H; ws (D, G) at strides (ws_d, ws_g); bs
// (G), temp (H) and tok (BH, G, D) dense; all of one type. part: scratch of
// BH * chunks * G * (D + 1) values (float64 for float64, else float32);
// num (BH, G, D), den (BH, G) dense. chunks and tiles_per_chunk come from
// the *_plan_* entry of the same kernel and shapes.
#define PMC_SLICE_ENTRIES(SUFFIX, S)                                          \
  extern "C" int pmc_slice_pool_plan_##SUFFIX(int BH, int N, int D, int G,    \
                                              int* chunks,                    \
                                              int* tiles_per_chunk) {         \
    return slice_pool_plan<S>(BH, N, D, G, chunks, tiles_per_chunk);          \
  }                                                                           \
  extern "C" int pmc_slice_pool_##SUFFIX(                                     \
      const S* fx, const S* xm, const S* ws, const S* bs, const S* temp,      \
      void* part, S* num, S* den, int BH, int H, int N, int D, int G,         \
      long long fx_b, long long fx_h, long long fx_n, long long xm_b,         \
      long long xm_h, long long xm_n, int ws_d, int ws_g, int chunks,         \
      int tiles_per_chunk, void* stream) {                                    \
    return slice_pool<S>(fx, xm, ws, bs, temp, part, num, den, BH, H, N, D,   \
                         G, Rows{fx_b, fx_h, fx_n}, Rows{xm_b, xm_h, xm_n},   \
                         ws_d, ws_g, chunks, tiles_per_chunk, stream);        \
  }                                                                           \
  extern "C" int pmc_slice_deslice_plan_##SUFFIX(int BH, int N, int D, int G, \
                                                 int* chunks,                 \
                                                 int* tiles_per_chunk) {      \
    return slice_deslice_plan<S>(BH, N, D, G, chunks, tiles_per_chunk);       \
  }                                                                           \
  extern "C" int pmc_slice_deslice_##SUFFIX(                                  \
      const S* xm, const S* tok, const S* ws, const S* bs, const S* temp,     \
      S* out, int BH, int H, int N, int D, int G, long long xm_b,             \
      long long xm_h, long long xm_n, long long out_b, long long out_h,       \
      long long out_n, int ws_d, int ws_g, int chunks, int tiles_per_chunk,   \
      void* stream) {                                                         \
    return slice_deslice<S>(xm, tok, ws, bs, temp, out, BH, H, N, D, G,       \
                            Rows{xm_b, xm_h, xm_n},                           \
                            Rows{out_b, out_h, out_n}, ws_d, ws_g, chunks,    \
                            tiles_per_chunk, stream);                         \
  }

PMC_SLICE_ENTRIES(f32, float)
PMC_SLICE_ENTRIES(f64, double)
PMC_SLICE_ENTRIES(bf16, __nv_bfloat16)
PMC_SLICE_ENTRIES(f16, __half)
